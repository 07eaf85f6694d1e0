"""PNG codec in numpy + zlib, and the image readers built on it.

The main path (image discovery, decode, undistorted exports, fixtures)
reads and writes PNG without third-party imaging libraries: 8-bit gray,
RGB or RGBA, non-interlaced, all five row filters of the PNG
specification (ISO/IEC 15948 §9).  Other formats (JPEG, TIFF, BMP) go
through Pillow, imported only when such a file is met.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}           # color type -> samples per pixel
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n


def _unfilter(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth)."""
    out = np.empty_like(rows)
    prev = np.zeros(rows.shape[1], np.uint8)
    for y, kind in enumerate(kinds):
        line = rows[y]
        if kind == 0:
            cur = line
        elif kind == 1:
            # recon[i] = filt[i] + recon[i - bpp]: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            # Average and Paeth depend non-linearly on the reconstructed
            # left neighbour, so they go byte by byte
            cur_b = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(len(cur_b)):
                a = cur_b[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur_b[i] = (cur_b[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG into uint8 (H, W) for gray or (H, W, C) for RGB/RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); 8-bit gray, RGB or RGBA, "
            "non-interlaced, is read")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError(f"{path}: PNG image data has the wrong length")
    rows = raw.reshape(h, w * c + 1)
    img = _unfilter(rows[:, 0], rows[:, 1:], c)
    return img.reshape(h, w) if c == 1 else img.reshape(h, w, c)


def write_png(path: str, img: np.ndarray) -> None:
    """Encode uint8 (H, W), (H, W, 3) or (H, W, 4) as a PNG.  Every row uses
    the Up filter, which suits smooth photographs and renders."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {img.dtype}")
    c = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or c not in _COLOR_TYPE:
        raise ValueError(f"write_png: unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, w * c)
    up = np.diff(rows, axis=0, prepend=np.zeros((1, w * c), np.uint8))
    scan = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(scan.tobytes(), 6))
                + chunk(b"IEND", b""))


def is_png(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".png"


def open_pillow(path: str):
    """Open a non-PNG image with Pillow; without Pillow, raise an error
    that names the format."""
    try:
        from PIL import Image
    except ImportError as e:
        ext = os.path.splitext(path)[1].lower() or "this"
        raise ImportError(
            f"{path}: reading {ext} images needs Pillow, which is not "
            "installed; PNG is read without it") from e
    return Image.open(path)


def read_image(path: str) -> np.ndarray:
    """Decode any supported image file to uint8 (H, W) or (H, W, C)."""
    if is_png(path):
        return read_png(path)
    with open_pillow(path) as im:
        return np.asarray(im)


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) without decoding the pixels."""
    if is_png(path):
        with open(path, "rb") as f:
            head = f.read(24)
        if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
            raise ValueError(f"{path}: not a PNG file")
        return struct.unpack(">II", head[16:24])
    with open_pillow(path) as im:
        return im.size
