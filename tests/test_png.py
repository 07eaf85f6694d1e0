"""PNG codec (io/png.py): round trips and every row filter of the spec."""
import struct
import sys
import zlib

import numpy as np
import pytest

from metricsfm_tpu.io import png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, prev, bpp):
    """Literal per-byte encoder of one scanline (PNG spec §9.2)."""
    out = []
    for i, x in enumerate(row):
        a = int(row[i - bpp]) if i >= bpp else 0
        b = int(prev[i])
        c = int(prev[i - bpp]) if i >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
        out.append((int(x) - pred) % 256)
    return bytes([kind] + out)


def _encode(img, kinds):
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c)
    prev = np.zeros(w * c, np.uint8)
    raw = b""
    for y in range(h):
        raw += _filter_row(kinds[y % len(kinds)], rows[y], prev, c)
        prev = rows[y]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_roundtrip(tmp_path, rng, channels):
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    assert png.image_size(path) == (53, 37)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_decodes_row_filter(tmp_path, rng, kind):
    """Each filter type, gray and RGB, against a literal encoder."""
    for shape in [(9, 14), (9, 14, 3)]:
        # smooth ramps plus noise: predictions and wrap-around both occur
        img = (np.add.outer(np.arange(shape[0]) * 20,
                            np.arange(shape[1]) * 13)[..., None]
               + rng.integers(0, 40, size=shape[:2] + (1,)))
        img = (img % 256).astype(np.uint8)
        img = img[..., 0] if len(shape) == 2 else np.repeat(img, 3, -1)
        path = str(tmp_path / f"f{kind}.png")
        with open(path, "wb") as f:
            f.write(_encode(img, [kind]))
        np.testing.assert_array_equal(png.read_png(path), img)


def test_png_rejects_unsupported(tmp_path):
    path = str(tmp_path / "deep.png")
    data = _encode(np.zeros((2, 2), np.uint8), [0])
    # patch IHDR to 16-bit depth (and fix its CRC)
    ihdr = struct.pack(">IIBBBBB", 2, 2, 16, 0, 0, 0, 0)
    data = (data[:16] + ihdr + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
            + data[33:])
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)


def test_jpeg_without_pillow_names_the_format(tmp_path, monkeypatch):
    path = str(tmp_path / "photo.jpg")
    with open(path, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"\.jpg images needs Pillow"):
        png.read_image(path)
