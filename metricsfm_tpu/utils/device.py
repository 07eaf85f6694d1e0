"""The device a measurement runs on, and the refusal to measure anything else.

bench.py and chip_smoke.py measure an NVIDIA GPU.  Without one they stop
before printing any result, instead of falling back to the CPU.
"""
from __future__ import annotations

import subprocess


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every visible card, one
    line each.  A card set below its maximum power runs slower under load,
    so every number is reported beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def require_gpu(prog: str):
    """JAX's first device, or SystemExit unless it is an NVIDIA GPU."""
    import jax
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:            # no CUDA backend could start
        raise SystemExit(f"{prog}: JAX found no GPU ({e})")
    if dev.platform != "gpu":
        raise SystemExit(
            f"{prog}: needs an NVIDIA GPU, JAX's device is {dev.platform}")
    return dev
