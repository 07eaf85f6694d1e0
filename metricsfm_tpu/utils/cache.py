"""Persistent XLA compilation cache setup.

The incremental pipeline is host-orchestrated jitted kernels; cold-start
compilation dominates small runs.  The reference has no counterpart — its
"compilation" is the C++ build.  Enabled by the CLI entry points, bench.py
and chip_smoke.py; library imports never touch global JAX config.
"""
from __future__ import annotations

import os

# one fixed directory inside the checkout (listed in .gitignore): the path
# is part of the cache key, so a directory that moves never hits
DEFAULT_CACHE_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", ".jax_cache"))


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and no
    other directory is set here; otherwise the cache lives at
    DEFAULT_CACHE_DIR.  Safe to call more than once."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
