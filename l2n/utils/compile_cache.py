"""Persistent XLA compilation cache.

The cache lives where `JAX_COMPILATION_CACHE_DIR` says when that is set,
and nowhere else; otherwise at the fixed `.jax_cache/` in the checkout (the
path is part of each entry's key, so a directory that moves never hits).
Entry points (chip_smoke.py, bench.py, the app, tests) opt in.

Must be called before the first JAX computation (backend init is fine).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                           "..", ".jax_cache"))


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
