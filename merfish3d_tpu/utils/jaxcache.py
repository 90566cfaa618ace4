"""Persistent XLA compilation cache wiring.

The serialized executable is keyed on (program, platform, topology,
flags), so a second process loads what a first one compiled instead of
compiling again: the CPU test suite re-traces hundreds of programs per
pytest process, and a cold pipeline run on the GPU spends tens of seconds
in the compiler. The reference has no analog (CuPy plan caches are
in-memory only, `rlgc.py:39-70`).
"""

from __future__ import annotations

import os
from pathlib import Path

# `<repo>/.jax_cache`: a fixed path, since the path is part of the key
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    """Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set
    and not empty, else :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Point JAX at the on-disk compilation cache (idempotent) and cache
    every program, however quickly it compiled. Returns the directory."""
    import jax

    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    # tiny programs are exactly the ones the test suite re-traces
    # hundreds of times across processes
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return str(path)
