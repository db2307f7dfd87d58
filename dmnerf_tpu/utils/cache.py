"""Persistent XLA compilation cache.

The flagship train step takes about a minute to compile, and every driver
(train/test/bench/graft entry) compiles it again in a fresh process. Each driver
calls enable_persistent_cache() first, so a program compiles once per (shape,
backend) across processes.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this module
sets no directory of its own. Otherwise the cache lives at the fixed path
``<repo>/.jax_cache``: the path is part of the cache key, so it must not move.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache lands in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_persistent_cache() -> str:
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
