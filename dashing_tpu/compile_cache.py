"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, bench.py, benchmarks/):
JAX_COMPILATION_CACHE_DIR, when set, is used as it is — JAX reads it
itself and no other path is set in code.  Otherwise the cache is one
fixed directory inside the checkout, <repo>/.jax_cache (git-ignored).
The path is part of each entry's key, so it must not move between runs.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """The cache directory this process uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> None:
    """Turn the persistent cache on for this process (before compiling).
    A checkout where the default directory cannot be created runs without
    it."""
    import jax
    path = cache_dir()
    if path == DEFAULT_DIR:
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            return
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
