"""Shared benchmark preamble: repo path, the CLI's compile-cache rule
(dashing_tpu/compile_cache.py) and its DASHING_TPU_PLATFORM override."""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def setup(default_platform: str = ""):
    import jax
    from dashing_tpu import compile_cache
    plat = os.environ.get("DASHING_TPU_PLATFORM", default_platform)
    if plat:
        jax.config.update("jax_platforms", plat)
    compile_cache.enable()
