"""One persistent XLA compile cache for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and this
module sets nothing. Otherwise the cache lives in ``.jax_cache/`` at the
checkout root: a fixed path, because the path is part of the cache key.
"""
from __future__ import annotations

import os
import pathlib

import jax

CHECKOUT_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT_ROOT / ".jax_cache"


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at its one directory.

    Call before the first compile. Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
