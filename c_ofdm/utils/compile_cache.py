"""Persistent XLA compile cache shared by every entry point.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set: JAX reads it itself and
nothing is set here.  Otherwise the cache lives at a fixed ``.jax_cache``
directory in the repository root (listed in ``.gitignore``) — a fixed path,
so that later runs from the same checkout find what earlier ones cached.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compile cache for programs that take at least
    ``min_compile_secs`` to compile; returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
