"""Persistent XLA compile cache shared by the scripts and CLIs.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, that
directory is used and nothing here overrides it. Otherwise the cache goes
to ``<checkout>/.jax_cache`` (listed in .gitignore). The path is part of
the cache key, so it is fixed rather than temporary.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
