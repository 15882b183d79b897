"""Where the scripts keep JAX's persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set in code. Otherwise the cache lives in one fixed directory inside the
checkout (``.jax_cache``, listed in .gitignore): the path is part of the
cache key, so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DIRNAME = ".jax_cache"


def compile_cache_dir(root: str) -> str:
    """The cache directory for a checkout rooted at ``root``."""
    return os.environ.get(ENV) or os.path.join(os.path.abspath(root), DIRNAME)


def use_compile_cache(root: str) -> str:
    """Turn the persistent cache on for this process; returns its path."""
    import jax

    path = compile_cache_dir(root)
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
