"""Persistent XLA compile cache location."""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at a fixed directory.

    `JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the
    cache lives in `<repo>/.jax_cache` (git-ignored).  The path is part
    of the cache key, so it is fixed, never a temporary name.  Returns
    the directory in use.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE
    jax.config.update("jax_compilation_cache_dir", path)
    return path
