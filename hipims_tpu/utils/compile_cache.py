"""Placement of JAX's persistent compilation cache.

A cold run otherwise compiles every step program again.  The cache lives
where ``JAX_COMPILATION_CACHE_DIR`` says when it is set; otherwise at the
fixed path ``<checkout>/.jax_cache`` (gitignored).  The path is part of
the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``JAX_COMPILATION_CACHE_DIR`` if set, else at ``DEFAULT_DIR``, and
    return the directory.  Call before the first compilation of the
    process: JAX fixes the cache when it first compiles."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
