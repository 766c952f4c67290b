"""Persistent XLA compile cache, shared by every entry point of one checkout.

``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing else is touched. Otherwise
the cache lives at a fixed ``.jax_cache/`` beside the package (gitignored). The path
is part of what a later process looks up, so it is never derived from a temporary
name, a pid or the time: a directory that moves never hits.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it.

    Call before the first compilation: JAX settles on a cache (or none) once per
    process."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
