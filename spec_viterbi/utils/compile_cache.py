"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives in ``<repo>/.jax_cache``
(git-ignored): a fixed path, because the path is part of what makes a
later run of the same checkout find its entries. ``chip_smoke.py``,
``bench.py`` and the compiling CLI subcommands call
:func:`enable_persistent_cache` once at start.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str:
    """Turn on JAX's on-disk compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(REPO_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
