"""JAX's persistent compilation cache, in one fixed place.

Every entry point (the CLI, the server, ``bench.py``, ``chip_smoke.py``)
calls :func:`enable` before its first compile. Where the environment sets
``JAX_COMPILATION_CACHE_DIR``, JAX already reads it and nothing else is
set here. Otherwise the cache lives at ``<repo>/.jax_cache`` (listed in
``.gitignore``): a fixed path, because the path is part of the cache key,
so a run in the same checkout finds the programs the last run compiled.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the repo's."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent cache at :func:`cache_dir`; returns it."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program that took a noticeable time to compile
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
