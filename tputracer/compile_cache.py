"""Persistent XLA compile cache for the entry points.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it
itself and nothing here overrides it.  Otherwise the cache lives at the
fixed ``<repo>/.jax_cache`` (git-ignored): the path is part of what makes
a later process find the cache again, so it never depends on the process,
the time or a temporary directory.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir(environ=None):
    """The cache directory the entry points use."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV) or DEFAULT_DIR


def enable():
    """Point JAX at the cache directory; returns it.  Call before the
    first compilation."""
    path = cache_dir()
    if not os.environ.get(ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
