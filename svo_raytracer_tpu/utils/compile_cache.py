"""JAX persistent compilation cache: one rule for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as is (JAX reads the
variable itself) and nothing else is configured.  Otherwise the cache
lives at the fixed path ``.jax_cache/`` in the checkout: a fixed path
keeps hitting across runs, where one built from a pid or a time never
would.
"""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    path = os.path.join(ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
