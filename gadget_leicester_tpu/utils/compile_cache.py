"""JAX persistent compilation cache location, one rule for every entry
point (CLI, bench.py, chip_smoke.py, tools): when JAX_COMPILATION_CACHE_DIR
is set, JAX reads it and nothing is set in code; otherwise the cache lives
in ``<checkout>/.jax_cache`` (listed in .gitignore)."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(checkout: str = CHECKOUT) -> str:
    """Point the persistent cache at its directory; returns that path.
    Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(checkout, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
