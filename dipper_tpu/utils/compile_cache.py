"""Where JAX keeps its persistent compile cache."""

from __future__ import annotations

import os

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is changed here; otherwise the cache goes to <repo>/.jax_cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
