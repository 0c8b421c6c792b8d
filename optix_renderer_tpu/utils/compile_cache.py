"""Persistent XLA compilation cache: the one rule every entry point follows.

If `JAX_COMPILATION_CACHE_DIR` is set, the cache lives there and no other
directory is set. Otherwise it lives in `<checkout>/.jax_cache`, a fixed
path: the directory is part of what makes a cached entry findable again, so
a path derived from a temporary name, a PID or the time would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache(min_compile_secs: float = 0.0) -> str | None:
    """Point JAX's persistent cache at `cache_dir()`; returns the directory,
    or None when it cannot be created (the run then goes without a cache)."""
    import jax

    path = cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
