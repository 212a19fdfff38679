"""Where XLA's persistent compilation cache lives."""

from __future__ import annotations

import os
import pathlib

# A fixed directory at the repository root (listed in .gitignore): the
# cache key includes nothing of the path, but a directory that moves
# between runs never hits.
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
    it itself and this sets nothing; otherwise the cache goes to
    ``DEFAULT_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
