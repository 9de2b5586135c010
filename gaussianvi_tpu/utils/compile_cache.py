"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses it and nothing here sets
another directory.  Otherwise the cache goes to ``<repo>/.jax_cache`` (git
ignored), a fixed path, since the path is part of what makes a cache hit.
Called by the entry points (``chip_smoke.py``, ``bench.py``, the examples),
never on import.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX at its persistent compilation cache; returns the
    directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
