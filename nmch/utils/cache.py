"""The persistent compilation cache, set up the same way by every entry
point (CLI, sweep, bench.py, chip_smoke.py, __graft_entry__.py).

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here overrides it.  Otherwise the cache lives at one fixed
path inside the checkout, ``<repo>/.jax_cache`` (git-ignored): the
directory is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
