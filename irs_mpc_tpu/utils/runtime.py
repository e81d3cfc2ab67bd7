"""Process set-up shared by the entry scripts (chip_smoke.py, bench.py,
bench_scaling.py, examples/common.py)."""
from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache goes to ``<checkout>/.jax_cache``
    (listed in .gitignore): a fixed path, because the path is part of what
    makes a later process find the entries.  Returns the directory used.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
