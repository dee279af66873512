"""Placement of JAX's persistent compilation cache.

The decoders unroll their Tanner graphs at trace time (one roll per edge for
the binary codes, one static slot loop per check degree for the NB codes), so
a cold compile of a full-size configuration takes much longer than one decode
call.  The entry points (``cli.main``, ``bench.py``, ``chip_smoke.py``) call
``enable_compile_cache`` so a second run of the same configuration reads the
compiled executables back instead of compiling again.

The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set, and otherwise
a fixed directory inside the checkout (``<repo>/.jax_cache``, ignored by git).
The path is part of what makes a cache hit possible, so it is never derived
from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os
import pathlib

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the persistent compilation cache lives in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``; returns it.
    Call before the first compile: JAX fixes the cache at that point."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
