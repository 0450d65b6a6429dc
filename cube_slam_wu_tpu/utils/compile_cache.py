"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os
import pathlib

import jax

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Keep compiled executables across processes; returns the directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here.  Otherwise the cache lives at `<repo>/.jax_cache`, one
    fixed path (listed in .gitignore), so every run of the repository finds
    what an earlier run compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
