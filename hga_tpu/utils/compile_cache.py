"""Persistent XLA compilation cache (SURVEY.md §6 environment notes).

The in-memory jit cache dies with the process; JAX's persistent compilation
cache keeps compiled executables on disk so every pipeline stage (and every
re-run / resumed run) pays each program's compile once per machine.

Where the cache lives: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here.  Otherwise the cache is ``.jax_cache/`` at
the root of the checkout — a fixed path, since the path is part of what a
later run must find again.  Called by the CLI entry and the harnesses.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache (idempotent).  Returns its dir."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
