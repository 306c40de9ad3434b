"""Persistent XLA compilation cache wiring.

The reference binary compiles once at build time; here the analogous cost
is XLA's compile of each jitted join program.  Caching compiled
executables lets repeated process invocations — the grid scripts' usage
pattern (tput-scalability.sh runs the driver once per configuration) —
skip it, so the [RECORD] phase timings measure execution rather than
compilation.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and no other directory is configured in code), otherwise
the fixed ``<checkout>/.jax_cache`` — a fixed path, because the path is
part of the cache's key.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> None:
    """Point JAX at the persistent on-disk compilation cache.  CPU
    programs recompile in seconds and are not cached."""
    import jax

    if jax.default_backend() == "cpu":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
