"""Persistent XLA compilation cache placement.

A cold compile of the Newton step takes minutes at production size, so
the CLI, the benchmark and the smoke check keep compiled executables
on disk. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself
and nothing is changed here; otherwise the cache lives in `.jax_cache`
at the root of the checkout (listed in `.gitignore`). A fixed path
matters: the cache directory is part of what a later process must
find again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. Call before the first compilation: JAX
    decides once per process whether the cache is in use."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
