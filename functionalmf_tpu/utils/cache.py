"""Persistent XLA compilation cache.

The constrained sweep compiles for tens of seconds at production shapes,
and every benchmark, app and example pays it again on each process start.
jax's persistent compilation cache is keyed on the HLO, so a second start
of the same program loads its executables instead of compiling them.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: jax reads it itself and this module
  sets no directory.
* otherwise: one fixed directory inside the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``). The path is part of what makes a later
  process find an earlier one's entries, so it is never built from a
  temporary name, a PID or a time.

Usage (bench/apps call this before the first compile)::

    from functionalmf_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
"""
from __future__ import annotations

import os

__all__ = ["enable_compilation_cache", "default_cache_dir"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """The fixed in-checkout cache directory: ``<repo>/.jax_cache``."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on jax's persistent compilation cache and lower its
    min-compile-time/entry-size gates so the many small sweep executables
    are cached too. Returns the directory in effect."""
    import jax
    cache_dir = os.environ.get(ENV_VAR)
    if not cache_dir:
        cache_dir = default_cache_dir()
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
