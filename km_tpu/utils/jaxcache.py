"""Persistent XLA compilation cache.

The walk and count programs are stable across runs; caching them on
disk removes their compile time from every later process. The cache
lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it
itself, and nothing here overrides it), otherwise at the fixed path
``<checkout>/.jax_cache`` (listed in .gitignore): the directory is part
of the cache key, so a path that moves never hits. Cross-process and
cross-entry-point hits are regression-tested in
tests/test_cache_crossprocess.py. Call enable() before the first jit
execution (bench.py and the CLI do).

The cache key is computed from the serialized MLIR module, which embeds
the SOURCE LOCATIONS of every traced frame — including the entry-point
script's path and line numbers. Left alone, that makes the key unstable
across entry points: the CLI, the bench driver, and every test file
would each recompile identical kernels. Canonicalizing source paths out
of the HLO and dropping full tracebacks from locations makes the key a
function of the computation alone, so one compile serves every caller."""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses (see module doc)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(REPO_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    # stabilize the cache key across entry points (see module doc)
    jax.config.update("jax_include_full_tracebacks_in_locations", False)
    jax.config.update("jax_hlo_source_file_canonicalization_regex", ".*")
