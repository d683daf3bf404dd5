"""Persistent XLA compilation cache for the app entry points.

The SLAM pipeline compiles one executable per distinct solver shape (the
windowed-BA capacity buckets, the final pose-graph BA, the LC verification
programs); the persistent cache lets a later process load them instead of
compiling again.

Where the cache lives: if JAX_COMPILATION_CACHE_DIR is set, JAX already
reads it and this module leaves JAX's setting alone. Otherwise the cache is
the fixed directory <repo>/.cache/jax (a fixed path, so entries are found
again from run to run). CVO_SLAM_COMPCACHE=0 turns it off.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_persistent_cache() -> bool:
    """Idempotent. Returns True if the cache is active."""
    import jax
    if os.environ.get("CVO_SLAM_COMPCACHE", "1") == "0":
        return False
    # JAX reads the variable when it is imported; it is applied here too
    # for a process that set it later
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".cache", "jax"))
    if jax.config.jax_compilation_cache_dir != path:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return True
