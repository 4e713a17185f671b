"""Runtime setup helpers (compilation cache, mesh utilities entry point)."""

from __future__ import annotations

import hashlib
import os
import pathlib


def _host_fingerprint() -> str:
    """Short hash of the host CPU feature set.

    The repo (and its .cache/) moves between machines across rounds; XLA:CPU
    AOT executables compiled with one machine's features can SIGILL or
    miscompute on another (observed: `+prefer-no-gather` mismatch poisoning a
    cached executable). Keying the cache dir on the CPU flags isolates hosts.
    """
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha256(line.encode()).hexdigest()[:10]
    except OSError:
        pass
    return hashlib.sha256(os.uname().version.encode()).hexdigest()[:10]


def enable_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache.

    JAX_COMPILATION_CACHE_DIR, when set, names the directory and JAX reads
    it itself; no other directory is set in code. Otherwise the cache lives
    at a fixed in-checkout path (.cache/jax-<host CPU fingerprint>): the
    path is part of the cache key, so a directory that moved would never
    hit. Called by the CLI, bench and chip_smoke entry points (not on
    library import — libraries shouldn't mutate global config).
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache_dir = (pathlib.Path(__file__).resolve().parent.parent
                     / ".cache" / f"jax-{_host_fingerprint()}")
        cache_dir.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
