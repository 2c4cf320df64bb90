"""Where JAX keeps its persistent compilation cache.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it. Otherwise the cache lives at one fixed path inside the
checkout (.jax_cache/, gitignored): the path is part of what a cache hit
needs, so it never depends on a pid, a time or a temporary directory.

CPU test processes use cpu_cache_dir(): a sub-directory of the same root,
keyed on the host CPU's feature set (XLA:CPU entries compiled on another
host can abort or SIGILL when loaded) and on the process's own name (two
processes writing one cache directory at once have crashed).
"""
from __future__ import annotations

import hashlib
import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    return os.environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX at compile_cache_dir() and return it."""
    path = compile_cache_dir()
    if not os.environ.get(ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def _host_key() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        import platform
        flags = platform.processor()
    return hashlib.sha1(flags.encode()).hexdigest()[:10]


def cpu_cache_dir(name: str) -> str:
    """compile_cache_dir()/cpu_<host key>_<name>, for one CPU process."""
    return os.path.join(compile_cache_dir(), f"cpu_{_host_key()}_{name}")
