"""Persistent XLA compilation cache.

Compiling the serving programs costs seconds per shape on every fresh
process; the persistent cache lets a restart or a second process of the
same checkout load them instead. Enabled by the benchmark, the smoke run,
the REST server binary and the driver entry points; tests use their own
cache under tests/.jax_cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and that
directory is the cache, unchanged. Otherwise the cache lives at a fixed
path inside the checkout (``DEFAULT_DIR``): the path is part of what makes
a later run find its entries, so it never depends on a temporary
directory, a process id or the time.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def _host_key() -> str:
    """Short fingerprint of the host CPU's feature set.

    XLA:CPU cache entries embed AOT-compiled host code; loading an entry
    produced on a machine with different ISA features (e.g. AMX/AVX-512
    variants) makes the loader warn about potential SIGILL. Keying the
    CPU cache directory by the host's feature flags makes stale
    cross-machine entries invisible instead of dangerous.
    """
    import hashlib
    import platform

    model = flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not model and ln.startswith("model name"):
                    model = ln
                elif not flags and ln.startswith("flags"):
                    flags = ln
                if model and flags:
                    break
    except OSError:
        pass
    # Flags alone are not enough: LLVM derives tuning features (e.g.
    # prefer-no-scatter) from the detected CPU *model*, so two hosts with
    # identical flag lines can still produce incompatible AOT code.
    raw = (model + flags) or platform.processor() or platform.machine() or "unknown"
    return hashlib.sha1(raw.encode()).hexdigest()[:8]


def enable_persistent_cache(path: str | None = None) -> str:
    """Idempotently point JAX's compilation cache at one directory and
    return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins over ``path`` and is used
    verbatim. Otherwise the cache is ``path`` (default ``DEFAULT_DIR``),
    with a host-keyed ``-cpu-<hash>`` suffix on the CPU backend only.
    """
    import jax

    cache_dir = os.environ.get(ENV_VAR)
    if not cache_dir:
        cache_dir = path or DEFAULT_DIR
        if jax.default_backend() == "cpu":
            cache_dir = f"{cache_dir}-cpu-{_host_key()}"
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
