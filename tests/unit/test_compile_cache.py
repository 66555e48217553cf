"""Persistent-compile-cache helper: which directory the cache lands in.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache verbatim. Otherwise
the cache sits at a fixed path inside the checkout; XLA:CPU cache entries
embed AOT host code, so on the CPU backend that path gets a stable
per-host suffix (a cache written on one machine must be invisible on
another, or the loader warns about SIGILL).
"""
import os

import jax
import pytest

from fabstir_vectordb_tpu.utils.compile_cache import (
    DEFAULT_DIR,
    ENV_VAR,
    _host_key,
    enable_persistent_cache,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def restore_suite_cache():
    """Put the suite-wide cache back (conftest's call) after each test."""
    yield
    saved = os.environ.pop(ENV_VAR, None)
    try:
        enable_persistent_cache(os.path.join(REPO, "tests", ".jax_cache"))
    finally:
        if saved is not None:
            os.environ[ENV_VAR] = saved


def test_host_key_stable_and_short():
    k1, k2 = _host_key(), _host_key()
    assert k1 == k2
    assert len(k1) == 8
    int(k1, 16)  # hex


def test_cpu_cache_dir_is_host_keyed(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    # tests always run on the CPU backend (conftest forces it)
    assert jax.default_backend() == "cpu"
    base = os.path.join(REPO, "tests", ".jax_cache-keyed")
    got = enable_persistent_cache(base)
    assert got == f"{base}-cpu-{_host_key()}"
    assert jax.config.jax_compilation_cache_dir == got


def test_env_dir_is_used_verbatim(monkeypatch):
    want = os.path.join(REPO, "tests", ".jax_cache-from-env")
    monkeypatch.setenv(ENV_VAR, want)
    assert enable_persistent_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    # an explicit path does not override the operator's variable
    assert enable_persistent_cache(os.path.join(REPO, "other")) == want
    assert jax.config.jax_compilation_cache_dir == want


def test_default_dir_points_into_repo(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    assert DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    got = enable_persistent_cache()
    assert got == f"{DEFAULT_DIR}-cpu-{_host_key()}"
    assert jax.config.jax_compilation_cache_dir == got
