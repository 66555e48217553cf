"""Test configuration: an 8-device virtual CPU backend before JAX imports.

The suite runs on the CPU; multi-device sharding tests use XLA's
host-platform device virtualization (8 CPU devices). Tests marked ``gpu``
need the card and skip elsewhere through the ``gpu`` fixture; run them on
the card with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""
import os

# Must be set before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compilation cache: kernel shapes repeat across test files/processes.
# Routed through enable_persistent_cache so the directory is keyed by the host
# CPU's feature set — XLA:CPU entries embed host-AOT code, and loading one
# produced on a different machine risks SIGILL.
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from fabstir_vectordb_tpu.utils.compile_cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache(os.path.join(os.path.dirname(__file__), ".jax_cache"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, when the test runs, never while modules are imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


# ---------------------------------------------------------------------------
# Per-run skip inventory: env-gated skips are named so a silently-growing
# skip list can't rot unnoticed. Every run writes tests/TESTS_LATEST.json
# (git-ignored) with counts + each skip's location and reason.
# ---------------------------------------------------------------------------
_skips: list = []
_counts = {"passed": 0, "failed": 0, "skipped": 0}


def pytest_runtest_logreport(report):
    if report.when == "call" and report.passed:
        _counts["passed"] += 1
    elif report.failed:
        _counts["failed"] += 1
    elif report.skipped:
        _counts["skipped"] += 1
        reason = ""
        if isinstance(report.longrepr, tuple):
            reason = report.longrepr[2]
        _skips.append({"test": report.nodeid, "reason": reason})


def pytest_sessionfinish(session, exitstatus):
    import json

    out = {
        "exit_status": int(exitstatus),
        # scoped runs understate totals — the args record the scope
        "args": list(session.config.invocation_params.args),
        **_counts,
        "skips": _skips,
    }
    path = os.path.join(os.path.dirname(__file__), "TESTS_LATEST.json")
    try:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    except OSError:
        pass
