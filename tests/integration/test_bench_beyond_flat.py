"""Miniature run of bench.bench_10m — the beyond-flat-residency artifact
path (direct device-assigned IVF state + reduced-rank serving + streamed
exact oracle). Guards the code that produces the headline scale metric
from rotting between (slow, accelerator-bound) bench runs."""
import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture()
def beyond_flat_env(monkeypatch, tmp_path):
    monkeypatch.setenv("FVDB_BENCH_10M_N", "60000")
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "32768")  # force reduced-rank
    # own cache prefix: never touch the real bench's /tmp/fvdb_bench10m
    monkeypatch.setenv("FVDB_BENCH_10M_CACHE", str(tmp_path / "corpus"))
    from fabstir_vectordb_tpu.utils import limits

    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 32768)
    yield


def test_bench_10m_path_recall(beyond_flat_env, capsys):
    import bench

    bench.bench_10m(32, 10, np.random.default_rng(0))
    out = capsys.readouterr().out
    import json

    metrics = {}
    for line in out.splitlines():
        if line.startswith("{"):
            m = json.loads(line)
            metrics[m["metric"]] = m["value"]
    rec_key = [k for k in metrics if k.startswith("scale_beyond_flat_recall")]
    assert rec_key, f"no recall metric in {list(metrics)}"
    assert metrics[rec_key[0]] >= 0.99
    assert any(k.startswith("scale_beyond_flat_qps") for k in metrics)
    assert any(k.startswith("scale_beyond_flat_p50") for k in metrics)
