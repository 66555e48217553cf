"""Memory lifecycle profile: RSS at each stage of a session workload.

Parity with the reference's memory profiling scripts (reference:
scripts/monitor_memory.sh, scripts/profile_memory.sh and the measured
lifecycle in docs/PERFORMANCE_TUNING.md:404-409 — create ~12MB, load 64MB,
warm ~180MB, steady ~175MB at 100K x 384 with a 150MB cache).

Usage:
    JAX_PLATFORMS=cpu python scripts/profile_memory.py [n_vectors]
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def stage(name: str, t0: float) -> None:
    print(f"{name:28s} rss={rss_mb():8.1f} MB  t+{time.perf_counter()-t0:6.1f}s",
          flush=True)


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    dim = 384
    t0 = time.perf_counter()
    stage("interpreter", t0)

    from fabstir_vectordb_tpu.core import MemoryObjectStore
    from fabstir_vectordb_tpu.index import (
        HybridConfig,
        HybridIndex,
        IVFConfig,
        SearchConfig,
    )
    from fabstir_vectordb_tpu.storage.persistence import HybridPersister

    stage("imports", t0)

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    stage(f"data {n}x{dim}", t0)

    idx = HybridIndex(
        dim,
        HybridConfig(
            ivf=IVFConfig(n_clusters=64, n_probe=8, train_size=4096,
                          max_iterations=8, seed=0),
            auto_migrate=False,
        ),
    )
    idx.initialize(vecs[:4096])
    stage("create+train", t0)

    ts = np.full(n, 1.0)
    ts[:256] = 2e9  # tiny recent tier
    idx.insert_batch([f"v{i}" for i in range(n)], vecs, ts, now=2e9)
    stage("insert", t0)

    store = MemoryObjectStore()
    persister = HybridPersister(store)
    persister.save_index_chunked(idx, "mem")
    stage("save chunked", t0)

    del idx
    loaded, _ = persister.load_index_chunked("mem")
    stage("load chunked", t0)

    cfg = SearchConfig(auto_migrate=False)
    q = vecs[:8] + 0.001
    loaded.search_rows(q, 10, config=cfg, now=2e9)
    stage("first search (compile)", t0)

    for i in range(50):
        loaded.search_rows(vecs[i % n][None], 10, config=cfg, now=2e9)
    stage("steady state (50 queries)", t0)


if __name__ == "__main__":
    main()
