"""Persistence microbenchmarks over the in-memory mock store.

Parity with the reference's criterion suite (reference:
benches/chunked_search_bench.rs:157-345 — cold vs warm cache search,
chunk-load overhead, load-time vs dataset size, 1000-query cache hit
rate, all on MockS5Storage). CPU-safe:

    JAX_PLATFORMS=cpu python scripts/bench_persistence.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

NOW, DAY = 1_700_000_000.0, 86_400.0


def build(n, dim=64):
    from fabstir_vectordb_tpu.index import HybridConfig, HybridIndex, IVFConfig

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    idx = HybridIndex(dim, HybridConfig(
        ivf=IVFConfig(n_clusters=32, n_probe=8, train_size=2048,
                      max_iterations=6, seed=0),
        auto_migrate=False))
    idx.initialize(vecs[: min(n, 2048)])
    ts = np.full(n, NOW - 30 * DAY)
    ts[: max(n // 20, 1)] = NOW - DAY
    idx.insert_batch([f"v{i}" for i in range(n)], vecs, ts, now=NOW)
    return idx, vecs


def main() -> None:
    from fabstir_vectordb_tpu.core import MemoryObjectStore
    from fabstir_vectordb_tpu.index import SearchConfig
    from fabstir_vectordb_tpu.storage.chunk_loader import ChunkLoader
    from fabstir_vectordb_tpu.storage.persistence import HybridPersister

    cfg = SearchConfig(auto_migrate=False)

    # ---- load time vs dataset size (reference: 1K/5K/10K matrix) ----
    for n in (1_000, 5_000, 10_000):
        idx, vecs = build(n)
        store = MemoryObjectStore()
        p = HybridPersister(store)
        t0 = time.perf_counter()
        p.save_index_chunked(idx, "b", chunk_size=1_000)
        save_ms = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        loaded, _ = HybridPersister(store).load_index_chunked("b")
        load_ms = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        lazy, _ = HybridPersister(store).load_index_chunked("b", lazy=True)
        lazy_ms = (time.perf_counter() - t0) * 1000

        # cold vs warm search (first search pays jit + materialization)
        q = vecs[0][None] + 0.001
        t0 = time.perf_counter()
        lazy.search_rows(q, 10, config=cfg, now=NOW)
        cold_ms = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        for _ in range(20):
            loaded.search_rows(q, 10, config=cfg, now=NOW)
        warm_ms = (time.perf_counter() - t0) / 20 * 1000
        print(f"n={n:6d}  save {save_ms:7.1f} ms  load {load_ms:7.1f} ms  "
              f"lazy-load {lazy_ms:6.1f} ms  cold search {cold_ms:7.1f} ms  "
              f"warm {warm_ms:6.2f} ms", flush=True)

    # ---- chunk loader cache hit rate over 1000 fetches ----
    idx, vecs = build(10_000)
    store = MemoryObjectStore()
    p = HybridPersister(store)
    p.save_index_chunked(idx, "c", chunk_size=1_000)
    from fabstir_vectordb_tpu.core import ChunkCache
    loader = ChunkLoader(store, cache=ChunkCache(max_chunks=6))
    keys = [f"c/chunks/chunk-{i}.cbor" for i in range(10)]
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    for _ in range(1000):
        loader.load_chunk(keys[int(rng.integers(0, 10))])
    dt = time.perf_counter() - t0
    m = loader.cache.metrics
    print(f"1000 chunk fetches in {dt*1000:.1f} ms, hit_rate="
          f"{m.hit_rate:.3f} (hits={m.hits} misses={m.misses} "
          f"evictions={m.evictions})", flush=True)


if __name__ == "__main__":
    main()
