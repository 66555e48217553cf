#!/usr/bin/env python
"""Lazy cold start: serve searches before the corpus is resident.

Saves a chunked index, then loads it with ``lazy=True``: the load returns
after fetching only the small sidecars (manifest, id map, timestamps, IVF
centroids, HNSW graph), the vector chunks stream in the background, and
the FIRST search is answered immediately by byte-range-reading only the
row spans its probe plan touches (the HNSW member span + the probed IVF
cluster spans — the save groups rows for exactly this locality).

Run from the repo root:  JAX_PLATFORMS=cpu python examples/lazy_cold_start.py
"""
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import numpy as np

from fabstir_vectordb_tpu.core.object_store import FileSystemObjectStore
from fabstir_vectordb_tpu.index import (
    HybridConfig, HybridIndex, IVFConfig, SearchConfig)
from fabstir_vectordb_tpu.storage.persistence import HybridPersister

DIM = 128
N = 50_000
NOW = time.time()
DAY = 86_400.0


def main() -> None:
    print("Lazy cold start walkthrough\n")
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)

    idx = HybridIndex(DIM, HybridConfig(
        ivf=IVFConfig(n_clusters=64, n_probe=8, seed=0),
        auto_migrate=False))
    idx.initialize(vecs[:10_000])
    ts = np.full(N, NOW - 30 * DAY)
    ts[:2_000] = NOW - DAY  # recent rows -> HNSW
    idx.insert_batch([f"v{i}" for i in range(N)], vecs, ts, now=NOW)

    root = tempfile.mkdtemp(prefix="fvdb_lazy_example_")
    store = FileSystemObjectStore(root)
    t0 = time.perf_counter()
    HybridPersister(store).save_index_chunked(idx, "demo")
    print(f"saved {N} x {DIM} chunked in {time.perf_counter()-t0:.2f}s")

    # ---- lazy load: returns after sidecars only ----
    t0 = time.perf_counter()
    loaded, manifest = HybridPersister(store).load_index_chunked(
        "demo", lazy=True)
    print(f"lazy load returned in {time.perf_counter()-t0:.2f}s "
          f"(ready={loaded.ready}, {manifest.num_chunks} chunks streaming)")

    # ---- first search: answered from ranged reads of the probe plan ----
    cfg = SearchConfig(auto_migrate=False)
    t0 = time.perf_counter()
    d, rows = loaded.search_rows(vecs[[30_000]], 5, config=cfg, now=NOW)
    dt = (time.perf_counter() - t0) * 1e3
    hit = loaded.store.id_of(int(rows[0, 0]))
    print(f"first search in {dt:.1f} ms -> top hit {hit} "
          f"(distance {d[0, 0]:.4f})")
    assert hit == "v30000" and d[0, 0] < 1e-3

    stats = loaded._cold.stats() if loaded._cold else {}
    if stats:
        frac = stats["bytes_fetched_on_demand"] / (N * DIM * 4)
        print(f"on-demand IO: {stats['rows_fetched_on_demand']:,} rows / "
              f"{stats['bytes_fetched_on_demand']/1e6:.1f} MB "
              f"({frac:.0%} of the corpus) via byte-range reads")

    # ---- background materialization completes; cold serving retires ----
    t0 = time.perf_counter()
    loaded.wait_ready(timeout=120)
    print(f"background materialize finished "
          f"{time.perf_counter()-t0:.2f}s later; warm from here on")
    d2, rows2 = loaded.search_rows(vecs[[30_000]], 5, config=cfg, now=NOW)
    assert int(rows2[0, 0]) == int(rows[0, 0])
    print("\nOK — warm search agrees with the cold answer")


if __name__ == "__main__":
    main()
