"""Profile where insert+build time goes at a given scale.

Times each phase of the ingest path separately: store.add_batch, IVF train,
IVF insert_rows (bulk assignment), HNSW insert_rows (candidates + linking),
and the first device-mirror upload. Run on the GPU to see device and
transfer costs; run with JAX_PLATFORMS=cpu for a host-only picture.

Usage: python scripts/profile_build.py --n 200000 --recent 10000
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from fabstir_vectordb_tpu.index.hybrid import HybridConfig, HybridIndex
from fabstir_vectordb_tpu.index.ivf import IVFConfig
from fabstir_vectordb_tpu.utils import limits

NOW = 1_700_000_000.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--recent", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--clusters", type=int, default=256)
    args = ap.parse_args()

    def mark(label, t0):
        dt = time.perf_counter() - t0
        print(f"{label:42s} {dt:8.1f}s", flush=True)
        return time.perf_counter()

    from fabstir_vectordb_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    rng = np.random.default_rng(0)
    t = time.perf_counter()
    centers = rng.standard_normal((args.clusters, args.dim), np.float32)
    vecs = (centers[rng.integers(0, args.clusters, args.n)]
            + 0.3 * rng.standard_normal((args.n, args.dim), np.float32))
    t = mark("data gen", t)

    n_recent = args.recent
    ts = np.full(args.n, NOW - 100_000.0)
    ts[:n_recent] = NOW - 10.0

    cfg = HybridConfig(
        recent_threshold_secs=86_400.0,
        ivf=IVFConfig(n_clusters=args.clusters),
    )
    idx = HybridIndex(args.dim, cfg)
    train = vecs[rng.choice(args.n, min(50_000, args.n), replace=False)]
    t = mark("train sample", t)
    idx.initialize(train)
    t = mark("IVF train", t)

    ids = [f"v{i}" for i in range(args.n)]
    t = mark("id strings", t)

    rows = idx.store.add_batch(ids, vecs, ts)
    t = mark("store.add_batch", t)

    recent_mask = (NOW - ts) < cfg.recent_threshold_secs
    idx.ivf.insert_rows(rows[~recent_mask])
    t = mark(f"ivf.insert_rows ({(~recent_mask).sum()})", t)

    # HNSW ingest, split into candidate-search vs host-linking time
    hrows = rows[recent_mask]
    hnsw = idx.hnsw
    hnsw._ensure_capacity()
    t_cand = t_link = 0.0
    pos = 0
    while pos < hrows.size:
        n_members = hnsw.num_nodes
        if n_members < hnsw.config.bootstrap_threshold:
            step = min(max(1, n_members) if n_members else 1,
                       hnsw.config.bootstrap_threshold)
        else:
            step = 1024
        batch = np.asarray(hrows[pos: pos + step], np.int64)
        levels_new = np.array(
            [hnsw._sample_level() for _ in batch], np.int32)
        if hnsw.num_nodes == 0:
            hnsw._install_node(int(batch[0]), int(levels_new[0]))
            hnsw.entry_point = int(batch[0])
            hnsw.max_level = int(levels_new[0])
            batch, levels_new = batch[1:], levels_new[1:]
        if batch.size:
            t0 = time.perf_counter()
            if hnsw.num_nodes <= hnsw.config.bootstrap_threshold:
                cands = hnsw._exact_candidates(batch)
            else:
                cands = hnsw._device_candidates(batch, levels_new)
            t_cand += time.perf_counter() - t0
            t0 = time.perf_counter()
            hnsw._link_batch(batch, levels_new, cands)
            t_link += time.perf_counter() - t0
        hnsw._version += 1
        pos += step
    print(f"{'  hnsw candidates':42s} {t_cand:8.1f}s", flush=True)
    print(f"{'  hnsw host linking':42s} {t_link:8.1f}s", flush=True)
    t = mark(f"hnsw.insert_rows ({recent_mask.sum()})", t)

    _ = idx.ivf.tiles()
    t = mark("ivf tiles", t)

    dev = idx.fused._device_state()
    dev["x"].block_until_ready()
    t = mark(f"device mirror upload ({limits.serving_dtype()})", t)

    q = vecs[:1]
    idx.search_rows(q, 10, now=NOW)
    t = mark("first search (compile)", t)


if __name__ == "__main__":
    main()
