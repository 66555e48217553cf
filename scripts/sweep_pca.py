"""Reduced-rank serving knob sweep: recall/latency vs rank x oversample.

Builds one corpus, then for each (FVDB_PCA_RANK, FVDB_PCA_OVERSAMPLE)
point rebuilds the projection mirror and measures recall@10, p50 and
batched QPS through the full serving path (threshold forced to 0 so the
reduced-rank regime always serves). It emits one markdown table.

Usage: python scripts/sweep_pca.py --n 1000000 [--ranks 96 192] [--ovs 8 32]
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("FVDB_SERVING_DTYPE", "bfloat16")

import argparse
import json
import time

import numpy as np

NOW = 1_700_000_000.0
DAY = 86_400.0


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--ranks", type=int, nargs="+", default=[96, 192])
    ap.add_argument("--ovs", type=int, nargs="+", default=[8, 32])
    args = ap.parse_args()

    import jax

    from fabstir_vectordb_tpu.index import (
        HybridConfig, HybridIndex, IVFConfig, SearchConfig)
    from fabstir_vectordb_tpu.utils import limits
    from fabstir_vectordb_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    log(f"devices: {jax.devices()}")

    rng = np.random.default_rng(0)
    n, dim, k = args.n, args.dim, 10
    centers = rng.standard_normal((1024, dim)).astype(np.float32)
    vecs = centers[rng.integers(0, 1024, n)]
    for lo in range(0, n, 1_000_000):
        hi = min(lo + 1_000_000, n)
        vecs[lo:hi] += 0.35 * rng.standard_normal((hi - lo, dim)).astype(np.float32)

    idx = HybridIndex(dim, HybridConfig(
        ivf=IVFConfig(n_clusters=256, n_probe=16, train_size=10_000, seed=0),
        auto_migrate=False))
    idx.initialize(vecs[:10_000])
    ts = np.full(n, NOW - 30 * DAY)
    ts[: n // 50] = NOW - DAY
    t0 = time.perf_counter()
    idx.insert_batch([f"v{i}" for i in range(n)], vecs, ts, now=NOW)
    log(f"build: {time.perf_counter()-t0:.0f}s")

    qi = rng.integers(0, n, args.queries)
    queries = vecs[qi] + 0.1 * rng.standard_normal(
        (args.queries, dim)).astype(np.float32)
    # exact ground truth, chunked f32 host
    truth = np.empty((args.queries, k), np.int64)
    q_sq = (queries ** 2).sum(1)
    best_d = np.full((args.queries, k), np.inf)
    best_i = np.full((args.queries, k), -1, np.int64)
    for lo in range(0, n, 262_144):
        x = vecs[lo: lo + 262_144]
        d = q_sq[:, None] - 2.0 * queries @ x.T + (x ** 2).sum(1)[None, :]
        cat_d = np.concatenate([best_d, d], axis=1)
        cat_i = np.concatenate(
            [best_i, np.arange(lo, lo + x.shape[0])[None, :].repeat(
                args.queries, 0)], axis=1)
        order = np.argsort(cat_d, axis=1)[:, :k]
        best_d = np.take_along_axis(cat_d, order, axis=1)
        best_i = np.take_along_axis(cat_i, order, axis=1)
    truth = best_i
    del vecs
    log("ground truth done")

    os.environ["FVDB_FLAT_THRESHOLD"] = "0"
    limits.FLAT_THRESHOLD = 0
    cfg = SearchConfig(auto_migrate=False)
    import jax

    print(f"## reduced-rank sweep, {n//1_000_000}M x {dim} (bf16, "
          f"{jax.devices()[0].device_kind})\n")
    print("| rank | oversample | recall@10 | p50 ms | QPS b=128 |")
    print("|---|---|---|---|---|")
    for rank in args.ranks:
        os.environ["FVDB_PCA_RANK"] = str(rank)
        idx.fused._release_proj()
        idx.fused._key = None
        for ov in args.ovs:
            os.environ["FVDB_PCA_OVERSAMPLE"] = str(ov)
            idx.search_rows(queries[0], k, config=cfg, now=NOW)  # compile
            lats, hits = [], 0
            for i in range(args.queries):
                t0 = time.perf_counter()
                _, rows = idx.search_rows(queries[i], k, config=cfg, now=NOW)
                lats.append((time.perf_counter() - t0) * 1e3)
                hits += len(set(rows[0][rows[0] >= 0]) & set(truth[i]))
            rec = hits / (args.queries * k)
            lats.sort()
            p50 = lats[len(lats) // 2]
            bq = np.repeat(queries, max(1, 128 // args.queries + 1),
                           axis=0)[:128]
            idx.search_rows(bq, k, config=cfg, now=NOW)
            t0 = time.perf_counter()
            for _ in range(5):
                idx.search_rows(bq, k, config=cfg, now=NOW)
            qps = 128 * 5 / (time.perf_counter() - t0)
            print(f"| {rank} | {ov} | {rec:.3f} | {p50:.1f} | {qps:,.0f} |",
                  flush=True)
            log(json.dumps({"rank": rank, "ov": ov,
                            "recall": round(rec, 4),
                            "p50_ms": round(p50, 2), "qps": round(qps, 1)}))


if __name__ == "__main__":
    main()
