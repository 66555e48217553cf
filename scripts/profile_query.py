"""Device-time profile of the fused hybrid query path at 100K x 384.

Builds (or loads from a filesystem cache) the bench-shaped index, then times
each sub-kernel — greedy descent, layer-0 beam, IVF nprobe scan, fused
hybrid — at several batch sizes, separating compile, host->device transfer,
and steady-state device time. Run alone on the card: a second JAX
process would find most of its memory already reserved.

Usage: python scripts/profile_query.py [--rebuild]
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CACHE = os.environ.get("FVDB_PROFILE_STORE", "/tmp/fvdb_profile_store")
N, DIM, NOW, DAY = 100_000, 384, 1_700_000_000.0, 86_400.0


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_or_load():
    from fabstir_vectordb_tpu.core.object_store import FileSystemObjectStore
    from fabstir_vectordb_tpu.index import (
        HybridConfig,
        HybridIndex,
        IVFConfig,
    )
    from fabstir_vectordb_tpu.storage.persistence import HybridPersister

    store = FileSystemObjectStore(CACHE)
    persister = HybridPersister(store)
    if "--rebuild" not in sys.argv and store.exists("profile/manifest.json"):
        t0 = time.perf_counter()
        idx = persister.load_index_chunked("profile")
        log(f"loaded cached index in {time.perf_counter()-t0:.1f}s")
        return idx

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((1024, DIM)).astype(np.float32)
    assign = rng.integers(0, 1024, N)
    vecs = centers[assign] + 0.35 * rng.standard_normal((N, DIM)).astype(
        np.float32
    )
    idx = HybridIndex(
        DIM,
        HybridConfig(
            ivf=IVFConfig(n_clusters=256, n_probe=16, train_size=10_000,
                          seed=0),
            auto_migrate=False,
        ),
    )
    t0 = time.perf_counter()
    idx.initialize(vecs[:10_000])
    log(f"trained in {time.perf_counter()-t0:.1f}s")
    ids = [f"v{i}" for i in range(N)]
    ts = np.full(N, NOW - 30 * DAY)
    ts[: N // 10] = NOW - DAY
    t0 = time.perf_counter()
    idx.insert_batch(ids, vecs, ts, now=NOW)
    log(f"built in {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    persister.save_index_chunked(idx, "profile")
    log(f"saved cache in {time.perf_counter()-t0:.1f}s")
    return idx


def timeit(fn, reps=20):
    fn()  # compile + warm
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps * 1000.0, out


def main():
    import jax
    import jax.numpy as jnp

    from fabstir_vectordb_tpu.index.fused import hybrid_search_kernel
    from fabstir_vectordb_tpu.index.hnsw import (
        beam_search_kernel,
        greedy_descent_kernel,
    )
    from fabstir_vectordb_tpu.index.ivf import ivf_search_kernel

    log(f"devices: {jax.devices()}")
    idx = build_or_load()
    fs = idx.fused  # FusedSearcher
    dev = fs._device_state()
    log(f"tiles shape: {dev['tiles'].shape}, capacity {dev['x'].shape}")

    rng = np.random.default_rng(1)
    k, ef, n_probe = 10, 64, 16

    for b in (1, 8, 32, 128):
        q_host = rng.standard_normal((b, DIM)).astype(np.float32)
        q = jax.device_put(jnp.asarray(q_host))
        jax.block_until_ready(q)

        def greedy():
            stop = jnp.zeros((b,), jnp.int32)
            cur, d = greedy_descent_kernel(
                dev["x"], dev["x_sq"], dev["hnsw_mask"], dev["nbrs_up"],
                dev["up_offset"], q, dev["entry"], dev["entry_level"], stop,
            )
            return jax.block_until_ready((cur, d))

        ms, (cur, _) = timeit(greedy)
        log(f"b={b:4d} greedy_descent     {ms:8.2f} ms")

        start = cur[:, None]
        act = jnp.ones((b,), bool)

        def beam():
            out = beam_search_kernel(
                dev["x"], dev["x_sq"], dev["hnsw_mask"], dev["nbrs0"],
                dev["nbrs_up"], dev["up_offset"], q, start, act,
                layer=0, ef=ef, max_iters=ef + 32,
            )
            return jax.block_until_ready(out)

        ms, _ = timeit(beam)
        log(f"b={b:4d} beam(ef={ef})        {ms:8.2f} ms")

        def ivf():
            out = ivf_search_kernel(
                dev["x"], dev["x_sq"], dev["ivf_mask"], dev["centroids"],
                dev["tiles"], q, k, n_probe,
            )
            return jax.block_until_ready(out)

        ms, _ = timeit(ivf)
        log(f"b={b:4d} ivf(n_probe={n_probe})    {ms:8.2f} ms")

        ones = dev["ones"]

        def fused():
            out = hybrid_search_kernel(
                dev["x"], dev["x_sq"], dev["hnsw_mask"], dev["ivf_mask"],
                ones, dev["nbrs0"], dev["nbrs_up"], dev["up_offset"],
                dev["entry"], dev["entry_level"], dev["centroids"],
                dev["tiles"], q, k, ef, n_probe, True, True, False,
            )
            return jax.block_until_ready(out)

        ms, _ = timeit(fused)
        log(f"b={b:4d} fused              {ms:8.2f} ms")

        def end_to_end():
            return idx.search_rows(q_host, k, now=NOW)

        ms, _ = timeit(end_to_end, reps=10)
        log(f"b={b:4d} end_to_end (host)  {ms:8.2f} ms")


if __name__ == "__main__":
    main()
