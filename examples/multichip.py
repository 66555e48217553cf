#!/usr/bin/env python
"""Multi-chip walkthrough: sharded build, sharded serving, reshard load.

Beyond reference parity (the reference is a single-process system): this
example runs the full multi-chip lifecycle on a virtual 8-device CPU
mesh — the same code drives real multi-GPU hosts via `jax.sharding.Mesh`:

  1. mesh-parallel k-means training (data-parallel Lloyd, psum'd updates);
  2. mesh-parallel HNSW build (link-candidate scan row-sharded; the
     graph is bit-identical to any other mesh size);
  3. data-parallel IVF bulk assignment;
  4. row-sharded exact serving with an all-gather top-k merge;
  5. shard-count-independent persistence: save from 8 devices, reload
     onto 4, identical results.

Run from the repo root:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/multichip.py
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

_FLAG = "--xla_force_host_platform_device_count"
if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" {_FLAG}=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def main() -> None:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fabstir_vectordb_tpu.core.object_store import MemoryObjectStore
    from fabstir_vectordb_tpu.index import (
        HNSWConfig, HNSWIndex, IVFConfig, IVFIndex, VectorStore,
    )
    from fabstir_vectordb_tpu.parallel import (
        ShardedBuilder,
        cpu_mesh,
        load_sharded_flat,
        save_sharded_flat,
        sharded_assign_clusters,
        sharded_flat_search,
        sharded_kmeans_train,
    )

    mesh = cpu_mesh(8)
    print(f"mesh: {mesh.shape} over {len(jax.devices())} devices\n")

    rng = np.random.default_rng(0)
    n, dim, k = 4096, 64, 5
    centers = rng.standard_normal((32, dim)).astype(np.float32) * 3
    vecs = (centers[rng.integers(0, 32, n)]
            + 0.3 * rng.standard_normal((n, dim)).astype(np.float32))

    # 1. mesh-parallel k-means: every chip trains on its row shard,
    #    centroid updates psum over ICI
    cents, info = sharded_kmeans_train(
        mesh, vecs, np.ones(n, bool), n_clusters=32, seed=1)
    print(f"1. sharded k-means: {info['iterations']} iterations, "
          f"converged={info['converged']}, err={info['final_error']:.3f}")

    # 2. mesh-parallel HNSW build: the exact link-candidate scan runs
    #    row-sharded; the host links from the merged pool
    store = VectorStore(dim)
    rows = store.add_batch([f"v{i}" for i in range(n)], vecs)
    hnsw = HNSWIndex(store, HNSWConfig(
        seed=7, ef_construction=64, bootstrap_threshold=256))
    ShardedBuilder(hnsw, mesh).insert_rows(rows, sub_batch=512)
    print(f"2. sharded HNSW build: {hnsw.num_nodes} nodes, "
          f"entry row {hnsw.entry_point}")

    # 3. data-parallel IVF assignment (no collectives: rows ARE the axis)
    ivf = IVFIndex(store, IVFConfig(n_clusters=32, n_probe=8, seed=0))
    ivf.set_trained(cents)
    assign = np.asarray(sharded_assign_clusters(mesh)(vecs, cents))
    ivf._ensure_capacity()
    ivf.assignments[rows] = assign
    ivf._version += 1
    print(f"3. sharded IVF assignment: {len(np.unique(assign))} "
          "clusters populated")

    # 4. row-sharded exact serving: local top-k per chip, all-gather merge
    shard = NamedSharding(mesh, P("data"))
    cap = store.capacity
    x = np.zeros((cap, dim), np.float32)
    x[:n] = vecs
    mask = np.zeros(cap, bool)
    mask[:n] = True
    xd = jax.device_put(x, shard)
    sqd = jax.device_put(np.einsum("nd,nd->n", x, x), shard)
    md = jax.device_put(mask, shard)
    q = vecs[:4] + 0.01
    search8 = sharded_flat_search(mesh)
    vals, hits = search8(xd, sqd, md, q, k)
    hits = np.asarray(hits)
    assert (hits[:, 0] == np.arange(4)).all()
    print(f"4. sharded exact search: top-1 rows {hits[:, 0].tolist()} "
          "(self-hits, correct)")

    # 5. persistence: save per-device shard blobs, reload on HALF the mesh
    obj = MemoryObjectStore()
    save_sharded_flat(obj, "demo/flat", xd, sqd, md)
    half = cpu_mesh(4)
    x2, sq2, m2 = load_sharded_flat(obj, "demo/flat", half)
    vals4, hits4 = sharded_flat_search(half)(x2, sq2, m2, q, k)
    assert np.array_equal(np.asarray(hits4), hits)
    n_blobs = len(obj.list_keys("demo/flat/shards"))
    print(f"5. reshard: saved {n_blobs} shard blobs from 8 devices, "
          "reloaded on 4 — results identical")

    print("\nmultichip walkthrough OK")


if __name__ == "__main__":
    main()
