"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""
import numpy as np
import pytest

import jax

from fabstir_vectordb_tpu.index import VectorStore, IVFIndex, IVFConfig, FlatIndex
from fabstir_vectordb_tpu.parallel import (
    cpu_mesh,
    sharded_flat_search,
    sharded_ivf_search,
    sharded_kmeans_train,
    shard_ivf_state,
)


@pytest.fixture(scope="module")
def mesh():
    return cpu_mesh(8)


def test_sharded_flat_matches_single_device(mesh, rng):
    n, d, b, k = 256, 16, 4, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[5] = False  # a deleted row

    fn = sharded_flat_search(mesh)
    vals, rows = fn(x, (x * x).sum(1), mask, q, k)
    vals, rows = np.asarray(vals), np.asarray(rows)

    dist = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    dist[:, 5] = np.inf
    want_rows = np.argsort(dist, axis=1)[:, :k]
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_allclose(
        vals, np.take_along_axis(dist, want_rows, 1), rtol=1e-3, atol=1e-3
    )


def test_sharded_flat_approx_select_matches_exact(mesh, rng):
    """Multi-chip twin of FVDB_FLAT_SELECT=approx: per-shard wide pool +
    local exact f32 refine must agree with the exact sharded search."""
    n, d, b, k = 256, 16, 4, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[5] = False
    mask[200:210] = False

    exact = sharded_flat_search(mesh)
    turbo = sharded_flat_search(mesh, select="approx", oversample=16)
    ev, er = exact(x, (x * x).sum(1), mask, q, k)
    tv, tr = turbo(x, (x * x).sum(1), mask, q, k)
    np.testing.assert_array_equal(np.asarray(er), np.asarray(tr))
    np.testing.assert_allclose(np.asarray(ev), np.asarray(tv),
                               rtol=1e-3, atol=1e-3)
    # masked rows must never surface
    assert not np.isin(np.asarray(tr), [5] + list(range(200, 210))).any()

    import pytest

    with pytest.raises(ValueError):
        sharded_flat_search(mesh, select="bogus")


def test_sharded_ivf_matches_host_ivf(mesh, rng):
    n, d, k = 400, 8, 5
    x = rng.standard_normal((n, d)).astype(np.float32) * 3
    store = VectorStore(d)
    rows = store.add_batch([f"v{i}" for i in range(n)], x)
    ivf = IVFIndex(store, IVFConfig(n_clusters=16, n_probe=16, seed=0))
    ivf.train(x)
    ivf.insert_rows(rows)
    store.mark_deleted("v17")

    state = shard_ivf_state(
        mesh, ivf.export_centroids(), ivf.tiles(), store.data,
        store.active_mask(),
    )
    fn = sharded_ivf_search(mesh)
    q = x[:6] + 0.01
    vals, out_rows = fn(state, q, k, 16)  # full probe -> exact among members
    out_rows = np.asarray(out_rows)

    _, host_rows = ivf.search_rows(q, k, n_probe=16)
    np.testing.assert_array_equal(out_rows, host_rows)
    assert 17 not in out_rows


def test_sharded_ivf_query_sharding(rng):
    mesh2 = None
    try:
        devs = jax.devices("cpu")[:8]
        mesh2 = jax.sharding.Mesh(np.array(devs).reshape(4, 2), ("list", "query"))
    except Exception:
        pytest.skip("cannot build 2D mesh")
    n, d, k = 200, 8, 3
    x = rng.standard_normal((n, d)).astype(np.float32)
    store = VectorStore(d)
    rows = store.add_batch([f"v{i}" for i in range(n)], x)
    ivf = IVFIndex(store, IVFConfig(n_clusters=8, n_probe=8, seed=0))
    ivf.train(x)
    ivf.insert_rows(rows)
    state = shard_ivf_state(
        mesh2, ivf.export_centroids(), ivf.tiles(), store.data,
        store.active_mask(), axis="list",
    )
    fn = sharded_ivf_search(mesh2, axis="list", query_axis="query")
    q = x[:4]  # batch divisible by query axis (2)
    vals, out_rows = fn(state, q, k, 8)
    assert np.asarray(out_rows)[0, 0] == 0


def test_sharded_kmeans_train(mesh, rng):
    centers = np.array([[0, 0, 0, 0], [8, 8, 8, 8], [-8, 8, -8, 8]], np.float32)
    pts = np.concatenate(
        [c + 0.2 * rng.standard_normal((50, 4)).astype(np.float32) for c in centers]
    )
    mask = np.ones(len(pts), bool)
    cents, info = sharded_kmeans_train(mesh, pts, mask, n_clusters=3, seed=1)
    assert info["converged"]
    # each true center recovered within noise
    for c in centers:
        d = np.linalg.norm(cents - c, axis=1).min()
        assert d < 0.5


def test_sharded_hnsw_matches_single_device(mesh, rng):
    from fabstir_vectordb_tpu.index import HNSWIndex
    from fabstir_vectordb_tpu.parallel import (
        shard_hnsw_state,
        sharded_hnsw_search,
    )

    n, d, k, ef = 300, 16, 8, 32
    x = rng.standard_normal((n, d)).astype(np.float32)
    store = VectorStore(d)
    rows = store.add_batch([f"v{i}" for i in range(n)], x)
    hnsw = HNSWIndex(store)
    hnsw.insert_rows(rows)
    store.mark_deleted("v7")

    state = shard_hnsw_state(mesh, hnsw)
    fn = sharded_hnsw_search(mesh)
    q = x[:16] + 0.01  # batch divisible by 8 devices
    vals, out_rows = fn(state, q, k, ef)
    out_rows = np.asarray(out_rows)

    _, host_rows = hnsw.search_rows(q, k, ef=ef)
    np.testing.assert_array_equal(out_rows, host_rows)
    assert 7 not in out_rows


def test_sharded_hybrid_search_merges_both_engines():
    """Multi-chip hybrid: query-sharded HNSW + list-sharded IVF + global
    merge must find the true nearest whether it lives in the recent graph
    or the historical lists."""
    import numpy as np

    from fabstir_vectordb_tpu.index import (
        HNSWIndex, IVFConfig, IVFIndex, VectorStore,
    )
    from fabstir_vectordb_tpu.parallel import (
        cpu_mesh, shard_hnsw_state, shard_ivf_state, sharded_hybrid_search,
    )

    mesh = cpu_mesh(8)
    rng = np.random.default_rng(0)
    dim, n = 32, 1024
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    store = VectorStore(dim)
    rows = store.add_batch([f"v{i}" for i in range(n)], vecs)

    recent = rows[: n // 4]           # graph tier
    historical = rows[n // 4:]        # list tier
    hnsw = HNSWIndex(store)
    hnsw.insert_rows(recent)
    ivf = IVFIndex(store, IVFConfig(n_clusters=16, n_probe=16, seed=0))
    ivf.train(vecs[n // 4:])
    ivf.insert_rows(historical)

    hmask = np.zeros(store.capacity, bool)
    hmask[recent] = True
    imask = np.zeros(store.capacity, bool)
    imask[historical] = True

    hstate = shard_hnsw_state(mesh, hnsw)
    istate = shard_ivf_state(
        mesh, ivf.export_centroids(), ivf.tiles(), store.data,
        store.active_mask() & imask,
    )
    search = sharded_hybrid_search(mesh)

    # 8 queries aimed at recent rows + 8 at historical rows
    targets = np.concatenate([rows[:8], rows[n // 4: n // 4 + 8]])
    q = store.data[targets] + 0.01
    d, r = search(hstate, istate, q, k=4, ef=32, n_probe=16)
    assert r.shape == (16, 4)
    assert (r[:, 0] == targets).all(), r[:, 0]
    # distances ascending and merged across engines
    assert (np.diff(np.where(np.isfinite(d), d, 1e30), axis=1) >= 0).all()


def test_sharded_projected_search_matches_single_chip(mesh, rng):
    """Row-sharded PCA stage-1 + host rerank == exact search (clustered
    data, generous oversample)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fabstir_vectordb_tpu.ops.projection import fit_pca, project
    from fabstir_vectordb_tpu.parallel.sharded import sharded_projected_search

    n, dim, rank, k = 2048, 32, 16, 5
    centers = rng.standard_normal((8, dim)).astype(np.float32)
    x = (centers[rng.integers(0, 8, n)]
         + 0.1 * rng.standard_normal((n, dim)).astype(np.float32))
    mu, p = fit_pca(x, rank)
    xp = project(x, mu, p)
    xp_sq = np.einsum("nr,nr->n", xp, xp)
    mask = np.ones(n, bool)

    shard = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    xp_d = jax.device_put(jnp.asarray(xp, jnp.bfloat16), shard)
    xp_sq_d = jax.device_put(jnp.asarray(xp_sq), shard)
    mask_d = jax.device_put(jnp.asarray(mask), shard)

    q = x[:16] + 0.01
    fn = sharded_projected_search(mesh)
    vals, rows = jax.device_get(fn(
        xp_d, xp_sq_d, mask_d,
        jax.device_put(jnp.asarray(mu), rep),
        jax.device_put(jnp.asarray(p), rep),
        jax.device_put(jnp.asarray(q), rep), 128,
    ))
    assert rows.shape == (16, 128)
    # host rerank of the stage-1 candidates -> exact top-k
    diff = x[np.maximum(rows, 0)] - q[:, None, :]
    d = np.einsum("bod,bod->bo", diff, diff)
    d = np.where(rows >= 0, d, np.inf)
    order = np.argsort(d, axis=1)[:, :k]
    got = np.take_along_axis(rows, order, axis=1)

    d_full = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(d_full, axis=1)[:, :k]
    hits = sum(len(set(got[i]) & set(truth[i])) for i in range(16))
    assert hits / (16 * k) >= 0.95


# --------------------------------------------------------------------------
# Shard-count-independent persistence (save on 8, load on 4 — VERDICT r2 #7)
# --------------------------------------------------------------------------


def test_sharded_flat_persistence_reshard(mesh, rng):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fabstir_vectordb_tpu.core.object_store import MemoryObjectStore
    from fabstir_vectordb_tpu.parallel import (
        load_sharded_flat,
        save_sharded_flat,
    )

    n, d, b, k = 512, 16, 4, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[33] = False
    shard = NamedSharding(mesh, P("data"))
    xd = jax.device_put(x, shard)
    sqd = jax.device_put((x * x).sum(1), shard)
    md = jax.device_put(mask, shard)

    store = MemoryObjectStore()
    save_sharded_flat(store, "mc/flat", xd, sqd, md)

    # the save wrote one blob per device shard
    assert len([k2 for k2 in store.list_keys("mc/flat/shards") ]) == 8

    vals8, rows8 = sharded_flat_search(mesh)(xd, sqd, md, q, k)

    for n_dev in (4, 2, 1):
        mesh_small = cpu_mesh(n_dev)
        x2, sq2, m2 = load_sharded_flat(store, "mc/flat", mesh_small)
        vals, rows = sharded_flat_search(mesh_small)(x2, sq2, m2, q, k)
        np.testing.assert_array_equal(np.asarray(rows), np.asarray(rows8))
        np.testing.assert_allclose(
            np.asarray(vals), np.asarray(vals8), rtol=1e-5, atol=1e-5)
    assert 33 not in np.asarray(rows8)


def test_sharded_flat_persistence_bf16_reshard(mesh, rng):
    """A bf16-resident sharded corpus round-trips (the manifest records
    dtype=bfloat16; numpy has no native bfloat16, so load must go through
    ml_dtypes)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fabstir_vectordb_tpu.core.object_store import MemoryObjectStore
    from fabstir_vectordb_tpu.parallel import (
        load_sharded_flat,
        save_sharded_flat,
    )

    n, d, b, k = 256, 16, 4, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = np.ones(n, bool)
    shard = NamedSharding(mesh, P("data"))
    xd = jax.device_put(jnp.asarray(x, jnp.bfloat16), shard)
    sqd = jax.device_put((x * x).sum(1), shard)
    md = jax.device_put(mask, shard)

    store = MemoryObjectStore()
    save_sharded_flat(store, "mc/bf16", xd, sqd, md)

    vals8, rows8 = sharded_flat_search(mesh)(xd, sqd, md, q, k)
    mesh_small = cpu_mesh(4)
    x2, sq2, m2 = load_sharded_flat(store, "mc/bf16", mesh_small)
    assert x2.dtype == jnp.bfloat16
    vals4, rows4 = sharded_flat_search(mesh_small)(x2, sq2, m2, q, k)
    np.testing.assert_array_equal(np.asarray(rows4), np.asarray(rows8))
    np.testing.assert_allclose(
        np.asarray(vals4), np.asarray(vals8), rtol=1e-2, atol=1e-2)


def test_sharded_ivf_persistence_reshard(mesh, rng):
    from fabstir_vectordb_tpu.core.object_store import MemoryObjectStore
    from fabstir_vectordb_tpu.parallel import (
        load_sharded_ivf,
        save_sharded_ivf,
    )

    n, d, k = 400, 8, 5
    x = rng.standard_normal((n, d)).astype(np.float32) * 3
    store = VectorStore(d)
    rows = store.add_batch([f"v{i}" for i in range(n)], x)
    ivf = IVFIndex(store, IVFConfig(n_clusters=12, n_probe=12, seed=0))
    ivf.train(x)
    ivf.insert_rows(rows)
    store.mark_deleted("v17")

    state8 = shard_ivf_state(
        mesh, ivf.export_centroids(), ivf.tiles(), store.data,
        store.active_mask(),
    )
    q = x[:6] + 0.01
    vals8, rows8 = sharded_ivf_search(mesh)(state8, q, k, 12)

    obj = MemoryObjectStore()
    save_sharded_ivf(obj, "mc/ivf", state8)

    for n_dev in (4, 2):
        mesh_small = cpu_mesh(n_dev)
        state = load_sharded_ivf(obj, "mc/ivf", mesh_small)
        assert state.n_clusters == 12
        vals, out_rows = sharded_ivf_search(mesh_small)(state, q, k, 12)
        np.testing.assert_array_equal(np.asarray(out_rows), np.asarray(rows8))
        np.testing.assert_allclose(
            np.asarray(vals), np.asarray(vals8), rtol=1e-5, atol=1e-5)
    assert 17 not in np.asarray(rows8)


def test_sharded_manifest_forward_version_rejected(mesh):
    import json

    from fabstir_vectordb_tpu.core.object_store import MemoryObjectStore
    from fabstir_vectordb_tpu.parallel import (
        ShardedPersistenceError,
        load_sharded_flat,
    )

    store = MemoryObjectStore()
    store.put("p/sharded_manifest.json", json.dumps(
        {"version": 99, "kind": "flat", "dim": 4, "n_rows": 8,
         "dtype": "float32", "shards": []}).encode())
    with pytest.raises(ShardedPersistenceError):
        load_sharded_flat(store, "p", mesh)


# --------------------------------------------------------------------------
# Scaling shape at 100K rows (virtual mesh; correctness + timing curve)
# --------------------------------------------------------------------------


def test_sharded_flat_scaling_100k(rng):
    """QPS/latency vs n_devices at 100K rows on the virtual CPU mesh.

    CPU simulation can't show real interconnect speedups (all 'devices' share one
    host), so the assertion is correctness at every mesh size; the timing
    curve is printed for the collective-overhead shape (run with -s).
    """
    import time

    from jax.sharding import NamedSharding, PartitionSpec as P

    n, d, b, k = 100_000, 64, 8, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    x_sq = (x * x).sum(1)
    mask = np.ones(n, bool)
    q = x[:b] + 0.01

    # oracle
    d_full = (
        (q * q).sum(1)[:, None] - 2.0 * q @ x.T + x_sq[None, :]
    )
    want_rows = np.argsort(d_full, axis=1, kind="stable")[:, :k]

    curve = []
    for n_dev in (1, 2, 4, 8):
        mesh = cpu_mesh(n_dev)
        shard = NamedSharding(mesh, P("data"))
        n_pad = ((n + n_dev - 1) // n_dev) * n_dev
        pad = n_pad - n
        xp = np.concatenate([x, np.zeros((pad, d), np.float32)]) if pad else x
        sqp = np.concatenate([x_sq, np.zeros(pad, np.float32)]) if pad else x_sq
        mp = np.concatenate([mask, np.zeros(pad, bool)]) if pad else mask
        xd = jax.device_put(xp, shard)
        sqd = jax.device_put(sqp, shard)
        md = jax.device_put(mp, shard)
        fn = sharded_flat_search(mesh)
        vals, rows = fn(xd, sqd, md, q, k)  # compile + first run
        rows = np.asarray(rows)
        np.testing.assert_array_equal(np.sort(rows), np.sort(want_rows))
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            vals, rows = fn(xd, sqd, md, q, k)
        jax.block_until_ready(vals)
        ms = (time.perf_counter() - t0) / reps * 1e3
        curve.append((n_dev, ms))
    print("\nsharded flat 100Kx64 warm latency (virtual CPU mesh): "
          + ", ".join(f"{nd}dev={ms:.1f}ms" for nd, ms in curve))


# --------------------------------------------------------------------------
# Mesh-parallel ingest (ShardedBuilder + sharded_assign_clusters)
# --------------------------------------------------------------------------


def _sharded_build(n_dev, vecs, seed=5, ef=32):
    from fabstir_vectordb_tpu.index import HNSWConfig, HNSWIndex, VectorStore
    from fabstir_vectordb_tpu.parallel import ShardedBuilder

    store = VectorStore(vecs.shape[1])
    rows = store.add_batch([f"v{i}" for i in range(len(vecs))], vecs)
    hnsw = HNSWIndex(store, HNSWConfig(
        seed=seed, ef_construction=ef, bootstrap_threshold=128))
    ShardedBuilder(hnsw, cpu_mesh(n_dev)).insert_rows(rows, sub_batch=256)
    return hnsw


def test_sharded_build_mesh_size_invariant(rng):
    """The mesh-parallel build produces the SAME graph at every mesh size:
    exact per-shard top-ef pools merge to the exact global pool (requires
    ef <= rows/device, which any real corpus satisfies), so adjacency is
    bit-identical across 1/2/8 devices."""
    vecs = rng.standard_normal((1024, 16)).astype(np.float32)
    ref = _sharded_build(1, vecs)
    for n_dev in (2, 8):
        got = _sharded_build(n_dev, vecs)
        assert got.entry_point == ref.entry_point
        assert got.max_level == ref.max_level
        np.testing.assert_array_equal(got.levels, ref.levels)
        np.testing.assert_array_equal(got.nbrs0, ref.nbrs0)
        np.testing.assert_array_equal(got.nbrs_up, ref.nbrs_up)


def test_sharded_build_recall(rng):
    """Graph built on the mesh serves with the same quality bar as the
    single-chip builder."""
    from fabstir_vectordb_tpu.index import FlatIndex
    from fabstir_vectordb_tpu.index.flat import recall_at_k

    vecs = rng.standard_normal((1024, 16)).astype(np.float32)
    hnsw = _sharded_build(8, vecs)
    q = vecs[:32] + 0.01 * rng.standard_normal((32, 16)).astype(np.float32)
    _, rows = hnsw.search_rows(q, 10, ef=64)
    rec = recall_at_k(FlatIndex(hnsw.store), rows, q, 10)
    assert rec >= 0.95


def test_sharded_assign_clusters_matches_host(rng):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fabstir_vectordb_tpu.parallel import sharded_assign_clusters

    mesh = cpu_mesh(8)
    n, d, c = 512, 16, 12
    x = rng.standard_normal((n, d)).astype(np.float32)
    cents = rng.standard_normal((c, d)).astype(np.float32)
    xd = jax.device_put(x, NamedSharding(mesh, P("data")))
    got = np.asarray(sharded_assign_clusters(mesh)(xd, cents))
    want = np.argmin(
        ((x[:, None, :] - cents[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(got, want)


def test_sharded_flat_2d_mesh_query_sharding(rng):
    """2D mesh for the flat regime: rows shard over one axis, queries over
    the other; results equal the 1D row-sharded search."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = jax.devices("cpu")[:8]
    mesh2 = Mesh(np.array(devs).reshape(4, 2), ("data", "query"))
    n, d, b, k = 512, 16, 4, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[9] = False
    x_sq = (x * x).sum(1)

    xd = jax.device_put(x, NamedSharding(mesh2, P("data")))
    sqd = jax.device_put(x_sq, NamedSharding(mesh2, P("data")))
    md = jax.device_put(mask, NamedSharding(mesh2, P("data")))
    qd = jax.device_put(q, NamedSharding(mesh2, P("query")))
    fn2 = sharded_flat_search(mesh2, query_axis="query")
    vals2, rows2 = fn2(xd, sqd, md, qd, k)

    ref = sharded_flat_search(cpu_mesh(8))(x, x_sq, mask, q, k)
    np.testing.assert_array_equal(np.asarray(rows2), np.asarray(ref[1]))
    np.testing.assert_allclose(np.asarray(vals2), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)
    assert 9 not in np.asarray(rows2)


def test_sharded_build_sees_rows_added_between_builds(rng):
    """A second insert_rows call after new add_batch()es (capacity
    unchanged) must re-upload the corpus — scanning the new rows' slots
    as the stale upload's zeros would link by distance-to-origin."""
    from fabstir_vectordb_tpu.index import HNSWConfig, HNSWIndex, VectorStore
    from fabstir_vectordb_tpu.parallel import ShardedBuilder

    dim = 16
    vecs = rng.standard_normal((1024, dim)).astype(np.float32)
    store = VectorStore(dim, initial_capacity=2048)
    rows1 = store.add_batch([f"a{i}" for i in range(768)], vecs[:768])
    hnsw = HNSWIndex(store, HNSWConfig(
        seed=5, ef_construction=32, bootstrap_threshold=128))
    builder = ShardedBuilder(hnsw, cpu_mesh(8))
    builder.insert_rows(rows1, sub_batch=256)

    rows2 = store.add_batch(
        [f"b{i}" for i in range(256)], vecs[768:])  # capacity unchanged
    assert store.capacity == 2048
    builder.insert_rows(rows2, sub_batch=256)

    # the new rows must be findable at their true locations
    q = vecs[768:784] + 0.001
    _, got = hnsw.search_rows(q, 1, ef=64)
    np.testing.assert_array_equal(got[:, 0], rows2[:16])


def test_sharded_assign_clusters_pads_uneven_rows(rng):
    from fabstir_vectordb_tpu.parallel import sharded_assign_clusters

    mesh = cpu_mesh(8)
    n, d, c = 509, 16, 7  # 509 % 8 != 0
    x = rng.standard_normal((n, d)).astype(np.float32)
    cents = rng.standard_normal((c, d)).astype(np.float32)
    got = np.asarray(sharded_assign_clusters(mesh)(x, cents))
    assert got.shape == (n,)
    want = np.argmin(((x[:, None, :] - cents[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(got, want)


def test_make_mesh_raises_when_devices_are_too_few():
    """No silent fallback: asking the backend for more devices than it has
    is an error (virtual CPU meshes come from cpu_mesh explicitly)."""
    from fabstir_vectordb_tpu.parallel import make_mesh

    have = len(jax.devices())
    with pytest.raises(ValueError):
        make_mesh(have + 1)
    assert make_mesh(have).devices.size == have
    assert make_mesh().devices.size == have
