"""Unit tests for distance / top-k / k-means / quantization ops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fabstir_vectordb_tpu.ops import (
    pairwise_sq_l2,
    pairwise_cosine_dist,
    pairwise_distance,
    masked_topk,
    merge_topk,
    chunked_topk,
    kmeans_train,
    assign_clusters,
)
from fabstir_vectordb_tpu.ops.quantization import (
    quantize_u8,
    dequantize_u8,
    pq_train,
    pq_encode,
    pq_decode,
    pq_adc_table,
    pq_adc_distances,
)


def test_sq_l2_matches_numpy(rng):
    q = rng.standard_normal((4, 32)).astype(np.float32)
    x = rng.standard_normal((50, 32)).astype(np.float32)
    got = np.asarray(pairwise_sq_l2(jnp.asarray(q), jnp.asarray(x)))
    want = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cosine_matches_numpy(rng):
    q = rng.standard_normal((3, 16)).astype(np.float32)
    x = rng.standard_normal((20, 16)).astype(np.float32)
    got = np.asarray(pairwise_cosine_dist(jnp.asarray(q), jnp.asarray(x)))
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    want = 1.0 - qn @ xn.T
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pairwise_distance_dot(rng):
    q = rng.standard_normal((2, 8)).astype(np.float32)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    got = np.asarray(pairwise_distance(jnp.asarray(q), jnp.asarray(x), metric="dot"))
    np.testing.assert_allclose(got, -(q @ x.T), rtol=1e-5, atol=1e-5)


def test_masked_topk_respects_mask(rng):
    d = jnp.asarray([[3.0, 1.0, 2.0, 0.5]])
    mask = jnp.asarray([True, True, False, False])
    vals, idx = masked_topk(d, mask, 3)
    assert idx[0, 0] == 1 and idx[0, 1] == 0
    assert idx[0, 2] == -1 and not np.isfinite(vals[0, 2])


def test_merge_topk(rng):
    va = jnp.asarray([[1.0, 5.0]])
    ia = jnp.asarray([[10, 11]], dtype=jnp.int32)
    vb = jnp.asarray([[0.5, 3.0]])
    ib = jnp.asarray([[20, 21]], dtype=jnp.int32)
    v, i = merge_topk(va, ia, vb, ib, 3)
    assert list(np.asarray(i[0])) == [20, 10, 21]
    np.testing.assert_allclose(np.asarray(v[0]), [0.5, 1.0, 3.0])


def test_chunked_topk_equals_full_scan(rng):
    n, d, b, k = 96, 16, 2, 5
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    q = jnp.asarray(rng.standard_normal((b, d)).astype(np.float32))
    full = np.asarray(pairwise_sq_l2(q, x))
    want = np.sort(full, axis=1)[:, :k]

    chunk = 32

    def dist_fn(start):
        xs = jax.lax.dynamic_slice_in_dim(x, start, chunk, axis=0)
        return pairwise_sq_l2(q, xs), jnp.ones((chunk,), bool)

    vals, idx = chunked_topk(dist_fn, n, chunk, k, b)()
    np.testing.assert_allclose(np.asarray(vals), want, rtol=1e-4, atol=1e-4)


def test_kmeans_separates_clear_clusters(rng):
    centers = np.array([[0, 0], [10, 10], [-10, 10]], np.float32)
    pts = np.concatenate(
        [c + 0.1 * rng.standard_normal((30, 2)).astype(np.float32) for c in centers]
    )
    mask = jnp.ones((pts.shape[0],), bool)
    res = kmeans_train(jax.random.PRNGKey(0), jnp.asarray(pts), mask, n_clusters=3)
    assert bool(res.converged)
    assign, _ = assign_clusters(jnp.asarray(pts), res.centroids, mask)
    a = np.asarray(assign)
    # Each ground-truth blob maps to exactly one cluster.
    groups = [set(a[i * 30:(i + 1) * 30]) for i in range(3)]
    assert all(len(g) == 1 for g in groups)
    assert len(set().union(*groups)) == 3


def test_kmeans_masks_padding(rng):
    pts = np.concatenate(
        [
            np.zeros((20, 4), np.float32),
            np.ones((20, 4), np.float32) * 5,
            np.full((24, 4), 1e6, np.float32),  # padding rows, masked out
        ]
    )
    mask = jnp.asarray([True] * 40 + [False] * 24)
    res = kmeans_train(jax.random.PRNGKey(1), jnp.asarray(pts), mask, n_clusters=2)
    c = np.asarray(res.centroids)
    assert np.abs(c).max() < 10.0  # padding never leaked into centroids


def test_u8_roundtrip(rng):
    x = rng.standard_normal((8, 64)).astype(np.float32)
    codes, mins, scales = quantize_u8(jnp.asarray(x))
    back = np.asarray(dequantize_u8(codes, mins, scales))
    assert np.abs(back - x).max() < (x.max() - x.min()) / 255.0 + 1e-5


def test_pq_roundtrip_and_adc(rng):
    n, d = 200, 32
    x = rng.standard_normal((n, d)).astype(np.float32)
    cb = pq_train(jax.random.PRNGKey(0), x, n_subspaces=4, n_codes=16)
    codes = pq_encode(cb.centroids, jnp.asarray(x))
    decoded = np.asarray(pq_decode(cb.centroids, codes))
    # Reconstruction error should be well below data variance.
    mse = np.mean((decoded - x) ** 2)
    assert mse < np.var(x) * 0.9

    q = jnp.asarray(rng.standard_normal((3, d)).astype(np.float32))
    table = pq_adc_table(cb.centroids, q)
    adc = np.asarray(pq_adc_distances(table, codes))
    exact_to_decoded = ((np.asarray(q)[:, None, :] - decoded[None]) ** 2).sum(-1)
    np.testing.assert_allclose(adc, exact_to_decoded, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("k", [8, 200, 256])
def test_masked_topk_pool_respects_mask(rng, k):
    """Candidate pools (link ef=200, stage-1 and turbo widths) are exact
    selections over the unmasked rows, with -1 / inf past the live ones."""
    from fabstir_vectordb_tpu.ops.topk import masked_topk

    d = rng.standard_normal((4, 512)).astype(np.float32) ** 2
    mask = np.ones(512, bool)
    mask[:256] = False
    vals, idx = masked_topk(jnp.asarray(d), jnp.asarray(mask), k)
    vals, idx = np.asarray(vals), np.asarray(idx)
    live = min(k, 256)
    assert (idx[:, :live] >= 256).all() and (idx[:, live:] == -1).all()
    assert np.isinf(vals[:, live:]).all()
    want = np.sort(np.where(mask, d, np.inf), axis=1)[:, :live]
    np.testing.assert_array_equal(vals[:, :live], want)


def test_grow_rows_preserves_prefix(rng):
    from fabstir_vectordb_tpu.utils.padding import grow_rows

    a = rng.standard_normal((10, 4)).astype(np.float32)
    g = grow_rows(a, 64)
    assert g.shape == (64, 4)
    np.testing.assert_array_equal(g[:10], a)
    assert (g[10:] == 0).all()

    b = np.arange(6, dtype=np.int32)
    g2 = grow_rows(b, 16, fill=-1)
    np.testing.assert_array_equal(g2[:6], b)
    assert (g2[6:] == -1).all()


def test_effective_flat_threshold_dtype_aware(monkeypatch):
    """bf16 halves bytes/row, so the flat-plan capacity bound doubles; an
    explicit env override is taken as already adjusted."""
    from fabstir_vectordb_tpu.utils import limits

    monkeypatch.delenv("FVDB_FLAT_THRESHOLD", raising=False)
    monkeypatch.delenv("FVDB_SERVING_DTYPE", raising=False)
    base = limits.FLAT_THRESHOLD
    assert limits.effective_flat_threshold() == base
    assert limits.effective_flat_threshold("bfloat16") == 2 * base
    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    assert limits.effective_flat_threshold() == 2 * base
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "12345")
    assert limits.effective_flat_threshold("bfloat16") == base  # env pins


def test_hbm_budget_from_host_memory_on_cpu(monkeypatch):
    """The CPU backend reports no memory stats: the budget is the share of
    host memory; the env override wins over either source."""
    import os

    from fabstir_vectordb_tpu.utils import limits

    monkeypatch.delenv("FVDB_HBM_BUDGET_GB", raising=False)
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert jax.devices()[0].memory_stats() is None
    assert limits.hbm_budget_bytes() == int(host * limits.HBM_BUDGET_FRACTION)
    assert limits.HBM_BUDGET_FRACTION == 0.75
    monkeypatch.setenv("FVDB_HBM_BUDGET_GB", "1.5")
    assert limits.hbm_budget_bytes() == int(1.5 * (1 << 30))


def test_hbm_budget_refuses_unknown_device(monkeypatch):
    """A non-CPU device without memory stats is an error, not a guess."""
    from fabstir_vectordb_tpu.utils import limits

    class Dev:
        platform = "gpu"
        device_kind = "mystery"

        def memory_stats(self):
            return None

    monkeypatch.delenv("FVDB_HBM_BUDGET_GB", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    with pytest.raises(RuntimeError):
        limits.hbm_budget_bytes()


@pytest.mark.gpu
def test_hbm_budget_from_device_limit_on_gpu(gpu, monkeypatch):
    from fabstir_vectordb_tpu.utils import limits

    monkeypatch.delenv("FVDB_HBM_BUDGET_GB", raising=False)
    want = int(gpu.memory_stats()["bytes_limit"] * limits.HBM_BUDGET_FRACTION)
    assert limits.hbm_budget_bytes() == want


def test_serving_knob_parsing(monkeypatch):
    """Env-knob semantics: auto rank sentinel, var clamping, beam expand
    and oversample floors."""
    from fabstir_vectordb_tpu.utils import limits

    for var in ("FVDB_PCA_RANK", "FVDB_PCA_VAR", "FVDB_PCA_OVERSAMPLE",
                "FVDB_BEAM_EXPAND", "FVDB_PCA_SERVE"):
        monkeypatch.delenv(var, raising=False)
    assert limits.pca_rank() == -1          # auto by default
    assert limits.pca_var() == 0.9
    assert limits.pca_oversample() is None  # auto: calibrated at build
    assert limits.beam_expand() == 4
    assert limits.pca_serve() is True
    assert limits.pca_rerank_mode() == "auto"
    assert limits.pca_target() == 0.99

    monkeypatch.setenv("FVDB_PCA_RANK", "64")
    assert limits.pca_rank() == 64
    monkeypatch.setenv("FVDB_PCA_RANK", "2")
    assert limits.pca_rank() == 8           # floor
    monkeypatch.setenv("FVDB_PCA_VAR", "0.1")
    assert limits.pca_var() == 0.5          # clamp low
    monkeypatch.setenv("FVDB_PCA_VAR", "1.5")
    assert limits.pca_var() == 0.999        # clamp high
    monkeypatch.setenv("FVDB_PCA_OVERSAMPLE", "1")
    assert limits.pca_oversample() == 2     # floor
    monkeypatch.setenv("FVDB_BEAM_EXPAND", "0")
    assert limits.beam_expand() == 1        # floor
    monkeypatch.setenv("FVDB_PCA_SERVE", "0")
    assert limits.pca_serve() is False


def test_angular_and_ip_to_cosine_corrections():
    """Reference vector_ops parity: inner_product_to_cosine handles zero
    norms; angular_distance = arccos(clamped cosine) with exact values for
    parallel / orthogonal / antiparallel pairs."""
    import jax.numpy as jnp

    from fabstir_vectordb_tpu.ops.distance import (
        angular_distance, inner_product_to_cosine)

    a = jnp.asarray([1.0, 0.0])
    assert float(angular_distance(a, jnp.asarray([2.0, 0.0]))) == pytest.approx(0.0, abs=1e-6)
    assert float(angular_distance(a, jnp.asarray([0.0, 3.0]))) == pytest.approx(np.pi / 2, abs=1e-6)
    assert float(angular_distance(a, jnp.asarray([-1.0, 0.0]))) == pytest.approx(np.pi, abs=1e-6)
    # zero-norm vector -> cosine 0 (not NaN), angular pi/2
    z = jnp.asarray([0.0, 0.0])
    assert float(inner_product_to_cosine(jnp.asarray(0.0), a, z)) == 0.0
    assert float(angular_distance(a, z)) == pytest.approx(np.pi / 2, abs=1e-6)
    assert not np.isnan(float(angular_distance(z, z)))
