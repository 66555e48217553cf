"""Serving-regime ladder integration: one index walked through all three
query plans (flat-exact -> reduced-rank -> pruned -> back to flat), checking
result consistency AND that each regime releases the others' device state
(their sum would not fit next to each other at scale — see index/fused.py)."""
import numpy as np
import pytest

from fabstir_vectordb_tpu.index import (
    FlatIndex, HybridConfig, HybridIndex, IVFConfig, SearchConfig)
from fabstir_vectordb_tpu.utils import limits

NOW = 1_700_000_000.0
DAY = 86_400.0


@pytest.fixture()
def ladder_index():
    rng = np.random.default_rng(11)
    dim, n = 32, 3000
    centers = rng.standard_normal((12, dim)).astype(np.float32)
    vecs = (centers[rng.integers(0, 12, n)]
            + 0.1 * rng.standard_normal((n, dim)).astype(np.float32))
    idx = HybridIndex(dim, HybridConfig(
        ivf=IVFConfig(n_clusters=12, n_probe=12, seed=0),
        auto_migrate=False))
    idx.initialize(vecs[:2000])
    ts = np.where(np.arange(n) % 3 == 0, NOW - DAY, NOW - 30 * DAY)
    idx.insert_batch([f"v{i}" for i in range(n)], vecs, ts, now=NOW)
    return idx, vecs


def _top1(idx, q):
    _, rows = idx.search_rows(q, 1, config=SearchConfig(auto_migrate=False),
                              now=NOW)
    return rows[:, 0]


def test_regime_ladder_consistency_and_state_release(ladder_index,
                                                     monkeypatch):
    idx, vecs = ladder_index
    q = vecs[::97] + 0.001
    expect = np.arange(vecs.shape[0])[::97]

    # flat-exact
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 10**9)
    monkeypatch.delenv("FVDB_FLAT_THRESHOLD", raising=False)
    assert (_top1(idx, q) == expect).all()
    assert idx.fused._dev is not None  # full state resident
    assert idx.fused._proj is None

    # reduced-rank (auto rank)
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 0)
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    assert (_top1(idx, q) == expect).mean() >= 0.95
    assert idx.fused._proj is not None
    assert idx.fused._dev is None, "full-dim state must be released"
    assert idx.fused.serving_info()["regime"] == "reduced-rank"

    # pruned
    monkeypatch.setenv("FVDB_PCA_SERVE", "0")
    assert (_top1(idx, q) == expect).mean() >= 0.9
    assert idx.fused._proj is None, "projection mirror must be released"
    assert idx.fused._dev is not None
    assert idx.fused.serving_info()["regime"] == "pruned"

    # back to flat-exact: exact again, projection still released
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 10**9)
    monkeypatch.delenv("FVDB_FLAT_THRESHOLD", raising=False)
    monkeypatch.delenv("FVDB_PCA_SERVE", raising=False)
    assert (_top1(idx, q) == expect).all()
    assert idx.fused._proj is None

    # sanity: flat == oracle
    oracle = FlatIndex(idx.store)
    _, orows = oracle.search_rows(q, 1)
    np.testing.assert_array_equal(_top1(idx, q), orows[:, 0])


def test_mutations_invalidate_every_regime(ladder_index, monkeypatch):
    """A post-switch insert must be visible in whichever regime serves."""
    idx, vecs = ladder_index
    new = (vecs[0] + 0.0005).astype(np.float32)

    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 0)
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    idx.search_rows(vecs[:1], 1, config=SearchConfig(auto_migrate=False),
                    now=NOW)  # build projection state
    idx.insert("fresh", new, timestamp=NOW - DAY, now=NOW)
    _, rows = idx.search_rows(new, 1, config=SearchConfig(auto_migrate=False),
                              now=NOW)
    assert idx.store.id_of(int(rows[0, 0])) == "fresh"

    monkeypatch.setenv("FVDB_PCA_SERVE", "0")
    idx.insert("fresh2", (vecs[1] + 0.0005).astype(np.float32),
               timestamp=NOW - DAY, now=NOW)
    _, rows = idx.search_rows(vecs[1] + 0.0005, 1,
                              config=SearchConfig(auto_migrate=False), now=NOW)
    assert idx.store.id_of(int(rows[0, 0])) == "fresh2"


def test_pinned_knobs_skip_calibration_pass(ladder_index, monkeypatch):
    """Restart fast path: FVDB_PCA_RANK + FVDB_PCA_OVERSAMPLE pinned (from
    a prior calibration's serving_info) must skip the probe-oracle corpus
    pass — observable as pca_calibrated_recall == None — while still
    serving at the pinned operating point's recall."""
    idx, vecs = ladder_index
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 0)
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    monkeypatch.setenv("FVDB_PCA_RANK", "16")
    monkeypatch.setenv("FVDB_PCA_OVERSAMPLE", "16")

    calls = []
    orig = idx.fused._build_proj_mirror

    def spy(data, n_rows, mu_d, p_d, members_np, probe_rows, oracle_rows,
            **kw):
        calls.append(len(probe_rows))
        return orig(data, n_rows, mu_d, p_d, members_np, probe_rows,
                    oracle_rows, **kw)

    monkeypatch.setattr(idx.fused, "_build_proj_mirror", spy)
    q = vecs[::97] + 0.001
    expect = np.arange(vecs.shape[0])[::97]
    got = _top1(idx, q)
    assert (got == expect).mean() >= 0.9
    info = idx.fused.serving_info()
    assert info["pca_calibrated_recall"] is None
    assert info["pca_rank"] == 16 and info["pca_oversample"] == 16
    assert calls == [0], "probe-oracle pass must be skipped when pinned"


def test_stage1_query_chunking_matches_unchunked(ladder_index, monkeypatch):
    """The stage-1 [B, N] transient cap splits query batches into
    power-of-two sub-batches at scale (10.5M rows force B<=64). CI can't
    hold a >1G-element matrix, so shrink FVDB_STAGE1_TRANSIENT_GB until
    the chunked branch runs at 3K rows and assert it returns exactly the
    unchunked results."""
    idx, vecs = ladder_index
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 0)
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    q = (vecs[::53] + 0.001).astype(np.float32)  # B=57 -> pads past b_sub
    cfg = SearchConfig(auto_migrate=False)

    _, rows_full = idx.search_rows(q, 5, config=cfg, now=NOW)

    # n_rows ~3K f32 -> one query row is ~12KB; cap the transient at 64KB
    # so b_sub lands at 4 and the batch splits into many chunks
    monkeypatch.setenv("FVDB_STAGE1_TRANSIENT_GB", str(65536 / (1 << 30)))
    assert limits.stage1_transient_bytes() == 65536
    _, rows_chunked = idx.search_rows(q, 5, config=cfg, now=NOW)

    np.testing.assert_array_equal(rows_full, rows_chunked)


def test_bf16_flat_rerank_restores_exact_ranking(monkeypatch):
    """VERDICT r2 #3: under FVDB_SERVING_DTYPE=bfloat16 the flat regime
    must rank near-ties exactly (f32 rerank of oversampled candidates).
    A near-duplicate cloud makes the raw mixed-precision bf16 scan
    misrank; the fused rerank must return the exact top-k with respect to
    the stored rows."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    dim, n, k = 64, 4096, 10
    base = rng.standard_normal(dim).astype(np.float32) * 2
    vecs = (base[None, :]
            + 0.3 * rng.standard_normal((n, dim)).astype(np.float32))
    idx = HybridIndex(dim, HybridConfig(auto_migrate=False))
    idx.initialize(vecs[:100])
    idx.insert_batch([f"v{i}" for i in range(n)], vecs,
                     np.full(n, NOW - DAY), now=NOW)

    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")

    q = base[None, :].astype(np.float32)
    # oracle: exact f32 distances to the bf16-STORED rows (what the device
    # actually holds) — rerank is exact w.r.t. these
    stored = vecs.astype(ml_dtypes.bfloat16).astype(np.float32)
    d_exact = ((q[:, None, :] - stored[None]) ** 2).sum(-1)[0]
    want = set(np.argsort(d_exact, kind="stable")[:k].tolist())

    monkeypatch.setenv("FVDB_BF16_REFINE", "0")  # device-only rerank here
    monkeypatch.setenv("FVDB_BF16_RERANK", "0")
    _, rows_raw = idx.search_rows(
        q, k, config=SearchConfig(auto_migrate=False), now=NOW)
    raw_hits = len(want & set(int(r) for r in rows_raw[0])) / k

    idx.fused._key = None  # drop cached device state between regimes
    monkeypatch.setenv("FVDB_BF16_RERANK", "1")
    _, rows_rr = idx.search_rows(
        q, k, config=SearchConfig(auto_migrate=False), now=NOW)
    rr_hits = len(want & set(int(r) for r in rows_rr[0])) / k

    assert rr_hits == 1.0, f"rerank recall {rr_hits} (raw was {raw_hits})"
    # the raw scan must actually have been broken on this corpus, or the
    # test proves nothing
    assert raw_hits < 1.0, "near-tie corpus no longer trips the raw scan"


def test_bf16_host_refine_exact_vs_canonical_f32(monkeypatch):
    """With FVDB_BF16_REFINE (default on) the bf16 flat regime re-scores
    the device-cut survivors from the canonical f32 host rows: top-k and
    distances must match the exact f32 oracle exactly — the storage-
    rounding recall gap (measured 0.987 at 5M device-only) closes."""
    rng = np.random.default_rng(4)
    dim, n, k = 64, 4096, 10
    base = rng.standard_normal(dim).astype(np.float32) * 2
    vecs = (base[None, :]
            + 0.3 * rng.standard_normal((n, dim)).astype(np.float32))
    idx = HybridIndex(dim, HybridConfig(auto_migrate=False))
    idx.initialize(vecs[:100])
    idx.insert_batch([f"v{i}" for i in range(n)], vecs,
                     np.full(n, NOW - DAY), now=NOW)

    monkeypatch.setenv("FVDB_SERVING_DTYPE", "bfloat16")
    monkeypatch.setenv("FVDB_BF16_RERANK", "1")
    monkeypatch.setenv("FVDB_BF16_REFINE", "1")

    q = (base[None, :] + 0.01).astype(np.float32)
    d_exact = ((q[:, None, :] - vecs[None]) ** 2).sum(-1)[0]
    order = np.argsort(d_exact, kind="stable")[:k]

    d_got, rows_got = idx.search_rows(
        q, k, config=SearchConfig(auto_migrate=False), now=NOW)
    np.testing.assert_array_equal(rows_got[0], order)
    # scores are exact f32 distances to the canonical rows (search_rows
    # returns true euclidean)
    np.testing.assert_allclose(
        d_got[0], np.sqrt(d_exact[order]), rtol=1e-6, atol=1e-6)


def test_reduced_rank_calibration_and_rerank_modes(monkeypatch):
    """VERDICT r2 #4: the reduced-rank regime must pick its own operating
    point — measured probe recall >= FVDB_PCA_TARGET — and serve stage-2
    on device when the HBM budget allows, with host rerank giving the
    same results."""
    rng = np.random.default_rng(7)
    dim, n, k = 48, 4000, 10
    centers = rng.standard_normal((16, dim)).astype(np.float32)
    vecs = (centers[rng.integers(0, 16, n)]
            + 0.25 * rng.standard_normal((n, dim)).astype(np.float32))
    idx = HybridIndex(dim, HybridConfig(
        ivf=IVFConfig(n_clusters=16, n_probe=16, seed=0),
        auto_migrate=False))
    idx.initialize(vecs[:2000])
    idx.insert_batch([f"v{i}" for i in range(n)], vecs,
                     np.full(n, NOW - 30 * DAY), now=NOW)

    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 0)
    monkeypatch.setenv("FVDB_FLAT_THRESHOLD", "0")
    monkeypatch.delenv("FVDB_PCA_OVERSAMPLE", raising=False)
    monkeypatch.delenv("FVDB_PCA_RANK", raising=False)

    q = vecs[rng.integers(0, n, 32)] + 0.02

    # device rerank (default auto fits at this size)
    monkeypatch.setenv("FVDB_PCA_RERANK", "device")
    _, rows_dev = idx.search_rows(
        q, k, config=SearchConfig(auto_migrate=False), now=NOW)
    info = idx.fused.serving_info()
    assert info["regime"] == "reduced-rank"
    assert info["pca_rerank"] == "device"
    assert info["pca_calibrated_recall"] >= limits.pca_target() - 0.05
    assert isinstance(info["pca_oversample"], int)

    # host rerank on the same state
    idx.fused._release_proj()
    monkeypatch.setenv("FVDB_PCA_RERANK", "host")
    _, rows_host = idx.search_rows(
        q, k, config=SearchConfig(auto_migrate=False), now=NOW)
    assert idx.fused.serving_info()["pca_rerank"] == "host"

    # both modes must reach the oracle recall target
    oracle = FlatIndex(idx.store)
    from fabstir_vectordb_tpu.index.flat import recall_at_k
    r_dev = recall_at_k(oracle, rows_dev, q, k)
    r_host = recall_at_k(oracle, rows_host, q, k)
    assert r_dev >= 0.95, f"device-rerank recall {r_dev}"
    assert r_host >= 0.95, f"host-rerank recall {r_host}"


def test_flat_approx_select_matches_exact(ladder_index, monkeypatch):
    """FVDB_FLAT_SELECT=approx: the turbo flat path (wide exact pool +
    fused exact f32 refine) must agree with the exact kernel."""
    idx, vecs = ladder_index
    q = vecs[::37] + 0.002
    k = 8
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 10**9)
    monkeypatch.delenv("FVDB_FLAT_THRESHOLD", raising=False)

    cfg = SearchConfig(auto_migrate=False)
    d_ex, r_ex = idx.search_rows(q, k, config=cfg, now=NOW)

    monkeypatch.setenv("FVDB_FLAT_SELECT", "approx")
    d_ap, r_ap = idx.search_rows(q, k, config=cfg, now=NOW)
    np.testing.assert_array_equal(r_ex, r_ap)
    # distances: exact kernel uses the matmul form (x_sq - 2qx + q_sq), the
    # refine the cancellation-safe difference form — tiny float drift on
    # near-zero distances is expected (and the refine is the more accurate)
    np.testing.assert_allclose(d_ex, d_ap, atol=2e-3)


def test_flat_approx_select_respects_masks(ladder_index, monkeypatch):
    """Deleted rows and filter bitmasks must not re-enter through the
    refine's re-scoring (the pool kernel masks BEFORE selection)."""
    idx, vecs = ladder_index
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 10**9)
    monkeypatch.delenv("FVDB_FLAT_THRESHOLD", raising=False)
    monkeypatch.setenv("FVDB_FLAT_SELECT", "approx")
    cfg = SearchConfig(auto_migrate=False)

    q = vecs[5:6] + 0.001
    # row 5 is the nearest neighbor of q; delete it
    assert idx.delete("v5")
    _, rows = idx.search_rows(q, 4, config=cfg, now=NOW)
    assert 5 not in rows[0]

    # extra filter mask: only even rows may surface
    mask = np.zeros(idx.store.capacity, bool)
    mask[np.arange(0, vecs.shape[0], 2)] = True
    _, rows = idx.search_rows(q, 8, config=cfg, extra_mask=mask, now=NOW)
    got = rows[0][rows[0] >= 0]
    assert got.size and (got % 2 == 0).all()


def test_flat_select_env_validation(monkeypatch):
    monkeypatch.setenv("FVDB_FLAT_SELECT", "bogus")
    with pytest.raises(ValueError):
        limits.flat_select()
    monkeypatch.setenv("FVDB_FLAT_OVERSAMPLE", "2")
    assert limits.flat_oversample() == 16  # floor


def test_serving_info_reports_flat_select(ladder_index, monkeypatch):
    idx, _ = ladder_index
    monkeypatch.setattr(limits, "FLAT_THRESHOLD", 10**9)
    monkeypatch.delenv("FVDB_FLAT_THRESHOLD", raising=False)
    info = idx.fused.serving_info()
    assert info["regime"] == "flat-exact"
    assert info["flat_select"] == "exact"
    assert "flat_oversample" not in info
    monkeypatch.setenv("FVDB_FLAT_SELECT", "approx")
    monkeypatch.setenv("FVDB_FLAT_OVERSAMPLE", "64")
    info = idx.fused.serving_info()
    assert info["flat_select"] == "approx"
    assert info["flat_oversample"] == 64
