"""Device-side procedural corpus source (utils/synth.py).

The contract under test: a SyntheticCorpusSource regenerates, on ANY JAX
backend, exactly the rows its host_block() produced — so a serving mirror
built from it (fused._proj_state_locked device-source path) serves the
same corpus the host store holds, with zero bulk host->device transfer.
On the CPU test backend host and "device" generation coincide, so every
comparison here is exact; the cross-backend bf16 skew budget (0.23% of
elements by one ULP, accelerator vs CPU) is enforced by spot_check's
tolerance logic, which is also exercised here.
"""
import numpy as np
import pytest

from fabstir_vectordb_tpu.utils.synth import SyntheticCorpusSource

DIM = 32


def _src(block_rows=256, seed=7, dim=DIM, n_centers=16):
    return SyntheticCorpusSource(seed=seed, dim=dim, n_centers=n_centers,
                                 scale=0.35, block_rows=block_rows)


class TestGeneration:
    def test_deterministic_and_block_distinct(self):
        s1, s2 = _src(), _src()
        b0a = s1.host_block(0)
        b0b = s2.host_block(0)
        np.testing.assert_array_equal(b0a, b0b)
        b1 = s1.host_block(1)
        assert b0a.shape == b1.shape == (256, DIM)
        assert not np.array_equal(b0a, b1)

    def test_seed_changes_corpus(self):
        assert not np.array_equal(
            _src(seed=7).host_block(0), _src(seed=8).host_block(0))

    def test_tag_identity(self):
        assert _src().tag == _src().tag
        assert _src(seed=8).tag != _src(seed=7).tag
        assert _src(block_rows=128).tag != _src(block_rows=256).tag

    def test_device_matches_host_on_same_backend(self):
        s = _src()
        np.testing.assert_array_equal(
            np.asarray(s.device_block(3)), s.host_block(3))

    def test_clustered_statistics(self):
        # points sit near one of n_centers unit-Gaussian centers with 0.35
        # spread: per-point distance to ITS center ~ 0.35*sqrt(dim)
        s = _src(n_centers=4)
        import jax

        with jax.default_device(jax.devices("cpu")[0]):
            centers = np.asarray(s._centers())
        b = s.host_block(0)
        d = np.linalg.norm(b[:, None, :] - centers[None], axis=-1).min(1)
        assert abs(d.mean() - 0.35 * np.sqrt(DIM)) < 0.35 * np.sqrt(DIM) * 0.2


class TestMirror:
    def test_mirror_assembles_blocks_with_tail(self):
        import ml_dtypes

        s = _src(block_rows=256)
        n_rows = 256 * 2 + 100  # ragged tail block
        mirror = np.asarray(s.mirror_bf16(n_rows))
        want = np.concatenate(
            [s.host_block(0), s.host_block(1), s.host_block(2)[:100]]
        ).astype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(
            mirror.view(np.uint16), want.view(np.uint16))

    def test_spot_check_accepts_own_rows(self):
        s = _src()
        data = np.concatenate([s.host_block(0), s.host_block(1)])
        rows = np.array([0, 5, 255, 256, 400, 511])
        assert s.spot_check(data, rows)

    def test_spot_check_rejects_foreign_corpus(self):
        s = _src()
        data = np.concatenate([s.host_block(0), s.host_block(1)])
        data[300] += 0.5  # beyond any rounding skew
        assert not s.spot_check(data, np.array([1, 300]))

    def test_spot_check_tolerates_one_ulp_bf16_skew(self):
        # emulate the measured cross-backend erfinv skew: nudge a SMALL
        # fraction of elements by one bf16 ULP — must still pass
        import ml_dtypes

        s = _src()
        data = s.host_block(0).copy()
        bf = data.astype(ml_dtypes.bfloat16)
        u16 = bf.view(np.uint16).copy()
        idx = np.random.default_rng(0).integers(0, u16.size, u16.size // 200)
        flat = u16.reshape(-1)
        flat[idx] += 1  # one bf16 ULP
        data = flat.reshape(u16.shape).view(ml_dtypes.bfloat16).astype(
            np.float32)
        assert s.spot_check(data, np.arange(256))

    def test_spot_check_rejects_multi_ulp_near_miss(self):
        """A corpus whose elements sit a few bf16 ULPs off is a DIFFERENT
        corpus, not rounding skew — even if only a small fraction differ
        (ADVICE r4: the old 2% relative bound accepted ~5-ULP misses)."""
        import ml_dtypes

        s = _src()
        data = s.host_block(0).copy()
        bf = data.astype(ml_dtypes.bfloat16)
        u16 = bf.view(np.uint16).copy()
        flat = u16.reshape(-1)
        idx = np.random.default_rng(1).integers(0, flat.size,
                                                flat.size // 500)
        flat[idx] += 3  # three bf16 ULPs: within the old relative bound
        data = flat.reshape(u16.shape).view(ml_dtypes.bfloat16).astype(
            np.float32)
        assert not s.spot_check(data, np.arange(256))

    def test_spot_check_frac_budget_still_enforced(self):
        """One-ULP skew on MORE than ulp_frac of elements fails."""
        import ml_dtypes

        s = _src()
        data = s.host_block(0).copy()
        u16 = data.astype(ml_dtypes.bfloat16).view(np.uint16).copy()
        flat = u16.reshape(-1)
        idx = np.random.default_rng(2).integers(0, flat.size,
                                                flat.size // 10)
        flat[idx] += 1
        data = flat.reshape(u16.shape).view(ml_dtypes.bfloat16).astype(
            np.float32)
        assert not s.spot_check(data, np.arange(256), ulp_frac=0.02)


class TestAutoDetach:
    """Mutating row data or row count detaches an attached device source
    (ADVICE r4: a mutation after attach would silently serve stale
    synthetic rows from the next mirror rebuild)."""

    def _store_with_source(self):
        from fabstir_vectordb_tpu.index.store import VectorStore

        s = _src()
        store = VectorStore(DIM)
        blk = s.host_block(0)
        store.add_batch([f"v{i}" for i in range(blk.shape[0])], blk, 1.0)
        store.attach_device_source(s)
        assert store.device_source is not None
        return store, blk

    def test_add_batch_detaches(self):
        store, blk = self._store_with_source()
        store.add_batch(["new"], blk[:1], 1.0)
        assert store.device_source is None

    def test_fill_rows_detaches(self):
        store, blk = self._store_with_source()
        store.fill_rows(0, blk[:2] + 1.0)
        assert store.device_source is None

    def test_register_rows_detaches(self):
        store, _ = self._store_with_source()
        store.register_rows(["r1", "r2"], 1.0)
        assert store.device_source is None

    def test_vacuum_detaches_soft_delete_keeps(self):
        store, _ = self._store_with_source()
        store.mark_deleted("v3")
        assert store.device_source is not None  # masks, not row data
        store.vacuum()  # zeroes the row's data
        assert store.device_source is None


class TestFusedIntegration:
    """A reduced-rank device-rerank mirror built FROM the source serves
    identically to one uploaded from the host copy (the two paths in
    fused._proj_state_locked)."""

    @pytest.fixture()
    def built(self, monkeypatch):
        from fabstir_vectordb_tpu.index import (
            HybridConfig, HybridIndex, IVFConfig)
        from fabstir_vectordb_tpu.utils import limits

        monkeypatch.setattr(limits, "FLAT_THRESHOLD", 256)
        monkeypatch.setenv("FVDB_PCA_RANK", "16")
        monkeypatch.setenv("FVDB_PCA_OVERSAMPLE", "8")
        monkeypatch.setenv("FVDB_PCA_RERANK", "device")
        s = _src(block_rows=512)
        n = 1200
        blocks = [s.host_block(0), s.host_block(1), s.host_block(2)]
        vecs = np.concatenate(blocks)[:n]
        idx = HybridIndex(DIM, HybridConfig(
            ivf=IVFConfig(n_clusters=8, n_probe=4, seed=0),
            auto_migrate=False))
        idx.initialize(vecs[:512])
        idx.insert_batch([f"v{i}" for i in range(n)], vecs,
                         np.full(n, 1.0), now=2.0)
        return idx, vecs, s

    def test_device_source_serves_identically(self, built):
        from fabstir_vectordb_tpu.index import SearchConfig

        idx, vecs, s = built
        rng = np.random.default_rng(3)
        q = vecs[rng.integers(0, len(vecs), 16)] + 0.01 * rng.standard_normal(
            (16, DIM)).astype(np.float32)
        cfg = SearchConfig(auto_migrate=False)

        assert s.spot_check(idx.store.data, np.array([0, 600, 1199]))
        idx.store.attach_device_source(s)
        d_src, r_src = idx.search_rows(q, 5, config=cfg, now=2.0)
        assert idx.fused._proj is not None  # reduced-rank path was taken
        assert idx.fused._proj["rerank_x"] is not None  # device rerank

        # rebuild via the host-upload path and compare
        idx.store.attach_device_source(None)
        idx.fused._release_proj()
        d_up, r_up = idx.search_rows(q, 5, config=cfg, now=2.0)
        np.testing.assert_array_equal(r_src, r_up)
        np.testing.assert_allclose(d_src, d_up, rtol=1e-5, atol=1e-5)

        # and the results are correct: self-row comes back first
        probe = vecs[37]
        _, rows = idx.search_rows(probe, 3, config=cfg, now=2.0)
        assert rows[0, 0] == 37

    def test_host_rerank_projection_from_generated_blocks(
            self, built, monkeypatch):
        """Stage-2-on-host mode (the 20M+ regime where the full-dim mirror
        no longer fits HBM): the projection pass reads generation blocks
        from the source instead of uploading the corpus."""
        from fabstir_vectordb_tpu.index import SearchConfig

        monkeypatch.setenv("FVDB_PCA_RERANK", "host")
        idx, vecs, s = built
        rng = np.random.default_rng(4)
        q = vecs[rng.integers(0, len(vecs), 8)] + 0.01 * rng.standard_normal(
            (8, DIM)).astype(np.float32)
        cfg = SearchConfig(auto_migrate=False)

        idx.store.attach_device_source(s)
        d_src, r_src = idx.search_rows(q, 5, config=cfg, now=2.0)
        assert idx.fused._proj is not None
        assert idx.fused._proj["rerank_x"] is None  # host stage 2

        idx.store.attach_device_source(None)
        idx.fused._release_proj()
        d_up, r_up = idx.search_rows(q, 5, config=cfg, now=2.0)
        np.testing.assert_array_equal(r_src, r_up)
        np.testing.assert_allclose(d_src, d_up, rtol=1e-5, atol=1e-5)
