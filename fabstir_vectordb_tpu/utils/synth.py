"""Deterministic device-side corpus source (procedural mirrors).

Problem this solves: installing a multi-GB serving mirror normally ships
the corpus through the host->device link once (``fused._proj_state_locked``
rerank-mirror upload). When the corpus is procedurally derivable — synthetic load tests, the
reference's own large-scale harness constructs state directly
(reference: tests/integration/large_dataset_tests.rs:41-130) — the mirror
can instead be REGENERATED on device: threefry is deterministic across
backends, so the same (seed, block) program run on the CPU backend fills
the host-canonical store while the accelerator assembles the bf16 serving
mirror, with zero bulk transfer. Equivalence: f32 values agree to float-op
ULPs; after the bf16 cast, some elements may differ by exactly one bf16
ULP (erfinv rounding) — below the storage-rounding noise the
serving path already absorbs (stage-2 host refine re-scores survivors from
the canonical f32 rows; calibration measures the end-to-end pipeline).

``VectorStore.attach_device_source`` registers a source; the fused
searcher's reduced-rank mirror build uses it instead of the host upload.
``spot_check`` guards the contract (host rows really are this source's
rows) before any serving state is built from it.
"""
from __future__ import annotations

import numpy as np

# Fixed generation-block height: determinism is tied to block boundaries,
# so host and device generation MUST use the same block size (it is part
# of the corpus identity, see ``tag``).
BLOCK_ROWS = 1 << 20


class SyntheticCorpusSource:
    """Clustered-Gaussian corpus, regenerable on any JAX backend.

    Row r of the corpus lives in block ``r // block_rows`` at offset
    ``r % block_rows``; block b draws from ``fold_in(key(seed), b)``:
    ``x = scale * N(0, I) + centers[randint(n_centers)]`` with centers
    drawn once from ``key(seed ^ 0x5EED)``. All draws are threefry
    (the JAX default PRNG, bit-deterministic across backends).
    """

    def __init__(self, seed: int, dim: int, n_centers: int = 4096,
                 scale: float = 0.35, block_rows: int = BLOCK_ROWS):
        self.seed = int(seed)
        self.dim = int(dim)
        self.n_centers = int(n_centers)
        self.scale = float(scale)
        self.block_rows = int(block_rows)
        self._centers_dev = None  # per-process device cache
        self._gen = None

    @property
    def tag(self) -> str:
        """Corpus identity string (cache validity marker: a disk-cached
        corpus is only reusable by a source with the SAME tag)."""
        return (f"synthv1-s{self.seed}-d{self.dim}-c{self.n_centers}"
                f"-sc{self.scale:g}-b{self.block_rows}")

    # ------------------------------------------------------------ generation
    def _gen_fn(self):
        if self._gen is not None:
            return self._gen
        import jax
        import jax.numpy as jnp

        dim, n_centers, scale = self.dim, self.n_centers, self.scale
        rows = self.block_rows

        def block(seed: int, blk_idx: int, centers):
            key = jax.random.fold_in(jax.random.key(seed), blk_idx)
            kz, ka = jax.random.split(key)
            z = jax.random.normal(kz, (rows, dim), jnp.float32)
            assign = jax.random.randint(ka, (rows,), 0, n_centers)
            return z * scale + centers[assign]

        self._gen = jax.jit(block, static_argnums=(0, 1))
        return self._gen

    def _centers(self):
        import jax
        import jax.numpy as jnp

        return jax.random.normal(
            jax.random.key(self.seed ^ 0x5EED),
            (self.n_centers, self.dim), jnp.float32)

    def device_block(self, blk_idx: int, dtype=None):
        """One [block_rows, dim] block on the DEFAULT device (f32, or cast
        to ``dtype``). Centers are generated once and cached device-side."""
        if self._centers_dev is None:
            self._centers_dev = self._centers()
        out = self._gen_fn()(self.seed, int(blk_idx), self._centers_dev)
        return out if dtype is None else out.astype(dtype)

    def host_block(self, blk_idx: int) -> np.ndarray:
        """The same block as float32 numpy, computed on the CPU backend
        (fills the host-canonical store without touching the accelerator)."""
        import jax

        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            c = self._centers()
            return np.asarray(self._gen_fn()(self.seed, int(blk_idx), c))

    # --------------------------------------------------------- mirror build
    def mirror_bf16(self, n_rows: int):
        """Assemble the [n_rows, dim] bf16 serving mirror ON DEVICE, block
        by block into a donated buffer (no corpus-sized host->device
        transfer, no whole-mirror copies per block). Rows past the last
        full block come from a sliced final block; rows past the caller's
        corpus count are synthetic padding — callers mask them out exactly
        as they do for zero padding (stage-1 member masks)."""
        import jax
        import jax.numpy as jnp

        from ..index.fused import _xp_write  # donated dynamic_update_slice
        from . import progress

        n_rows = int(n_rows)
        mirror = jnp.zeros((n_rows, self.dim), jnp.bfloat16)
        for lo in range(0, n_rows, self.block_rows):
            hi = min(lo + self.block_rows, n_rows)
            blk = self.device_block(lo // self.block_rows, jnp.bfloat16)
            if hi - lo < self.block_rows:
                blk = jax.lax.slice_in_dim(blk, 0, hi - lo, axis=0)
            mirror = _xp_write(mirror, blk, jnp.int32(lo))
            progress.mark()  # stall-watchdog heartbeat per block
        return mirror

    # ---------------------------------------------------------- verification
    def spot_check(self, data: np.ndarray, rows: np.ndarray,
                   ulp_frac: float = 0.02) -> bool:
        """True iff ``data[rows]`` matches this source at the given rows to
        within bf16 storage rounding (at most ``ulp_frac`` of elements off
        by one bf16 ULP — the measured cross-backend erfinv skew is 0.23%).
        Cheap (downloads only the probed rows); callers MUST gate
        ``attach_device_source`` on it so a stale or foreign corpus can
        never silently serve from a mismatched mirror."""
        import ml_dtypes

        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return True
        by_block: dict[int, list] = {}
        for r in rows:
            by_block.setdefault(int(r) // self.block_rows, []).append(int(r))
        bad = total = 0
        for blk_idx, rs in by_block.items():
            offs = np.asarray(rs) - blk_idx * self.block_rows
            got = np.asarray(self.device_block(blk_idx)[offs]).astype(
                ml_dtypes.bfloat16)
            want = data[np.asarray(rs)].astype(ml_dtypes.bfloat16)
            gu = got.view(np.uint16)
            wu = want.view(np.uint16)
            diff = gu != wu
            bad += int(diff.sum())
            total += int(diff.size)
            # any differing element must be EXACTLY one bf16 ULP away:
            # map the uint16 patterns to a total order over representable
            # values (negatives reflected below 0x8000; +0 and -0 both map
            # to 0x8000) and require adjacency there — anything further is
            # a different corpus, not cross-backend erfinv rounding
            if diff.any():
                def _code(u):
                    u = u.astype(np.int32)
                    return np.where(u & 0x8000,
                                    0x8000 - (u & 0x7FFF), 0x8000 + u)
                if (np.abs(_code(gu[diff]) - _code(wu[diff])) > 1).any():
                    return False
        return bad <= ulp_frac * max(total, 1)
