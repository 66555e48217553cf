"""Fused hybrid search: the whole query path in ONE device program.

Serving-path optimization. Two regimes, picked by corpus size:

- **Device-resident (the common case, up to FLAT_THRESHOLD rows)**: one
  masked exact L2 top-k — a [B, D] x [D, N] matmul with the soft-delete /
  membership / metadata-filter bitmask fused into selection. Recall is
  exactly 1.0, and a scan that streams the corpus once per batch needs no
  pointer chasing; graph/IVF pruning is for corpora the device cannot
  hold.
- **Beyond the threshold**: HNSW greedy descent + layer-0 beam, IVF
  centroid ranking + nprobe list scan, global top-k merge — still one jit.
  (Past one device's memory, the sharded path in ``parallel/`` is the
  design; it is not wired into serving yet.)

Either way a query costs one dispatch + one small host->device transfer
(the query) + one [B, k] readback. Engine state (vectors, adjacency,
tiles, masks) stays device-resident between calls, keyed by engine
versions.

Distances returned are squared euclidean (callers sqrt at the boundary).
"""
from __future__ import annotations


import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.distance import pairwise_distance
from ..ops.topk import masked_topk, merge_topk
from ..utils.padding import fit_mask
from .hnsw import beam_search_kernel, greedy_descent_kernel
from .ivf import ivf_search_kernel

# Above limits.FLAT_THRESHOLD (padded) rows the exact flat scan is no longer
# the query plan on one device and a beyond-flat regime takes over. Read
# dynamically so tests and benchmarks can flip regimes at runtime.
from ..utils import limits  # noqa: E402


# FVDB_SERVING_DTYPE ("float32" | "bfloat16") — see utils.limits.serving_dtype.


@partial(jax.jit, static_argnames=("k",))
def flat_search_kernel(x, x_sq, mask, q, k: int):
    """Masked exact top-k: one distance matmul + fused top-k.

    With a bf16-resident corpus (FVDB_SERVING_DTYPE=bfloat16: half the
    device memory per row, double the capacity), the matmul runs in bf16
    with f32 accumulation; precomputed f32 x_sq keeps the norm term
    full-precision.
    """
    compute = jnp.bfloat16 if x.dtype == jnp.bfloat16 else jnp.float32
    d = pairwise_distance(q, x, x_sq=x_sq, compute_dtype=compute)
    return masked_topk(d, mask, k)


@partial(jax.jit, static_argnames=("ov_k",))
def stage1_select_kernel(xp, xp_sq, mask, qp, ov_k: int):
    """Reduced-rank stage 1: distances over the projected mirror + a WIDE
    candidate pool (after TPU-KNN, arXiv:2206.14286). The selection is a
    sort of each [B, N] distance row on the GPU: at [128, 10.5M] its
    compiled temporaries are 32 GB (H100 memory analysis), which is why
    ``_projected_dispatch`` splits query batches under
    ``stage1_transient_bytes``. The projection's recall slack is absorbed
    by the oversample calibration, which measures this exact kernel end
    to end and widens the pool until the target holds.
    """
    compute = jnp.bfloat16 if xp.dtype == jnp.bfloat16 else jnp.float32
    d = pairwise_distance(qp, xp, x_sq=xp_sq, compute_dtype=compute)
    return masked_topk(d, mask, ov_k)


@partial(jax.jit, static_argnames=("k",))
def rerank_f32_kernel(x, q, rows, k: int):
    """Gather candidate rows and re-score in full f32 (difference form).

    Restores ranking exactness for bf16-resident corpora (VERDICT r2 #3):
    the raw bf16 scan ranks by q_bf16 . x_bf16 paired with an f32 x_sq of
    the ORIGINAL f32 rows — two inconsistent precisions whose mixture
    flips near-ties at multi-million scale. Here the gathered bf16 rows
    upcast losslessly to f32 and distances use the cancellation-safe
    difference form, so ordering is exact with respect to the stored
    (bf16) corpus. Cost: a [B, OV, D] gather + an elementwise reduce,
    small next to the corpus-wide matmul.
    """
    xg = x[jnp.maximum(rows, 0)].astype(jnp.float32)  # [B, OV, D]
    diff = xg - q[:, None, :].astype(jnp.float32)
    d = jnp.sum(diff * diff, axis=-1)
    d = jnp.where(rows >= 0, d, jnp.inf)
    neg, pos = jax.lax.top_k(-d, k)
    out_rows = jnp.take_along_axis(rows, pos, axis=1)
    return jnp.where(neg > -jnp.inf, -neg, jnp.inf), \
        jnp.where(neg > -jnp.inf, out_rows, -1)


@partial(jax.jit, static_argnames=("k", "ov_k"))
def flat_search_rerank_kernel(x, x_sq, mask, q, k: int, ov_k: int):
    """Flat scan + fused f32 rerank in ONE device program: masked matmul
    top-ov_k (bf16 or f32, as the mirror is stored), then exact f32
    re-scoring of the candidates.

    Serves every flat regime: f32 with ``ov_k == k`` (exact distances for
    the winners), the bf16 rerank, and turbo selection (FVDB_FLAT_SELECT=
    approx, a wide ``ov_k`` pool). Masked rows surface from masked_topk as
    -1 and are +inf'd by the rerank, so deletes/filters can't re-enter
    through the re-score."""
    _, rows = flat_search_kernel(x, x_sq, mask, q, ov_k)
    return rerank_f32_kernel(x, q, rows, k)


@partial(
    jax.jit,
    static_argnames=("k", "ef", "n_probe", "has_hnsw", "has_ivf",
                     "has_filter", "beam_expand"),
)
def hybrid_search_kernel(
    x,
    x_sq,
    hnsw_mask,
    ivf_mask,
    extra_mask,
    nbrs0,
    nbrs_up,
    up_offset,
    entry,
    entry_level,
    centroids,
    tiles,
    q,
    k: int,
    ef: int,
    n_probe: int,
    has_hnsw: bool,
    has_ivf: bool,
    has_filter: bool = False,
    beam_expand: int = 1,
):
    b = q.shape[0]
    vals = jnp.full((b, k), jnp.inf, jnp.float32)
    rows = jnp.full((b, k), -1, jnp.int32)

    if has_hnsw:
        stop = jnp.zeros((b,), jnp.int32)
        cur, _ = greedy_descent_kernel(
            x, x_sq, hnsw_mask, nbrs_up, up_offset, q, entry, entry_level, stop
        )
        # traversal keeps the full graph; the filter bitmask only gates
        # which rows may enter the result set
        hd, hr = beam_search_kernel(
            x, x_sq, hnsw_mask, nbrs0, nbrs_up, up_offset, q, cur[:, None],
            jnp.ones((b,), bool), layer=0, ef=ef, max_iters=ef + 32,
            result_mask=(hnsw_mask & extra_mask) if has_filter else None,
            has_result_mask=has_filter, expand=beam_expand,
        )
        vals, rows = merge_topk(vals, rows, hd[:, :k], hr[:, :k], k)

    if has_ivf:
        imask = (ivf_mask & extra_mask) if has_filter else ivf_mask
        ivd, ivr, _ = ivf_search_kernel(
            x, x_sq, imask, centroids, tiles, q, k, n_probe
        )
        vals, rows = merge_topk(vals, rows, ivd, ivr, k)

    return vals, rows


@jax.jit
def _project_chunk(blk, mu, p):
    """Fused chunk projection: bf16 corpus block -> bf16 projected block.
    One jit so the f32 upcast + centering fuse into the matmul prologue —
    the eager form materializes a [chunk, D] f32 temporary (3.2 GB at 2M
    rows) next to the serving state."""
    # default precision: the projected pool is re-scored exactly in f32
    return jnp.matmul(blk.astype(jnp.float32) - mu, p,
                      precision=jax.lax.Precision.DEFAULT
                      ).astype(jnp.bfloat16)


@jax.jit
def _project_queries(q, mu, p):
    """Queries into the reduced-rank basis. Default precision: stage 1
    only picks a pool, which is then re-scored exactly in f32."""
    return jnp.matmul(q - mu, p, precision=jax.lax.Precision.DEFAULT)


@partial(jax.jit, static_argnames=("k",))
def _oracle_step(blk, m, q, base, vals, rows, k: int):
    """Running exact top-k of probe queries against one streamed bf16
    corpus block (f32 compute): the reduced-rank calibration oracle,
    accumulated for free during the mirror-build pass over the corpus."""
    d = pairwise_distance(q, blk.astype(jnp.float32))
    tv, ti = masked_topk(d, m, min(k, blk.shape[0]))
    tr = jnp.where(ti >= 0, ti + base, -1)
    if tv.shape[1] < k:
        pad = k - tv.shape[1]
        tv = jnp.pad(tv, ((0, 0), (0, pad)), constant_values=jnp.inf)
        tr = jnp.pad(tr, ((0, 0), (0, pad)), constant_values=-1)
    return merge_topk(vals, rows, tv, tr, k)


@partial(jax.jit, donate_argnums=(0,))
def _xp_write(xp, blk, lo):
    """Write one projected block into the device mirror IN PLACE (donated
    buffer): ``.at[].set`` / un-donated dynamic_update_slice copy the whole
    [N, rank] mirror per chunk — 3.8 GB per block at 10M rows."""
    return jax.lax.dynamic_update_slice(xp, blk, (lo, 0))


@jax.jit
def _bf16_row_norms(xp):
    """Squared row norms of a bf16 matrix, f32 accumulation, fused (the
    eager form would materialize an [N, r] f32 temporary — GBs at 30M+
    rows)."""
    x32 = xp.astype(jnp.float32)
    return jnp.sum(x32 * x32, axis=1)


class FusedSearcher:
    """Caches device-resident engine state and dispatches fused searches."""

    def __init__(self, hybrid):
        self.hybrid = hybrid
        self._key = None
        self._dev: dict | None = None
        # serializes device-state (re)builds: two readers racing a rebuild
        # would otherwise hold two corpus-sized mirrors on device transiently
        # (an OOM at multi-GB corpus sizes) and could publish a torn
        # (_dev, _key) pair
        self._state_lock = threading.RLock()
        # reduced-rank serving state: (mu, p) fit + projected bf16 mirror,
        # keyed by (store version, rank) — see _proj_state
        self._proj_key = None
        self._proj: dict | None = None
        # device-resident filter bitmask, keyed by content digest: repeated
        # filtered queries (the columnar path caches masks per epoch) would
        # otherwise re-upload a capacity-sized bool array every call — one
        # extra host->device transfer per query
        self._mask_digest: bytes | None = None
        self._mask_dev = None
        # masks-only device state for the reduced-rank regime (the full-dim
        # corpus mirror must NOT be resident there — that is the regime's
        # memory premise)
        self._members_key = None
        self._members_dev = None

    def _device_mask(self, extra_mask: np.ndarray):
        import hashlib

        m = np.ascontiguousarray(extra_mask)
        digest = hashlib.blake2b(m.tobytes(), digest_size=16).digest()
        if digest != self._mask_digest:
            self._mask_dev = jnp.asarray(m)
            self._mask_digest = digest
        return self._mask_dev

    def _state_key(self):
        h = self.hybrid
        return (h.store._version, h.hnsw._version, h.ivf._version,
                limits.serving_dtype())

    def _device_state(self) -> dict:
        # fast path without the lock: steady-state serving just reads the
        # published cache (assignment of the dict is atomic)
        dev, key = self._dev, self._key
        if dev is not None and key == self._state_key():
            return dev
        with self._state_lock:
            return self._device_state_locked()

    def _device_state_locked(self) -> dict:
        key = self._state_key()
        if self._dev is None or self._key != key:
            h = self.hybrid
            h.hnsw._fix_entry_point()  # entry may have been deleted
            key = self._state_key()
            # release the stale cached state before re-uploading: holding the
            # old corpus mirror while building the new one doubles its memory
            self._dev = None
            mirror = h.store.device(dtype=limits.serving_dtype())
            graph = h.hnsw._device_arrays()
            # masks reconciled to the mirror's row count: a concurrent
            # capacity grow between snapshots must not mix shapes
            n = int(mirror.x.shape[0])
            active = h.store.active_mask(n)
            hnsw_mask = active & h.hnsw.member_mask(n)
            # a migration batch mid-flight (inserted into IVF, not yet
            # removed from HNSW) must not occupy two result slots: HNSW
            # wins when both engines claim a row
            ivf_mask = active & h.ivf.member_mask(n) & ~hnsw_mask
            has_ivf = h.ivf.trained and bool(ivf_mask.any())
            self._dev = {
                "x": mirror.x,
                "x_sq": mirror.x_sq,
                "hnsw_mask": jnp.asarray(hnsw_mask),
                "ivf_mask": jnp.asarray(ivf_mask),
                "members": jnp.asarray(hnsw_mask | ivf_mask),
                "ones": jnp.ones((n,), bool),
                "nbrs0": graph["nbrs0"],
                "nbrs_up": graph["nbrs_up"],
                "up_offset": graph["up_offset"],
                "entry": jnp.int32(max(h.hnsw.entry_point, 0)),
                "entry_level": jnp.int32(max(h.hnsw.max_level, 0)),
                "centroids": jnp.asarray(h.ivf.centroids)
                if h.ivf.trained
                else jnp.zeros((1, h.store.dim), jnp.float32),
                "tiles": jnp.asarray(h.ivf.tiles())
                if has_ivf
                else jnp.full((1, 128), -1, jnp.int32),
                "has_hnsw": h.hnsw.num_nodes > 0 and h.hnsw.entry_point >= 0,
                "has_ivf": has_ivf,
            }
            self._key = key
        return self._dev

    # rows per projection chunk: the f32 corpus may exceed the device in this
    # regime, so it ships as transient bf16 blocks (mirror rows are padded
    # to _PROJ_ROW_PAD multiples, so all chunks share one compiled shape)
    _PROJ_CHUNK = 2_097_152
    # reduced-rank mirrors pad to COUNT (in 1M-row buckets), not to the
    # power-of-two store capacity: a 10M corpus occupies a 16.8M-row store,
    # and capacity-sized mirrors would waste 40% of HBM (the difference
    # between a device rerank mirror fitting or not)
    _PROJ_ROW_PAD = 1_048_576
    _PROBES = 128       # calibration probe queries
    _CAL_K = 10         # recall@k the calibration targets

    def _proj_state(self) -> dict:
        """Reduced-rank serving mirror: PCA fit + projected bf16 corpus +
        measured-recall calibration (+ optional device rerank mirror).

        Fit: covariance of a <=16K-row sample on device (eigh of the
        [D, D] covariance is trivial host-side).
        Projection: the corpus streams through the device in bf16 chunks —
        [chunk, D] upload, one matmul, write into the resident
        [n_rows, rank] bf16 mirror — so neither host BLAS nor a full-HBM
        f32 mirror is ever needed. The SAME streamed blocks feed a probe
        oracle (exact top-k for _PROBES member queries), so calibration
        costs no extra corpus pass. Calibration picks the smallest
        oversample whose stage-1 probe recall meets limits.pca_target();
        if even the widest pool misses the target and rank was auto, rank
        doubles and the mirror rebuilds once. When the device memory
        budget allows, a full-dim bf16 rerank mirror is kept so stage 2
        runs on the device instead of the host. Rebuilt whenever the store
        version or rank changes.
        """
        h = self.hybrid
        rank_req = limits.pca_rank()
        key = (h.store._version, rank_req)
        if self._proj is not None and self._proj_key == key:
            return self._proj
        with self._state_lock:
            return self._proj_state_locked(key, rank_req)

    @staticmethod
    def _stage_log(label: str, t0: float) -> float:
        """Mirror-build stage timing to stderr when FVDB_TIMING=1 (the build
        is minutes-long at 10M; operators need to see where)."""
        import os as _os
        import sys as _sys
        import time as _time

        t1 = _time.perf_counter()
        if _os.environ.get("FVDB_TIMING", "0") == "1":
            print(f"[fvdb-timing] {label}: {t1 - t0:.1f}s",
                  file=_sys.stderr, flush=True)
        from fabstir_vectordb_tpu.utils import progress

        progress.mark()  # progress hook between build stages
        return t1

    def _proj_state_locked(self, key, rank_req: int) -> dict:
        import time as _time

        _t = _time.perf_counter()
        h = self.hybrid
        if self._proj is not None and self._proj_key == key:
            return self._proj  # another thread built it while we waited
        self._proj = None  # release before re-upload (memory headroom)
        # the full-dim mirror and graph/tile device state are dead
        # weight in this regime — free them before allocating
        h.store.release_mirror()
        self._dev = None
        self._key = None
        data = h.store.data
        count = max(h.store.count, 1)
        dim = data.shape[1]
        from ..utils.padding import round_up

        n_rows = min(data.shape[0],
                     round_up(count, self._PROJ_ROW_PAD))

        stride = max(1, count // 16_384)
        sample = jnp.asarray(data[:count:stride])
        mu_d = jnp.mean(sample, axis=0)
        xc = sample - mu_d
        cov = np.asarray(jax.device_get(jnp.matmul(
            xc.T, xc, precision=jax.lax.Precision.HIGHEST)), np.float64)
        evals, evecs = np.linalg.eigh(cov)
        _t = self._stage_log("pca fit (sample cov + eigh)", _t)
        rank = rank_req
        if rank < 0:  # auto: smallest rank capturing pca_var() variance
            ev = np.maximum(evals[::-1], 0.0)
            total = ev.sum()
            if total <= 0:
                rank = 32
            else:
                cum = np.cumsum(ev) / total
                rank = int(np.searchsorted(cum, limits.pca_var()) + 1)
            rank = int(min(max(rank, 32), 192, dim))
        rank = min(rank, dim)

        members_np = h.store.active_mask(data.shape[0]) & (
            h.hnsw.member_mask(data.shape[0])
            | h.ivf.member_mask(data.shape[0])
        )
        member_rows = np.nonzero(members_np[:count])[0]
        pinned = rank_req >= 0 and limits.pca_oversample() is not None
        if pinned:
            # restart fast path: rank AND oversample pinned (operators copy
            # them from a previous calibration's serving_info) — skip the
            # probe-oracle corpus pass; the mirror build is the only
            # remaining streaming pass over the corpus
            probe_rows = np.zeros(0, np.int64)
        elif member_rows.size:
            sel = np.linspace(
                0, member_rows.size - 1,
                min(self._PROBES, member_rows.size),
            ).astype(np.int64)
            probe_rows = member_rows[sel]
        else:
            probe_rows = np.zeros(0, np.int64)

        # stage-2 placement decided BEFORE the mirror build: device mode
        # keeps a full-dim bf16 mirror resident, and the projection + probe-
        # oracle passes then read the corpus FROM that resident mirror —
        # zero further host->device traffic (the alternative order moves the
        # corpus three times: per-chunk upload, projected-mirror download
        # and re-upload). In auto mode the device switch also requires
        # scale: small corpora keep the all-host rerank. Device mode cuts
        # the wide pool on the device, then the host exactly re-scores just
        # the few survivors (see _projected_dispatch) — final scores are
        # exact f32 in both modes.
        mode = limits.pca_rerank_mode()

        def want_device_rerank(r: int) -> bool:
            if mode == "host":
                return False
            used = n_rows * r * 2 + n_rows * 4 + n_rows
            need = n_rows * dim * 2
            # reserve room for the stage-1 [B, N] distance transient (its
            # cap is a knob — deployments trade it against mirror residency)
            head = max(1 << 30, limits.stage1_transient_bytes())
            fits = used + need + head <= limits.hbm_budget_bytes()
            return mode == "device" or (fits and count >= 2_000_000)

        rerank_x = None
        oracle_rows = None
        attempt = 0
        while True:
            if want_device_rerank(rank):
                if rerank_x is None and h.store.device_source is not None:
                    # procedural corpus (utils/synth.py): regenerate the
                    # mirror ON device — zero bulk host->device transfer
                    rerank_x = h.store.device_source.mirror_bf16(n_rows)
                    jax.block_until_ready(rerank_x)
                    _t = self._stage_log(
                        "rerank mirror device-side generation", _t)
                if rerank_x is None:
                    from ..utils.transfer import put_bf16_blocks

                    # chunked upload: per-block progress marks and no
                    # full-corpus bf16 host twin
                    rerank_x = put_bf16_blocks(data, n_rows)
                    jax.block_until_ready(rerank_x)
                    _t = self._stage_log("rerank mirror chunked upload", _t)
            else:
                rerank_x = None  # auto-rank retry may outgrow the budget
            p_d = jnp.asarray(
                np.ascontiguousarray(evecs[:, ::-1][:, :rank], np.float32)
            )
            xp, xp_sq, oracle_rows = self._build_proj_mirror(
                data, n_rows, mu_d, p_d, members_np, probe_rows, oracle_rows,
                src=rerank_x,
            )
            _t = self._stage_log("projection pass (+probe oracle)", _t)
            oversample, achieved = self._calibrate_oversample(
                xp, xp_sq, members_np[:n_rows], data, probe_rows,
                mu_d, p_d, oracle_rows,
            )
            _t = self._stage_log("oversample calibration", _t)
            if (achieved >= limits.pca_target() or rank_req >= 0
                    or attempt >= 1 or rank >= dim):
                break
            rank = min(2 * rank, dim)  # auto-rank retry: double and rebuild
            xp = xp_sq = None
            attempt += 1
        if pinned:
            achieved = None  # not measured — the probe pass was skipped

        self._proj = {
            "mu": mu_d,
            "p": p_d,
            "xp": xp,
            "xp_sq": xp_sq,
            "n_rows": n_rows,
            "oversample": oversample,
            "achieved_recall": achieved,
            "rerank_x": rerank_x,
        }
        self._proj_key = key
        return self._proj

    def _build_proj_mirror(self, data, n_rows, mu_d, p_d, members_np,
                           probe_rows, oracle_rows, src=None):
        """One pass: project every corpus block into a device-resident bf16
        mirror and (first pass only) accumulate the probes' exact top-k.

        ``src`` (the resident full-dim bf16 rerank mirror, when stage 2 is
        on device) makes the pass read corpus blocks from device memory —
        no per-chunk host->device upload. Without it, blocks REGENERATE on
        device when the store has a device source (utils/synth.py — the
        stage-2-on-host regime where the full-dim mirror no longer fits
        would otherwise re-upload the whole corpus here), else upload as
        bf16 from host ``data``. Either way the projected mirror is
        assembled in place on device (donated dynamic_update_slice — see
        ``_xp_write``), never round-tripped through the host.
        """
        rank = int(p_d.shape[1])
        want_oracle = oracle_rows is None and probe_rows.size > 0
        if want_oracle:
            q_probe = jnp.asarray(data[probe_rows])
            ovals = jnp.full((len(probe_rows), self._CAL_K + 1),
                             jnp.inf, jnp.float32)
            orows = jnp.full((len(probe_rows), self._CAL_K + 1),
                             -1, jnp.int32)
        gen = None if src is not None else self.hybrid.store.device_source
        # resident source: shrink the chunk so the per-chunk slice copy +
        # f32 upcast transients stay small next to the extra full-dim
        # mirror (at 10M x 384: 7.7 GB rerank + 3.8 GB xp + transients).
        # generated source: the chunk IS the generation block (determinism
        # is tied to its boundaries).
        if src is not None:
            step = max(262_144, self._PROJ_CHUNK // 4)
        elif gen is not None:
            step = gen.block_rows
        else:
            step = self._PROJ_CHUNK
        xp = jnp.zeros((n_rows, rank), jnp.bfloat16)
        for lo in range(0, n_rows, step):
            hi = min(lo + step, n_rows)
            if src is not None:
                blk = jax.lax.slice_in_dim(src, lo, hi, axis=0)
            elif gen is not None:
                blk = gen.device_block(lo // step, jnp.bfloat16)
                if hi - lo < step:
                    blk = jax.lax.slice_in_dim(blk, 0, hi - lo, axis=0)
            else:
                from ..utils.transfer import put_bf16

                blk = put_bf16(data[lo:hi])  # u16 fast path (transfer.py)
            xp = _xp_write(xp, _project_chunk(blk, mu_d, p_d), jnp.int32(lo))
            if want_oracle:
                m = jnp.asarray(members_np[lo:hi])
                ovals, orows = _oracle_step(
                    blk, m, q_probe, jnp.int32(lo), ovals, orows,
                    self._CAL_K + 1,
                )
            del blk
        if want_oracle:
            # exclude each probe's self-row, keep _CAL_K true neighbors
            orows_np = np.asarray(orows)
            out = np.full((len(probe_rows), self._CAL_K), -1, np.int64)
            for j, pr in enumerate(probe_rows):
                r = orows_np[j]
                r = r[(r >= 0) & (r != pr)][: self._CAL_K]
                out[j, : len(r)] = r
            oracle_rows = out
        xp_sq = _bf16_row_norms(xp)  # fused: no [N, r] f32 transient
        return xp, xp_sq, oracle_rows

    def _calibrate_oversample(self, xp, xp_sq, members_slice, data,
                              probe_rows, mu_d, p_d, oracle_rows):
        """Smallest oversample meeting the recall target, measured on the
        probe oracle with ONE wide stage-1 pool (prefix widths evaluate
        every candidate oversample for free). Returns (oversample,
        achieved_recall_at_chosen)."""
        explicit = limits.pca_oversample()
        if probe_rows.size == 0 or oracle_rows is None:
            return (explicit or 8), 1.0
        ov_max = int(min(1024, xp.shape[0]))
        mask_dev = jnp.asarray(members_slice)
        # calibrate the SERVING selection kernel (stage 1), in probe
        # sub-batches that bound the [B, N] distance matrix: 128 probes at
        # once over a 10.5M-row mirror is a 5.4 GB transient next to the
        # resident state
        pools = []
        for lo in range(0, len(probe_rows), 16):
            q = jnp.asarray(data[probe_rows[lo: lo + 16]])
            qp = _project_queries(q, mu_d, p_d)
            _, pool_d = stage1_select_kernel(xp, xp_sq, mask_dev, qp, ov_max)
            pools.append(np.asarray(pool_d))
        pool = np.concatenate(pools, axis=0)
        want = [set(int(r) for r in row if r >= 0) for row in oracle_rows]
        total = sum(len(w) for w in want) or 1

        def recall_at(width: int) -> float:
            hits = 0
            for j, w in enumerate(want):
                got = set(int(r) for r in pool[j, :width] if r >= 0)
                hits += len(w & got)
            return hits / total

        if explicit is not None:
            return explicit, recall_at(min(explicit * self._CAL_K, ov_max))
        target = limits.pca_target()
        chosen, achieved = None, 0.0
        for factor in (4, 6, 8, 12, 16, 24, 32, 48, 64, 96):
            width = min(factor * self._CAL_K, ov_max)
            r = recall_at(width)
            if r >= target:
                chosen, achieved = factor, r
                break
            if width >= ov_max:
                chosen, achieved = factor, r
                break
        if chosen is None:
            chosen, achieved = 96, recall_at(ov_max)
        return chosen, achieved

    def serving_info(self) -> dict:
        """Which query plan serves right now (observability: REST
        /admin/statistics). Does not materialize any device state."""
        cap = self.hybrid.store.capacity
        if cap <= limits.effective_flat_threshold():
            regime = "flat-exact"
        elif limits.pca_serve():
            regime = "reduced-rank"
        else:
            regime = "pruned"
        info = {
            "regime": regime,
            "serving_dtype": limits.serving_dtype(),
            "capacity_rows": int(cap),
            "effective_flat_threshold": int(limits.effective_flat_threshold()),
        }
        if regime == "flat-exact":
            info["flat_select"] = limits.flat_select()
            if info["flat_select"] == "approx":
                info["flat_oversample"] = limits.flat_oversample()
        if regime == "reduced-rank":
            if self._proj is not None:
                info["pca_rank"] = int(self._proj["p"].shape[1])
                info["pca_oversample"] = (
                    limits.pca_oversample() or self._proj["oversample"])
                ar = self._proj["achieved_recall"]
                # None = rank+oversample were pinned, probe pass skipped
                info["pca_calibrated_recall"] = (
                    None if ar is None else round(float(ar), 4))
                info["pca_rerank"] = (
                    "device" if self._proj["rerank_x"] is not None
                    else "host")
            else:
                r = limits.pca_rank()
                info["pca_rank"] = "auto" if r < 0 else r
                info["pca_oversample"] = limits.pca_oversample() or "auto"
        return info

    def _release_proj(self) -> None:
        """Free the reduced-rank mirror when another regime takes over —
        the exact/pruned state and the projection state never coexist in
        device memory."""
        self._proj = None
        self._proj_key = None

    def _members_state(self, n_rows: int | None = None):
        """Device members mask alone (all the reduced-rank regime needs).
        ``n_rows`` truncates to the count-padded mirror length."""
        h = self.hybrid
        key = (self._state_key(), n_rows)
        if self._members_dev is None or self._members_key != key:
            n = n_rows if n_rows is not None else h.store.capacity
            members = h.store.active_mask(n) & (
                h.hnsw.member_mask(n) | h.ivf.member_mask(n)
            )
            self._members_dev = jnp.asarray(members)
            self._members_key = key
        return self._members_dev

    def _projected_dispatch(self, queries_np, q, k: int,
                            extra_mask: np.ndarray | None):
        """Stage 1 on device: exact top-(oversample*k) in PCA space.
        Stage 2 (rerank) on device when the bf16 full-dim mirror is
        resident, else on the host from the canonical f32 rows."""
        from ..utils.padding import bucket

        proj = self._proj_state()
        n_rows = proj["n_rows"]
        mask = self._members_state(n_rows)
        if extra_mask is not None:
            # reconcile to the mirror's row count (a count-sized or stale
            # capacity-sized mask must crop/pad, not broadcast-error)
            mask = mask & self._device_mask(fit_mask(extra_mask, n_rows))
        oversample = limits.pca_oversample() or proj["oversample"]
        # floor the pool at the CALIBRATED width (oversample * _CAL_K): the
        # probe pass measured recall of exactly that prefix for the true
        # top-_CAL_K, which contains the true top-k for any k <= _CAL_K —
        # scaling the pool down with a smaller client k (k=1 -> a 4-wide
        # pool over 10M rows) would serve a recall the
        # calibration never measured
        ov_k = min(bucket(max(k, self._CAL_K) * oversample),
                   int(proj["xp"].shape[0]))
        qp = _project_queries(q, proj["mu"], proj["p"])  # [B, rank]
        # chunk the query batch so the [B, N] stage-1 distance transient
        # stays bounded (B=512 over 10.5M rows is a 21.5 GB allocation)
        b = int(qp.shape[0])
        b_sub = max(1, min(
            b, limits.stage1_transient_bytes() // max(n_rows * 4, 1)))
        # power-of-two sub-batch: callers pad B to a power of two, so the
        # chunks all share one compiled shape
        b_sub = 1 << (b_sub.bit_length() - 1)
        if b <= b_sub:
            vals_p, rows_p = stage1_select_kernel(
                proj["xp"], proj["xp_sq"], mask, qp, ov_k)
        else:
            parts = [
                stage1_select_kernel(
                    proj["xp"], proj["xp_sq"], mask, qp[lo: lo + b_sub],
                    ov_k)
                for lo in range(0, b, b_sub)
            ]
            vals_p = jnp.concatenate([p[0] for p in parts], axis=0)
            rows_p = jnp.concatenate([p[1] for p in parts], axis=0)
        if proj["rerank_x"] is not None:
            # device stage 2: f32 re-scoring against the bf16 full-dim mirror
            # cuts the wide pool to a small survivor set on device. The
            # bf16-stored rows flip f32 near-ties at 10M scale (measured
            # recall 0.988 vs 1.000 at 10M when the ranking stops here), so the
            # host then exactly re-scores ONLY the survivors from the
            # canonical f32 rows — a ~16x smaller gather than host-mode
            # stage 2, off the device hot path, restoring both recall and
            # the exact-score API contract (score = 1/(1+exact d)).
            m = min(bucket(max(32, 4 * k)), int(rows_p.shape[1]))
            vals_p, rows_p = rerank_f32_kernel(proj["rerank_x"], q, rows_p, m)
        store = self.hybrid.store

        def rerank(vals_np: np.ndarray, rows_np: np.ndarray):
            """Stage 2 on host: exact sq-L2 over the candidate rows.

            Selection uses the norm-expansion form (cached row norms + one
            BLAS batched matmul — the difference form materializes and
            squares a [B, OV, D] temporary);
            the k winners then get difference-form distances (the expansion
            form loses ~1e-3 absolute to cancellation on near-duplicates).
            """
            safe = np.maximum(rows_np, 0)
            cv = store.data[safe]  # [B, OV, D]
            dots = np.matmul(cv, queries_np[:, :, None])[..., 0]
            q_sq = np.einsum("bd,bd->b", queries_np, queries_np)
            d = store.host_sq()[safe] - 2.0 * dots + q_sq[:, None]
            d = np.where(rows_np >= 0, d, np.inf)
            order = np.argsort(d, axis=1, kind="stable")[:, :k]
            top_rows = np.take_along_axis(rows_np, order, axis=1)
            diff = store.data[np.maximum(top_rows, 0)] \
                - queries_np[:, None, :]  # [B, k, D] — small
            top_d = np.einsum("bkd,bkd->bk", diff, diff)
            top_d = np.where(top_rows >= 0, top_d, np.inf)
            # exact distances can reorder within the candidate set
            order2 = np.argsort(top_d, axis=1, kind="stable")
            return (
                np.take_along_axis(top_d, order2, axis=1),
                np.take_along_axis(top_rows, order2, axis=1),
            )

        return vals_p, rows_p, rerank

    def prewarm(self, k: int = 10) -> float:
        """Build the active regime's device state and compile+run its query
        program on a dummy query — so the first REAL request pays neither
        the corpus upload nor a (cache-miss) compile. Servers call this at
        startup, so upload and compile are not paid by the first request.
        Returns seconds spent."""
        import time as _time

        t0 = _time.perf_counter()
        dummy = np.zeros((1, self.hybrid.store.dim), np.float32)
        vals, rows, post = self.search_dispatch(dummy, k, ef=50, n_probe=16)
        vals, rows = jax.device_get((vals, rows))
        if post is not None:
            post(vals, rows)
        return _time.perf_counter() - t0

    def search_dispatch(
        self,
        queries: np.ndarray,
        k: int,
        ef: int,
        n_probe: int,
        extra_mask: np.ndarray | None = None,
    ):
        """Dispatch one fused search WITHOUT the result readback.

        Returns ``(sq_dists, rows, post)``: two device arrays plus an
        optional host post-process to apply AFTER ``jax.device_get`` (the
        reduced-rank regime reranks its stage-1 candidates there; exact
        regimes return ``post=None``). JAX dispatch is asynchronous: this
        call returns as soon as the program is enqueued, so callers can
        pipeline several batches (dispatch i+1 before reading i) and overlap
        the host<->device round-trips with device work.
        """
        queries_np = np.atleast_2d(np.asarray(queries, np.float32))
        q = jnp.asarray(queries_np)

        # regime selection BEFORE materializing any mirror: the reduced-rank
        # regime must never upload the full-dim corpus (its memory premise)
        if self.hybrid.store.capacity <= limits.effective_flat_threshold():
            self._release_proj()  # regimes are exclusive in HBM
            dev = self._device_state()
            mask = dev["members"]
            cap = int(dev["x"].shape[0])
            if extra_mask is not None:
                mask = mask & self._device_mask(fit_mask(extra_mask, cap))
            if limits.flat_select() == "approx" and cap > k:
                from ..utils.padding import bucket

                # turbo: a wide pool re-scored exactly. Its pool selection
                # is the same sort as the exact kernel's on the GPU, so
                # whether it still buys anything is ROADMAP Queue 3 #4.
                ov_k = min(bucket(max(limits.flat_oversample(), 4 * k)), cap)
                vals, rows = flat_search_rerank_kernel(
                    dev["x"], dev["x_sq"], mask, q, k, ov_k)
            elif dev["x"].dtype == jnp.bfloat16 and limits.bf16_rerank() \
                    and cap > k:
                from ..utils.padding import bucket

                if limits.bf16_host_refine():
                    # device cut + exact host refine from the canonical
                    # f32 rows (the reduced-rank regime's stage-2 shape):
                    # the device rerank is exact only w.r.t. the STORED
                    # bf16 rows, whose rounding cost recall at 5M against
                    # the f32 oracle. A wider pool + tiny host
                    # re-score removes the storage-rounding term and
                    # restores the exact-score API contract.
                    ov_k = min(
                        bucket(max(8 * k, limits.bf16_oversample())), cap)
                    m = min(bucket(max(32, 4 * k)), ov_k)
                    vals, rows = flat_search_rerank_kernel(
                        dev["x"], dev["x_sq"], mask, q, m, ov_k)
                    store = self.hybrid.store

                    def refine(vals_np, rows_np):
                        safe = np.maximum(rows_np, 0)
                        diff = store.data[safe] \
                            - queries_np[:, None, :]  # [B, m, D] — small
                        d = np.einsum("bmd,bmd->bm", diff, diff)
                        d = np.where(rows_np >= 0, d, np.inf)
                        order = np.argsort(d, axis=1, kind="stable")[:, :k]
                        return (
                            np.take_along_axis(d, order, axis=1),
                            np.take_along_axis(rows_np, order, axis=1),
                        )

                    return vals, rows, refine
                ov_k = min(bucket(max(4 * k, 64)), cap)
                vals, rows = flat_search_rerank_kernel(
                    dev["x"], dev["x_sq"], mask, q, k, ov_k)
            else:
                # the k winners are re-scored in difference form: the
                # expansion form's cancellation (||x||^2 >> distance^2)
                # leaves returned distances ~1e-4 off on the GPU's f32 GEMM
                vals, rows = flat_search_rerank_kernel(
                    dev["x"], dev["x_sq"], mask, q, k, k)
            return vals, rows, None

        if limits.pca_serve():
            # beyond bf16 residency: compressed exact scan + exact rerank
            # (matmul-bound) instead of gather-bound graph/list traversal
            return self._projected_dispatch(queries_np, q, k, extra_mask)

        self._release_proj()  # pruned regime: free the projection mirror
        dev = self._device_state()
        extra = (dev["ones"] if extra_mask is None
                 else self._device_mask(
                     fit_mask(extra_mask, int(dev["x"].shape[0]))))
        n_probe_eff = min(n_probe, int(dev["centroids"].shape[0]))
        vals, rows = hybrid_search_kernel(
            dev["x"], dev["x_sq"], dev["hnsw_mask"], dev["ivf_mask"], extra,
            dev["nbrs0"], dev["nbrs_up"], dev["up_offset"],
            dev["entry"], dev["entry_level"], dev["centroids"], dev["tiles"],
            q, k, ef, n_probe_eff, dev["has_hnsw"], dev["has_ivf"],
            has_filter=extra_mask is not None,
            beam_expand=limits.beam_expand(),
        )
        return vals, rows, None

    def search(
        self,
        queries: np.ndarray,
        k: int,
        ef: int,
        n_probe: int,
        extra_mask: np.ndarray | None = None,
    ):
        """Returns (sq-dists [B, k], rows [B, k]) as numpy."""
        vals, rows, post = self.search_dispatch(
            queries, k, ef, n_probe, extra_mask
        )
        # one combined readback (separate np.asarray calls pay two
        # device->host round-trips)
        vals, rows = jax.device_get((vals, rows))
        if post is not None:
            vals, rows = post(vals, rows)
        return vals, rows
