"""IVF (inverted-file) index: on-device k-means + nprobe list scans.

Array rebuild of the reference IVF engine (reference: src/ivf/core.rs,
src/ivf/operations.rs). Key mapping:
  - k-means++ init + Lloyd training (core.rs:240-371) -> ops.kmeans on device;
  - InvertedList HashMaps (core.rs:112-152) -> padded int32 row-id tiles
    ``list_ids [C, L_pad]`` (-1 padding) over the shared VectorStore;
  - search = rank all centroids by one [B, C] matmul, then a lax.scan over the
    n_probe nearest lists: gather list rows, batched distance, fused masked
    top-k merge (core.rs:622-681 made batched + static-shaped);
  - soft-deletes are skipped via the store's active mask fused into top-k
    (core.rs:666-669);
  - operations parity: retrain, add_clusters, optimize_clusters, ClusterStats,
    evaluate_search_quality, balance_clusters, compact, centroid export/import,
    vacuum (operations.rs).

Defaults match the reference config: n_clusters=256, n_probe=16,
train_size=10000, max_iterations=25 (core.rs:42-60).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.distance import pairwise_distance
from ..ops.kmeans import assign_clusters, kmeans_train_stepped
from ..ops.topk import masked_topk, merge_topk
from ..utils import limits, progress
from ..utils.padding import bucket, fit_mask, round_up, grow_rows
from .store import VectorStore


class NotTrainedError(RuntimeError):
    pass


class TrainingError(ValueError):
    pass


@dataclass
class IVFConfig:
    n_clusters: int = 256
    n_probe: int = 16
    train_size: int = 10_000
    max_iterations: int = 25
    seed: int = 42


@dataclass
class TrainStats:
    iterations: int
    converged: bool
    final_error: float


@dataclass
class ClusterStats:
    sizes: list = field(default_factory=list)
    variances: list = field(default_factory=list)
    empty_clusters: int = 0

    @property
    def total_vectors(self) -> int:
        return int(sum(self.sizes))

    @property
    def mean_variance(self) -> float:
        nz = [v for s, v in zip(self.sizes, self.variances) if s > 0]
        return float(np.mean(nz)) if nz else 0.0


@partial(jax.jit, static_argnames=("k", "n_probe", "metric"))
def ivf_search_kernel(
    x, x_sq, mask, centroids, list_ids, q, k: int, n_probe: int,
    metric: str = "euclidean",
):
    """Batched nprobe scan. Returns (dists [B,k], rows [B,k], probe [B,P]).

    list_ids: [C, L_pad] int32 row ids, -1 padded. All shapes static; the
    probe loop is a lax.scan so XLA pipelines gather + matmul + top-k merge.
    """
    b = q.shape[0]
    l_pad = list_ids.shape[1]
    dc = pairwise_distance(q, centroids, metric=metric)  # [B, C]
    n_probe = min(n_probe, centroids.shape[0])
    _, probe = jax.lax.top_k(-dc, n_probe)  # [B, P]

    q_sq = jnp.sum(q * q, axis=-1)  # [B]
    k_step = min(k, l_pad)

    def body(carry, probe_col):  # probe_col: [B] cluster id at this probe rank
        vals, idx = carry
        cand = list_ids[probe_col]  # [B, L_pad]
        # clamp to the mirror's row count: tiles built after the mirror
        # snapshot may reference rows a concurrent insert appended — an
        # out-of-range gather would silently clamp to row n-1 and return
        # its distance under the new row's id
        valid = (cand >= 0) & (cand < x.shape[0])
        safe = jnp.where(valid, cand, 0)
        xs = x[safe]  # [B, L_pad, D] gather
        if metric == "euclidean":
            dots = jnp.einsum(
                "bd,bld->bl", q, xs, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            d = q_sq[:, None] - 2.0 * dots + x_sq[safe]
            d = jnp.maximum(d, 0.0)
        elif metric == "cosine":
            dots = jnp.einsum(
                "bd,bld->bl", q, xs, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            denom = jnp.sqrt(jnp.maximum(q_sq[:, None] * x_sq[safe], 1e-30))
            d = 1.0 - dots / denom
        else:  # dot
            d = -jnp.einsum("bd,bld->bl", q, xs,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
        m = valid & mask[safe]
        cvals, cpos = masked_topk(d, m, k_step)
        crow = jnp.where(
            cpos >= 0, jnp.take_along_axis(safe, jnp.maximum(cpos, 0), axis=1), -1
        )
        vals, idx = merge_topk(vals, idx, cvals, crow, k)
        return (vals, idx), None

    init = (
        jnp.full((b, k), jnp.inf, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )
    (vals, idx), _ = jax.lax.scan(body, init, probe.T)
    return vals, idx, probe


class IVFIndex:
    """Inverted-file index over a shared VectorStore."""

    def __init__(self, store: VectorStore, config: IVFConfig | None = None):
        self.store = store
        self.config = config or IVFConfig()
        self.centroids: np.ndarray | None = None  # [C, D] f32
        # row -> cluster id; -1 means "not a member of this index"
        self.assignments = np.full(store.capacity, -1, np.int32)
        self.trained = False
        self._tiles: tuple | None = None  # (list_ids np [C, L_pad], version)
        self._tiles_version = -1
        self._version = 0
        # device-resident (base mask, centroids, tiles) for the standalone
        # search path, version-keyed like the store mirror: without it
        # every search re-uploads tens of MB of tiles/centroids that have
        # not changed
        self._dev_search: dict | None = None
        self._dev_search_key = None

    # ------------------------------------------------------------- training
    def train(self, vectors: np.ndarray) -> TrainStats:
        """k-means train the coarse quantizer; does NOT insert the vectors
        (matches reference initialize(): train then clear lists,
        src/hybrid/core.rs:262-290)."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2:
            raise TrainingError("training data must be [n, dim]")
        if vectors.shape[0] < self.config.n_clusters:
            raise TrainingError(
                f"need at least n_clusters={self.config.n_clusters} training "
                f"vectors, got {vectors.shape[0]}"
            )
        if vectors.shape[1] != self.store.dim:
            raise TrainingError(
                f"training dim {vectors.shape[1]} != store dim {self.store.dim}"
            )
        n = min(vectors.shape[0], self.config.train_size)
        # bucket the sample rows to a power of two (masked padding): the
        # training program is one big jit (k-means++ scan + Lloyd loop)
        # that costs 60s+ per compile on remote-compile targets — without
        # bucketing every distinct sample size pays that compile
        n_pad = bucket(n, minimum=min(1024, n))
        if vectors.shape[0] > n:
            # seeded RANDOM sample: taking the first train_size rows biases
            # the quantizer toward the head of ordered/grouped corpora
            # (rows sorted by category would train on one category only)
            sel = np.random.default_rng(self.config.seed).choice(
                vectors.shape[0], n, replace=False)
            sample = vectors[np.sort(sel)]
        else:
            sample = vectors[:n]
        if n_pad > n:
            sample = np.concatenate(
                [sample, np.zeros((n_pad - n, sample.shape[1]), np.float32)]
            )
        mask = jnp.arange(n_pad) < n
        res = kmeans_train_stepped(
            jax.random.PRNGKey(self.config.seed),
            jnp.asarray(sample),
            mask,
            n_clusters=self.config.n_clusters,
            max_iterations=self.config.max_iterations,
        )
        self.centroids = np.asarray(res.centroids)
        self.trained = True
        self._version += 1
        return TrainStats(
            iterations=int(res.iterations),
            converged=bool(res.converged),
            final_error=float(res.final_error),
        )

    def set_trained(self, centroids: np.ndarray) -> None:
        """Install centroids directly (load path / tests), like the
        reference's set_trained used by persistence + scale tests.

        Validates BEFORE mutating any state (a malformed call must not
        leave a trained index with unusable centroids), and drops
        assignments pointing past the new cluster count — a shrinking
        import would otherwise crash the next tile build. Assignments
        within range are kept (the load path restores them right after);
        callers changing the centroid BASIS should reassign via
        insert_rows/retrain."""
        cents = np.asarray(centroids, np.float32)
        if cents.ndim != 2 or cents.shape[1] != self.store.dim:
            raise TrainingError("centroids must be [C, dim]")
        self.centroids = cents
        self.assignments[self.assignments >= cents.shape[0]] = -1
        self.trained = True
        self._version += 1

    # ------------------------------------------------------------- mutation
    def _ensure_capacity(self) -> None:
        if self.assignments.shape[0] < self.store.capacity:
            self.assignments = grow_rows(
                self.assignments, self.store.capacity, fill=-1
            )

    # rows per assignment chunk: bounds the transient host->device transfer
    # (1M x 384 f32 = 1.5 GB) so multi-million-row bulk inserts never hold
    # the whole batch in HBM next to the resident corpus mirror
    _ASSIGN_CHUNK = 1_048_576

    def insert_rows(self, rows: np.ndarray) -> None:
        """Assign store rows to their nearest centroid and add to lists."""
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        self._ensure_capacity()
        cj = jnp.asarray(self.centroids)
        # assign against the serving mirror: re-uploading the batch as f32
        # (1.5 GB per 1M rows) would duplicate the upload serving does
        # right after anyway. The
        # mirror upload (bf16: half the bytes) is shared with serving;
        # assignment then only ships row indices and gathers on-device.
        mirror = self.store.device(dtype=limits.serving_dtype())
        for lo in range(0, rows.size, self._ASSIGN_CHUNK):
            sub = rows[lo: lo + self._ASSIGN_CHUNK]
            # pad the tail chunk to a power-of-two bucket so bulk inserts
            # compile O(log N) assignment variants, not one per batch size
            n_pad = bucket(len(sub), minimum=1)
            sub_pad = sub
            if n_pad > len(sub):
                sub_pad = np.concatenate(
                    [sub, np.repeat(sub[:1], n_pad - len(sub))]
                )
            vecs = mirror.x[jnp.asarray(sub_pad)].astype(jnp.float32)
            assign, _ = assign_clusters(vecs, cj)
            self.assignments[sub] = np.asarray(assign, np.int32)[: len(sub)]
            progress.mark()  # one assignment chunk done
        self._version += 1

    def remove_rows(self, rows: np.ndarray) -> None:
        self._ensure_capacity()
        self.assignments[np.asarray(rows, np.int64)] = -1
        self._version += 1

    def member_rows(self) -> np.ndarray:
        return np.nonzero(self.member_mask())[0]

    def member_mask(self, n: int | None = None) -> np.ndarray:
        """[n or store.capacity] bool membership. Non-mutating: readers
        (search, tiles) call this concurrently with writers, so it never
        grows arrays and tolerates a capacity grow swapping them mid-read."""
        assign = self.assignments  # local ref: growth replaces the object
        if n is None:
            n = max(self.store.capacity, assign.shape[0])
        m = np.zeros(n, bool)
        c = min(n, assign.shape[0])
        m[:c] = assign[:c] >= 0
        return m

    @property
    def active_count(self) -> int:
        act = self.store.active_mask()
        m = self.member_mask(act.shape[0])
        return int((m & act).sum())

    @property
    def deleted_count(self) -> int:
        deleted = self.store.deleted
        count = min(self.store.count, deleted.shape[0])
        m = self.member_mask(count)
        return int((m & deleted[:count]).sum())

    def vacuum(self) -> int:
        """Drop tombstoned/deleted rows from the lists. Returns count removed."""
        self._ensure_capacity()
        dead = np.zeros(self.assignments.shape[0], bool)
        dead[: self.store.count] = self.store.deleted[: self.store.count]
        removed = int(((self.assignments >= 0) & dead).sum())
        self.assignments[dead] = -1
        self._version += 1
        return removed

    # ---------------------------------------------------------------- tiles
    def _build_tiles(self) -> np.ndarray:
        """Pack assignments into padded [C, L_pad] row-id tiles."""
        c = self.config.n_clusters if self.centroids is None else self.centroids.shape[0]
        # ONE snapshot of the assignments array, then filter: member_rows()
        # followed by a second read raced concurrent remove/vacuum (-1
        # landing between the two reads crashed np.bincount)
        assign_arr = self.assignments
        members = np.nonzero(assign_arr >= 0)[0]
        if members.size == 0:
            return np.full((c, 128), -1, np.int32)
        assign = assign_arr[members]
        ok = (assign >= 0) & (assign < c)
        members, assign = members[ok], assign[ok]
        if members.size == 0:
            return np.full((c, 128), -1, np.int32)
        counts = np.bincount(assign, minlength=c)
        # power-of-two tile width: rounding to the next 128 recompiles the
        # search kernel every time the largest list grows by 128 rows
        # (60s+/compile on remote-compile targets); bucketing bounds the
        # distinct widths to O(log L). compact_clusters() still repacks
        # minimally on demand.
        l_pad = max(128, bucket(int(counts.max()), minimum=128))
        tiles = np.full((c, l_pad), -1, np.int32)
        order = np.argsort(assign, kind="stable")
        sorted_rows = members[order]
        sorted_assign = assign[order]
        starts = np.zeros(c + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(sorted_rows.size) - starts[sorted_assign]
        tiles[sorted_assign, pos] = sorted_rows
        return tiles

    def tiles(self) -> np.ndarray:
        if self._tiles is None or self._tiles_version != self._version:
            # read the version BEFORE building: a writer bumping it
            # mid-build must invalidate this build, not be masked by it
            v = self._version
            t = self._build_tiles()
            self._tiles, self._tiles_version = t, v
        return self._tiles

    # ---------------------------------------------------------------- search
    def search_rows(
        self,
        queries: np.ndarray,
        k: int,
        n_probe: int | None = None,
        extra_mask: np.ndarray | None = None,
        metric: str = "euclidean",
    ):
        """Returns (distances [B,k] true euclidean, rows [B,k])."""
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        n_probe = n_probe if n_probe is not None else self.config.n_probe
        mirror = self.store.device(dtype=limits.serving_dtype())
        # masks reconciled to the mirror's row count: concurrent capacity
        # growth must not feed the kernel mismatched shapes
        n = int(mirror.x.shape[0])
        key = (self._version, self.store._version, n)
        dev = self._dev_search
        if dev is None or self._dev_search_key != key:
            dev = {
                "mask": jnp.asarray(
                    self.store.active_mask(n) & self.member_mask(n)),
                "centroids": jnp.asarray(self.centroids),
                "tiles": jnp.asarray(self.tiles()),
            }
            self._dev_search = dev
            self._dev_search_key = key
        mask_dev = dev["mask"]
        if extra_mask is not None:
            # per-call filter: combine on host against a fresh snapshot
            mask_dev = jnp.asarray(
                self.store.active_mask(n) & self.member_mask(n)
                & fit_mask(extra_mask, n))
        # bucket k so jit kernels are shared across k values
        k_eff = bucket(k)
        vals, rows, _ = ivf_search_kernel(
            mirror.x,
            mirror.x_sq,
            mask_dev,
            dev["centroids"],
            dev["tiles"],
            jnp.asarray(queries),
            k_eff,
            min(n_probe, self.centroids.shape[0]),
            metric,
        )
        vals = np.asarray(vals)[:, :k]
        rows = np.asarray(rows)[:, :k]
        if metric == "euclidean":
            vals = np.sqrt(np.maximum(vals, 0.0))
        return vals, rows

    # ------------------------------------------------------------ operations
    def retrain(self, new_config: IVFConfig | None = None) -> TrainStats:
        """Collect members -> train under (new) config -> reinsert
        (reference: src/ivf/operations.rs:148-193)."""
        members = self.member_rows()
        act = self.store.active_mask()
        members = members[act[members]]
        # validate BEFORE installing the new config: a failed retrain must
        # not leave config (n_clusters etc.) disagreeing with the installed
        # centroids — persistence writes the config into the manifest
        cfg = new_config if new_config is not None else self.config
        if members.size < cfg.n_clusters:
            raise TrainingError("not enough active members to retrain")
        self.config = cfg
        stats = self.train(self.store.data[members])
        self.assignments[:] = -1
        self.insert_rows(members)
        return stats

    def add_clusters(self, n_new: int) -> None:
        """Append n_new centroids seeded from the worst-served vectors
        (reference: src/ivf/operations.rs:195-220)."""
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        members = self.member_rows()
        act = self.store.active_mask()
        members = members[act[members]]  # a deleted outlier must not seed
        if members.size == 0:
            raise TrainingError("no members to derive new clusters from")
        vecs = self.store.data[members]
        _, d2 = assign_clusters(jnp.asarray(vecs), jnp.asarray(self.centroids))
        far = np.argsort(-np.asarray(d2))[:n_new]
        self.centroids = np.vstack([self.centroids, vecs[far]])
        self._version += 1
        self.insert_rows(members)  # reassign everyone

    def optimize_clusters(self) -> dict:
        """Fresh k-means over current members; returns variance improvement
        (reference: src/ivf/operations.rs:222-261)."""
        before = self.cluster_stats().mean_variance
        stats = self.retrain()
        after = self.cluster_stats().mean_variance
        return {
            "variance_before": before,
            "variance_after": after,
            "improvement": before - after,
            "iterations": stats.iterations,
        }

    def cluster_stats(self) -> ClusterStats:
        if not self.trained:
            return ClusterStats()
        c = self.centroids.shape[0]
        members = self.member_rows()
        act = self.store.active_mask()
        members = members[act[members]]
        sizes = np.bincount(self.assignments[members], minlength=c)
        variances = np.zeros(c)
        if members.size:
            diffs = self.store.data[members] - self.centroids[self.assignments[members]]
            sq = (diffs * diffs).sum(axis=1)
            np.add.at(variances, self.assignments[members], sq)
            # NO where=: np.divide(..., where=) without out= leaves the
            # masked slots as uninitialized memory — empty clusters must
            # report variance 0.0, not garbage (denominator is already
            # clamped to 1)
            variances = variances / np.maximum(sizes, 1)
        return ClusterStats(
            sizes=sizes.tolist(),
            variances=variances.tolist(),
            empty_clusters=int((sizes == 0).sum()),
        )

    def balance_clusters(self, max_ratio: float = 2.0) -> int:
        """Move vectors out of oversized clusters into their nearest
        NON-FULL cluster (reference: src/ivf/operations.rs:422-492 — but
        the reference moves to the unconditional next-nearest, which on
        dense corpora just piles the excess into the NEXT-largest nearby
        cluster; measured at 1M x 384 that doubled the serving tile width
        instead of shrinking it). Receivers are capped at the same limit:
        running counts gate each destination, and victims spill to their
        next-best non-full alternative. Returns moves."""
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        stats = self.cluster_stats()
        sizes = np.asarray(stats.sizes, np.int64).copy()
        nonempty = sizes[sizes > 0]
        if nonempty.size == 0:
            return 0
        mean = nonempty.mean()
        limit = max(int(mean * max_ratio), 1)
        moves = 0
        cj = jnp.asarray(self.centroids)
        # largest first: the biggest offenders get first pick of receivers
        for cid in np.argsort(-sizes):
            if sizes[cid] <= limit:
                break
            rows = np.nonzero(self.assignments == cid)[0]
            act = self.store.active_mask()
            rows = rows[act[rows]]
            excess = int(sizes[cid] - limit)
            if excess <= 0 or rows.size == 0:
                continue
            vecs = jnp.asarray(self.store.data[rows])
            d = np.array(pairwise_distance(vecs, cj))  # writable copy
            d_self = d[:, cid].copy()
            d[:, cid] = np.inf
            d[:, sizes >= limit] = np.inf  # full receivers excluded
            alt = d.argmin(axis=1)
            first = d[np.arange(rows.size), alt]
            if not np.isfinite(first).any():
                continue  # every other cluster already at the cap
            # cheapest moves first (smallest distance penalty vs staying)
            order = np.argsort(first - d_self, kind="stable")
            for i in order[: 4 * excess]:  # headroom for full receivers
                if excess <= 0:
                    break
                if not np.isfinite(first[i]):
                    continue
                dest = int(alt[i])
                while sizes[dest] >= limit:
                    # receiver filled up since d was snapshot: re-pick
                    d[:, dest] = np.inf
                    dest = int(np.argmin(d[i]))
                    if not np.isfinite(d[i, dest]):
                        dest = -1
                        break
                    alt[i] = dest
                    first[i] = d[i, dest]
                if dest < 0:
                    break  # no non-full receiver remains at all
                self.assignments[rows[i]] = np.int32(dest)
                sizes[dest] += 1
                sizes[cid] -= 1
                excess -= 1
                moves += 1
        if moves:
            self._version += 1
        return moves

    def compact_clusters(self) -> None:
        """Rebuild tiles at minimal padding (reference shrink_to_fit,
        src/ivf/operations.rs:394-420)."""
        self._tiles = None
        self._tiles_version = -1
        self.tiles()

    def evaluate_search_quality(self, queries: np.ndarray, k: int = 10) -> dict:
        """Recall/precision vs exhaustive ground truth + avg query latency
        (reference: src/ivf/operations.rs:329-391)."""
        from .flat import FlatIndex

        queries = np.atleast_2d(np.asarray(queries, np.float32))
        member_mask = self.member_mask()[: self.store.capacity]
        oracle = FlatIndex(self.store)
        t0 = time.perf_counter()
        _, rows = self.search_rows(queries, k)
        avg_ms = (time.perf_counter() - t0) * 1000.0 / max(1, queries.shape[0])
        _, exact = oracle.search_rows(queries, k, extra_mask=member_mask)
        hits = 0
        retrieved = 0
        relevant = 0
        for b in range(exact.shape[0]):
            truth = {int(r) for r in exact[b] if r >= 0}
            got = {int(r) for r in rows[b] if r >= 0}
            hits += len(truth & got)
            retrieved += len(got)
            relevant += len(truth)
        return {
            "recall": hits / relevant if relevant else 1.0,
            "precision": hits / retrieved if retrieved else 1.0,
            "avg_query_ms": avg_ms,
        }

    def export_centroids(self) -> np.ndarray:
        if not self.trained:
            raise NotTrainedError("IVF index is not trained")
        return self.centroids.copy()

    def import_centroids(self, centroids: np.ndarray) -> None:
        self.set_trained(centroids)

    def memory_usage_bytes(self) -> int:
        total = self.assignments.nbytes
        if self.centroids is not None:
            total += self.centroids.nbytes
        if self._tiles is not None:
            total += self._tiles.nbytes
        return int(total)
