"""Hybrid index: HNSW for recent vectors + IVF for historical, time-routed.

Array rebuild of the reference hybrid engine (reference: src/hybrid/core.rs).
Key mapping:
  - HNSW("recent") + IVF("historical") + per-id timestamps (:202-213) -> ONE
    shared VectorStore with per-engine membership masks; timestamps live in
    the store; routing flips membership instead of copying vectors;
  - config: recent_threshold 7 days, migration_batch_size 100,
    auto_migrate, min_ivf_training_size=10 (:69-85), and the reference's
    default hybrid IVF config of 3 clusters / n_probe 2 (:70-74);
  - initialize(): <min_ivf_training_size vectors -> HNSW-only mode; else
    k-means train then discard (":262-290 train then clear lists");
  - insert routes by age vs threshold (:357-417);
  - search_with_config: search both engines, merge by distance, truncate
    (:425-486) — here both run on device and merge is a fused top-k;
  - search_with_filter: x3 k-oversampling + metadata post-filter (:513-549);
    additionally the filter bitmask is pushed down into IVF/flat selection
    (strictly-better recall; documented deviation per SURVEY §7);
  - migration recent->historical in batches (:551-649) — unlike the
    reference (which never removes migrated nodes from HNSW, :579-580), we
    truly move membership: IVF gains the rows, HNSW scrubs them (deliberate
    fix listed in SURVEY §7 "quirks to NOT copy");
  - CRUD: delete routes by membership (:904-936), batch_delete (:968-986),
    vacuum across both (:989-1011), deletion_stats/get_deleted_vectors
    (:1028-1068), stats with age-distribution buckets (:758-820);
  - from_parts reconstruction for the persistence layer (:857-901).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.metadata_filter import MetadataFilter
from .flat import FlatIndex
from .hnsw import HNSWConfig, HNSWIndex
from .ivf import IVFConfig, IVFIndex
from .store import VectorStore, UnknownIdError

SECONDS_PER_DAY = 86_400.0


def _default_hybrid_ivf() -> IVFConfig:
    # Reference HybridConfig overrides IVF defaults to 3 clusters / n_probe 2
    # (src/hybrid/core.rs:70-74) so tiny datasets can train.
    return IVFConfig(n_clusters=3, n_probe=2)


@dataclass
class HybridConfig:
    recent_threshold_secs: float = 7 * SECONDS_PER_DAY
    migration_batch_size: int = 100
    auto_migrate: bool = True
    min_ivf_training_size: int = 10
    hnsw: HNSWConfig = field(default_factory=HNSWConfig)
    ivf: IVFConfig = field(default_factory=_default_hybrid_ivf)


@dataclass
class SearchConfig:
    recent_k: int | None = None  # defaults to k
    historical_k: int | None = None  # defaults to k
    hnsw_ef: int = 50
    ivf_n_probe: int | None = None  # defaults to ivf config
    auto_migrate: bool | None = None  # defaults to hybrid config


@dataclass
class HybridStats:
    total_vectors: int
    recent_vectors: int
    historical_vectors: int
    deleted_recent: int
    deleted_historical: int
    ivf_trained: bool
    age_distribution: dict


class HybridIndex:
    """Recency-routed dual-engine index over one shared VectorStore."""

    def __init__(self, dim: int, config: HybridConfig | None = None,
                 store: VectorStore | None = None):
        self.config = config or HybridConfig()
        self.store = store or VectorStore(dim)
        self.hnsw = HNSWIndex(self.store, self.config.hnsw)
        self.ivf = IVFIndex(self.store, self.config.ivf)
        self.flat = FlatIndex(self.store)
        from .fused import FusedSearcher

        self.fused = FusedSearcher(self)
        self.initialized = False
        self._materialize_event = None  # set during lazy loads
        self._load_error: Exception | None = None
        self._cold = None  # ColdServing during lazy loads (serve-on-demand)
        # serializes MUTATIONS (insert/delete/vacuum/migrate): the engines'
        # multi-step link/assign sequences are not safe under concurrent
        # writers (a capacity grow mid-link raced a second writer's insert
        # in testing). Readers stay lock-free: searches snapshot versioned
        # device state and tolerate pre-/post-write host views.
        self._write_lock = threading.RLock()
        # earliest `now` at which any HNSW member could age out; None =
        # unknown (scan on next call). auto_migrate runs on EVERY search:
        # without this the hot path pays an O(N) member/age scan (plus
        # the write lock) per query even when nothing is migratable
        self._migration_due: float | None = None

    # ------------------------------------------------------------ lifecycle
    def begin_materialize(self, event) -> None:
        """Mark the index as lazily loading; data-plane ops block on
        wait_ready() until the background materializer signals ``event``."""
        self._materialize_event = event

    def attach_cold(self, cold) -> None:
        """Install a ColdServing context: searches during the lazy load are
        answered from on-demand chunk fetches instead of blocking."""
        self._cold = cold

    def _cold_active(self, cfg) -> bool:
        from ..utils import limits

        return (not self.ready and self._cold is not None
                and limits.cold_serve()
                and cfg.recent_k is None and cfg.historical_k is None)

    def wait_ready(self, timeout: float | None = None) -> None:
        """Block until lazily loaded vector data is resident (no-op for
        eager loads). Raises the materializer's error if loading failed."""
        ev = self._materialize_event
        if ev is None:
            return
        if not ev.wait(timeout):
            raise TimeoutError("lazy load still materializing")
        if self._load_error is not None:
            raise self._load_error
        self._materialize_event = None
        self._cold = None  # fully resident: cold serving retires

    @property
    def ready(self) -> bool:
        ev = self._materialize_event
        return ev is None or ev.is_set()

    @property
    def ivf_trained(self) -> bool:
        return self.ivf.trained

    def initialize(self, training_data: np.ndarray | None = None) -> None:
        """Train IVF if enough data, else HNSW-only mode (everything routes
        to HNSW until retrained)."""
        if training_data is not None:
            training_data = np.asarray(training_data, np.float32)
        n = 0 if training_data is None else training_data.shape[0]
        if n >= max(self.config.min_ivf_training_size, self.config.ivf.n_clusters):
            self.ivf.train(training_data)
        self.initialized = True

    # -------------------------------------------------------------- inserts
    def insert(self, vid: str, vector: np.ndarray, timestamp: float | None = None,
               now: float | None = None) -> int:
        return int(
            self.insert_batch([vid], np.asarray(vector, np.float32)[None, :],
                              None if timestamp is None else [timestamp], now=now)[0]
        )

    def insert_batch(
        self,
        ids: list,
        vectors: np.ndarray,
        timestamps=None,
        now: float | None = None,
    ) -> np.ndarray:
        """Insert vectors, routing each by age. Returns store rows."""
        self.wait_ready()
        with self._write_lock:
            return self._insert_batch_locked(ids, vectors, timestamps, now)

    def _insert_batch_locked(self, ids, vectors, timestamps, now):
        now = time.time() if now is None else now
        vectors = np.asarray(vectors, np.float32)
        if timestamps is None:
            ts = np.full(vectors.shape[0], now, np.float64)
        else:
            ts = np.asarray(timestamps, np.float64)
            if ts.ndim == 0:
                ts = np.full(vectors.shape[0], float(ts), np.float64)
            # validate BEFORE mutating the store: a short timestamps list
            # broadcasts fine into add_batch but blows up at the routing
            # index below, leaving ids orphaned in store rows that no
            # engine will ever serve (and unrecoverable: re-insert is a
            # DuplicateIdError)
            if ts.shape != (vectors.shape[0],):
                raise ValueError(
                    f"timestamps shape {ts.shape} != ({vectors.shape[0]},)")
        rows = self.store.add_batch(ids, vectors, ts)
        age = now - ts
        recent = age < self.config.recent_threshold_secs
        if not self.ivf.trained:
            recent[:] = True  # HNSW-only mode
        if recent.any():
            self.hnsw.insert_rows(rows[recent])
            # new HNSW members may age out earlier than anything cached
            due_new = float(ts[recent].min()) \
                + self.config.recent_threshold_secs
            cur = self._migration_due
            if cur is not None and due_new < cur:
                self._migration_due = due_new
        if (~recent).any():
            self.ivf.insert_rows(rows[~recent])
        return rows

    # --------------------------------------------------------------- search
    def search(self, query: np.ndarray, k: int, config: SearchConfig | None = None,
               now: float | None = None):
        """Single query -> list[(id, distance)] ascending."""
        d, rows = self.search_rows(np.atleast_2d(query), k, config, now=now)
        return self._rows_to_results(d[0], rows[0])

    def search_rows(
        self,
        queries: np.ndarray,
        k: int,
        config: SearchConfig | None = None,
        extra_mask: np.ndarray | None = None,
        now: float | None = None,
    ):
        """Batched dual-engine search. Returns (dists [B,k], rows [B,k])."""
        cfg = config or SearchConfig()
        if self._cold_active(cfg):
            cold = self._cold
            if cold is not None:  # materializer may retire it concurrently
                return cold.search_rows(
                    queries, k,
                    n_probe=(self.config.ivf.n_probe
                             if cfg.ivf_n_probe is None else cfg.ivf_n_probe),
                    extra_mask=extra_mask,
                )
        self.wait_ready()
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        b = queries.shape[0]
        auto = self.config.auto_migrate if cfg.auto_migrate is None else cfg.auto_migrate
        if auto:
            self.migrate_old_vectors(now=now)

        # `x if x is not None else default`: 0 is a VALID value (skip that
        # engine), which `or` would silently coerce back to the default
        recent_k = k if cfg.recent_k is None else cfg.recent_k
        historical_k = k if cfg.historical_k is None else cfg.historical_k

        # fast path: default per-engine k -> one fused device program
        if recent_k == k and historical_k == k:
            from ..utils.padding import bucket

            # clamp to capacity: lax.top_k rejects k > N (a k=16384 request
            # against a 1K-row store must truncate, not crash)
            k_eff = min(bucket(k), self.store.capacity)
            vals, rows = self.fused.search(
                queries,
                k=k_eff,
                ef=bucket(max(cfg.hnsw_ef, k)),
                n_probe=(self.config.ivf.n_probe if cfg.ivf_n_probe is None
                         else cfg.ivf_n_probe),
                extra_mask=extra_mask,
            )
            return self._finalize_fast(vals, rows, k)

        parts_d, parts_r = [], []
        if recent_k > 0 and self.hnsw.num_nodes > 0:
            d1, r1 = self.hnsw.search_rows(
                queries, recent_k, ef=max(cfg.hnsw_ef, recent_k),
                extra_mask=extra_mask,
            )
            parts_d.append(d1)
            parts_r.append(r1)
        if (historical_k > 0 and self.ivf.trained
                and self.ivf.member_rows().size > 0):
            d2, r2 = self.ivf.search_rows(
                queries, historical_k, n_probe=cfg.ivf_n_probe,
                extra_mask=extra_mask,
            )
            parts_d.append(d2)
            parts_r.append(r2)
        if not parts_d:
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int32))
        d = np.concatenate(parts_d, axis=1)
        r = np.concatenate(parts_r, axis=1)
        d = np.where(r >= 0, d, np.inf)
        # dedup rows across engines before the merge: a migration batch
        # mid-flight (inserted into IVF, not yet removed from HNSW) may
        # surface in BOTH engines' results for a lock-free reader — keep
        # the best-scoring copy, never two result slots for one row
        order_all = np.argsort(d, axis=1, kind="stable")
        d_sorted = np.take_along_axis(d, order_all, axis=1)
        r_sorted = np.take_along_axis(r, order_all, axis=1)
        for i in range(r_sorted.shape[0]):
            _, first = np.unique(r_sorted[i], return_index=True)
            dup = np.ones(r_sorted.shape[1], bool)
            dup[first] = False
            dup &= r_sorted[i] >= 0
            d_sorted[i, dup] = np.inf
            r_sorted[i, dup] = -1
        order = np.argsort(d_sorted, axis=1, kind="stable")[:, :k]
        out_d = np.take_along_axis(d_sorted, order, axis=1)
        out_r = np.take_along_axis(r_sorted, order, axis=1)
        out_r = np.where(np.isfinite(out_d), out_r, -1)
        if out_d.shape[1] < k:
            pad = k - out_d.shape[1]
            out_d = np.pad(out_d, ((0, 0), (0, pad)), constant_values=np.inf)
            out_r = np.pad(out_r, ((0, 0), (0, pad)), constant_values=-1)
        return out_d, out_r

    @staticmethod
    def _finalize_fast(vals, rows, k: int):
        """Post-process one fused-kernel result: sqrt, trim/pad to k."""
        vals, rows = np.asarray(vals)[:, :k], np.asarray(rows)[:, :k]
        vals = np.sqrt(np.maximum(vals, 0.0))
        vals = np.where(rows >= 0, vals, np.inf)
        if vals.shape[1] < k:
            pad = k - vals.shape[1]
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=np.inf)
            rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
        return vals, rows

    def search_rows_dispatch(
        self,
        queries: np.ndarray,
        k: int,
        config: SearchConfig | None = None,
        extra_mask: np.ndarray | None = None,
        now: float | None = None,
    ):
        """Dispatch half of :meth:`search_rows`: enqueue the fused device
        program and return a zero-arg ``finalize() -> (dists, rows)``.

        JAX dispatch is asynchronous, so callers can enqueue several batches
        before finalizing the first — overlapping host<->device round-trips
        with device work. Configs that need
        per-engine k (recent_k/historical_k) fall back to an eager search.
        """
        cfg = config or SearchConfig()
        recent_k = cfg.recent_k or k
        historical_k = cfg.historical_k or k
        if recent_k != k or historical_k != k or self._cold_active(cfg):
            d, r = self.search_rows(queries, k, config, extra_mask, now=now)
            return lambda: (d, r)

        self.wait_ready()
        auto = (self.config.auto_migrate if cfg.auto_migrate is None
                else cfg.auto_migrate)
        if auto:
            self.migrate_old_vectors(now=now)
        from ..utils.padding import bucket

        queries = np.atleast_2d(np.asarray(queries, np.float32))
        k_eff = min(bucket(k), self.store.capacity)  # lax.top_k needs k <= N
        vals_d, rows_d, post = self.fused.search_dispatch(
            queries, k_eff, bucket(max(cfg.hnsw_ef, k)),
            cfg.ivf_n_probe or self.config.ivf.n_probe, extra_mask,
        )

        def finalize():
            import jax

            vals, rows = jax.device_get((vals_d, rows_d))
            if post is not None:
                vals, rows = post(vals, rows)
            return self._finalize_fast(vals, rows, k)

        return finalize

    def search_rows_pipelined(
        self,
        query_batches,
        k: int,
        config: SearchConfig | None = None,
        extra_mask: np.ndarray | None = None,
        now: float | None = None,
        depth: int = 4,
    ) -> list:
        """Pipelined batched search: dispatch up to ``depth`` fused device
        programs before the first readback, so consecutive batches overlap
        the host<->device round-trip instead of paying it serially.

        Takes a list of [B_i, D] query batches; returns a list of
        (dists [B_i, k], rows [B_i, k]) in order. Results are identical to
        calling :meth:`search_rows` per batch with the same config.
        """
        fins: list = []
        out: list = []
        for qb in query_batches:
            fins.append(
                self.search_rows_dispatch(qb, k, config, extra_mask, now=now)
            )
            if len(fins) >= depth:
                out.append(fins.pop(0)())
        while fins:
            out.append(fins.pop(0)())
        return out

    def search_with_filter(
        self,
        query: np.ndarray,
        k: int,
        filter: MetadataFilter | dict | None,
        metadata_rows: list | None = None,
        oversample: int = 3,
        now: float | None = None,
        row_mask: np.ndarray | None = None,
    ):
        """Filtered search: bitmask pushdown into IVF + x3 oversampled HNSW
        with post-filter (reference: src/hybrid/core.rs:513-549).

        The bitmask comes from ``row_mask`` (precomputed — the columnar
        metadata index path, microseconds at 1M rows) or is compiled from
        ``metadata_rows`` (per-row Python evaluation — legacy path)."""
        if filter is None:
            d, rows = self.search_rows(np.atleast_2d(query), k, now=now)
            return self._rows_to_results(d[0], rows[0])
        if isinstance(filter, dict):
            filter = MetadataFilter.from_json(filter)
        if row_mask is None:
            if metadata_rows is None:
                raise ValueError("need row_mask or metadata_rows")
            row_mask = filter.compile_mask(metadata_rows)  # indexed by row
        from ..utils.padding import fit_mask

        mask = fit_mask(np.asarray(row_mask, bool), self.store.capacity)
        # oversample to k*oversample; masks are fused where engines allow
        d, rows = self.search_rows(
            np.atleast_2d(query), k * oversample, extra_mask=mask, now=now
        )
        # HNSW can't fuse the mask into traversal results reliably when the
        # predicate is extremely selective; enforce it here — on the ROW
        # array from the search snapshot, never by re-resolving ids back
        # to rows (a concurrent vacuum drops id mappings -> UnknownIdError,
        # and delete-then-reinsert remaps the id to a different row)
        keep = (rows[0] >= 0) & mask[np.maximum(rows[0], 0)]
        d0 = np.where(keep, d[0], np.inf)
        r0 = np.where(keep, rows[0], -1)
        return self._rows_to_results(d0, r0)[:k]

    def search_oversampled_post_filter(
        self,
        query: np.ndarray,
        k: int,
        predicate,
        oversample: int = 3,
        now: float | None = None,
    ):
        """The reference's exact filtered-search strategy: search k*oversample
        UNFILTERED, post-filter the results by ``predicate(id)``, truncate to
        k (src/hybrid/core.rs:513-549). O(k) predicate evaluations — the
        fallback when a filter can't be lowered to a columnar bitmask."""
        d, rows = self.search_rows(np.atleast_2d(query), k * oversample, now=now)
        results = self._rows_to_results(d[0], rows[0])
        return [(vid, dist) for vid, dist in results if predicate(vid)][:k]

    def _rows_to_results(self, dists: np.ndarray, rows: np.ndarray):
        out = []
        for dist, row in zip(dists, rows):
            if row < 0 or not np.isfinite(dist):
                continue
            vid = self.store.id_of(int(row))
            if vid is not None:
                out.append((vid, float(dist)))
        return out

    # ------------------------------------------------------------ migration
    def migrate_old_vectors(self, batch_size: int | None = None,
                            now: float | None = None) -> int:
        """Move aged-out HNSW rows to IVF. Returns number migrated."""
        if not self.ivf.trained:
            return 0
        now_eff = time.time() if now is None else now
        due = self._migration_due
        if due is not None and now_eff < due:
            return 0  # nothing can be old yet: skip the scan AND the lock
        self.wait_ready()
        with self._write_lock:
            return self._migrate_locked(batch_size, now_eff)

    def _migrate_locked(self, batch_size, now) -> int:
        if batch_size is None:
            batch_size = self.config.migration_batch_size
        m = self.hnsw.member_mask()[: self.store.count]
        act = ~self.store.deleted[: self.store.count]
        age = now - self.store.timestamps[: self.store.count]
        old = np.nonzero(m & act & (age >= self.config.recent_threshold_secs))[0]
        if old.size == 0:
            live = m & act
            member_ts = self.store.timestamps[: self.store.count][live]
            self._migration_due = (
                float(member_ts.min()) + self.config.recent_threshold_secs
                if member_ts.size else float("inf"))
            return 0
        batch = old[:batch_size]
        self.ivf.insert_rows(batch)
        self.hnsw.remove_rows(batch)
        self._migration_due = None  # more may remain: re-scan next call
        return int(batch.size)

    def migrate_all(self, now: float | None = None) -> int:
        total = 0
        while True:
            n = self.migrate_old_vectors(now=now)
            if n == 0:
                return total
            total += n

    # ----------------------------------------------------------------- CRUD
    def delete(self, vid: str) -> bool:
        """Soft-delete by id (either engine)."""
        with self._write_lock:
            return self.store.mark_deleted(vid)

    def batch_delete(self, ids: list) -> int:
        # under the write lock like delete(): a batch racing vacuum() could
        # otherwise mark rows between the engine vacuums and the store
        # vacuum, leaving a delete that no manifest ever records
        with self._write_lock:
            n = 0
            for vid in ids:
                try:
                    if self.store.mark_deleted(vid):
                        n += 1
                except UnknownIdError:
                    pass
            return n

    def vacuum(self) -> dict:
        """Physically remove soft-deleted vectors from both engines."""
        self.wait_ready()
        with self._write_lock:
            return self._vacuum_locked()

    def _vacuum_locked(self) -> dict:
        hnsw_removed = self.hnsw.vacuum()
        ivf_removed = self.ivf.vacuum()
        self.store.vacuum()
        return {
            "hnsw_removed": hnsw_removed,
            "ivf_removed": ivf_removed,
            "total_removed": hnsw_removed + ivf_removed,
        }

    def deletion_stats(self) -> dict:
        """Per-engine soft-deleted counts. ``total_deleted`` is the sum of
        the engine counts — NOT ``store.deleted_count``, which includes
        rows tombstoned by a previous vacuum (rows stay tombstoned forever
        so adjacency indices remain stable) and would therefore never
        return to 0 (reference parity: deleted counts reset after vacuum,
        hybrid/core.rs:1028-1045)."""
        return {
            "hnsw_deleted": self.hnsw.deleted_count,
            "ivf_deleted": self.ivf.deleted_count,
            "total_deleted": self.hnsw.deleted_count + self.ivf.deleted_count,
        }

    def get_deleted_vectors(self) -> list:
        """Soft-deleted ids for the manifest (reference: hybrid/core.rs:1047)."""
        out = []
        for row in np.nonzero(self.store.deleted[: self.store.count])[0]:
            vid = self.store.id_of(int(row))
            if vid is not None:
                out.append(vid)
        return out

    def contains(self, vid: str) -> bool:
        return self.store.contains(vid)

    def get_vector(self, vid: str) -> np.ndarray:
        self.wait_ready()
        return self.store.get_vector(vid)

    # ---------------------------------------------------------------- stats
    def stats(self, now: float | None = None) -> HybridStats:
        now = time.time() if now is None else now
        n = self.store.count
        act = ~self.store.deleted[:n]
        # clamp: future timestamps (client clock skew) land in "0-1d"
        # rather than vanishing from every bucket (buckets must sum to
        # the active count)
        age_days = np.maximum(
            now - self.store.timestamps[:n], 0.0) / SECONDS_PER_DAY
        buckets = {"0-1d": (0, 1), "1-7d": (1, 7), "7-30d": (7, 30),
                   "30d+": (30, np.inf)}
        dist = {
            name: int(((age_days >= lo) & (age_days < hi) & act).sum())
            for name, (lo, hi) in buckets.items()
        }
        return HybridStats(
            total_vectors=self.store.active_count,
            recent_vectors=self.hnsw.active_count,
            historical_vectors=self.ivf.active_count,
            deleted_recent=self.hnsw.deleted_count,
            deleted_historical=self.ivf.deleted_count,
            ivf_trained=self.ivf.trained,
            age_distribution=dist,
        )

    def memory_usage_bytes(self) -> int:
        return (
            self.store.memory_usage_bytes()
            + self.hnsw.memory_usage_bytes()
            + self.ivf.memory_usage_bytes()
        )

    # ----------------------------------------------------------- persistence
    @classmethod
    def from_parts(
        cls,
        dim: int,
        config: HybridConfig,
        ids: list,
        vectors: np.ndarray,
        timestamps: np.ndarray,
        hnsw_member: np.ndarray,
        centroids: np.ndarray | None,
        deleted_ids: list | None = None,
    ) -> "HybridIndex":
        """Reconstruct from persisted state (reference: hybrid/core.rs:857-901).

        hnsw_member: bool per input row; non-members go to IVF (when trained).
        The HNSW graph is rebuilt (fast batched device build) — the manifest
        stores true row->engine maps instead of the reference's hash heuristic
        (deliberate fix, SURVEY §7).
        """
        idx = cls(dim, config)
        rows = idx.store.add_batch(ids, vectors, timestamps)
        if centroids is not None and len(centroids):
            idx.ivf.set_trained(centroids)
        hnsw_member = np.asarray(hnsw_member, bool)
        if (~hnsw_member).any() and not idx.ivf.trained:
            raise ValueError("historical rows present but no centroids")
        if hnsw_member.any():
            idx.hnsw.insert_rows(rows[hnsw_member])
        if (~hnsw_member).any():
            idx.ivf.insert_rows(rows[~hnsw_member])
        for vid in deleted_ids or []:
            if idx.store.contains(vid):
                idx.store.mark_deleted(vid)
        idx.initialized = True
        return idx
