"""Dense row-oriented vector storage shared by all index engines.

Array replacement for the reference's per-node HashMaps
(reference: src/hnsw/core.rs:49-116 nodes hold full vectors;
src/ivf/core.rs:112-152 InvertedList HashMap<VectorId, Vec<f32>>):
vectors live in ONE dense [capacity, dim] f32 array; ids are row indices.
A host dict maps user id <-> row (replacing blake3 VectorId + `_originalId`
bookkeeping). Soft-delete is a boolean mask fused into device top-k
(SURVEY §7 design stance).

Capacity grows in power-of-two buckets so jitted kernels specialize on at
most O(log N) shapes. The device mirror (x, x_sq) is cached and re-uploaded
only when the host copy changes.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..utils.padding import grow_capacity, grow_rows


class DuplicateIdError(ValueError):
    pass


class UnknownIdError(KeyError):
    pass


class DimensionMismatchError(ValueError):
    pass


@dataclass
class DeviceMirror:
    x: jnp.ndarray
    x_sq: jnp.ndarray
    version: int
    dtype: str = "float32"


class MirrorStager:
    """Assembles the device mirror's HOST image from row blocks as they
    decode, then uploads it in ONE ``device_put`` at install time.

    ``add`` converts each block to the mirror dtype into a preallocated
    host buffer (cheap, ~3 ms per 10K x 384 block); ``install`` pads to
    capacity and ships a single transfer. An earlier design device_put
    EVERY block and concatenated on device — the 101-operand concatenate
    compiled + executed for 34.8 s at 1M x 384 (measured; the per-block
    transfers it was supposed to overlap cost only ~1-8 s on this link).
    Blocks may arrive in any order; ``index`` is their position in row
    order, and per-block byte offsets come from the running row count of
    each slot, resolved at install.

    The staged mirror is bit-identical to what ``VectorStore.device()``
    would upload (same dtype cast, zero tail), so serving results are
    unchanged — only the timeline moves.
    """

    def __init__(self, dtype: str = "float32"):
        self.dtype = dtype
        self._slots: dict[int, np.ndarray] = {}
        self.rows = 0

    def add(self, index: int, block: np.ndarray) -> None:
        b = np.ascontiguousarray(block, np.float32)
        if b.size == 0:
            return
        if self.dtype == "bfloat16":
            import ml_dtypes

            b = b.astype(ml_dtypes.bfloat16)
        self._slots[index] = b
        self.rows += b.shape[0]

    def install(self, store: "VectorStore") -> None:
        """Publish the staged mirror for ``store`` (keyed to its CURRENT
        version — call after every load-time mutation is done). Rows must
        have been staged in ``index`` order matching store rows [0, n)."""
        import jax
        import ml_dtypes

        npdt = (ml_dtypes.bfloat16 if self.dtype == "bfloat16"
                else np.float32)
        with store._lock:
            host = np.zeros((store.capacity, store.dim), npdt)
            pos = 0
            for i in sorted(self._slots):
                b = self._slots[i]
                host[pos: pos + b.shape[0]] = b
                pos += b.shape[0]
            self._slots.clear()
            if self.dtype == "bfloat16":
                from ..utils.transfer import put_bf16

                x = put_bf16(host)  # u16-view fast path (22x: transfer.py)
            else:
                x = jax.device_put(host)
            del host
            if self.dtype == "bfloat16":
                # match device() BIT-EXACTLY (same expression, so the
                # staged mirror can never disagree with a rebuilt one):
                # x_sq stays f32 from the host copy
                x_sq = jnp.asarray(
                    (store.data.astype(np.float32) ** 2).sum(axis=1))
            else:
                x_sq = jnp.sum(x * x, axis=1)
            store._mirror = DeviceMirror(
                x=x, x_sq=x_sq, version=store._version, dtype=self.dtype)


class VectorStore:
    """Host-canonical vector rows + device mirror.

    Row states: unallocated (row >= count), active, deleted (soft).
    """

    def __init__(self, dim: int, initial_capacity: int = 1024):
        if dim <= 0:
            raise DimensionMismatchError("dim must be positive")
        self.dim = dim
        self.capacity = grow_capacity(1, initial_capacity)
        self.count = 0  # allocated rows (including soft-deleted)
        self.data = np.zeros((self.capacity, dim), np.float32)
        self.deleted = np.zeros(self.capacity, bool)
        self.timestamps = np.zeros(self.capacity, np.float64)
        self.id_to_row: dict[str, int] = {}
        self.row_to_id: list = []
        self._version = 0
        self._mirror: DeviceMirror | None = None
        self._lock = threading.RLock()
        # optional device-side corpus provider (utils/synth.py): serving
        # mirrors regenerate on device instead of uploading the host copy
        self.device_source = None

    def attach_device_source(self, source) -> None:
        """Register a device-side corpus source (``utils.synth``): an object
        whose ``mirror_bf16(n_rows)`` returns this store's rows as a device
        bf16 mirror WITHOUT a host->device corpus transfer. The caller is
        responsible for verifying the source matches the host rows first
        (``source.spot_check``) — mirror builds trust it blindly. Detach by
        passing None. Any later mutation of row data or row count
        (add/fill/register/vacuum) AUTO-DETACHES the source: the next mirror
        rebuild would otherwise silently regenerate synthetic rows that no
        longer match the mutated host data (spot_check only runs at attach
        time). Soft-deletes keep it — they live in masks, not row data."""
        self.device_source = source

    def _detach_source_on_mutation(self) -> None:
        """Row data / row count changed: a procedural device source no
        longer reproduces this store. Called with ``_lock`` held by every
        mutating writer (same invalidation point as the ``_version`` bump
        that retires device mirrors)."""
        if self.device_source is not None:
            self.device_source = None

    # ------------------------------------------------------------ mutation
    def _check_new_ids(self, ids: list) -> None:
        """Duplicate-id validation that permits re-inserting a soft-deleted
        id: the tombstoned row releases its mapping (stays deleted forever)
        and the id maps to the new row — this is how delete-then-reinsert
        (the reference client's update) works without a vacuum in between."""
        if len(set(ids)) != len(ids):
            raise DuplicateIdError("duplicate ids within batch")
        for vid in ids:
            row = self.id_to_row.get(vid)
            if row is None:
                continue
            if not self.deleted[row]:
                raise DuplicateIdError(f"duplicate vector id: {vid}")
            self.row_to_id[row] = None
            del self.id_to_row[vid]

    def _grow_to(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = grow_capacity(needed, self.capacity)
        self.data = grow_rows(self.data, new_cap)
        self.deleted = grow_rows(self.deleted, new_cap)
        self.timestamps = grow_rows(self.timestamps, new_cap)
        self.capacity = new_cap

    def add_batch(
        self,
        ids: list,
        vectors: np.ndarray,
        timestamps: np.ndarray | float | None = None,
    ) -> np.ndarray:
        """Append rows; returns their row indices. Duplicate ids are errors."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise DimensionMismatchError(
                f"expected [n, {self.dim}] vectors, got {vectors.shape}"
            )
        if len(ids) != vectors.shape[0]:
            raise ValueError("ids/vectors length mismatch")
        with self._lock:
            self._check_new_ids(ids)
            n = vectors.shape[0]
            self._grow_to(self.count + n)
            rows = np.arange(self.count, self.count + n, dtype=np.int32)
            self.data[rows] = vectors
            if timestamps is None:
                timestamps = time.time()
            self.timestamps[rows] = timestamps
            self.deleted[rows] = False
            for vid, row in zip(ids, rows):
                self.id_to_row[vid] = int(row)
                self.row_to_id.append(vid)
            self.count += n
            self._version += 1
            self._detach_source_on_mutation()
            return rows

    def add_blocks(
        self,
        ids: list,
        blocks: list,
        timestamps: np.ndarray | float | None = None,
    ) -> np.ndarray:
        """Append pre-chunked [ni, dim] blocks without concatenating them
        first (bulk-load path: one copy straight into the store instead of
        materializing an intermediate corpus-sized array)."""
        n = sum(int(b.shape[0]) for b in blocks)
        if len(ids) != n:
            raise ValueError("ids/blocks length mismatch")
        with self._lock:
            self._check_new_ids(ids)
            self._grow_to(self.count + n)
            pos = self.count
            for b in blocks:
                b = np.asarray(b, np.float32)
                if b.ndim != 2 or b.shape[1] != self.dim:
                    raise DimensionMismatchError(
                        f"expected [n, {self.dim}] block, got {b.shape}"
                    )
                self.data[pos: pos + b.shape[0]] = b
                pos += b.shape[0]
            rows = np.arange(self.count, self.count + n, dtype=np.int32)
            if timestamps is None:
                timestamps = time.time()
            self.timestamps[rows] = timestamps
            self.deleted[rows] = False
            for vid, row in zip(ids, rows):
                self.id_to_row[vid] = int(row)
                self.row_to_id.append(vid)
            self.count += n
            self._version += 1
            self._detach_source_on_mutation()
            return rows

    def register_rows(
        self, ids: list, timestamps: np.ndarray | float | None = None
    ) -> np.ndarray:
        """Allocate rows and id mappings WITHOUT writing vector data (lazy
        load: data arrives later via fill_rows). Rows read as zeros until
        filled."""
        with self._lock:
            self._check_new_ids(ids)
            n = len(ids)
            self._grow_to(self.count + n)
            rows = np.arange(self.count, self.count + n, dtype=np.int32)
            if timestamps is None:
                timestamps = time.time()
            self.timestamps[rows] = timestamps
            self.deleted[rows] = False
            for vid, row in zip(ids, rows):
                self.id_to_row[vid] = int(row)
                self.row_to_id.append(vid)
            self.count += n
            self._version += 1
            self._detach_source_on_mutation()
            return rows

    def fill_rows(self, start_row: int, block: np.ndarray,
                  bump_version: bool = False) -> None:
        """Write a contiguous [n, dim] data block into pre-registered rows.
        Callers streaming many blocks bump the version once at the end
        (each bump invalidates the device mirror)."""
        block = np.asarray(block, np.float32)
        with self._lock:
            self.data[start_row: start_row + block.shape[0]] = block
            self._detach_source_on_mutation()
            if bump_version:
                self._version += 1

    def bump_version(self) -> None:
        with self._lock:
            self._version += 1

    def row_of(self, vid: str) -> int:
        try:
            return self.id_to_row[vid]
        except KeyError:
            raise UnknownIdError(vid) from None

    def id_of(self, row: int) -> str | None:
        if 0 <= row < self.count:
            return self.row_to_id[row]
        return None

    def get_vector(self, vid: str) -> np.ndarray:
        return self.data[self.row_of(vid)].copy()

    def mark_deleted(self, vid: str) -> bool:
        """Soft-delete. Returns False if already deleted."""
        with self._lock:
            row = self.row_of(vid)
            if self.deleted[row]:
                return False
            self.deleted[row] = True
            self._version += 1
            return True

    def is_deleted(self, vid: str) -> bool:
        return bool(self.deleted[self.row_of(vid)])

    def contains(self, vid: str) -> bool:
        return vid in self.id_to_row

    def vacuum(self) -> list:
        """Physically free soft-deleted rows. Returns the removed ids.

        Rows are not compacted (row indices are stable; adjacency arrays in
        engines reference them); data is zeroed and the id mapping dropped.
        """
        with self._lock:
            removed = []
            for row in np.nonzero(self.deleted[: self.count])[0]:
                vid = self.row_to_id[row]
                if vid is not None:
                    removed.append(vid)
                    del self.id_to_row[vid]
                    self.row_to_id[row] = None
                self.data[row] = 0.0
            # rows stay 'deleted' forever (tombstoned); they never match masks
            self._version += 1
            self._detach_source_on_mutation()
            return removed

    # ------------------------------------------------------------- queries
    @property
    def active_count(self) -> int:
        return self.count - int(self.deleted[: self.count].sum())

    @property
    def deleted_count(self) -> int:
        return int(self.deleted[: self.count].sum())

    def active_mask(self, n: int | None = None) -> np.ndarray:
        """[n or capacity] bool: allocated and not deleted.

        Built lock-free from one-shot local references with min() bounds so
        a reader racing a concurrent capacity grow (which swaps the backing
        arrays) sees a consistent prefix snapshot instead of a shape error.
        """
        deleted = self.deleted  # local ref: growth replaces the object
        if n is None:
            n = max(self.capacity, deleted.shape[0])
        mask = np.zeros(n, bool)
        count = min(self.count, n, deleted.shape[0])
        mask[:count] = ~deleted[:count]
        return mask

    def active_ids(self) -> list:
        return [
            self.row_to_id[r]
            for r in range(self.count)
            if not self.deleted[r] and self.row_to_id[r] is not None
        ]

    def device(self, dtype: str = "float32") -> DeviceMirror:
        """Device-resident (x, x_sq); re-uploaded only when host data changed.

        ``dtype="bfloat16"`` keeps the resident vectors in bf16 — half the
        device memory per row (double the single-device capacity) with distances still
        accumulated in f32; x_sq stays f32 from the host copy.
        """
        with self._lock:
            m = self._mirror
            if m is None or m.version != self._version or m.dtype != dtype:
                # free the stale mirror BEFORE allocating the new one: at
                # multi-GB corpus sizes holding both transiently (e.g. a
                # f32->bf16 switch at 8M rows: 12.9 + 6.4 GB) would OOM HBM
                self._mirror = m = None
                if dtype == "bfloat16":
                    from ..utils.transfer import put_bf16

                    x = put_bf16(self.data)
                    x_sq = jnp.asarray((
                        self.data.astype(np.float32) ** 2).sum(axis=1))
                else:
                    x = jnp.asarray(self.data)
                    x_sq = jnp.sum(x * x, axis=1)
                self._mirror = DeviceMirror(
                    x=x, x_sq=x_sq, version=self._version, dtype=dtype)
            return self._mirror

    def release_mirror(self) -> None:
        """Drop the cached device mirror (re-uploaded on next use). The
        reduced-rank serving regime calls this: past the flat threshold the
        full-dim mirror is dead weight in HBM (6.4 GB at 8.4M bf16 rows)."""
        with self._lock:
            self._mirror = None

    def host_sq(self) -> np.ndarray:
        """Cached [capacity] f32 squared row norms of the host copy (keyed by
        version). Serving reranks read this instead of re-squaring gathered
        rows per query batch (memory-bound and slow on few-core hosts)."""
        with self._lock:
            cached = getattr(self, "_host_sq", None)
            if cached is None or cached[0] != self._version:
                sq = np.einsum(
                    "nd,nd->n", self.data, self.data, dtype=np.float32
                )
                self._host_sq = cached = (self._version, sq)
            return cached[1]

    def memory_usage_bytes(self) -> int:
        return int(
            self.data.nbytes
            + self.deleted.nbytes
            + self.timestamps.nbytes
            + 64 * len(self.id_to_row)
        )
