"""Mesh-parallel ingest: multi-chip index BUILD, not just serving.

The single-chip build (index/hnsw.py::insert_rows) is bottlenecked by one
device's candidate program at scale; serving already shards across chips
(parallel/sharded.py) but the build path did not. Here the exact-candidate
scan — the device-dominant phase of HNSW linking — runs row-sharded over a
``jax.sharding.Mesh``: each chip scans only its shard of the corpus for
each 1024-row link batch, partial top-ef pools merge over the device
interconnect (all_gather + fused top-k, the same collective shape as
sharded serving),
and the host links from the merged pool with the SAME linker as the
single-chip path. IVF ingest parallelizes the same way: training is
``sharded_kmeans_train`` (data-parallel Lloyd with psum'd centroid
updates) and bulk cluster assignment shards rows across the mesh.

Because per-shard selection is exact (``select="exact"``) the merged
candidate pool — and therefore the built graph — is INVARIANT to the mesh
size: build on 8 chips, 2 chips, or 1 chip and the adjacency arrays are
bit-identical (tested), provided ef <= rows/device so no shard's true
candidates are truncated (any real corpus satisfies this by orders of
magnitude). ``select="approx"`` swaps each shard's top-ef for a wider
pool + exact refine (the sharded twin of turbo flat selection).

Reference analog: the reference has no distributed build at all (its
parallelism is tokio tasks in one process, SURVEY §2.10); this is the
capability its architecture could not express.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.padding import bucket, round_up
from .sharded import sharded_flat_search

__all__ = ["ShardedBuilder", "sharded_assign_clusters"]


@jax.jit
def _set_rows_true(mask, rows):
    """Scatter True at ``rows`` on a (possibly sharded) device mask."""
    return mask.at[rows].set(True)


def sharded_assign_clusters(mesh: Mesh, axis: str = "data"):
    """Builds a jitted data-parallel nearest-centroid assignment.

    Returns fn(x [N, D] row-sharded, centroids [C, D] replicated) ->
    assignments [N] int32, sharded like the rows. This is the bulk-insert
    phase of IVF ingest (reference: src/ivf/core.rs:431-491 assigns one
    vector at a time on the host): each chip assigns only its own rows —
    no collectives needed, the row axis IS the parallelism.
    """
    from ..ops.distance import pairwise_distance

    def body(x, centroids):
        d = pairwise_distance(x, centroids)
        return jnp.argmin(d, axis=1).astype(jnp.int32)

    n_dev = mesh.shape[axis]
    f = jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis), P()),
            out_specs=P(axis),
            check_vma=False,
        )
    )

    def run(x, centroids):
        n = int(x.shape[0])
        pad = round_up(n, n_dev) - n
        if pad == 0:
            return f(x, centroids)
        if not isinstance(x, np.ndarray):
            raise ValueError(
                f"row count {n} must divide by the {n_dev}-device mesh for "
                "pre-sharded inputs; pass a host array to get padded "
                "automatically"
            )
        xp = np.concatenate(
            [x, np.zeros((pad, x.shape[1]), x.dtype)], axis=0)
        return f(xp, centroids)[:n]

    return run


class ShardedBuilder:
    """Drives a mesh-parallel HNSW build into an existing ``HNSWIndex``.

    The index's host state (adjacency, levels, entry point) stays the
    single source of truth; only the candidate search is lifted onto the
    mesh. The device corpus shards once per build (rows must already be in
    the VectorStore) and the member mask is scatter-updated per batch — a
    tiny replicated index upload, never a mask re-upload.

    Usage::

        builder = ShardedBuilder(hnsw, mesh)
        builder.insert_rows(rows)          # same contract as hnsw.insert_rows
    """

    def __init__(self, hnsw, mesh: Mesh, axis: str = "data",
                 select: str = "exact"):
        self.hnsw = hnsw
        self.mesh = mesh
        self.axis = axis
        n_dev = mesh.shape[axis]
        ef = hnsw.config.ef_construction
        self._search = sharded_flat_search(
            mesh, axis, select=select, oversample=2 * ef)
        self._n_dev = n_dev
        self._x = None
        self._x_sq = None
        self._mask = None
        self._n_pad = 0
        self._corpus_key = None  # (store version, capacity) of the upload

    # ------------------------------------------------------------- corpus
    def _upload_corpus(self) -> None:
        """Shard the store's row prefix over the mesh (re-uploaded whenever
        the store's version changes — rows added between builds must not
        be scanned as the zeros their slots held at the last upload)."""
        store = self.hnsw.store
        n_pad = round_up(store.capacity, self._n_dev)
        shard = NamedSharding(self.mesh, P(self.axis))
        x = store.data
        if n_pad > x.shape[0]:
            x = np.concatenate(
                [x, np.zeros((n_pad - x.shape[0], x.shape[1]), x.dtype)])
        self._x = jax.device_put(x, shard)
        self._x_sq = jax.device_put(
            np.einsum("nd,nd->n", x, x).astype(np.float32), shard)
        mask = np.zeros(n_pad, bool)
        m = self.hnsw._search_mask()
        mask[: len(m)] = m
        self._mask = jax.device_put(mask, shard)
        self._n_pad = n_pad
        self._corpus_key = (store._version, store.capacity)

    # -------------------------------------------------------------- build
    def insert_rows(self, rows: np.ndarray, sub_batch: int = 1024) -> None:
        """Insert store rows into the graph, candidate search on the mesh.

        Bootstrap (graph smaller than ``bootstrap_threshold``) delegates to
        the host exact path — identical to the single-chip builder — then
        post-bootstrap batches run the sharded candidate program.
        """
        hnsw = self.hnsw
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        hnsw._ensure_capacity()
        cfg = hnsw.config

        boot = max(0, cfg.bootstrap_threshold + 1 - hnsw.num_nodes)
        if boot > 0:
            head, rows = rows[:boot], rows[boot:]
            hnsw.insert_rows(head)
            if rows.size == 0:
                return

        store = hnsw.store
        if (self._x is None
                or self._corpus_key != (store._version, store.capacity)):
            # version change covers rows added/overwritten since the last
            # build — scanning their slots as the stale upload's zeros
            # would silently link by distance-to-origin
            self._upload_corpus()
        else:
            # same corpus bytes: just reconcile the device mask to host
            # membership (rows linked by the bootstrap path above)
            m = hnsw._search_mask()
            mask = np.zeros(self._n_pad, bool)
            mask[: len(m)] = m
            self._mask = jax.device_put(
                mask, NamedSharding(self.mesh, P(self.axis)))

        ef = cfg.ef_construction
        for lo in range(0, rows.size, sub_batch):
            batch = rows[lo: lo + sub_batch]
            levels_new = np.array(
                [hnsw._sample_level() for _ in batch], np.int32)
            n_real = batch.size
            b_pad = bucket(n_real, minimum=1)
            padded = batch
            if b_pad > n_real:
                padded = np.concatenate(
                    [batch, np.repeat(batch[:1], b_pad - n_real)])
            q = jnp.asarray(hnsw.store.data[padded])
            vals, ids = self._search(self._x, self._x_sq, self._mask, q, ef)
            vals = np.asarray(vals)[:n_real]
            ids = np.asarray(ids, np.int64)[:n_real]
            kept = hnsw._kept_host(ids, vals, cfg.m0)
            hnsw._link_batch(
                batch, levels_new,
                {"mode": "exact", "ids": ids, "dists": vals, "kept": kept},
            )
            hnsw._version += 1
            idx = np.empty(bucket(n_real, minimum=1), np.int32)
            idx[:n_real] = batch
            idx[n_real:] = batch[0]  # idempotent pad
            self._mask = _set_rows_true(self._mask, jnp.asarray(idx))
