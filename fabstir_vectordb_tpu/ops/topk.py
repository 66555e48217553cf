"""Masked top-k selection and streaming top-k merges.

Device replacement for the reference's heap/sort top-k and StreamingTopK
(reference: src/core/vector_ops.rs:12-22,180-263). Smaller distance = better
everywhere; invalid entries are masked to +inf and surface with index -1.

Soft-deletes and metadata-filter bitmasks are ANDed into ``mask`` so deletion
filtering is fused into selection rather than post-filtered (SURVEY §7).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

INF = jnp.float32(jnp.inf)


@partial(jax.jit, static_argnames=("k",))
def masked_topk(dists: jax.Array, mask: jax.Array, k: int):
    """Exact top-k smallest distances where mask is True.

    dists: [B, N] f32; mask: [N] or [B, N] bool.
    Returns (vals [B, k] f32 with +inf padding, idx [B, k] int32 with -1 padding).

    The one selection of the package: every candidate pool (HNSW link
    candidates, turbo and reduced-rank stage-1 pools, sharded pools) uses
    it too. ``lax.approx_min_k`` was the pool selection before; on the GPU
    it lowers to the same sort as ``lax.top_k``, and on an H100 the two
    timed alike at every caller's shape (scripts/bench_selection.py), so
    only the exact one is kept.
    """
    if mask.ndim == 1:
        mask = mask[None, :]
    masked = jnp.where(mask, dists, INF)
    neg_vals, idx = jax.lax.top_k(-masked, k)
    vals = -neg_vals
    valid = jnp.isfinite(vals)
    return jnp.where(valid, vals, INF), jnp.where(valid, idx, -1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k",))
def merge_topk(vals_a, idx_a, vals_b, idx_b, k: int):
    """Merge two top-k result sets (same convention as masked_topk)."""
    vals = jnp.concatenate([vals_a, vals_b], axis=-1)
    idx = jnp.concatenate([idx_a, idx_b], axis=-1)
    neg_vals, pos = jax.lax.top_k(-vals, k)
    out_vals = -neg_vals
    out_idx = jnp.take_along_axis(idx, pos, axis=-1)
    valid = jnp.isfinite(out_vals)
    return jnp.where(valid, out_vals, INF), jnp.where(valid, out_idx, -1)


def chunked_topk(dist_fn, n_total: int, chunk: int, k: int, batch: int):
    """Build a jittable streaming top-k over row chunks of a large corpus.

    ``dist_fn(start)`` must return ([B, chunk] distances, [B, chunk] or [chunk]
    mask) for rows [start, start+chunk). Scans chunks with lax.fori_loop,
    keeping a running [B, k] result — the device-side analog of the
    reference's StreamingTopK min-heap, but vectorized per chunk.
    """
    n_chunks = (n_total + chunk - 1) // chunk

    def run():
        init_vals = jnp.full((batch, k), INF, jnp.float32)
        init_idx = jnp.full((batch, k), -1, jnp.int32)

        def body(i, carry):
            vals, idx = carry
            start = i * chunk
            d, m = dist_fn(start)
            cvals, cidx = masked_topk(d, m, min(k, chunk))
            cidx = jnp.where(cidx >= 0, cidx + start, -1)
            return merge_topk(vals, idx, cvals, cidx, k)

        return jax.lax.fori_loop(0, n_chunks, body, (init_vals, init_idx))

    return run


class StreamingTopK:
    """Host-side streaming top-k accumulator over result chunks.

    The driver-loop analog of the reference's min-heap StreamingTopK
    (reference: src/core/vector_ops.rs:204-263): push (distance, id) pairs
    — or whole chunk results from device scans — and read back the k best
    seen so far. Device-side streaming lives in ``chunked_topk``; this class
    serves host orchestration (e.g. merging per-chunk results arriving
    asynchronously from multiple device programs).
    """

    def __init__(self, k: int):
        import heapq  # noqa: F401  (documents the structure)

        if k <= 0:
            raise ValueError("k must be positive")
        self.k = k
        self._heap: list = []  # max-heap via negated distance
        self._counter = 0  # tiebreak: insertion order, avoids comparing ids

    def push(self, distance: float, item) -> None:
        import heapq

        entry = (-float(distance), self._counter, item)
        self._counter += 1
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, entry)
        elif entry[0] > self._heap[0][0]:  # smaller distance than current worst
            heapq.heapreplace(self._heap, entry)

    def push_many(self, distances, items) -> None:
        for d, it in zip(distances, items):
            self.push(float(d), it)

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def worst(self) -> float:
        """Largest distance currently kept (+inf when not yet full)."""
        if len(self._heap) < self.k:
            return float("inf")
        return -self._heap[0][0]

    def results(self) -> list:
        """[(distance, item)] ascending by distance."""
        out = sorted(self._heap, key=lambda e: (-e[0], e[1]))
        return [(-d, item) for d, _, item in out]
