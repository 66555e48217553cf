"""Host-DRAM -> HBM tiered exact search (double-buffered tile streaming).

This rebuild's answer to the reference's beyond-RAM scaling stack (reference:
chunked storage + LRU ChunkCache + lazy ChunkLoader, SURVEY §2.10
"capacity scaling" row): when the corpus exceeds the single-chip HBM
budget, vectors stay in host DRAM (or memory-mapped chunk files) and
queries stream over fixed-size row tiles. Transfers and compute overlap
through JAX's async dispatch: tile t+1's `device_put` is issued while
tile t's masked distance matmul + top-k is still executing, so the scan
runs at max(HBM-copy bandwidth, matmul throughput) — double buffering
without explicit streams.

A running [B, k] top-k (values + global row ids) carries across tiles via
`merge_topk`; soft-delete / filter masks are per-tile slices fused into
selection, identical semantics to the resident path.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.distance import pairwise_distance
from ..ops.topk import masked_topk, merge_topk
from ..utils.padding import round_up


@partial(jax.jit, static_argnames=("k",), donate_argnums=(4, 5))
def _tile_step(x_tile, mask_tile, q, base, vals, rows, k: int):
    """One tile: distances + local top-k, merged into the running top-k.

    ``base`` (traced scalar) offsets local indices into global row space, so
    one compiled program serves every tile. The running (vals, rows) buffers
    are donated — the merge updates them in place on device.
    """
    d = pairwise_distance(q, x_tile)
    tvals, tidx = masked_topk(d, mask_tile, min(k, x_tile.shape[0]))
    trows = jnp.where(tidx >= 0, tidx + base, -1)
    if trows.shape[1] < k:  # tile smaller than k: pad
        pad = k - trows.shape[1]
        tvals = jnp.pad(tvals, ((0, 0), (0, pad)), constant_values=jnp.inf)
        trows = jnp.pad(trows, ((0, 0), (0, pad)), constant_values=-1)
    return merge_topk(vals, rows, tvals, trows, k)


class TieredFlatSearcher:
    """Exact search over a host-resident corpus streamed tile-by-tile.

    data: [N, D] float32 (numpy / np.memmap). mask: [N] bool or None.
    hbm_budget_bytes bounds device residency: tiles are sized to fit two
    in flight (compute + inbound copy).
    """

    def __init__(self, data: np.ndarray, mask: np.ndarray | None = None,
                 hbm_budget_bytes: int = 2 << 30, tile_rows: int | None = None):
        self.data = data
        self.n, self.dim = data.shape
        self.mask = np.ones(self.n, bool) if mask is None else mask
        if tile_rows is None:
            bytes_per_row = self.dim * 4
            tile_rows = max(1024, int(hbm_budget_bytes / 2 / bytes_per_row))
        # pad tiles to a fixed size so one compiled step serves all tiles
        self.tile_rows = min(round_up(tile_rows, 1024), round_up(self.n, 1024))
        self.n_tiles = (self.n + self.tile_rows - 1) // self.tile_rows

    def _host_tile(self, t: int):
        lo = t * self.tile_rows
        hi = min(lo + self.tile_rows, self.n)
        x = self.data[lo:hi]
        m = self.mask[lo:hi]
        if hi - lo < self.tile_rows:  # pad the tail tile to the fixed shape
            pad = self.tile_rows - (hi - lo)
            x = np.concatenate([x, np.zeros((pad, self.dim), np.float32)])
            m = np.concatenate([m, np.zeros(pad, bool)])
        return x, m, lo

    def search(self, queries: np.ndarray, k: int,
               extra_mask: np.ndarray | None = None,
               progress=None):
        """Returns (sq-dists [B, k], rows [B, k]); exact over active rows."""
        return jax.device_get(
            self.search_async(queries, k, extra_mask, progress=progress))

    def search_async(self, queries: np.ndarray, k: int,
                     extra_mask: np.ndarray | None = None,
                     progress=None):
        """Like search() but returns device arrays without blocking — all
        tile transfers/compute are dispatched; callers running several
        searchers (e.g. one per device) overlap them by deferring the get."""
        q = jnp.asarray(np.atleast_2d(np.asarray(queries, np.float32)))
        b = q.shape[0]
        vals = jnp.full((b, k), jnp.inf, jnp.float32)
        rows = jnp.full((b, k), -1, jnp.int32)

        mask = self.mask if extra_mask is None else (self.mask & extra_mask)
        old_mask, self.mask = self.mask, mask
        try:
            # prime the pipeline: issue tile 0's transfer
            nxt = self._put(0)
            for t in range(self.n_tiles):
                x_tile, m_tile, base = nxt
                if t + 1 < self.n_tiles:
                    # issue the NEXT transfer before blocking on compute
                    nxt = self._put(t + 1)
                vals, rows = _tile_step(
                    x_tile, m_tile, q, jnp.int32(base), vals, rows, k
                )
                if progress is not None:
                    # dispatch-side marker (transfer backpressure keeps it
                    # roughly in step with real device progress) — lets
                    # callers with a stall watchdog distinguish a slow
                    # streamed pass from a lost backend RPC
                    progress(t)
        finally:
            self.mask = old_mask
        return vals, rows

    def _put(self, t: int):
        x, m, lo = self._host_tile(t)
        # device_put is async: returns immediately with transfers in flight
        return jax.device_put(x), jax.device_put(m), lo


class MultiDeviceTieredSearcher:
    """Exact search over a host corpus streamed across SEVERAL devices.

    The beyond-total-HBM regime (SURVEY §7 step 8 per-shard tiering): rows
    partition across devices; each device independently double-buffers its
    own host->HBM tile stream (async dispatch overlaps every device's copy
    and compute with all the others'), keeps a running [B, k] top-k, and
    the per-device partials merge on the host at the end. No collectives —
    the merge axis is k*n_devices values per query, negligible.
    """

    def __init__(self, data: np.ndarray, mask: np.ndarray | None = None,
                 devices: list | None = None,
                 hbm_budget_bytes: int = 2 << 30,
                 tile_rows: int | None = None):
        self.devices = devices or jax.devices()
        n = data.shape[0]
        n_dev = len(self.devices)
        bounds = np.linspace(0, n, n_dev + 1).astype(np.int64)
        full_mask = np.ones(n, bool) if mask is None else mask
        self.shards = []
        for d, lo, hi in zip(self.devices, bounds[:-1], bounds[1:]):
            if hi <= lo:
                continue
            searcher = TieredFlatSearcher(
                data[lo:hi], full_mask[lo:hi],
                hbm_budget_bytes=hbm_budget_bytes, tile_rows=tile_rows,
            )
            self.shards.append((d, searcher, int(lo)))

    def search(self, queries: np.ndarray, k: int):
        """Returns (sq-dists [B, k], rows [B, k]) over the global corpus."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        pending = []
        # dispatch every shard's full tile pipeline before blocking on any —
        # devices stream and compute concurrently
        for dev, searcher, base in self.shards:
            with jax.default_device(dev):
                pending.append((searcher.search_async(q, k), base))
        partials = []
        for (vals_d, rows_d), base in pending:
            vals, rows = jax.device_get((vals_d, rows_d))
            partials.append((vals, np.where(rows >= 0, rows + base, -1)))
        all_vals = np.concatenate([p[0] for p in partials], axis=1)
        all_rows = np.concatenate([p[1] for p in partials], axis=1)
        order = np.argsort(all_vals, axis=1, kind="stable")[:, :k]
        return (
            np.take_along_axis(all_vals, order, axis=1),
            np.take_along_axis(all_rows, order, axis=1),
        )
