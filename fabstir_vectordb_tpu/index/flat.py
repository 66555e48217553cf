"""Exact brute-force index: one masked distance matmul + top-k.

Three roles (SURVEY §7 step 1):
  - the recall oracle for IVF/HNSW parity checks (the reference computes
    ground truth the same way in evaluate_search_quality,
    src/ivf/operations.rs:329-391);
  - the feature-equivalent of the reference's WASM InMemoryIndex brute-force
    search (bindings/wasm/src/index.rs:122-161);
  - the small-dataset fast path.

The whole search is one [B, N] matmul + lax.top_k; soft-delete and
metadata-filter bitmasks are fused into selection.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.distance import pairwise_distance
from ..ops.topk import masked_topk
from ..utils import limits
from ..utils.padding import bucket, fit_mask
from .store import VectorStore


@partial(jax.jit, static_argnames=("k", "metric"))
def flat_search_kernel(x, x_sq, mask, q, k: int, metric: str = "euclidean"):
    """(x [N,D], x_sq [N], mask [N] or [B,N], q [B,D]) -> (dists [B,k], rows [B,k]).

    bf16-resident corpora run the matmul in bf16 with f32 accumulation
    (x_sq stays f32 from the host), matching the fused serving kernel.
    """
    compute = jnp.bfloat16 if x.dtype == jnp.bfloat16 else jnp.float32
    d = pairwise_distance(q, x, metric=metric, x_sq=x_sq, compute_dtype=compute)
    return masked_topk(d, mask, k)


class FlatIndex:
    """Brute-force exact index over a VectorStore."""

    def __init__(self, store: VectorStore, metric: str = "euclidean"):
        self.store = store
        self.metric = metric

    def search_rows(
        self,
        queries: np.ndarray,
        k: int,
        extra_mask: np.ndarray | None = None,
        dtype: str | None = None,
    ):
        """Returns (distances [B, k], rows [B, k]); rows are -1 beyond matches.

        Euclidean distances are returned as true (non-squared) distances.
        ``dtype`` pins the device-mirror dtype for this call; the default
        follows the serving regime (FVDB_SERVING_DTYPE). Note the mirror
        slot is shared — pinning a non-serving dtype evicts the serving
        mirror (``recall_at_k`` streams its own f32 oracle for exactly
        this reason).
        """
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        mirror = self.store.device(dtype=dtype or limits.serving_dtype())
        # mask reconciled to the mirror's row count: concurrent capacity
        # growth must not feed the kernel mismatched shapes
        n = int(mirror.x.shape[0])
        mask = self.store.active_mask(n)
        if extra_mask is not None:
            mask = mask & fit_mask(extra_mask, n)
        # bucket k to a power of two so jit kernels are shared across k values
        k_eff = min(bucket(k), n)
        d, rows = flat_search_kernel(
            mirror.x, mirror.x_sq, jnp.asarray(mask), jnp.asarray(queries),
            k_eff, self.metric,
        )
        d = np.asarray(d)[:, :k]
        rows = np.asarray(rows)[:, :k]
        k_eff = min(k, k_eff)
        if self.metric == "euclidean":
            d = np.sqrt(np.maximum(d, 0.0))
        if k_eff < k:  # pad to requested k
            pad = k - k_eff
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
            rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
        return d, rows

    def search(self, query: np.ndarray, k: int, extra_mask=None):
        """Single-query search -> list of (id, distance)."""
        d, rows = self.search_rows(np.asarray(query)[None, :], k, extra_mask)
        out = []
        for dist, row in zip(d[0], rows[0]):
            if row < 0:
                break
            vid = self.store.id_of(int(row))
            if vid is not None:
                out.append((vid, float(dist)))
        return out


def recall_at_k(
    oracle: FlatIndex, approx_rows: np.ndarray, queries: np.ndarray, k: int
) -> float:
    """Fraction of exact top-k rows recovered by an approximate search.

    Generalization of the reference's evaluate_search_quality recall
    computation (src/ivf/operations.rs:329-391) usable against any engine.
    The exact-f32 ground truth STREAMS over host tiles
    (``TieredFlatSearcher``) rather than forcing a f32 device mirror:
    the store caches exactly one mirror, so a f32 oracle upload under a
    bf16 serving regime would evict the serving mirror AND transiently
    double-reside the corpus in HBM (f32 + the still-pinned bf16 arrays —
    ~11.5 GB at 5M x 384, at exactly the scale bf16 serving exists for).
    """
    from .tiered import TieredFlatSearcher

    store = oracle.store
    count = store.count
    members = store.active_mask(count)
    _, exact = TieredFlatSearcher(store.data[:count], members).search(
        np.atleast_2d(np.asarray(queries, np.float32)), k)
    hits = 0
    total = 0
    for b in range(exact.shape[0]):
        truth = set(int(r) for r in exact[b] if r >= 0)
        got = set(int(r) for r in approx_rows[b] if r >= 0)
        hits += len(truth & got)
        total += len(truth)
    return hits / total if total else 1.0
