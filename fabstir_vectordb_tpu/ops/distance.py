"""Batched distance kernels as matmuls.

Device replacement for the reference's scalar/AVX2 distance loops
(reference: src/core/vector_ops.rs:35-136). Instead of per-pair SIMD loops,
all distances are computed as one batched matmul ``Q @ X.T`` plus norm terms,
which XLA hands to the matrix units.

Distance conventions (matching the reference engines):
  - "euclidean": HNSW/IVF ordering metric (src/hnsw/core.rs:691-697). We keep
    *squared* L2 inside kernels (same ordering, no sqrt in the hot loop) and
    take sqrt only at the API boundary.
  - "cosine": 1 - cos(q, x) (reference Embedding::cosine, src/core/types.rs:79-120).
  - "dot": negative inner product (smaller = better, uniform convention).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

METRICS = ("euclidean", "cosine", "dot")


def squared_norms(x: jax.Array) -> jax.Array:
    """Row-wise squared L2 norms, shape [N]."""
    return jnp.sum(x.astype(jnp.float32) * x.astype(jnp.float32), axis=-1)


def _matmul(q: jax.Array, x: jax.Array, compute_dtype) -> jax.Array:
    """q [B, D] @ x.T [D, N] -> [B, N], f32 accumulation.

    For f32 inputs we request HIGHEST precision (full f32, never TF32) so
    the norm-expansion distance formulation stays accurate and ranks like
    the CPU; bf16 compute_dtype is the fast path with f32 accumulation.
    """
    precision = (
        jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32 else None
    )
    return jax.lax.dot_general(
        q.astype(compute_dtype),
        x.astype(compute_dtype),
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )


def pairwise_dot(q: jax.Array, x: jax.Array, compute_dtype=jnp.float32) -> jax.Array:
    """Inner products: [B, D] x [N, D] -> [B, N]."""
    return _matmul(q, x, compute_dtype)


def pairwise_sq_l2(
    q: jax.Array,
    x: jax.Array,
    x_sq: jax.Array | None = None,
    compute_dtype=jnp.float32,
) -> jax.Array:
    """Squared euclidean distances [B, N] via |q|^2 - 2 q.x + |x|^2.

    ``x_sq`` may be precomputed (index-resident) to skip the reduction.
    Clamped at 0 to absorb cancellation error.
    """
    if x_sq is None:
        x_sq = squared_norms(x)
    q_sq = squared_norms(q)
    d = q_sq[:, None] - 2.0 * _matmul(q, x, compute_dtype) + x_sq[None, :]
    return jnp.maximum(d, 0.0)


def pairwise_cosine_dist(
    q: jax.Array,
    x: jax.Array,
    x_sq: jax.Array | None = None,
    compute_dtype=jnp.float32,
) -> jax.Array:
    """Cosine distances 1 - cos(q, x), zero-norm rows treated as orthogonal."""
    if x_sq is None:
        x_sq = squared_norms(x)
    q_sq = squared_norms(q)
    dots = _matmul(q, x, compute_dtype)
    denom = jnp.sqrt(jnp.maximum(q_sq[:, None] * x_sq[None, :], 1e-30))
    return 1.0 - dots / denom


@partial(jax.jit, static_argnames=("metric", "compute_dtype"))
def pairwise_distance(
    q: jax.Array,
    x: jax.Array,
    metric: str = "euclidean",
    x_sq: jax.Array | None = None,
    compute_dtype=jnp.float32,
) -> jax.Array:
    """Dispatch on metric; euclidean returns *squared* L2 (ordering-equivalent)."""
    if metric == "euclidean":
        return pairwise_sq_l2(q, x, x_sq, compute_dtype)
    if metric == "cosine":
        return pairwise_cosine_dist(q, x, x_sq, compute_dtype)
    if metric == "dot":
        return -pairwise_dot(q, x, compute_dtype)
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")


def finalize_distance(d: jax.Array, metric: str) -> jax.Array:
    """Convert internal kernel distance to the user-facing distance."""
    if metric == "euclidean":
        return jnp.sqrt(jnp.maximum(d, 0.0))
    return d


def inner_product_to_cosine(ip, a: jax.Array, b: jax.Array) -> jax.Array:
    """Correct a raw inner product into cosine similarity; 0 where either
    vector has zero norm (reference: src/core/vector_ops.rs:581-589)."""
    denom = jnp.linalg.norm(a, axis=-1) * jnp.linalg.norm(b, axis=-1)
    return jnp.where(denom > 0, ip / jnp.maximum(denom, 1e-30), 0.0)


def angular_distance(a: jax.Array, b: jax.Array) -> jax.Array:
    """arccos of clamped cosine similarity
    (reference: src/core/vector_ops.rs:591-596)."""
    ip = jnp.sum(a * b, axis=-1)
    cos = inner_product_to_cosine(ip, a, b)
    return jnp.arccos(jnp.clip(cos, -1.0, 1.0))
