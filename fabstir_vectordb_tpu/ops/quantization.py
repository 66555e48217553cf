"""Vector quantization: u8 scalar quantization + Product Quantization (PQ).

Device replacement for the reference's quantization support
(reference: src/core/vector_ops.rs:349-578): u8 scalar quantization with
per-vector (min, scale) and a ProductQuantizer that k-means-trains a codebook
per subspace, encodes to code indices, and supports asymmetric distance
computation (ADC) via lookup tables — the matmul-friendly way to scan quantized
inverted lists.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# PQ tables/encodings are small; run their matmuls at full f32 precision so
# ADC lookups match exact reconstruction distances.
_HI = jax.lax.Precision.HIGHEST

from .kmeans import kmeans_train


@jax.jit
def quantize_u8(x: jax.Array):
    """Per-row u8 scalar quantization. Returns (codes u8 [N,D], mins [N], scales [N])."""
    mins = jnp.min(x, axis=-1)
    maxs = jnp.max(x, axis=-1)
    scales = jnp.where(maxs > mins, (maxs - mins) / 255.0, 1.0)
    codes = jnp.clip(
        jnp.round((x - mins[:, None]) / scales[:, None]), 0, 255
    ).astype(jnp.uint8)
    return codes, mins, scales


@jax.jit
def dequantize_u8(codes: jax.Array, mins: jax.Array, scales: jax.Array) -> jax.Array:
    return codes.astype(jnp.float32) * scales[:, None] + mins[:, None]


@dataclass(frozen=True)
class PQCodebook:
    """Trained PQ codebook: [M, K, Ds] centroids for M subspaces of width Ds."""

    centroids: jax.Array  # [M, K, Ds] f32
    dim: int

    @property
    def n_subspaces(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_codes(self) -> int:
        return self.centroids.shape[1]


def pq_train(
    key,
    x: np.ndarray | jax.Array,
    n_subspaces: int = 8,
    n_codes: int = 256,
    max_iterations: int = 25,
) -> PQCodebook:
    """Train per-subspace k-means codebooks (vmapped over subspaces)."""
    x = jnp.asarray(x, jnp.float32)
    n, d = x.shape
    if d % n_subspaces != 0:
        raise ValueError(f"dim {d} not divisible by n_subspaces {n_subspaces}")
    ds = d // n_subspaces
    k_eff = min(n_codes, n)
    sub = x.reshape(n, n_subspaces, ds).transpose(1, 0, 2)  # [M, N, Ds]
    mask = jnp.ones((n,), bool)
    keys = jax.random.split(key, n_subspaces)

    train = partial(kmeans_train, n_clusters=k_eff, max_iterations=max_iterations)
    results = jax.vmap(lambda kk, xx: train(kk, xx, mask))(keys, sub)
    cents = results.centroids  # [M, k_eff, Ds]
    if k_eff < n_codes:
        pad = jnp.repeat(cents[:, :1], n_codes - k_eff, axis=1)
        cents = jnp.concatenate([cents, pad], axis=1)
    return PQCodebook(centroids=cents, dim=d)


@jax.jit
def pq_encode(codebook_centroids: jax.Array, x: jax.Array) -> jax.Array:
    """Encode x [N, D] -> codes u8 [N, M] (nearest centroid per subspace)."""
    m, k, ds = codebook_centroids.shape
    n = x.shape[0]
    sub = x.reshape(n, m, ds).transpose(1, 0, 2)  # [M, N, Ds]

    def enc(c, xs):  # c [K, Ds], xs [N, Ds]
        d = (
            jnp.sum(xs * xs, -1)[:, None]
            - 2.0 * jnp.matmul(xs, c.T, precision=_HI)
            + jnp.sum(c * c, -1)[None, :]
        )
        return jnp.argmin(d, axis=-1)

    codes = jax.vmap(enc)(codebook_centroids, sub)  # [M, N]
    return codes.T.astype(jnp.uint8)


@jax.jit
def pq_decode(codebook_centroids: jax.Array, codes: jax.Array) -> jax.Array:
    """Decode codes u8 [N, M] -> approximate vectors [N, D]."""
    m = codebook_centroids.shape[0]
    parts = [codebook_centroids[j][codes[:, j].astype(jnp.int32)] for j in range(m)]
    return jnp.concatenate(parts, axis=-1)


@jax.jit
def pq_adc_table(codebook_centroids: jax.Array, q: jax.Array) -> jax.Array:
    """ADC lookup table for queries q [B, D] -> [B, M, K] squared distances."""
    m, k, ds = codebook_centroids.shape
    b = q.shape[0]
    qs = q.reshape(b, m, ds).transpose(1, 0, 2)  # [M, B, Ds]

    def table(c, qq):  # [K, Ds], [B, Ds] -> [B, K]
        return (
            jnp.sum(qq * qq, -1)[:, None]
            - 2.0 * jnp.matmul(qq, c.T, precision=_HI)
            + jnp.sum(c * c, -1)[None, :]
        )

    return jax.vmap(table)(codebook_centroids, qs).transpose(1, 0, 2)


@jax.jit
def pq_adc_distances(table: jax.Array, codes: jax.Array) -> jax.Array:
    """Sum table lookups: table [B, M, K], codes [N, M] -> sq dists [B, N]."""
    codes_i = codes.astype(jnp.int32)  # [N, M]
    # one_hot matmul keeps this a matmul instead of gather-bound.
    k = table.shape[-1]
    onehot = jax.nn.one_hot(codes_i, k, dtype=table.dtype)  # [N, M, K]
    return jnp.einsum("bmk,nmk->bn", table, onehot, precision=_HI)
