"""On-device k-means (k-means++ init + Lloyd) for the IVF coarse quantizer.

Device replacement for the reference's scalar k-means
(reference: src/ivf/core.rs:240-371): assignment is one [N, C] distance
matmul + argmin; the centroid update is a one-hot matmul
(segment-sum); k-means++ seeding is a lax.scan with an incrementally
maintained min-distance table (O(C·N·D) total, all batched).

Supports masked rows (padding / deleted vectors excluded from training).
Convergence criterion mirrors the reference: relative error change < 1e-4,
max 25 iterations by default (src/ivf/core.rs:42-60,286-322).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .distance import pairwise_sq_l2, squared_norms


class TrainResult(NamedTuple):
    centroids: jax.Array  # [C, D] f32
    iterations: jax.Array  # scalar int32
    converged: jax.Array  # scalar bool
    final_error: jax.Array  # scalar f32 (mean squared assignment distance)


@partial(jax.jit, static_argnames=("n_clusters",))
def kmeans_pp_init(key, x, mask, n_clusters: int):
    """k-means++ seeding over valid rows of x [N, D], mask [N] bool.

    Each step samples the next centroid with probability proportional to the
    squared distance to the nearest already-chosen centroid.
    """
    n = x.shape[0]
    x_sq = squared_norms(x)
    neg_mask_inf = jnp.where(mask, 0.0, jnp.inf)

    key, sub = jax.random.split(key)
    # First centroid: uniform over valid rows.
    logits = jnp.where(mask, 0.0, -jnp.inf)
    first = jax.random.categorical(sub, logits)
    first_c = x[first]

    d2 = pairwise_sq_l2(first_c[None, :], x, x_sq)[0] + neg_mask_inf
    d2 = jnp.where(mask, d2, 0.0)  # invalid rows carry zero weight

    def step(carry, k_step):
        d2, key = carry
        key, sub = jax.random.split(key)
        # Sample proportional to d2 (categorical over log weights).
        logw = jnp.where(mask & (d2 > 0), jnp.log(jnp.maximum(d2, 1e-30)), -jnp.inf)
        # Fallback: if all distances are zero (duplicate data), sample uniform.
        any_pos = jnp.any(jnp.isfinite(logw))
        logw = jnp.where(any_pos, logw, jnp.where(mask, 0.0, -jnp.inf))
        pick = jax.random.categorical(sub, logw)
        c = x[pick]
        new_d2 = pairwise_sq_l2(c[None, :], x, x_sq)[0]
        d2 = jnp.where(mask, jnp.minimum(d2, new_d2), 0.0)
        return (d2, key), c

    (_, _), rest = jax.lax.scan(step, (d2, key), jnp.arange(1, n_clusters))
    return jnp.concatenate([first_c[None, :], rest], axis=0)


def assign_clusters(x, centroids, mask=None, c_sq=None):
    """Nearest-centroid assignment. Returns (assign [N] int32, d2 [N] f32).

    Invalid rows get assignment -1 and distance 0.
    """
    d = pairwise_sq_l2(x, centroids, c_sq)  # [N, C]
    assign = jnp.argmin(d, axis=1).astype(jnp.int32)
    d2 = jnp.take_along_axis(d, assign[:, None].astype(jnp.int32), axis=1)[:, 0]
    if mask is not None:
        assign = jnp.where(mask, assign, -1)
        d2 = jnp.where(mask, d2, 0.0)
    return assign, d2


def lloyd_step(x, mask, centroids):
    """One Lloyd iteration: assign + one-hot-matmul centroid update.

    Empty clusters keep their previous centroid (reference behavior:
    src/ivf/core.rs update step skips empty clusters).
    Returns (new_centroids, mean_sq_error).
    """
    c = centroids.shape[0]
    assign, d2 = assign_clusters(x, centroids, mask)
    onehot = jax.nn.one_hot(assign, c, dtype=jnp.float32)  # [-1 rows -> all zero]
    counts = jnp.sum(onehot, axis=0)  # [C]
    sums = jax.lax.dot_general(
        onehot, x.astype(jnp.float32),
        dimension_numbers=(((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [C, D]
    new_centroids = jnp.where(
        counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), centroids
    )
    n_valid = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
    err = jnp.sum(d2) / n_valid
    return new_centroids, err


_lloyd_step_jit = jax.jit(lloyd_step)


@partial(jax.jit, static_argnames=("steps",))
def _lloyd_block(x, mask, cents, steps: int):
    """``steps`` Lloyd iterations in ONE program, stacking every
    intermediate (centroids, error) so the host can stop at the exact
    iteration the per-step loop would have: one device round-trip does
    the work of ``steps``. The stacked centroids are [steps, C, D] f32 (~2 MB at C=256, D=384)."""

    def body(c, _):
        nc, err = lloyd_step(x, mask, c)
        return nc, (nc, err)

    _, (all_c, errs) = jax.lax.scan(body, cents, None, length=steps)
    return all_c, errs


@jax.jit
def _scalable_first(key, x, mask):
    """First kmeans|| pick + initial min-distance table (one program)."""
    x_sq = squared_norms(x)
    logits = jnp.where(mask, 0.0, -jnp.inf)
    first = jax.random.categorical(key, logits)
    d2 = pairwise_sq_l2(x[first][None, :], x, x_sq)[0]
    return x_sq, jnp.where(mask, d2, 0.0), x[first]


@jax.jit
def _scalable_weights(x, mask, cand):
    """Candidate weights = attracted population (one program)."""
    dc = pairwise_sq_l2(x, cand)  # [N, C]
    nearest = jnp.argmin(dc, axis=1)
    return jnp.bincount(
        jnp.where(mask, nearest, cand.shape[0]), length=cand.shape[0] + 1
    )[: cand.shape[0]]


@partial(jax.jit, static_argnames=("l",))
def _scalable_round(key, x, x_sq, mask, d2, l: int):
    """One kmeans|| round: Gumbel-top-l weighted sample (without
    replacement, proportional to d2) + min-distance table update.
    Returns (new_d2, cand [l, D], cand_rows [l])."""
    logw = jnp.where(mask & (d2 > 0), jnp.log(jnp.maximum(d2, 1e-30)), -jnp.inf)
    g = jax.random.gumbel(key, logw.shape)
    _, rows = jax.lax.top_k(logw + g, l)
    cand = x[rows]
    dc = pairwise_sq_l2(cand, x, x_sq)  # [l, N]
    d2 = jnp.where(mask, jnp.minimum(d2, jnp.min(dc, axis=0)), 0.0)
    return d2, cand, rows


def _weighted_kmeanspp_host(cand: np.ndarray, w: np.ndarray, k: int,
                            rng: np.random.Generator) -> np.ndarray:
    """Classic k-means++ over a small weighted candidate set (host numpy)."""
    c_n = cand.shape[0]
    first = int(rng.choice(c_n, p=w / w.sum()))
    chosen = [first]
    d2 = ((cand - cand[first]) ** 2).sum(1)
    for _ in range(1, k):
        p = w * d2
        s = p.sum()
        if not np.isfinite(s) or s <= 0:
            nxt = int(rng.integers(0, c_n))
        else:
            nxt = int(rng.choice(c_n, p=p / s))
        chosen.append(nxt)
        nd = ((cand - cand[nxt]) ** 2).sum(1)
        np.minimum(d2, nd, out=d2)
    return cand[np.asarray(chosen)]


def kmeans_scalable_init(key, x, mask, n_clusters: int, rounds: int = 5,
                         oversample: int = 8) -> jax.Array:
    """kmeans|| seeding (Bahmani et al., VLDB'12) — the compile-friendly
    k-means++ replacement.

    ``kmeans_pp_init``'s C-step lax.scan is one long program to compile
    per shape; this runs ``rounds`` small programs
    (one [l, N] distance matmul + Gumbel-top-l weighted sample each,
    static shapes), weights the ~rounds*oversample*k candidates by cluster
    population, and finishes with exact weighted k-means++ on that small
    set host-side. Seeding quality >= k-means++ at these sizes.
    """
    from ..utils import progress

    l = max(n_clusters * oversample // rounds, 1)
    key, sub = jax.random.split(key)
    x_sq, d2, first_c = _scalable_first(sub, x, mask)
    progress.mark()

    cands = [first_c[None, :]]
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        d2, cand, _ = _scalable_round(sub, x, x_sq, mask, d2, l)
        cands.append(cand)
        progress.mark()  # one completed round-trip per round
    cand = jnp.concatenate(cands, axis=0)  # [1 + rounds*l, D]

    # weight candidates by the population they attract (one assignment pass)
    w = _scalable_weights(x, mask, cand)

    cand_np = np.asarray(cand, np.float32)
    w_np = np.asarray(w, np.float64) + 1e-9
    seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1]) & 0x7FFFFFFF
    rng = np.random.default_rng(seed)
    return jnp.asarray(_weighted_kmeanspp_host(cand_np, w_np, n_clusters, rng))


def kmeans_train_stepped(
    key,
    x,
    mask,
    n_clusters: int,
    max_iterations: int = 25,
    tol: float = 1e-4,
) -> TrainResult:
    """Host-driven twin of kmeans_train: pp_init + one jitted Lloyd step per
    host iteration, convergence checked host-side.

    Same update rule and stopping rule, but seeded by kmeans|| (see
    kmeans_scalable_init — quality >= k-means++) and compiled as SMALL
    programs instead of one scan+while_loop giant: on remote-compile
    targets the monolithic program costs minutes per compile (and a
    corrupted cached executable of it once wedged the device); the
    blocked form (5 Lloyd iterations per dispatch, every intermediate
    stacked) compiles in seconds and costs at most ceil(25/5)+1 device
    round-trips. Convergence is decided host-side from the per-step
    error vector, stopping at EXACTLY the iteration the one-step-per-
    round-trip loop would have (same centroids, same count).
    """
    from ..utils import progress

    block = 5
    cents = kmeans_scalable_init(key, x, mask, n_clusters)
    last_err = float("inf")
    i = 0
    converged = False
    err = jnp.float32(0.0)
    while i < max_iterations and not converged:
        steps = min(block, max_iterations - i)
        all_c, errs = _lloyd_block(x, mask, cents, steps)
        errs_h = np.asarray(errs, np.float64)
        progress.mark()  # one Lloyd block done
        stop = None
        for j in range(steps):
            err_f = float(errs_h[j])
            if (i + j > 0
                    and abs(last_err - err_f) / max(last_err, 1e-30) < tol):
                converged = True
                stop = j
                break
            last_err = err_f
        j = steps - 1 if stop is None else stop
        cents = all_c[j]
        err = errs[j]
        i += j + 1
    return TrainResult(
        cents, jnp.int32(i), jnp.bool_(converged), jnp.float32(err)
    )


@partial(jax.jit, static_argnames=("n_clusters", "max_iterations"))
def kmeans_train(
    key,
    x,
    mask,
    n_clusters: int,
    max_iterations: int = 25,
    tol: float = 1e-4,
) -> TrainResult:
    """Full k-means training loop with early convergence, on device."""
    init = kmeans_pp_init(key, x, mask, n_clusters)

    def cond(state):
        i, _, _, done = state
        return (i < max_iterations) & (~done)

    def body(state):
        i, cents, last_err, _ = state
        new_cents, err = lloyd_step(x, mask, cents)
        rel = jnp.abs(last_err - err) / jnp.maximum(last_err, 1e-30)
        done = (i > 0) & (rel < tol)
        return i + 1, new_cents, err, done

    i0 = jnp.int32(0)
    big = jnp.float32(jnp.finfo(jnp.float32).max)
    i, cents, err, done = jax.lax.while_loop(
        cond, body, (i0, init, big, jnp.bool_(False))
    )
    return TrainResult(cents, i, done, err)
