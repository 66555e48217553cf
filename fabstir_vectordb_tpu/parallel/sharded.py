"""Multi-chip sharded search + training over a jax.sharding.Mesh.

New capability vs the reference (its only "distributed backend" is HTTP to
an S5 portal, SURVEY §2.10): inverted lists and the flat corpus shard across
chips; queries can shard across a second mesh axis (data parallelism);
partial top-k results merge with an all_gather over the device
interconnect and a final fused
top-k — the collective top-k merge design from SURVEY §7 step 8.

Everything is shard_map'd SPMD so XLA inserts the collectives:
  - ``sharded_flat_search``: corpus rows sharded; per-device masked
    distance matmul + local top-k; all_gather(k per device) + global top-k.
  - ``sharded_ivf_search``: cluster tiles (vectors materialized per list)
    sharded over the list axis; replicated centroid ranking; each device
    scans only its probed∩owned lists; all_gather + merge.
  - ``sharded_lloyd_step`` / ``sharded_kmeans_train``: training rows
    sharded; one-hot matmul partial sums psum'd into replicated centroids —
    the "training step" of a vector database.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.distance import pairwise_distance
from ..ops.kmeans import kmeans_scalable_init
from ..ops.topk import masked_topk, merge_topk
from ..utils import limits
from ..utils.padding import round_up

# --------------------------------------------------------------------------
# Flat (exact) sharded search
# --------------------------------------------------------------------------


def sharded_flat_search(mesh: Mesh, axis: str = "data",
                        select: str = "exact", oversample: int = 128,
                        query_axis: str | None = None):
    """Builds a jitted exact search over a row-sharded corpus.

    Returns fn(x [N, D] sharded, x_sq [N], mask [N], q [B, D] replicated, k)
    -> (dists [B, k], rows [B, k]) replicated. N must divide evenly by the
    axis size (pad with mask=False rows).

    ``select="approx"`` is the multi-chip twin of the single-chip turbo
    flat mode (FVDB_FLAT_SELECT, index/fused.py::flat_search_rerank_kernel):
    each shard picks an ``oversample``-wide pool from its local rows and
    re-scores the pool exactly in f32 BEFORE the merge, so only
    [n_dev, B, k] candidates cross the interconnect either way.

    ``query_axis`` (2D mesh) additionally shards the QUERY batch: rows
    shard over ``axis``, queries over ``query_axis`` (B divisible by its
    size), results come back query-sharded. Capacity scaling and serving
    data-parallelism compose on one mesh — the all_gather still runs only
    over the row axis, so interconnect traffic per query is unchanged.
    """
    if select not in ("exact", "approx"):
        raise ValueError(f"select must be exact|approx, got {select}")
    qspec = P(query_axis) if query_axis else P()

    def body(x, x_sq, mask, q, k: int):
        n_local = x.shape[0]
        idx = jax.lax.axis_index(axis)
        d = pairwise_distance(q, x, x_sq=x_sq)
        if select == "approx" and n_local > k:
            ov = min(max(oversample, 4 * k), n_local)
            _, cand = masked_topk(d, mask, ov)
            # exact f32 refine of the local pool (difference form — same
            # squared-distance convention as the scan above)
            xg = x[jnp.maximum(cand, 0)].astype(jnp.float32)
            diff = xg - q[:, None, :].astype(jnp.float32)
            dr = jnp.sum(diff * diff, axis=-1)
            dr = jnp.where(cand >= 0, dr, jnp.inf)
            neg, pos = jax.lax.top_k(-dr, min(k, n_local))
            vals = jnp.where(jnp.isfinite(neg), -neg, jnp.inf)
            rows = jnp.where(
                jnp.isfinite(neg),
                jnp.take_along_axis(cand, pos, axis=1), -1)
        else:
            vals, rows = masked_topk(d, mask, min(k, n_local))
        rows = jnp.where(rows >= 0, rows + idx * n_local, -1)
        # gather each device's top-k and merge
        all_vals = jax.lax.all_gather(vals, axis)  # [n_dev, B, k]
        all_rows = jax.lax.all_gather(rows, axis)
        nd, b, kk = all_vals.shape
        all_vals = jnp.transpose(all_vals, (1, 0, 2)).reshape(b, nd * kk)
        all_rows = jnp.transpose(all_rows, (1, 0, 2)).reshape(b, nd * kk)
        neg, pos = jax.lax.top_k(-all_vals, k)
        out_rows = jnp.take_along_axis(all_rows, pos, axis=1)
        return -neg, out_rows

    @partial(jax.jit, static_argnames=("k",))
    def run(x, x_sq, mask, q, k: int):
        f = jax.shard_map(
            partial(body, k=k),
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), qspec),
            out_specs=(qspec, qspec),
            check_vma=False,  # outputs replicated via all_gather+top_k
        )
        return f(x, x_sq, mask, q)

    return run


def sharded_projected_search(mesh: Mesh, axis: str = "data"):
    """Row-sharded reduced-rank stage 1 (multi-chip twin of the single-chip
    PCA regime, see index/fused.py::FusedSearcher._projected_dispatch).

    Returns fn(xp [N, rank] bf16 sharded, xp_sq [N], mask [N], mu [D],
    p [D, rank], q [B, D] replicated, ov_k) -> (approx sq-dists, rows)
    replicated — the top ov_k stage-1 candidates. Queries project on
    device; each chip scans only its row shard of the compressed mirror;
    partial top-k merge across devices. The caller reranks the candidates
    against the full-precision corpus (host-resident at these scales),
    exactly like the single-chip regime.
    """
    flat = sharded_flat_search(mesh, axis)

    @partial(jax.jit, static_argnames=("ov_k",))
    def run(xp, xp_sq, mask, mu, p, q, ov_k: int):
        # default precision: the caller reranks the pool exactly in f32
        qp = jnp.matmul(q - mu, p, precision=jax.lax.Precision.DEFAULT
                        ).astype(xp.dtype)
        return flat(xp, xp_sq, mask, qp, ov_k)

    return run


# --------------------------------------------------------------------------
# Sharded IVF
# --------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("centroids", "list_vecs", "list_rows", "list_valid"),
    meta_fields=("n_clusters",),
)
@dataclass
class ShardedIVFState:
    """Cluster-major sharded IVF layout (a jax pytree).

    centroids: [C_pad, D] replicated; list_vecs: [C_pad, L_pad, D] sharded
    over clusters; list_rows: [C_pad, L_pad] int32 global row ids (-1 pad)
    sharded; list_valid: [C_pad, L_pad] bool sharded.
    """

    centroids: jax.Array
    list_vecs: jax.Array
    list_rows: jax.Array
    list_valid: jax.Array
    n_clusters: int  # real (unpadded) cluster count


def shard_ivf_state(
    mesh: Mesh,
    centroids: np.ndarray,
    tiles: np.ndarray,
    data: np.ndarray,
    active_mask: np.ndarray,
    axis: str = "data",
) -> ShardedIVFState:
    """Build device-sharded list tiles from host IVF state.

    tiles: [C, L_pad] row ids (-1 padded) as produced by IVFIndex.tiles();
    data: [cap, D] host rows; active_mask: [cap] bool.
    """
    n_dev = mesh.shape[axis]
    c, l_pad = tiles.shape
    d = data.shape[1]
    c_pad = round_up(c, n_dev)
    safe = np.maximum(tiles, 0)
    vecs = data[safe]  # [C, L_pad, D]
    valid = (tiles >= 0) & active_mask[safe]
    if c_pad > c:
        vecs = np.concatenate(
            [vecs, np.zeros((c_pad - c, l_pad, d), np.float32)], axis=0
        )
        tiles = np.concatenate(
            [tiles, np.full((c_pad - c, l_pad), -1, np.int32)], axis=0
        )
        valid = np.concatenate(
            [valid, np.zeros((c_pad - c, l_pad), bool)], axis=0
        )
        centroids = np.concatenate(
            [centroids, np.full((c_pad - c, d), 1e30, np.float32)], axis=0
        )
    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    return ShardedIVFState(
        centroids=jax.device_put(np.asarray(centroids, np.float32), repl),
        list_vecs=jax.device_put(vecs.astype(np.float32), shard),
        list_rows=jax.device_put(tiles.astype(np.int32), shard),
        list_valid=jax.device_put(valid, shard),
        n_clusters=c,
    )


def sharded_ivf_search(mesh: Mesh, axis: str = "data",
                       query_axis: str | None = None):
    """Builds a jitted nprobe search over cluster-sharded inverted lists.

    Returns fn(state, q [B, D], k, n_probe) -> (dists [B, k], rows [B, k]).
    With query_axis set (2D mesh), the query batch is additionally data-
    parallel: results come back sharded over the query axis.
    """
    qspec = P(query_axis) if query_axis else P()

    def body(centroids, list_vecs, list_rows, list_valid, q, k: int, n_probe: int):
        c_local = list_vecs.shape[0]
        l_pad = list_vecs.shape[1]
        my_lo = jax.lax.axis_index(axis) * c_local
        b = q.shape[0]
        q_sq = jnp.sum(q * q, axis=-1)

        dc = pairwise_distance(q, centroids)  # [B, C_pad] replicated compute
        _, probe = jax.lax.top_k(-dc, n_probe)  # [B, P] global cluster ids

        def step(carry, probe_col):
            vals, rows = carry
            local = probe_col - my_lo  # [B]
            mine = (local >= 0) & (local < c_local)
            safe_c = jnp.clip(local, 0, c_local - 1)
            xs = list_vecs[safe_c]  # [B, L_pad, D]
            dots = jnp.einsum("bd,bld->bl", q, xs,
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
            xs_sq = jnp.sum(xs * xs, axis=-1)
            dist = jnp.maximum(q_sq[:, None] - 2.0 * dots + xs_sq, 0.0)
            valid = list_valid[safe_c] & mine[:, None]
            cvals, cpos = masked_topk(dist, valid, min(k, l_pad))
            crows_all = list_rows[safe_c]  # [B, L_pad]
            crow = jnp.where(
                cpos >= 0,
                jnp.take_along_axis(crows_all, jnp.maximum(cpos, 0), axis=1),
                -1,
            )
            return merge_topk(vals, rows, cvals, crow, k), None

        init = (
            jnp.full((b, k), jnp.inf, jnp.float32),
            jnp.full((b, k), -1, jnp.int32),
        )
        (vals, rows), _ = jax.lax.scan(step, init, probe.T)
        # merge partial top-k across the list shards
        all_vals = jax.lax.all_gather(vals, axis)
        all_rows = jax.lax.all_gather(rows, axis)
        nd, bb, kk = all_vals.shape
        all_vals = jnp.transpose(all_vals, (1, 0, 2)).reshape(bb, nd * kk)
        all_rows = jnp.transpose(all_rows, (1, 0, 2)).reshape(bb, nd * kk)
        neg, pos = jax.lax.top_k(-all_vals, k)
        return -neg, jnp.take_along_axis(all_rows, pos, axis=1)

    @partial(jax.jit, static_argnames=("k", "n_probe"))
    def run(state: ShardedIVFState, q, k: int, n_probe: int):
        f = jax.shard_map(
            partial(body, k=k, n_probe=n_probe),
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(axis), qspec),
            out_specs=(qspec, qspec),
            check_vma=False,  # outputs replicated over the list axis
        )
        return f(state.centroids, state.list_vecs, state.list_rows,
                 state.list_valid, q)

    return run


# --------------------------------------------------------------------------
# Sharded k-means (the "training step")
# --------------------------------------------------------------------------


def sharded_lloyd_step(mesh: Mesh, axis: str = "data"):
    """Builds a jitted data-parallel Lloyd iteration.

    Returns fn(x [N, D] sharded, mask [N] sharded, centroids [C, D]
    replicated) -> (new_centroids replicated, mean_sq_error scalar).
    """

    def body(x, mask, centroids):
        c = centroids.shape[0]
        d = pairwise_distance(x, centroids)  # [n_local, C]
        assign = jnp.argmin(d, axis=1)
        d2 = jnp.take_along_axis(d, assign[:, None], axis=1)[:, 0]
        d2 = jnp.where(mask, d2, 0.0)
        onehot = jax.nn.one_hot(jnp.where(mask, assign, -1), c, dtype=jnp.float32)
        counts = jax.lax.psum(jnp.sum(onehot, axis=0), axis)  # [C]
        sums = jax.lax.psum(
            jax.lax.dot_general(
                onehot, x.astype(jnp.float32),
                dimension_numbers=(((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            ),
            axis,
        )  # [C, D]
        new_centroids = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0),
            centroids,
        )
        n_valid = jax.lax.psum(jnp.sum(mask.astype(jnp.float32)), axis)
        err = jax.lax.psum(jnp.sum(d2), axis) / jnp.maximum(n_valid, 1.0)
        return new_centroids, err

    return jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis), P(axis), P()),
            out_specs=(P(), P()),
            check_vma=False,  # outputs replicated via psum
        )
    )


def sharded_kmeans_train(
    mesh: Mesh,
    x: np.ndarray,
    mask: np.ndarray,
    n_clusters: int,
    max_iterations: int = 25,
    tol: float = 1e-4,
    seed: int = 42,
    axis: str = "data",
):
    """Host-orchestrated multi-chip k-means: single-device k-means++ seeding
    on a sample, then data-parallel Lloyd iterations over the mesh."""
    n = x.shape[0]
    n_dev = mesh.shape[axis]
    n_pad = round_up(n, n_dev)
    if n_pad > n:
        x = np.concatenate([x, np.zeros((n_pad - n, x.shape[1]), np.float32)])
        mask = np.concatenate([mask, np.zeros(n_pad - n, bool)])

    # seed from a host-side sample (cheap, single device) — kmeans||,
    # same as the single-chip trainer: the k-means++ lax.scan costs
    # minutes per shape to compile on remote-compile targets
    sample_idx = np.nonzero(mask)[0][: max(n_clusters * 40, n_clusters)]
    init = kmeans_scalable_init(
        jax.random.PRNGKey(seed),
        jnp.asarray(x[sample_idx]),
        jnp.ones(len(sample_idx), bool),
        n_clusters,
    )

    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    xd = jax.device_put(x, shard)
    md = jax.device_put(mask, shard)
    cents = jax.device_put(np.asarray(init), repl)

    step = sharded_lloyd_step(mesh, axis)
    last_err = float("inf")
    iterations = 0
    converged = False
    for i in range(max_iterations):
        cents, err = step(xd, md, cents)
        err = float(err)
        iterations = i + 1
        if i > 0 and abs(last_err - err) / max(last_err, 1e-30) < tol:
            converged = True
            break
        last_err = err
    return np.asarray(cents), {
        "iterations": iterations,
        "converged": converged,
        "final_error": float(err),
    }


# --------------------------------------------------------------------------
# Sharded HNSW (query-data-parallel serving)
# --------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("x", "x_sq", "mask", "nbrs0", "nbrs_up", "up_offset"),
    meta_fields=("entry", "entry_level"),
)
@dataclass
class ShardedHNSWState:
    """Graph + vector arrays replicated on every device (a jax pytree).

    HNSW traversal is pointer-chasing over the whole graph, so the graph
    replicates and the QUERY batch shards — linear QPS scaling for serving
    (capacity scaling across chips is the sharded-IVF path's job).
    """

    x: jax.Array
    x_sq: jax.Array
    mask: jax.Array
    nbrs0: jax.Array
    nbrs_up: jax.Array
    up_offset: jax.Array
    entry: int
    entry_level: int


def shard_hnsw_state(mesh: Mesh, hnsw) -> ShardedHNSWState:
    """Replicate an HNSWIndex's device arrays over the mesh."""
    repl = NamedSharding(mesh, P())
    dev = hnsw._device_arrays()
    mirror = hnsw.store.device(dtype=limits.serving_dtype())
    put = lambda a: jax.device_put(a, repl)  # noqa: E731
    return ShardedHNSWState(
        x=put(mirror.x),
        x_sq=put(mirror.x_sq),
        mask=put(jnp.asarray(hnsw._search_mask())),
        nbrs0=put(dev["nbrs0"]),
        nbrs_up=put(dev["nbrs_up"]),
        up_offset=put(dev["up_offset"]),
        entry=int(hnsw.entry_point),
        entry_level=max(int(hnsw.max_level), 0),
    )


def sharded_hnsw_search(mesh: Mesh, axis: str = "data"):
    """Builds a jitted query-sharded HNSW search.

    Returns fn(state, q [B, D] (B divisible by mesh axis), k, ef) ->
    (dists [B, k], rows [B, k]), results sharded like the queries. Each
    device runs greedy descent + layer-0 beam on its slice of the batch;
    no collectives are needed (the merge axis is the batch).
    """
    from ..index.hnsw import beam_search_kernel, greedy_descent_kernel

    def body(x, x_sq, mask, nbrs0, nbrs_up, up_offset, q,
             entry: int, entry_level: int, k: int, ef: int):
        b = q.shape[0]
        stop = jnp.zeros((b,), jnp.int32)
        cur, _ = greedy_descent_kernel(
            x, x_sq, mask, nbrs_up, up_offset, q, entry, entry_level, stop
        )
        pool_d, pool_id = beam_search_kernel(
            x, x_sq, mask, nbrs0, nbrs_up, up_offset, q, cur[:, None],
            jnp.ones((b,), bool), layer=0, ef=ef, max_iters=ef + 32,
            expand=limits.beam_expand(),
        )
        return pool_d[:, :k], pool_id[:, :k]

    @partial(jax.jit, static_argnames=("k", "ef"))
    def run(state: ShardedHNSWState, q, k: int, ef: int):
        f = jax.shard_map(
            partial(body, entry=state.entry, entry_level=state.entry_level,
                    k=k, ef=ef),
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(), P(), P(axis)),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )
        return f(state.x, state.x_sq, state.mask, state.nbrs0, state.nbrs_up,
                 state.up_offset, q)

    return run


# --------------------------------------------------------------------------
# Sharded hybrid search (both engines over the mesh)
# --------------------------------------------------------------------------


def sharded_hybrid_search(mesh: Mesh, axis: str = "data"):
    """Composes the multi-chip hybrid query path: a query-sharded HNSW beam
    over the replicated recent-tier graph AND a list-sharded IVF scan over
    the historical tier, merged into one global top-k. Both engines issue
    back-to-back device programs on the same mesh; rows are in the shared
    VectorStore's row space so the merge is a plain top-k.

    Returns fn(hstate: ShardedHNSWState, istate: ShardedIVFState, q [B, D]
    (B divisible by the mesh axis), k, ef, n_probe) -> (dists, rows) numpy,
    distances squared-L2 like the single-chip fused path.
    """
    hs = sharded_hnsw_search(mesh, axis)
    ivs = sharded_ivf_search(mesh, axis)

    def run(hstate, istate, q, k: int, ef: int, n_probe: int):
        hd, hr = hs(hstate, q, k, ef)
        ivd, ivr = ivs(istate, q, k, n_probe)
        hd, hr, ivd, ivr = (np.asarray(a) for a in (hd, hr, ivd, ivr))
        d = np.concatenate([hd, ivd], axis=1)
        r = np.concatenate([hr, ivr], axis=1)
        d = np.where(r >= 0, d, np.inf)
        order = np.argsort(d, axis=1)[:, :k]
        out_d = np.take_along_axis(d, order, axis=1)
        out_r = np.take_along_axis(r, order, axis=1)
        out_r = np.where(np.isfinite(out_d), out_r, -1)
        return out_d, out_r

    return run
