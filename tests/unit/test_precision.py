"""Every float32 matmul in a ranking kernel states its precision.

On the GPU an f32 ``dot_general`` without a precision may run in TF32,
which keeps about three decimal digits and flips near-ties against the
CPU. Each kernel that ranks or assigns rows is traced here (abstract
shapes, nothing runs) and every f32 x f32 ``dot_general`` in its jaxpr,
nested programs included, must carry an explicit precision.
"""
import jax
import jax.numpy as jnp
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

from fabstir_vectordb_tpu.index import flat, fused, hnsw, ivf, tiered
from fabstir_vectordb_tpu.ops import kmeans
from fabstir_vectordb_tpu.parallel import (
    cpu_mesh,
    sharded_flat_search,
    sharded_ivf_search,
    sharded_lloyd_step,
    sharded_projected_search,
)
from fabstir_vectordb_tpu.parallel.sharded import ShardedIVFState

N, D, B, C, L, M, U, R = 256, 16, 4, 8, 32, 4, 64, 8


def f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def i32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.int32)


def bools(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.bool_)


def _hybrid(filtered: bool):
    return (lambda *a: fused.hybrid_search_kernel(
        *a, k=4, ef=8, n_probe=2, has_hnsw=True, has_ivf=True,
        has_filter=filtered, beam_expand=2),
        (f32(N, D), f32(N), bools(N), bools(N), bools(N), i32(N, 2 * M),
         i32(U, M), i32(N), i32(), i32(), f32(C, D), i32(C, L), f32(B, D)))


def _sharded_ivf():
    state = ShardedIVFState(centroids=f32(C, D), list_vecs=f32(C, L, D),
                            list_rows=i32(C, L), list_valid=bools(C, L),
                            n_clusters=C)
    run = sharded_ivf_search(cpu_mesh(2))
    return (lambda s, q: run(s, q, 4, 2)), (state, f32(B, D))


KERNELS = {
    "fused.flat_search": lambda: (
        lambda *a: fused.flat_search_kernel(*a, k=4),
        (f32(N, D), f32(N), bools(N), f32(B, D))),
    "fused.flat_search_rerank": lambda: (
        lambda *a: fused.flat_search_rerank_kernel(*a, k=4, ov_k=16),
        (f32(N, D), f32(N), bools(N), f32(B, D))),
    "fused.oracle_step": lambda: (
        lambda *a: fused._oracle_step(*a, k=4),
        (jax.ShapeDtypeStruct((N, D), jnp.bfloat16), bools(N), f32(B, D),
         i32(), f32(B, 4), i32(B, 4))),
    "tiered.tile_step": lambda: (
        lambda *a: tiered._tile_step(*a, k=4),
        (f32(N, D), bools(N), f32(B, D), i32(), f32(B, 4), i32(B, 4))),
    "fused.stage1_select": lambda: (
        lambda *a: fused.stage1_select_kernel(*a, ov_k=16),
        (f32(N, R), f32(N), bools(N), f32(B, R))),
    "fused.project_queries": lambda: (
        fused._project_queries, (f32(B, D), f32(D), f32(D, R))),
    "fused.project_chunk": lambda: (
        fused._project_chunk, (f32(N, D), f32(D), f32(D, R))),
    "fused.hybrid_search": lambda: _hybrid(False),
    "fused.hybrid_search_filtered": lambda: _hybrid(True),
    "flat.flat_search": lambda: (
        lambda *a: flat.flat_search_kernel(*a, k=4),
        (f32(N, D), f32(N), bools(N), f32(B, D))),
    "hnsw.flat_candidates": lambda: (
        lambda *a: hnsw._flat_candidates_kernel(*a, ef=8, n_pad=N),
        (f32(N, D), f32(N), bools(N), f32(B, D))),
    "hnsw.flat_candidates_chunked": lambda: (
        lambda *a: hnsw._flat_candidates_chunked(
            *a, ef=8, n_pad=hnsw._CAND_CHUNK),
        (f32(hnsw._CAND_CHUNK, D), f32(hnsw._CAND_CHUNK),
         bools(hnsw._CAND_CHUNK), f32(B, D))),
    "hnsw.heuristic_kept": lambda: (
        lambda *a: hnsw.heuristic_kept_kernel(*a, m=4),
        (f32(N, D), i32(B, 16), f32(B, 16))),
    "hnsw.pair_dists": lambda: (
        hnsw._pair_dists_kernel, (f32(N, D), f32(N), i32(32), i32(32))),
    "hnsw.greedy_descent": lambda: (
        hnsw.greedy_descent_kernel,
        (f32(N, D), f32(N), bools(N), i32(U, M), i32(N), f32(B, D), i32(),
         i32(), i32(B))),
    "ivf.search_euclidean": lambda: (
        lambda *a: ivf.ivf_search_kernel(*a, k=4, n_probe=2),
        (f32(N, D), f32(N), bools(N), f32(C, D), i32(C, L), f32(B, D))),
    "ivf.search_cosine": lambda: (
        lambda *a: ivf.ivf_search_kernel(*a, k=4, n_probe=2,
                                         metric="cosine"),
        (f32(N, D), f32(N), bools(N), f32(C, D), i32(C, L), f32(B, D))),
    "ivf.search_dot": lambda: (
        lambda *a: ivf.ivf_search_kernel(*a, k=4, n_probe=2, metric="dot"),
        (f32(N, D), f32(N), bools(N), f32(C, D), i32(C, L), f32(B, D))),
    "kmeans.lloyd_step": lambda: (
        kmeans.lloyd_step, (f32(N, D), bools(N), f32(C, D))),
    "kmeans.assign_clusters": lambda: (
        kmeans.assign_clusters, (f32(N, D), f32(C, D))),
    "sharded.flat_search": lambda: (
        (lambda *a: sharded_flat_search(cpu_mesh(2))(*a, 4)),
        (f32(N, D), f32(N), bools(N), f32(B, D))),
    "sharded.flat_search_approx": lambda: (
        (lambda *a: sharded_flat_search(cpu_mesh(2), select="approx",
                                        oversample=16)(*a, 4)),
        (f32(N, D), f32(N), bools(N), f32(B, D))),
    "sharded.projected_search": lambda: (
        (lambda *a: sharded_projected_search(cpu_mesh(2))(*a, 16)),
        (jax.ShapeDtypeStruct((N, R), jnp.bfloat16), f32(N), bools(N),
         f32(D), f32(D, R), f32(B, D))),
    "sharded.ivf_search": _sharded_ivf,
    "sharded.lloyd_step": lambda: (
        sharded_lloyd_step(cpu_mesh(2)), (f32(N, D), bools(N), f32(C, D))),
}


def _sub_jaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def f32_dots(jaxpr):
    """Every f32 x f32 dot_general in ``jaxpr`` and its nested programs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and all(
                v.aval.dtype == jnp.float32 for v in eqn.invars):
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from f32_dots(sub)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_f32_matmuls_state_precision(name):
    fn, args = KERNELS[name]()
    dots = list(f32_dots(jax.make_jaxpr(fn)(*args).jaxpr))
    assert dots, f"{name}: no f32 matmul traced"
    missing = [str(e) for e in dots if e.params.get("precision") is None]
    assert not missing, f"{name}: f32 matmuls without precision: {missing}"


def test_walker_sees_a_missing_precision():
    """The check itself: an unannotated f32 matmul is reported."""
    jaxpr = jax.make_jaxpr(jax.jit(lambda a, b: a @ b.T))(f32(B, D), f32(N, D))
    dots = list(f32_dots(jaxpr.jaxpr))
    assert len(dots) == 1 and dots[0].params.get("precision") is None
