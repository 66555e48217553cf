"""Time the two top-k selections at the shapes their callers use.

    python scripts/bench_selection.py [--reps 20] [--scale 1.0]

Compares ``lax.approx_min_k`` (recall_target 0.95, the pool selection the
package used before) with ``masked_topk`` (``lax.top_k``, the one it keeps)
on random distance rows:

  - ``hnsw_link_100k``: the HNSW link-candidate batch of a 100K-node graph,
    [1024, 131072] rows, ef_construction = 200;
  - ``pool_1m_k128`` and ``pool_1m_k1024``: a 128-query pool over 1M rows at
    the turbo and reduced-rank pool widths;
  - ``pool_10m_k1024``: [128, 10.5M], compiled for its memory analysis only.

Prints one JSON line per shape and selection: warm median milliseconds
(``block_until_ready`` inside the timed region), compile seconds,
``compiled.memory_analysis()`` and whether the two selections agree on the
k-th value. Meant for the GPU; on the CPU use small ``--scale``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = (
    ("hnsw_link_100k", 1024, 131_072, 200, True),
    ("pool_1m_k128", 128, 1_048_576, 128, True),
    ("pool_1m_k1024", 128, 1_048_576, 1024, True),
    ("pool_10m_k1024", 128, 10_500_000, 1024, False),
)


def _memory(compiled) -> dict | None:
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {"argument_bytes": int(ma.argument_size_in_bytes),
            "output_bytes": int(ma.output_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every row count (CPU rehearsal)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from fabstir_vectordb_tpu.ops.topk import masked_topk

    @partial(jax.jit, static_argnames=("k",))
    def approx_min_k(d, mask, k: int):
        masked = jnp.where(mask[None, :], d, jnp.inf)
        return jax.lax.approx_min_k(masked, k, recall_target=0.95)

    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "jax": jax.__version__}), flush=True)
    selections = {"approx_min_k": approx_min_k, "top_k": masked_topk}
    for name, b, n, k, timed in SHAPES:
        n = max(int(n * args.scale), 4 * k)
        spec_d = jax.ShapeDtypeStruct((b, n), jnp.float32)
        spec_m = jax.ShapeDtypeStruct((n,), jnp.bool_)
        kth = {}
        for sel_name, fn in selections.items():
            t0 = time.perf_counter()
            compiled = fn.lower(spec_d, spec_m, k=k).compile()
            line = {"shape": name, "b": b, "n": n, "k": k,
                    "selection": sel_name,
                    "compile_s": time.perf_counter() - t0,
                    "memory": _memory(compiled)}
            if timed:
                d = jax.random.uniform(jax.random.PRNGKey(0), (b, n))
                m = jnp.ones((n,), bool)
                vals, _ = jax.block_until_ready(compiled(d, m))
                kth[sel_name] = np.asarray(vals[:, -1])
                times = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(compiled(d, m))
                    times.append((time.perf_counter() - t0) * 1e3)
                line["warm_median_ms"] = float(np.median(times))
                line["warm_min_ms"] = float(np.min(times))
                del d, m, vals
            print(json.dumps(line), flush=True)
        if len(kth) == 2:
            print(json.dumps({
                "shape": name, "kth_value_max_abs_diff": float(np.max(np.abs(
                    kth["approx_min_k"] - kth["top_k"])))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
