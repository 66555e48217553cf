"""Run the serving path once on a GPU and check every answer against float64.

    python chip_smoke.py [--seed 0] [--session-rows 100000]
                         [--scale-rows 1000000] [--dim 384]

Phase A (``phase_session``) drives ``VectorDBSession`` at the upstream
project's documented deployment (BASELINE.md): 100K x 384 f32 vectors,
10K-row chunks, metadata on every vector, 10% of the rows inside the 7-day
recency window so that both HNSW and IVF hold rows. It ingests, searches
one query and a 128-query batch, runs filtered searches (``$gte`` at ~10%
selectivity and ``$in``), deletes by id and by metadata, vacuums, saves to
the in-memory S5 mock, lazily loads into a fresh session, answers a first
search on the cold path and then a warm search.

Phase B (``phase_scale``) builds a 1M x 384 ``HybridIndex`` the way the
session builds one (initialise, then ``insert_batch`` with 10% recent rows)
and serves the same queries through every regime of ``index/fused.py`` at
B=1 and B=128, k=10: flat-exact f32, flat bf16 with device rerank and host
refine, turbo selection, reduced-rank, and pruned HNSW+IVF.

Every answer is compared with an exact numpy float64 search over the rows
that are live at that moment. Each step prints one JSON line with its
correctness numbers, the memory analysis of the device programs it ran,
seconds spent compiling, and warm wall-clock times labelled with the card.
The script exits non-zero, and prints no result, when JAX finds no GPU or
when any check fails. Its last line on success is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

DAY = 86_400.0
NOW = 1_700_000_000.0
K = 10
BATCH = 128
TIE_REL = 1e-5     # oracle ties closer than this may swap places
SCORE_REL = 1e-4   # returned scores / distances vs the float64 oracle


# --------------------------------------------------------------- reporting
class Clock:
    """Backend compile seconds, summed from JAX's own monitoring events."""

    def __init__(self):
        import jax.monitoring

        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration


class Reporter:
    """Prints one JSON line per step and remembers which checks failed."""

    def __init__(self, card: str, clock: Clock):
        self.card = card
        self.clock = clock
        self.failures: list = []

    def step(self, phase: str, step: str, checks: dict, **fields) -> None:
        bad = [name for name, ok in checks.items() if not ok]
        line = {"phase": phase, "step": step, "ok": not bad,
                "failed_checks": bad, "card": self.card, **fields}
        print(json.dumps(line, default=_jsonable), flush=True)
        self.failures += [f"{phase}/{step}/{name}" for name in bad]


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def card_label() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


@contextlib.contextmanager
def captured_programs(module, names):
    """Record the top-level calls to ``module``'s jitted kernels ``names``
    (calls traced inside another kernel carry tracers and are skipped)."""
    import jax

    calls: list = []
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            leaves = jax.tree_util.tree_leaves((args, kwargs))
            if not any(isinstance(a, jax.core.Tracer) for a in leaves):
                calls.append((name, fn, args, kwargs))
            return fn(*args, **kwargs)
        return call

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def program_key(name: str, args, kwargs) -> str:
    """``name[B=<batch>,<static args>]``: the last array argument of every
    fused kernel is the query batch or a per-query array."""
    arrays = [a for a in args if np.ndim(a) > 0]
    static = [str(a) for a in args if isinstance(a, (int, str))]
    static += [f"{k}={v}" for k, v in sorted(kwargs.items())]
    return f"{name}[" + ",".join([f"B={arrays[-1].shape[0]}"] + static) + "]"


def memory_analysis(calls) -> dict:
    """``compiled.memory_analysis()`` of each distinct captured program,
    keyed by kernel, query batch and static arguments."""
    out: dict = {}
    for name, fn, args, kwargs in calls:
        key = program_key(name, args, kwargs)
        if key in out:
            continue
        ma = fn.lower(*args, **kwargs).compile().memory_analysis()
        out[key] = None if ma is None else {
            "argument_bytes": int(ma.argument_size_in_bytes),
            "output_bytes": int(ma.output_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes),
            "generated_code_bytes": int(ma.generated_code_size_in_bytes),
        }
    return out


def timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        _, s = timed(fn)
        times.append(s * 1e3)
    return float(np.median(times))


# ------------------------------------------------------------------ oracle
def make_corpus(n: int, dim: int, rng, n_centers: int = 1024):
    """Clustered Gaussian corpus, as the benchmark generates it."""
    centers = rng.standard_normal((n_centers, dim), dtype=np.float32)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    x *= 0.35
    x += centers[rng.integers(0, n_centers, n)]
    return x


def make_queries(x: np.ndarray, n_q: int, rng, rows=None):
    rows = rng.integers(0, x.shape[0], n_q) if rows is None else rows
    noise = rng.standard_normal((len(rows), x.shape[1]), dtype=np.float32)
    return x[rows] + 0.1 * noise


def exact_topk(x: np.ndarray, live: np.ndarray, q: np.ndarray, k: int,
               block: int = 262_144):
    """Exact float64 top-k over the live rows: (dist [B, k], rows [B, k]),
    ascending, -1 / inf padded."""
    q64 = np.asarray(q, np.float64)
    q_sq = np.einsum("bd,bd->b", q64, q64)
    best_d = np.full((q64.shape[0], 0), np.inf)
    best_r = np.zeros((q64.shape[0], 0), np.int64)
    for lo in range(0, x.shape[0], block):
        xb = x[lo: lo + block].astype(np.float64)
        d2 = (np.einsum("nd,nd->n", xb, xb)[None, :] - 2.0 * (q64 @ xb.T)
              + q_sq[:, None])
        d2[:, ~live[lo: lo + block]] = np.inf
        kk = min(k, d2.shape[1])
        part = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
        best_d = np.concatenate(
            [best_d, np.take_along_axis(d2, part, axis=1)], axis=1)
        best_r = np.concatenate([best_r, part + lo], axis=1)
    order = np.argsort(best_d, axis=1, kind="stable")[:, :k]
    rows = np.take_along_axis(best_r, order, axis=1)
    rows = np.where(np.isfinite(np.take_along_axis(best_d, order, axis=1)),
                    rows, -1)
    return exact_dist(x, q, rows), rows


def exact_dist(x: np.ndarray, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Difference-form float64 distances from each query to its rows."""
    diff = (x[np.maximum(rows, 0)].astype(np.float64)
            - np.asarray(q, np.float64)[:, None, :])
    d = np.sqrt(np.einsum("bkd,bkd->bk", diff, diff))
    return np.where(rows >= 0, d, np.inf)


def compare(x, live, q, got_rows, got_dist, k: int = K) -> dict:
    """Check one answer set against the float64 oracle.

    ``got_rows`` are corpus positions (-1 = empty slot), ``got_dist`` the
    euclidean distances the system returned for them. A true neighbour
    that is missing counts as found when it ties the k-th oracle distance
    within TIE_REL and the answer holds another row just as close."""
    got_rows = np.asarray(got_rows, np.int64)
    got_dist = np.asarray(got_dist, np.float64)
    true_d, true_r = exact_topk(x, live, q, k)
    exact_got = exact_dist(x, q, got_rows)
    hits = excused = total = dead = dup = 0
    worst_rel = 0.0
    for i in range(q.shape[0]):
        truth = [int(r) for r in true_r[i] if r >= 0]
        got = [int(r) for r in got_rows[i] if r >= 0]
        dup += len(got) - len(set(got))
        dead += sum(1 for r in got if not live[r])
        total += len(truth)
        found = set(truth) & set(got)
        hits += len(found)
        kth = true_d[i, len(truth) - 1] if truth else np.inf
        extra = [j for j, r in enumerate(got_rows[i])
                 if r >= 0 and r not in found and r not in truth
                 and exact_got[i, j] <= kth * (1 + TIE_REL)]
        for j, r in enumerate(truth):
            tied = true_d[i, j] >= kth * (1 - TIE_REL)
            if r not in found and tied and extra:
                extra.pop()
                excused += 1
        ok = got_rows[i] >= 0
        if ok.any():
            rel = np.abs(got_dist[i][ok] - exact_got[i][ok]) / np.maximum(
                exact_got[i][ok], 1e-6)
            worst_rel = max(worst_rel, float(rel.max()))
    return {
        "recall": hits / max(total, 1),
        "recall_ties_excused": (hits + excused) / max(total, 1),
        "max_rel_dist_err": worst_rel,
        "deleted_returned": dead,
        "duplicates": dup,
    }


def score_to_dist(score: float) -> float:
    return 1.0 / score - 1.0


def results_to_arrays(results: list, k: int = K):
    """Session result items (``id`` = "v<pos>") -> (rows [k], dist [k])."""
    rows = np.full(k, -1, np.int64)
    dist = np.full(k, np.inf)
    for j, item in enumerate(results[:k]):
        rows[j] = int(item["id"][1:])
        dist[j] = score_to_dist(item["score"])
    return rows, dist


# ---------------------------------------------------- phase A: the session
class GatedStore:
    """Object store whose background chunk reads wait for ``gate``.

    Stands in for a remote S5 portal whose chunk reads have not arrived
    when the first query does: the lazy materializer runs in a worker
    thread, while a cold search fetches its own row spans from the thread
    that searches."""

    def __init__(self, inner):
        self._inner = inner
        self.gate = threading.Event()

    def _wait(self, key: str) -> None:
        if ("/chunks/" in key
                and threading.current_thread() is not threading.main_thread()):
            if not self.gate.wait(600):
                raise TimeoutError("chunk gate never opened")

    def get(self, key):
        self._wait(key)
        return self._inner.get(key)

    def get_range(self, key, offset, length):
        self._wait(key)
        return self._inner.get_range(key, offset, length)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def session_metadata(n: int, rng):
    """Metadata on every row: ``cat`` (10 values), ``rank`` (a permutation
    of 0..n-1, so ``$gte`` picks an exact share) and ``lang``."""
    langs = np.array(["en", "de", "fr", "es", "ja"])
    return {
        "cat": np.arange(n) % 10,
        "rank": rng.permutation(n),
        "lang": langs[rng.integers(0, len(langs), n)],
    }


def phase_session(rep: Reporter, n: int, dim: int, seed: int,
                  chunk_rows: int = 10_000, n_single: int = 16,
                  batch: int = BATCH) -> None:
    from fabstir_vectordb_tpu.api.session import VectorDBSession
    from fabstir_vectordb_tpu.core.object_store import MemoryObjectStore
    from fabstir_vectordb_tpu.index import fused

    phase = "A_session"
    rng = np.random.default_rng(seed)
    x = make_corpus(n, dim, rng)
    meta = session_metadata(n, rng)
    live = np.ones(n, bool)
    n_recent = n // 10
    n_hist = n - n_recent
    cfg = {"sessionId": "smoke", "storageMode": "mock",
           "encryptAtRest": False, "chunkSize": chunk_rows,
           "cacheSizeMb": 150}
    inner = MemoryObjectStore()
    s = VectorDBSession.create(cfg, store=inner)

    def items(lo, hi):
        return [{"id": f"v{i}", "vector": x[i],
                 "metadata": {"cat": int(meta["cat"][i]),
                              "rank": int(meta["rank"][i]),
                              "lang": str(meta["lang"][i])}}
                for i in range(lo, hi)]

    # ---- ingest: the historical 90% first, then a week passes (the
    # hybrid's own migration moves them to IVF), then the recent 10% ----
    c0 = rep.clock.compile_s
    t0 = time.perf_counter()
    for lo in range(0, n_hist, chunk_rows):
        s.add_vectors(items(lo, min(lo + chunk_rows, n_hist)))
    t_hist = time.perf_counter() - t0
    moved, t_mig = timed(s.index.migrate_old_vectors, batch_size=n_hist,
                         now=time.time() + 7 * DAY + 60)
    t0 = time.perf_counter()
    for lo in range(n_hist, n, chunk_rows):
        s.add_vectors(items(lo, min(lo + chunk_rows, n)))
    t_recent = time.perf_counter() - t0
    st = s.get_stats()
    rep.step(phase, "ingest", {
        "count": st.vector_count == n,
        "hnsw_rows": st.hnsw_vector_count == n_recent,
        "ivf_rows": st.ivf_vector_count == n_hist,
        "migrated": moved == n_hist,
    }, rows=n, dim=dim, hnsw_rows=st.hnsw_vector_count,
        ivf_rows=st.ivf_vector_count, ingest_historical_s=t_hist,
        migrate_s=t_mig, ingest_recent_s=t_recent,
        compile_s=rep.clock.compile_s - c0,
        regime=s.index.fused.serving_info()["regime"])

    q_rows = np.concatenate([rng.integers(0, n_hist, batch // 2),
                             rng.integers(n_hist, n, batch - batch // 2)])
    q = make_queries(x, batch, rng, rows=q_rows)

    def single(queries, options=None):
        out = [results_to_arrays(s.search(qq, K, options)) for qq in queries]
        return np.stack([r for r, _ in out]), np.stack([d for _, d in out])

    def batched(queries, flt=None):
        out = [results_to_arrays(r)
               for r in s.search_batch(queries, K, flt)]
        return np.stack([r for r, _ in out]), np.stack([d for _, d in out])

    def search_step(name, live_now, flt=None, flt_mask=None):
        """Single queries and one batch, both against the oracle."""
        live_f = live_now if flt_mask is None else live_now & flt_mask
        opts = None if flt is None else {"filter": flt}
        c0 = rep.clock.compile_s
        with captured_programs(fused, FUSED_KERNELS) as calls:
            (r1, d1), first_s = timed(single, q[:1], opts)
            (rb, db), first_b_s = timed(batched, q, flt)
        mem = memory_analysis(calls)
        compile_s = rep.clock.compile_s - c0
        r1, d1 = single(q[:n_single], opts)
        one = compare(x, live_f, q[:n_single], r1, d1)
        many = compare(x, live_f, q, rb, db)
        checks = {
            "single_recall": one["recall_ties_excused"] == 1.0,
            "batch_recall": many["recall_ties_excused"] == 1.0,
            "single_scores": one["max_rel_dist_err"] <= SCORE_REL,
            "batch_scores": many["max_rel_dist_err"] <= SCORE_REL,
            "no_excluded_rows": one["deleted_returned"] + many[
                "deleted_returned"] == 0,
            "no_duplicates": one["duplicates"] + many["duplicates"] == 0,
        }
        rep.step(phase, name, checks, single=one, batch=many,
                 filter=flt, live_rows=int(live_f.sum()),
                 memory=mem, compile_s=compile_s,
                 first_single_s=first_s, first_batch_s=first_b_s,
                 warm_single_ms=median_ms(lambda: s.search(q[0], K, opts),
                                          n_single),
                 warm_batch_ms=median_ms(lambda: s.search_batch(q, K, flt),
                                         5),
                 peak_bytes_in_use=device_peak_bytes())

    search_step("search", live)
    gte = {"rank": {"$gte": int(0.9 * n)}}
    search_step("filter_gte", live, gte, meta["rank"] >= int(0.9 * n))
    in_ = {"lang": {"$in": ["de", "ja"]}}
    search_step("filter_in", live, in_, np.isin(meta["lang"], ["de", "ja"]))

    # ---- deletes: the top hit of each single query, then one category ----
    r1, _ = single(q[:n_single])
    victims = sorted({int(r) for r in r1[:, 0] if r >= 0})
    for pos in victims:
        s.delete_vector(f"v{pos}")
    live[victims] = False
    by_meta = live & (meta["cat"] == 7)
    res = s.delete_by_metadata({"cat": 7})
    live &= ~by_meta
    rep.step(phase, "delete", {
        "by_metadata_count": res.deleted_count == int(by_meta.sum()),
        "stats": s.get_stats().total_deleted_count
        == len(victims) + int(by_meta.sum()),
    }, deleted_by_id=len(victims), deleted_by_metadata=res.deleted_count)
    search_step("search_after_delete", live)
    vac = s.vacuum()
    rep.step(phase, "vacuum", {
        "removed": vac.total_removed == int((~live).sum()),
        "count": s.get_stats().vector_count == int(live.sum()),
    }, removed=vac.total_removed)
    search_step("search_after_vacuum", live)
    search_step("filter_gte_after_vacuum", live, gte,
                meta["rank"] >= int(0.9 * n))

    # ---- save, lazy load into a fresh session, cold then warm ----
    cid, save_s = timed(s.save_to_s5)
    s.destroy()
    gated = GatedStore(inner)
    s = VectorDBSession.create(cfg, store=gated)
    _, load_s = timed(s.load_user_vectors, cid, {"lazyLoad": True})
    cold = s.index._cold
    was_lazy = cold is not None and not s.index.ready
    if was_lazy:
        # park the materializer between chunks, then let its one in-flight
        # chunk read finish: every other row the search needs, it fetches
        cold.hold_materializer()
    gated.gate.set()
    n_cold = 8
    (rc, dc), first_cold_s = timed(single, q[:1])
    first_stats = cold.stats() if cold is not None else {}
    # chunks holding any resident row after the first search (the
    # materializer's one in-flight chunk included)
    chunks_touched = 0 if cold is None else int(np.add.reduceat(
        cold.row_filled, np.arange(0, cold.total, cold.chunk_size)).astype(
        bool).sum())
    (rest, more_s) = timed(single, q[1:n_cold])
    rc = np.concatenate([rc, rest[0]])
    dc = np.concatenate([dc, rest[1]])
    still_cold = not s.index.ready
    cold_stats = cold.stats() if cold is not None else {}
    cold_cmp = compare(x, live, q[:n_cold], rc, dc)
    # the cold path scans only the probed IVF lists, so its recall is
    # printed, not checked. Whether the first search touched only some
    # chunks is reported too: at the session's default IVF it touches all.
    n_chunks = first_stats.get("chunks_total", 0)
    rep.step(phase, "cold_search", {
        "served_cold": was_lazy and still_cold,
        "fetched_on_demand": first_stats.get("rows_fetched_on_demand", 0) > 0,
        "scores": cold_cmp["max_rel_dist_err"] <= SCORE_REL,
        "no_excluded_rows": cold_cmp["deleted_returned"] == 0,
        "no_duplicates": cold_cmp["duplicates"] == 0,
    }, result=cold_cmp, first_search_chunks_touched=chunks_touched,
        chunks_total=n_chunks,
        first_search_touched_only_some_chunks=chunks_touched < n_chunks,
        save_s=save_s, load_s=load_s,
        first_cold_search_s=first_cold_s, next_cold_searches_s=more_s,
        cold_after_first=first_stats, cold_after_all=cold_stats)
    if was_lazy:
        cold.release_materializer()
    _, ready_s = timed(s.index.wait_ready, 600)
    rep.step(phase, "load", {
        "count": s.get_stats().vector_count == int(live.sum()),
    }, materialize_rest_s=ready_s)
    search_step("warm_after_load", live)
    search_step("filter_in_after_load", live, in_,
                np.isin(meta["lang"], ["de", "ja"]))
    s.destroy()


# ------------------------------------------------ phase B: 1M, all regimes
FUSED_KERNELS = (
    "flat_search_kernel", "flat_search_rerank_kernel",
    "stage1_select_kernel", "rerank_f32_kernel", "hybrid_search_kernel",
)

# regime -> (environment, flat threshold override, recall gate or None).
# Turbo and reduced-rank are held to what they read on the CPU at the test
# size (1.000); pruned prints its recall only.
REGIMES = {
    "flat_f32": ({}, None, 1.0),
    "flat_bf16_rerank_refine": ({"FVDB_SERVING_DTYPE": "bfloat16"}, None,
                                0.999),
    "turbo": ({"FVDB_FLAT_SELECT": "approx"}, None, 1.0),
    "reduced_rank": ({"FVDB_PCA_SERVE": "1"}, 0, 1.0),
    "pruned": ({"FVDB_PCA_SERVE": "0"}, 0, None),
}
EXPECTED_REGIME = {"flat_f32": "flat-exact",
                   "flat_bf16_rerank_refine": "flat-exact",
                   "turbo": "flat-exact", "reduced_rank": "reduced-rank",
                   "pruned": "pruned"}


@contextlib.contextmanager
def serving_regime(env: dict, threshold):
    """Select a serving regime the way an operator does: through the
    FVDB_* environment, with the flat threshold forced below the corpus
    for the beyond-flat regimes."""
    from fabstir_vectordb_tpu.utils import limits

    keys = set(env) | ({"FVDB_FLAT_THRESHOLD"} if threshold is not None
                       else set())
    saved_env = {k: os.environ.get(k) for k in keys}
    saved_thr = limits.FLAT_THRESHOLD
    os.environ.update(env)
    if threshold is not None:
        os.environ["FVDB_FLAT_THRESHOLD"] = str(threshold)
        limits.FLAT_THRESHOLD = threshold
    try:
        yield
    finally:
        limits.FLAT_THRESHOLD = saved_thr
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def drop_device_state(idx) -> None:
    """Free every device mirror before the next regime builds its own."""
    import gc

    idx.fused._release_proj()
    idx.fused._dev = None
    idx.fused._key = None
    idx.store.release_mirror()
    gc.collect()


def phase_scale(rep: Reporter, n: int, dim: int, seed: int,
                n_single: int = 16, batch: int = BATCH,
                ivf_clusters: int = 256, ivf_probe: int = 16) -> None:
    from fabstir_vectordb_tpu.index import (
        HybridConfig, HybridIndex, IVFConfig, SearchConfig, fused)

    phase = "B_scale"
    rng = np.random.default_rng(seed + 1)
    x, gen_s = timed(make_corpus, n, dim, rng)
    n_recent = n // 10
    ts = np.full(n, NOW - 30 * DAY)
    ts[:n_recent] = NOW - DAY
    idx = HybridIndex(dim, HybridConfig(
        ivf=IVFConfig(n_clusters=ivf_clusters, n_probe=ivf_probe,
                      train_size=10_000, seed=0),
        auto_migrate=False))
    c0 = rep.clock.compile_s
    _, init_s = timed(idx.initialize, x[:10_000])
    rows, build_s = timed(idx.insert_batch, [f"v{i}" for i in range(n)],
                          x, ts, now=NOW)
    live = np.ones(n, bool)
    st = idx.stats(now=NOW)
    rep.step(phase, "build", {
        "rows_in_order": bool((rows == np.arange(n)).all()),
        "hnsw_rows": st.recent_vectors == n_recent,
        "ivf_rows": st.historical_vectors == n - n_recent,
    }, rows=n, dim=dim, corpus_gen_s=gen_s, ivf_train_s=init_s,
        insert_build_s=build_s, compile_s=rep.clock.compile_s - c0)

    q = make_queries(x, batch, rng)
    cfg = SearchConfig(auto_migrate=False)

    def search(queries):
        d, r = idx.search_rows(queries, K, config=cfg, now=NOW)
        return np.asarray(r, np.int64), np.asarray(d, np.float64)

    def single(queries):
        out = [search(qq[None, :]) for qq in queries]
        return (np.concatenate([r for r, _ in out]),
                np.concatenate([d for _, d in out]))

    for name, (env, threshold, gate) in REGIMES.items():
        drop_device_state(idx)
        with serving_regime(env, threshold):
            c0 = rep.clock.compile_s
            with captured_programs(fused, FUSED_KERNELS) as calls:
                _, first_s = timed(search, q[:1])
                _, first_b_s = timed(search, q)
            mem = memory_analysis(calls)
            compile_s = rep.clock.compile_s - c0
            info = idx.fused.serving_info()
            r1, d1 = single(q[:n_single])
            rb, db = search(q)
            one = compare(x, live, q[:n_single], r1, d1)
            many = compare(x, live, q, rb, db)
            checks = {
                "regime": info["regime"] == EXPECTED_REGIME[name],
                "single_dists": one["max_rel_dist_err"] <= SCORE_REL,
                "batch_dists": many["max_rel_dist_err"] <= SCORE_REL,
                "no_duplicates": one["duplicates"] + many["duplicates"] == 0,
            }
            if gate is not None:
                checks["single_recall"] = one["recall_ties_excused"] >= gate
                checks["batch_recall"] = many["recall_ties_excused"] >= gate
            rep.step(phase, name, checks, serving=info, single=one,
                     batch=many, recall_gate=gate, memory=mem,
                     compile_s=compile_s, first_single_s=first_s,
                     first_batch_s=first_b_s,
                     warm_single_ms=median_ms(lambda: search(q[:1]),
                                              n_single),
                     warm_batch_ms=median_ms(lambda: search(q), 5),
                     peak_bytes_in_use=device_peak_bytes())
    drop_device_state(idx)


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--session-rows", type=int, default=100_000)
    ap.add_argument("--scale-rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=384)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    card = card_label()
    from fabstir_vectordb_tpu.utils.compile_cache import (
        enable_persistent_cache)

    cache_dir = enable_persistent_cache()
    print(card, flush=True)
    print(json.dumps({"devices": [str(d) for d in jax.devices()],
                      "jax": jax.__version__,
                      "xla_flags": os.environ.get("XLA_FLAGS", ""),
                      "compile_cache": cache_dir}), flush=True)
    rep = Reporter(card, Clock())
    t0 = time.perf_counter()
    phase_session(rep, args.session_rows, args.dim, args.seed)
    phase_scale(rep, args.scale_rows, args.dim, args.seed)
    print(json.dumps({"wall_s": time.perf_counter() - t0,
                      "failed_checks": rep.failures}), flush=True)
    if rep.failures:
        print("chip_smoke: FAILED " + ", ".join(rep.failures),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
