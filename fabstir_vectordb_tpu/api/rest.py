"""REST API: /api/v1 routes over a session-backed engine (aiohttp).

Route + behavior parity with the reference axum app (reference:
src/api/rest.rs):
  - app factory with storage from env + mock fallback (:232-290), index
    dimension from VECTOR_DIMENSION (:291-310);
  - routes ``/api/v1/{health, vectors, vectors/batch, vectors/:id [GET,
    DELETE], search, admin/{statistics, migrate, rebalance, backup},
    stream/updates, ws}`` (:325-346);
  - insert: validate -> index -> metadata map -> storage persist (:392-447);
    batch (:449-531); get with memory -> storage fallback (:533-570);
  - search: score = 1/(1+distance), optional metadata, score_threshold
    (:599-677);
  - CORS headers + body size limit (:319-349).

Where the reference left TODO stubs (admin handlers, SSE, WebSocket,
:679-738) this implementation is functional: statistics/migrate/rebalance/
backup call into the engine, stream/updates is a real SSE feed of mutation
events, /ws echoes subscriptions with update push.

Engine calls are serialized through a single-thread executor so device
compute never blocks the event loop.
"""
from __future__ import annotations

import asyncio
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
from aiohttp import web, WSMsgType

from .. import __version__
from ..core.object_store import ObjectStore
from ..storage.factory import StorageFactory
from ..utils.tracing import get_logger
from .session import (
    VectorDBConfig,
    VectorDBError,
    VectorDBSession,
)

log = get_logger(__name__)


@dataclass
class ApiConfig:
    host: str = "0.0.0.0"
    port: int = 8080
    max_request_size: int = 10 * 1024 * 1024
    timeout_secs: float = 30.0
    cors_origins: list = field(default_factory=lambda: ["*"])
    dimension: int | None = None  # None -> from first insert / env
    session_id: str = "rest-server"

    @classmethod
    def from_env(cls) -> "ApiConfig":
        dim_env = os.environ.get("VECTOR_DIMENSION")
        return cls(
            host=os.environ.get("VECTOR_DB_HOST", "0.0.0.0"),
            port=int(os.environ.get("VECTOR_DB_PORT", "8080")),
            max_request_size=int(
                os.environ.get("VECTOR_DB_MAX_REQUEST_SIZE", str(10 * 1024 * 1024))
            ),
            timeout_secs=float(os.environ.get("VECTOR_DB_TIMEOUT_SECS", "30")),
            cors_origins=os.environ.get("VECTOR_DB_CORS_ORIGINS", "*").split(","),
            dimension=int(dim_env) if dim_env else None,
        )


class AppState:
    def __init__(self, config: ApiConfig, store: ObjectStore):
        self.config = config
        self.store = store
        self.session = VectorDBSession(
            VectorDBConfig(session_id=config.session_id), store
        )
        self.executor = ThreadPoolExecutor(max_workers=1)  # serialize engine ops
        self.subscribers: list[_Subscriber] = []
        self.coalescer = SearchCoalescer(self)

    async def run(self, fn, *args):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self.executor, fn, *args)

    def publish(self, event: dict) -> None:
        """Fan a mutation event to every feed subscriber. Slow-consumer
        policy (the reference stubs these endpoints, rest.rs:679-738, so
        this build defines the contract): a full subscriber queue DROPS
        the event for that subscriber only, and the subscriber is told
        with a ``{"type": "lagged", "dropped": N}`` marker delivered AT
        THE GAP POSITION — after every queued pre-gap event and before
        the first post-gap event — so a client that resyncs on the marker
        never replays stale pre-gap mutations over its fresh snapshot.
        The connection itself stays up; fast consumers never lose events
        (queue depth 256)."""
        for sub in list(self.subscribers):
            if sub.dropped:
                # a gap is open: close it with the marker before any
                # post-gap event may enqueue
                try:
                    sub.queue.put_nowait(
                        {"type": "lagged", "dropped": sub.dropped})
                    sub.dropped = 0
                except asyncio.QueueFull:
                    sub.dropped += 1  # this event extends the gap
                    continue
            try:
                sub.queue.put_nowait(event)
            except asyncio.QueueFull:
                sub.dropped += 1


class _Subscriber:
    __slots__ = ("queue", "dropped")

    def __init__(self):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=256)
        self.dropped = 0

    async def next_events(self) -> list:
        """Next event(s) to deliver. An open gap (drops with no post-gap
        event enqueued yet) is closed here once the queue drains — the
        consumer is then exactly at the gap position."""
        if self.dropped and self.queue.empty():
            n, self.dropped = self.dropped, 0
            return [{"type": "lagged", "dropped": n}]
        return [await self.queue.get()]


class SearchCoalescer:
    """Server-side micro-batching: concurrent /search requests form one
    [B, D] device batch.

    Natural batching, no timer: a worker drains everything queued while the
    previous device call was in flight, groups by (k, filter), and issues one
    ``session.search_batch`` per group. Under a single client this adds zero
    latency (the queue is empty, the request dispatches immediately); under
    concurrency the batch size adapts to device speed. The engine is already
    batch-native (one [B,D]x[D,N] matmul serves 128 queries in roughly the
    time of 1), so concurrent QPS scales far beyond 1/p50 instead of
    serializing whole requests through the 1-worker executor (the round-1
    bottleneck)."""

    MAX_BATCH = 512
    # device programs in flight before the oldest is finalized: JAX dispatch
    # is async, so keeping a few batches enqueued overlaps the host<->device
    # round-trip with device work without unbounded memory growth
    PIPELINE_DEPTH = 4

    def __init__(self, state: "AppState"):
        self.state = state
        self.queue: asyncio.Queue = asyncio.Queue()
        self._worker: asyncio.Task | None = None
        # observability: how much coalescing actually happens
        self.dispatches = 0
        self.requests = 0

    async def search(self, query: list, k: int, filter_json) -> list:
        # per-request validation BEFORE coalescing: a malformed query must
        # fail alone — grouped dispatch fans one error to every request in
        # the batch (measured: one wrong-dim query 400'd 9 good neighbors)
        sess = self.state.session
        try:
            q = np.asarray(query, np.float32)
        except (TypeError, ValueError) as e:
            raise VectorDBError("query vector contains non-numeric values",
                                "INVALID_INPUT") from e
        if q.ndim != 1 or not np.isfinite(q).all():
            raise VectorDBError(
                "query vector must be a flat list of finite numbers",
                "INVALID_INPUT")
        if sess.dim is not None and q.shape[0] != sess.dim:
            raise VectorDBError(
                f"query dimension {q.shape[0]} does not match index "
                f"dimension {sess.dim}", "INVALID_INPUT")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        # enqueue the validated f32 array, not the raw list: dispatch stacks
        # ndarrays cheaply instead of re-converting every query a second time
        await self.queue.put((q, k, filter_json, fut))
        if self._worker is None or self._worker.done():
            self._worker = asyncio.ensure_future(self._drain())
        return await fut

    async def _dispatch_round(self, pending: list) -> None:
        """Drain the queue once: group by (k, filter), dispatch each group's
        device program (no readback yet), append (group, finalize) handles."""
        items = []
        while not self.queue.empty() and len(items) < self.MAX_BATCH:
            items.append(self.queue.get_nowait())
        groups: dict = {}
        for query, k, flt, fut in items:
            try:
                key = (k, json.dumps(flt, sort_keys=True, default=repr))
            except Exception:  # noqa: BLE001 — unserializable filter
                key = (k, object())
            groups.setdefault(key, []).append((query, flt, fut))
        for (k, _), grp in groups.items():
            self.dispatches += 1
            self.requests += len(grp)
            queries = [g[0] for g in grp]
            flt = grp[0][1]
            try:
                finalize = await self.state.run(
                    self.state.session.search_batch_dispatch, queries, k, flt
                )
            except Exception as e:  # noqa: BLE001 — fan the error out
                for _, _, fut in grp:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            pending.append((grp, finalize))

    async def _drain(self) -> None:
        pending: list = []  # [(group, finalize)]
        while not self.queue.empty() or pending:
            # fill the pipeline: dispatch new batches while under depth
            while not self.queue.empty() and len(pending) < self.PIPELINE_DEPTH:
                await self._dispatch_round(pending)
            if not pending:
                continue
            grp, finalize = pending.pop(0)
            try:
                results = await self.state.run(finalize)
            except Exception as e:  # noqa: BLE001 — fan the error out
                for _, _, fut in grp:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for (_, _, fut), res in zip(grp, results):
                if not fut.done():
                    fut.set_result(res)


def _error(status: int, message: str, code: str = "ERROR"):
    return web.json_response(
        {"error": {"message": message, "code": code}}, status=status
    )


def _err_status(e: VectorDBError) -> int:
    return {
        "INVALID_INPUT": 400,
        "INVALID_CONFIG": 400,
        "INVALID_DATA": 400,
        "SESSION_ERROR": 409,
        "STORAGE_ERROR": 502,
        "S5_ERROR": 502,
        "INDEX_ERROR": 500,
    }.get(e.code, 500)


def create_app(config: ApiConfig | None = None,
               store: ObjectStore | None = None) -> web.Application:
    config = config or ApiConfig.from_env()
    store = store or StorageFactory.create_from_env()
    state = AppState(config, store)

    app = web.Application(client_max_size=config.max_request_size)
    app["state"] = state

    # ------------------------------------------------------------- handlers
    async def health(request: web.Request):
        stats = None
        if state.session.index is not None:
            stats = (await state.run(state.session.get_stats)).to_json()
        return web.json_response(
            {
                "status": "healthy",
                "version": __version__,
                "storage_mode": type(store).__name__,
                "stats": stats,
            }
        )

    def _vector_key(vid: str) -> str:
        return f"{config.session_id}/vectors/{vid}.cbor"

    def _persist_vector(vid: str, vector: list, metadata) -> None:
        # per-vector durability independent of /session/save (reference
        # insert handler persists to storage, rest.rs:392-447)
        from .. import cbor as _cbor

        try:
            store.put(_vector_key(vid), _cbor.dumps(
                {"id": vid, "vector": vector, "metadata": metadata}
            ))
        except Exception:  # noqa: BLE001 — persist is best-effort
            log.warning("vector persist failed for %s", vid, exc_info=True)

    async def insert_vector(request: web.Request):
        body = await request.json()
        vid = body.get("id")
        vector = body.get("vector")
        metadata = body.get("metadata")
        if not vid or not isinstance(vector, list):
            return _error(400, "id and vector are required", "INVALID_INPUT")
        try:
            await state.run(
                state.session.add_vectors,
                [{"id": vid, "vector": vector, "metadata": metadata}],
            )
        except VectorDBError as e:
            return _error(_err_status(e), e.message, e.code)
        await state.run(_persist_vector, vid, vector, metadata)
        state.publish({"type": "insert", "id": vid})
        return web.json_response({"id": vid, "status": "inserted"}, status=201)

    async def insert_batch(request: web.Request):
        body = await request.json()
        vectors = body.get("vectors")
        if not isinstance(vectors, list) or not vectors:
            return _error(400, "vectors array is required", "INVALID_INPUT")
        inserted, errors = [], []
        # fast path: bulk insert (lets the session's first-batch IVF training
        # see the whole batch); fall back to per-item partial success
        # (parity :449-531) when any item is invalid
        try:
            await state.run(state.session.add_vectors, vectors)
            inserted = [item.get("id") for item in vectors]
        except Exception:  # noqa: BLE001
            for item in vectors:
                try:
                    await state.run(state.session.add_vectors, [item])
                    inserted.append(item.get("id"))
                except Exception as e:  # noqa: BLE001
                    errors.append({"id": item.get("id"), "error": str(e)})
        by_id = {item.get("id"): item for item in vectors}
        for vid in inserted:
            item = by_id.get(vid) or {}
            await state.run(
                _persist_vector, vid, item.get("vector"), item.get("metadata")
            )
            state.publish({"type": "insert", "id": vid})
        return web.json_response(
            {"inserted": len(inserted), "failed": len(errors), "errors": errors},
            status=201 if inserted else 400,
        )

    async def get_vector(request: web.Request):
        vid = request.match_info["id"]
        sess = state.session
        try:
            if sess.index is None:
                raise VectorDBError("no index", "SESSION_ERROR")
            iid = await state.run(sess._resolve, vid)
        except VectorDBError:
            # memory -> storage fallback (reference rest.rs:533-570)
            from .. import cbor as _cbor

            try:
                blob = await state.run(store.get, _vector_key(vid))
                obj = _cbor.loads(blob)
                return web.json_response(
                    {"id": vid, "vector": obj.get("vector"),
                     "metadata": obj.get("metadata"), "source": "storage"}
                )
            except Exception:  # noqa: BLE001
                return _error(404, f"vector {vid!r} not found", "NOT_FOUND")
        vec = await state.run(sess.index.get_vector, iid)
        return web.json_response(
            {
                "id": vid,
                "vector": [float(x) for x in vec],
                "metadata": sess._user_metadata(iid),
            }
        )

    async def delete_vector(request: web.Request):
        vid = request.match_info["id"]
        try:
            await state.run(state.session.delete_vector, vid)
        except VectorDBError as e:
            return _error(404, e.message, e.code)
        try:
            await state.run(store.delete, _vector_key(vid))
        except Exception:  # noqa: BLE001
            pass
        state.publish({"type": "delete", "id": vid})
        return web.json_response({"id": vid, "status": "deleted"})

    async def search(request: web.Request):
        body = await request.json()
        query = body.get("vector") or body.get("query")
        if not isinstance(query, list):
            return _error(400, "query vector is required", "INVALID_INPUT")
        k = body.get("k", 10)
        if not isinstance(k, int) or isinstance(k, bool) \
                or k < 1 or k > 16_384:
            return _error(400, f"k must be an integer in [1, 16384], got {k!r}",
                          "INVALID_INPUT")
        options = body.get("options") or {}
        threshold = float(
            options.get("score_threshold", options.get("threshold", 0.0))
        )
        include = bool(options.get("include_vectors", False))
        flt = options.get("filter") or body.get("filter")
        try:
            items = await state.coalescer.search(query, k, flt)
        except VectorDBError as e:
            return _error(_err_status(e), e.message, e.code)
        # per-request options applied outside the shared device batch
        results = []
        for item in items:
            if item["score"] < threshold:
                continue
            out = {k2: v for k2, v in item.items() if k2 != "_iid"}
            if include:
                out["vector"] = [
                    float(x)
                    for x in await state.run(
                        state.session.index.get_vector, item["_iid"]
                    )
                ]
            results.append(out)
        return web.json_response({"results": results, "count": len(results)})

    async def statistics(request: web.Request):
        if state.session.index is None:
            return web.json_response({
                "initialized": False,
                "stream": {"subscribers": len(state.subscribers)},
            })
        stats = await state.run(state.session.get_stats)
        perf = state.session.monitor.stats()
        return web.json_response(
            {
                "initialized": True,
                "index": stats.to_json(),
                "search_perf": perf,
                "coalescer": {
                    "requests": state.coalescer.requests,
                    "dispatches": state.coalescer.dispatches,
                },
                "stream": {"subscribers": len(state.subscribers)},
                "serving": state.session.index.fused.serving_info(),
            }
        )

    async def metrics(request: web.Request):
        """Prometheus text exposition (version 0.0.4) of the same counters
        /admin/statistics serves as JSON. Beyond reference parity: the
        reference has no Prometheus/OTel surface at all (SURVEY §5
        observability)."""
        from .. import __version__

        lines = [
            "# HELP fvdb_build_info Build metadata.",
            "# TYPE fvdb_build_info gauge",
            f'fvdb_build_info{{version="{__version__}"}} 1',
            "# HELP fvdb_stream_subscribers Live SSE/WS subscribers.",
            "# TYPE fvdb_stream_subscribers gauge",
            f"fvdb_stream_subscribers {len(state.subscribers)}",
            "# HELP fvdb_coalescer_requests_total Search requests received.",
            "# TYPE fvdb_coalescer_requests_total counter",
            f"fvdb_coalescer_requests_total {state.coalescer.requests}",
            "# HELP fvdb_coalescer_dispatches_total Device batches dispatched.",
            "# TYPE fvdb_coalescer_dispatches_total counter",
            f"fvdb_coalescer_dispatches_total {state.coalescer.dispatches}",
        ]
        if state.session.index is not None:
            stats = (await state.run(state.session.get_stats)).to_json()
            perf = state.session.monitor.stats()
            info = state.session.index.fused.serving_info()
            lines += [
                "# HELP fvdb_vectors Active vectors per index tier.",
                "# TYPE fvdb_vectors gauge",
                f'fvdb_vectors{{index="hnsw"}} {stats["hnswVectorCount"]}',
                f'fvdb_vectors{{index="ivf"}} {stats["ivfVectorCount"]}',
                "# HELP fvdb_deleted_vectors Soft-deleted (pre-vacuum) rows.",
                "# TYPE fvdb_deleted_vectors gauge",
                f"fvdb_deleted_vectors {stats['totalDeletedCount']}",
                "# HELP fvdb_memory_usage_mb Estimated host index memory.",
                "# TYPE fvdb_memory_usage_mb gauge",
                f"fvdb_memory_usage_mb {stats['memoryUsageMb']}",
                "# HELP fvdb_searches_total Searches served.",
                "# TYPE fvdb_searches_total counter",
                f"fvdb_searches_total {perf.get('total_searches', 0)}",
                "# HELP fvdb_serving_regime_info Active query plan.",
                "# TYPE fvdb_serving_regime_info gauge",
                f'fvdb_serving_regime_info{{regime="{info["regime"]}",'
                f'dtype="{info["serving_dtype"]}"}} 1',
            ]
            if perf.get("total_searches", 0):
                lines += [
                    "# HELP fvdb_search_latency_ms Search latency quantiles.",
                    "# TYPE fvdb_search_latency_ms summary",
                    'fvdb_search_latency_ms{quantile="0.5"} '
                    f"{perf['p50_ms']:.3f}",
                    'fvdb_search_latency_ms{quantile="0.99"} '
                    f"{perf['p99_ms']:.3f}",
                ]
        return web.Response(
            text="\n".join(lines) + "\n",
            content_type="text/plain",
            charset="utf-8",
        )

    async def migrate(request: web.Request):
        if state.session.index is None:
            return _error(409, "index not initialized", "SESSION_ERROR")
        moved = await state.run(state.session.index.migrate_all)
        return web.json_response({"migrated": moved})

    async def rebalance(request: web.Request):
        sess = state.session
        if sess.index is None or not sess.index.ivf.trained:
            return _error(409, "IVF index not trained", "SESSION_ERROR")
        moves = await state.run(sess.index.ivf.balance_clusters)
        return web.json_response({"moved": moves})

    async def backup(request: web.Request):
        if state.session.index is None:
            return _error(409, "index not initialized", "SESSION_ERROR")
        prefix, compress = "backup", False
        if request.can_read_body:
            try:
                body = await request.json()
                prefix = body.get("backup_path") or "backup"
                compress = bool(body.get("compress", False))
            except Exception:  # noqa: BLE001 — empty/invalid body: defaults
                pass
        cid = await state.run(state.session.save_to_s5)
        await state.run(
            lambda: state.session._persister.backup(cid, prefix, compress)
        )
        return web.json_response(
            {"backup": cid, "backup_path": prefix, "compressed": compress}
        )

    # ------------------------------------------------ session-level routes
    # Beyond the reference REST surface: the reference exposes these only
    # through the in-process Node binding (bindings/node/src/session.rs);
    # here the engine lives in the serving process, so remote SDKs (the
    # Node SDK in bindings/node) reach them over HTTP.
    async def delete_by_metadata(request: web.Request):
        body = await request.json()
        flt = body.get("filter")
        if flt is None:
            return _error(400, "filter is required", "INVALID_INPUT")
        try:
            result = await state.run(state.session.delete_by_metadata, flt)
        except VectorDBError as e:
            return _error(_err_status(e), e.message, e.code)
        state.publish({"type": "delete_by_metadata", "count": result.deleted_count})
        return web.json_response(result.to_json())

    async def update_metadata(request: web.Request):
        vid = request.match_info["id"]
        body = await request.json()
        if "metadata" not in body:
            return _error(400, "metadata is required", "INVALID_INPUT")
        try:
            await state.run(state.session.update_metadata, vid, body["metadata"])
        except VectorDBError as e:
            return _error(_err_status(e), e.message, e.code)
        state.publish({"type": "update_metadata", "id": vid})
        return web.json_response({"id": vid, "status": "updated"})

    async def session_save(request: web.Request):
        try:
            cid = await state.run(state.session.save_to_s5)
        except VectorDBError as e:
            return _error(_err_status(e), e.message, e.code)
        return web.json_response({"cid": cid})

    async def session_load(request: web.Request):
        body = await request.json()
        cid = body.get("cid")
        if not cid:
            return _error(400, "cid is required", "INVALID_INPUT")
        try:
            await state.run(state.session.load_user_vectors, cid,
                            body.get("options"))
        except VectorDBError as e:
            return _error(_err_status(e), e.message, e.code)
        if os.environ.get("FVDB_PREWARM", "1") != "0":
            # serve-ready before the response returns: upload + compile now
            # instead of on the first query (cold first search was 5 s at
            # 1M when both were lazy)
            await state.run(state.session.prewarm)
        stats = await state.run(state.session.get_stats)
        return web.json_response({"cid": cid, "loaded": stats.vector_count})

    async def session_schema(request: web.Request):
        body = await request.json()
        try:
            await state.run(state.session.set_schema, body.get("schema"))
        except VectorDBError as e:
            return _error(_err_status(e), e.message, e.code)
        return web.json_response({"status": "ok"})

    async def session_vacuum(request: web.Request):
        try:
            stats = await state.run(state.session.vacuum)
        except VectorDBError as e:
            return _error(_err_status(e), e.message, e.code)
        state.publish({"type": "vacuum", "removed": stats.total_removed})
        return web.json_response(stats.to_json())

    async def session_stats(request: web.Request):
        try:
            stats = await state.run(state.session.get_stats)
        except VectorDBError as e:
            return _error(_err_status(e), e.message, e.code)
        return web.json_response(stats.to_json())

    async def stream_updates(request: web.Request):
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            }
        )
        await resp.prepare(request)
        sub = _Subscriber()
        state.subscribers.append(sub)
        try:
            while True:
                for event in await sub.next_events():
                    payload = f"data: {json.dumps(event)}\n\n"
                    await resp.write(payload.encode())
        except (ConnectionResetError, asyncio.CancelledError):
            pass  # client went away mid-stream: unsubscribe below
        finally:
            if sub in state.subscribers:
                state.subscribers.remove(sub)
        return resp

    async def websocket(request: web.Request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        sub = _Subscriber()
        state.subscribers.append(sub)

        async def pusher():
            while True:
                for event in await sub.next_events():
                    await ws.send_json(event)

        task = asyncio.ensure_future(pusher())
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    if msg.data == "ping":
                        await ws.send_str("pong")
                elif msg.type == WSMsgType.ERROR:
                    break
        finally:
            task.cancel()
            if sub in state.subscribers:
                state.subscribers.remove(sub)
        return ws

    # --------------------------------------------------------------- routes
    prefix = "/api/v1"
    app.router.add_get(f"{prefix}/health", health)
    app.router.add_post(f"{prefix}/vectors", insert_vector)
    app.router.add_post(f"{prefix}/vectors/batch", insert_batch)
    app.router.add_get(f"{prefix}/vectors/{{id}}", get_vector)
    app.router.add_delete(f"{prefix}/vectors/{{id}}", delete_vector)
    app.router.add_post(f"{prefix}/search", search)
    app.router.add_get(f"{prefix}/admin/statistics", statistics)
    app.router.add_get("/metrics", metrics)  # Prometheus scrape endpoint
    app.router.add_post(f"{prefix}/admin/migrate", migrate)
    app.router.add_post(f"{prefix}/admin/rebalance", rebalance)
    app.router.add_post(f"{prefix}/admin/backup", backup)
    app.router.add_post(f"{prefix}/vectors/delete-by-metadata", delete_by_metadata)
    app.router.add_patch(f"{prefix}/vectors/{{id}}/metadata", update_metadata)
    app.router.add_post(f"{prefix}/session/save", session_save)
    app.router.add_post(f"{prefix}/session/load", session_load)
    app.router.add_put(f"{prefix}/session/schema", session_schema)
    app.router.add_post(f"{prefix}/session/vacuum", session_vacuum)
    app.router.add_get(f"{prefix}/session/stats", session_stats)
    app.router.add_get(f"{prefix}/stream/updates", stream_updates)
    app.router.add_get(f"{prefix}/ws", websocket)

    # ----------------------------------------------------------------- CORS
    allowed_origins = [o.strip() for o in config.cors_origins if o.strip()]
    wildcard = allowed_origins == ["*"]

    @web.middleware
    async def cors_middleware(request, handler):
        if request.method == "OPTIONS":
            resp = web.Response(status=204)
        else:
            resp = await handler(request)
        # the header only admits a single origin or '*': echo the request
        # Origin when it's on the allowlist (with Vary: Origin so caches
        # don't leak one origin's grant to another)
        origin = request.headers.get("Origin")
        if wildcard:
            resp.headers["Access-Control-Allow-Origin"] = "*"
        elif origin and origin in allowed_origins:
            resp.headers["Access-Control-Allow-Origin"] = origin
            resp.headers["Vary"] = "Origin"
        resp.headers["Access-Control-Allow-Methods"] = (
            "GET,POST,PUT,PATCH,DELETE,OPTIONS"
        )
        resp.headers["Access-Control-Allow-Headers"] = "Content-Type"
        return resp

    # ------------------------------------------------------- error shaping
    @web.middleware
    async def error_middleware(request, handler):
        try:
            return await handler(request)
        except web.HTTPException:
            raise
        except json.JSONDecodeError:
            return _error(400, "request body is not valid JSON", "INVALID_INPUT")
        except Exception as e:  # noqa: BLE001 — uniform JSON error envelope
            log.exception("unhandled error on %s %s", request.method, request.path)
            return _error(500, str(e), "INDEX_ERROR")

    app.middlewares.append(cors_middleware)
    app.middlewares.append(error_middleware)

    async def _startup_prewarm(app: web.Application):
        """Serve-ready at listen time: if an index already exists (restored
        state / preloaded store), upload + compile before the first
        request. FVDB_PREWARM=0 disables."""
        if os.environ.get("FVDB_PREWARM", "1") != "0" \
                and state.session.index is not None:
            secs = await state.run(state.session.prewarm)
            log.info("prewarm: serving state ready in %.2fs", secs)

    app.on_startup.append(_startup_prewarm)
    return app
