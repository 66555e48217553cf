"""Server binary: env config + graceful shutdown.

Parity with the reference server binary (reference: src/bin/server.rs:11-94):
env-driven config (VECTOR_DB_HOST/PORT/MAX_REQUEST_SIZE/TIMEOUT_SECS/
CORS_ORIGINS, VECTOR_DIMENSION), structured logging with env filter,
SIGINT/SIGTERM graceful shutdown. Run: ``python -m
fabstir_vectordb_tpu.api.server``.
"""
from __future__ import annotations

import asyncio
import signal

from aiohttp import web

from ..utils.tracing import get_logger
from .rest import ApiConfig, create_app

log = get_logger("fabstir_vectordb_tpu.server")


async def serve(config: ApiConfig | None = None) -> None:
    config = config or ApiConfig.from_env()
    app = create_app(config)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, config.host, config.port)
    await site.start()
    log.info("vector-db REST server listening on %s:%s", config.host, config.port)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover
            pass
    await stop.wait()
    log.info("shutting down gracefully")
    await runner.cleanup()


def main() -> None:
    from ..utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()  # warm restarts load compiled programs
    asyncio.run(serve())


if __name__ == "__main__":
    main()
