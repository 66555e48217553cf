"""ObjectStore protocol + resilience decorators + test fakes.

Python equivalent of the reference's ``S5Storage`` trait stack
(reference: src/core/storage.rs):
  - the narrow {get, put, delete, list} interface (:25-30);
  - ``CachedObjectStore``: LRU + TTL + memory cap with hit/miss stats (:39-277);
  - ``RetryObjectStore``: exponential backoff + jitter + circuit breaker with
    failure threshold and reset timeout (:280-481);
  - ``BatchObjectStore``: write/delete buffering with background flush (:484-635);
  - ``MemoryObjectStore``: the in-memory HashMap fake with per-path call
    counting — the universal test backend (:637-683).

The interface is synchronous (host-side I/O feeding device transfers);
parallelism happens in the chunk loader's thread pool, and the REST layer
wraps calls in an executor.
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Protocol, runtime_checkable


class StorageError(RuntimeError):
    pass


class NotFoundError(StorageError, KeyError):
    pass


@runtime_checkable
class ObjectStore(Protocol):
    """Narrow blob-store interface; keys are '/'-separated paths."""

    def get(self, key: str) -> bytes: ...

    def put(self, key: str, data: bytes) -> None: ...

    def delete(self, key: str) -> None: ...

    def list_keys(self, prefix: str = "") -> list: ...

    def exists(self, key: str) -> bool: ...


class _BaseStore:
    #: True when ``get`` releases the GIL for long stretches (network /
    #: remote IO) so concurrent fetches genuinely overlap. Local stores
    #: (memory, filesystem page cache) keep it False: their "fetch" is
    #: GIL-bound byte shuffling, and a thread pool only adds convoy
    #: overhead (measured 10.4 s pooled vs 1.0 s serial for 100 x 15 MB
    #: chunks on a 1-core host). ChunkLoader sizes its fan-out from this.
    parallel_fetch = False
    #: True when ``get_range`` reads only the requested bytes from the
    #: backend (pread / HTTP Range). The default implementation below is
    #: always CORRECT (full fetch + slice) but saves no IO, so callers
    #: that plan sub-object reads (lazy cold serving) check this flag
    #: before choosing the range-read strategy.
    supports_range = False

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        """Bytes ``[offset, offset+length)`` of the object. Reads past the
        end are truncated (HTTP Range semantics), not errors."""
        data = self.get(key)
        return data[offset: offset + length]

    def exists(self, key: str) -> bool:
        try:
            self.get(key)
            return True
        except NotFoundError:
            return False


class _DecoratorStore(_BaseStore):
    """Base for stores that wrap an ``inner`` store: forwards the IO
    profile so a decorator chain over a network store keeps the chunk
    loader's full fetch fan-out (and its byte-range capability)."""

    inner: "ObjectStore"

    @property
    def parallel_fetch(self) -> bool:
        return getattr(self.inner, "parallel_fetch", False)

    @property
    def supports_range(self) -> bool:
        return getattr(self.inner, "supports_range", False)

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        inner_range = getattr(self.inner, "get_range", None)
        if inner_range is not None:
            return inner_range(key, offset, length)
        return self.inner.get(key)[offset: offset + length]


class MemoryObjectStore(_BaseStore):
    """In-memory store with per-path call counting (the universal test fake)."""

    supports_range = True

    def __init__(self, fail_on: dict | None = None):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.get_calls: dict[str, int] = {}
        self.put_calls: dict[str, int] = {}
        self.delete_calls: dict[str, int] = {}
        self.range_calls: dict[str, int] = {}
        # Optional fault injection: {key: n} -> first n gets on key raise.
        self.fail_on = dict(fail_on or {})

    def get(self, key: str) -> bytes:
        with self._lock:
            self.get_calls[key] = self.get_calls.get(key, 0) + 1
            remaining = self.fail_on.get(key, 0)
            if remaining > 0:
                self.fail_on[key] = remaining - 1
                raise StorageError(f"injected failure for {key}")
            if key not in self._data:
                raise NotFoundError(key)
            return self._data[key]

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self.put_calls[key] = self.put_calls.get(key, 0) + 1
            self._data[key] = bytes(data)

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        with self._lock:
            self.range_calls[key] = self.range_calls.get(key, 0) + 1
            remaining = self.fail_on.get(key, 0)
            if remaining > 0:
                self.fail_on[key] = remaining - 1
                raise StorageError(f"injected failure for {key}")
            if key not in self._data:
                raise NotFoundError(key)
            return self._data[key][offset: offset + length]

    def delete(self, key: str) -> None:
        with self._lock:
            self.delete_calls[key] = self.delete_calls.get(key, 0) + 1
            self._data.pop(key, None)

    def list_keys(self, prefix: str = "") -> list:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def total_get_calls(self) -> int:
        return sum(self.get_calls.values())


class FileSystemObjectStore(_BaseStore):
    """Local-filesystem store; keys map to files under a root directory."""

    supports_range = True

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.abspath(os.path.join(self.root, key))
        if not path.startswith(self.root + os.sep) and path != self.root:
            raise StorageError(f"key escapes store root: {key}")
        return path

    def get(self, key: str) -> bytes:
        path = self._path(key)
        if not os.path.isfile(path):
            raise NotFoundError(key)
        with open(path, "rb") as f:
            return f.read()

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        path = self._path(key)
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            raise NotFoundError(key) from None
        try:
            # pread: positioned read of exactly the requested window — no
            # full-file read, no shared file-offset state across threads
            out = []
            remaining = length
            pos = offset
            while remaining > 0:
                b = os.pread(fd, remaining, pos)
                if not b:
                    break  # read past EOF truncates (Range semantics)
                out.append(b)
                pos += len(b)
                remaining -= len(b)
            return b"".join(out)
        finally:
            os.close(fd)

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.isfile(path):
            os.remove(path)

    def list_keys(self, prefix: str = "") -> list:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))


# --------------------------------------------------------------------------
# Decorators
# --------------------------------------------------------------------------


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class CachedObjectStore(_DecoratorStore):
    """Read-through LRU cache with TTL and a memory cap."""

    def __init__(
        self,
        inner: ObjectStore,
        max_entries: int = 256,
        ttl_seconds: float | None = None,
        max_bytes: int | None = None,
        clock=time.monotonic,
    ):
        self.inner = inner
        self.max_entries = max_entries
        self.ttl = ttl_seconds
        self.max_bytes = max_bytes
        self._clock = clock
        self._cache: OrderedDict[str, tuple] = OrderedDict()  # key -> (data, t)
        self._bytes = 0
        self._lock = threading.Lock()
        self.stats = CacheStats()

    def get(self, key: str) -> bytes:
        now = self._clock()
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                data, t = entry
                if self.ttl is None or now - t <= self.ttl:
                    self._cache.move_to_end(key)
                    self.stats.hits += 1
                    return data
                self._cache.pop(key)
                self._bytes -= len(data)
            self.stats.misses += 1
        data = self.inner.get(key)
        with self._lock:
            self._insert(key, data, now)
        return data

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        # A fresh fully-cached blob answers any range locally; otherwise
        # forward to the inner store WITHOUT caching the partial (a partial
        # blob under a full-get key would corrupt later reads). Mirrors
        # get()'s stats and TTL bookkeeping: forwarded ranges count as
        # misses, and an expired entry is evicted (not left holding its
        # byte budget until some later full get()).
        now = self._clock()
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                data, t = entry
                if self.ttl is None or now - t <= self.ttl:
                    self._cache.move_to_end(key)
                    self.stats.hits += 1
                    return data[offset: offset + length]
                self._cache.pop(key)
                self._bytes -= len(data)
            self.stats.misses += 1
        return super().get_range(key, offset, length)

    def _insert(self, key: str, data: bytes, now: float) -> None:
        if key in self._cache:
            old, _ = self._cache.pop(key)
            self._bytes -= len(old)
        self._cache[key] = (data, now)
        self._bytes += len(data)
        while len(self._cache) > self.max_entries or (
            self.max_bytes is not None
            and self._bytes > self.max_bytes
            and len(self._cache) > 1
        ):
            _, (old, _) = self._cache.popitem(last=False)
            self._bytes -= len(old)
            self.stats.evictions += 1

    def put(self, key: str, data: bytes) -> None:
        self.inner.put(key, data)
        with self._lock:
            self._insert(key, bytes(data), self._clock())

    def delete(self, key: str) -> None:
        self.inner.delete(key)
        with self._lock:
            entry = self._cache.pop(key, None)
            if entry:
                self._bytes -= len(entry[0])

    def list_keys(self, prefix: str = "") -> list:
        return self.inner.list_keys(prefix)

    def invalidate(self, key: str | None = None) -> None:
        with self._lock:
            if key is None:
                self._cache.clear()
                self._bytes = 0
            else:
                entry = self._cache.pop(key, None)
                if entry:
                    self._bytes -= len(entry[0])


class CircuitOpenError(StorageError):
    pass


class CircuitBreaker:
    """Failure-threshold circuit breaker with reset timeout (half-open probe)."""

    def __init__(self, failure_threshold: int = 5, reset_timeout: float = 30.0,
                 clock=time.monotonic):
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._failures = 0
        self._opened_at: float | None = None
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self._clock() - self._opened_at >= self.reset_timeout:
                return "half-open"
            return "open"

    def before_call(self) -> None:
        state = self.state
        if state == "open":
            raise CircuitOpenError("circuit breaker is open")

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = self._clock()


class RetryObjectStore(_DecoratorStore):
    """Exponential backoff + jitter retries around every operation."""

    def __init__(
        self,
        inner: ObjectStore,
        max_retries: int = 3,
        base_delay: float = 0.1,
        max_delay: float = 5.0,
        jitter: float = 0.1,
        breaker: CircuitBreaker | None = None,
        sleep=time.sleep,
    ):
        self.inner = inner
        self.max_retries = max_retries
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.jitter = jitter
        self.breaker = breaker or CircuitBreaker()
        self._sleep = sleep

    def _with_retry(self, fn, *args):
        self.breaker.before_call()
        last_exc: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                result = fn(*args)
                self.breaker.record_success()
                return result
            except NotFoundError:
                # Missing keys are not transient; don't trip the breaker.
                raise
            except Exception as e:  # noqa: BLE001 - storage drivers raise anything
                last_exc = e
                self.breaker.record_failure()
                if attempt < self.max_retries:
                    delay = min(self.base_delay * (2 ** attempt), self.max_delay)
                    delay += random.uniform(0, self.jitter * delay)
                    self._sleep(delay)
        raise StorageError(f"operation failed after {self.max_retries + 1} attempts") from last_exc

    def get(self, key: str) -> bytes:
        return self._with_retry(self.inner.get, key)

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        return self._with_retry(super().get_range, key, offset, length)

    def put(self, key: str, data: bytes) -> None:
        return self._with_retry(self.inner.put, key, data)

    def delete(self, key: str) -> None:
        return self._with_retry(self.inner.delete, key)

    def list_keys(self, prefix: str = "") -> list:
        return self._with_retry(self.inner.list_keys, prefix)


class BatchObjectStore(_DecoratorStore):
    """Buffers puts/deletes and flushes on size or explicit flush().

    A background flusher thread drains the buffer periodically (the
    reference spawns a tokio task; we use a daemon thread).
    """

    def __init__(
        self,
        inner: ObjectStore,
        max_buffer: int = 64,
        flush_interval: float | None = None,
    ):
        self.inner = inner
        self.max_buffer = max_buffer
        self._writes: OrderedDict[str, bytes] = OrderedDict()
        self._deletes: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        if flush_interval:
            self._thread = threading.Thread(
                target=self._flusher, args=(flush_interval,), daemon=True
            )
            self._thread.start()

    def _flusher(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.flush()

    def get(self, key: str) -> bytes:
        with self._lock:
            if key in self._writes:
                return self._writes[key]
            if key in self._deletes:
                raise NotFoundError(key)
        return self.inner.get(key)

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        with self._lock:
            if key in self._writes:
                return self._writes[key][offset: offset + length]
            if key in self._deletes:
                raise NotFoundError(key)
        return super().get_range(key, offset, length)

    def put(self, key: str, data: bytes) -> None:
        flush_needed = False
        with self._lock:
            self._deletes.discard(key)
            self._writes[key] = bytes(data)
            flush_needed = len(self._writes) + len(self._deletes) >= self.max_buffer
        if flush_needed:
            self.flush()

    def delete(self, key: str) -> None:
        with self._lock:
            self._writes.pop(key, None)
            self._deletes.add(key)

    def list_keys(self, prefix: str = "") -> list:
        self.flush()
        return self.inner.list_keys(prefix)

    def flush(self) -> None:
        with self._lock:
            writes = list(self._writes.items())
            deletes = list(self._deletes)
            self._writes.clear()
            self._deletes.clear()
        for key, data in writes:
            self.inner.put(key, data)
        for key in deletes:
            self.inner.delete(key)

    def close(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        self.flush()
