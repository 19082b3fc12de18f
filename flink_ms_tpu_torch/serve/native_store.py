"""ctypes binding of the port's C++ persistent store, lookup server and
arena reader (``flink_ms_tpu_torch/native/``): the ``--stateBackend
rocksdb`` mode of the serving job (the reference keeps served state in
RocksDB through JNI; a bitcask-style log-structured store plays that role)
and the ``--nativeServer true`` data plane.

Own copy of ``flink_ms_tpu/serve/native_store.py``: the same classes, ABI
declarations and on-disk store format, so a store directory written by
either package's library opens in the other.  The library is the port's
own build of its own sources (``native/_build.py``: ``g++`` at first use
into ``build/native/``), loaded ``RTLD_LOCAL`` so that its ``tpums_*``
symbols never bind to the JAX package's library when both are loaded in
one process.  ``TPUMS_NATIVE_LIB`` names another build to load instead
(the sanitizer variants).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import threading
from typing import Iterator, List, Optional, Tuple

_lib = None
_lib_lock = threading.Lock()

_KEY_CB = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_char), ctypes.c_uint32, ctypes.c_void_p
)


def library_path() -> str:
    """The library ``_load_lib`` maps: ``TPUMS_NATIVE_LIB`` when set, else
    the port's build under ``build/native/`` (compiled here if needed)."""
    override = os.environ.get("TPUMS_NATIVE_LIB")
    if override:
        return override
    from ..native import _build

    return str(_build.build())


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _declare_abi(ctypes.CDLL(library_path(),
                                            mode=os.RTLD_LOCAL))
        return _lib


def _declare_abi(lib):
    lib.tpums_open.restype = ctypes.c_void_p
    lib.tpums_open.argtypes = [ctypes.c_char_p]
    lib.tpums_put.restype = ctypes.c_int
    lib.tpums_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.tpums_get.restype = ctypes.POINTER(ctypes.c_char)
    lib.tpums_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int),
    ]
    lib.tpums_free_buf.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.tpums_delete.restype = ctypes.c_int
    lib.tpums_delete.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.tpums_count.restype = ctypes.c_uint64
    lib.tpums_count.argtypes = [ctypes.c_void_p]
    lib.tpums_flush.restype = ctypes.c_int
    lib.tpums_flush.argtypes = [ctypes.c_void_p]
    lib.tpums_keys.restype = ctypes.c_int
    lib.tpums_keys.argtypes = [ctypes.c_void_p, _KEY_CB, ctypes.c_void_p]
    lib.tpums_log_bytes.restype = ctypes.c_uint64
    lib.tpums_log_bytes.argtypes = [ctypes.c_void_p]
    lib.tpums_live_bytes.restype = ctypes.c_uint64
    lib.tpums_live_bytes.argtypes = [ctypes.c_void_p]
    lib.tpums_compact.restype = ctypes.c_int
    lib.tpums_compact.argtypes = [ctypes.c_void_p]
    lib.tpums_close.argtypes = [ctypes.c_void_p]
    lib.tpums_ingest_buf.restype = ctypes.c_int
    lib.tpums_ingest_buf.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.tpums_arena_open.restype = ctypes.c_void_p
    lib.tpums_arena_open.argtypes = [ctypes.c_char_p]
    lib.tpums_arena_refresh.restype = ctypes.c_int
    lib.tpums_arena_refresh.argtypes = [ctypes.c_void_p]
    lib.tpums_arena_read_retries.restype = ctypes.c_uint64
    lib.tpums_arena_read_retries.argtypes = [ctypes.c_void_p]
    lib.tpums_arena_stats.restype = ctypes.c_int
    lib.tpums_arena_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.tpums_arena_write_stats.restype = ctypes.c_int
    lib.tpums_arena_write_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    try:
        # absent from older builds a TPUMS_NATIVE_LIB may name: every
        # caller treats the missing symbol as "no CPU data", like a
        # sidecar that predates the write_cpu_ns field
        lib.tpums_arena_write_cpu_seconds.restype = ctypes.c_int
        lib.tpums_arena_write_cpu_seconds.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ]
    except AttributeError:
        pass
    lib.tpums_arena_writer_open.restype = ctypes.c_void_p
    lib.tpums_arena_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tpums_arena_writer_close.argtypes = [ctypes.c_void_p]
    lib.tpums_arena_put_batch.restype = ctypes.c_longlong
    lib.tpums_arena_put_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.tpums_arena_cas_floats.restype = ctypes.c_int
    lib.tpums_arena_cas_floats.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.tpums_server_start.restype = ctypes.c_void_p
    lib.tpums_server_start.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.tpums_server_start2.restype = ctypes.c_void_p
    lib.tpums_server_start2.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.tpums_server_start3.restype = ctypes.c_void_p
    lib.tpums_server_start3.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.tpums_server_set_health.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tpums_server_set_trace.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int]
    lib.tpums_server_port.restype = ctypes.c_int
    lib.tpums_server_port.argtypes = [ctypes.c_void_p]
    lib.tpums_server_requests.restype = ctypes.c_uint64
    lib.tpums_server_requests.argtypes = [ctypes.c_void_p]
    lib.tpums_server_io_stats.restype = ctypes.c_int
    lib.tpums_server_io_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.tpums_server_stop.argtypes = [ctypes.c_void_p]
    return lib


class StoreLockedError(OSError):
    """Another process holds the store's writer lock."""


class NativeStore:
    """Persistent string->string store backed by the C++ log."""

    def __init__(self, directory: str):
        self._lib = _load_lib()
        os.makedirs(directory, exist_ok=True)
        self._h = self._lib.tpums_open(directory.encode("utf-8"))
        if not self._h:
            if self._is_locked(directory):
                raise StoreLockedError(
                    f"store {directory} is locked by another writer"
                )
            raise OSError(f"tpums_open failed for {directory}")
        self.directory = directory
        # guards every native call against close(): a thread that captured
        # self._h just before close() frees the Store would otherwise
        # dereference freed memory (a TOCTOU that shows as a tpums_get
        # I/O failure on a live key under a long soak).  The native layer
        # already serializes under its own mutex, so this adds no new
        # contention — it only makes close() an exclusion point.
        self._call_lock = threading.RLock()

    def _live_handle(self):
        h = self._h
        if not h:
            raise OSError(f"store {self.directory} is closed")
        return h

    @staticmethod
    def _is_locked(directory: str) -> bool:
        log = os.path.join(directory, "data.log")
        try:
            fd = os.open(log, os.O_RDWR)
        except OSError:
            return False
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            fcntl.flock(fd, fcntl.LOCK_UN)
            return False
        except OSError:
            return True
        finally:
            os.close(fd)

    def put(self, key: str, value: str) -> None:
        k = key.encode("utf-8")
        v = value.encode("utf-8")
        with self._call_lock:
            if self._lib.tpums_put(self._live_handle(), k, len(k), v,
                                   len(v)) != 0:
                raise OSError("tpums_put failed")

    def ingest_buf(self, data: bytes, mode: int) -> Tuple[int, int]:
        """Bulk-ingest a chunk of complete journal lines natively.

        mode 0 = ALS rows (key ``id-T``), 1 = SVM rows (key = first comma
        token).  -> (rows ingested, parse errors)."""
        rows = ctypes.c_uint64(0)
        errs = ctypes.c_uint64(0)
        with self._call_lock:
            rc = self._lib.tpums_ingest_buf(
                self._live_handle(), data, len(data), mode,
                ctypes.byref(rows), ctypes.byref(errs),
            )
        if rc != 0:
            raise OSError("tpums_ingest_buf failed")
        return int(rows.value), int(errs.value)

    def get(self, key: str) -> Optional[str]:
        k = key.encode("utf-8")
        vlen = ctypes.c_uint32()
        err = ctypes.c_int()
        with self._call_lock:
            p = self._lib.tpums_get(
                self._live_handle(), k, len(k), ctypes.byref(vlen),
                ctypes.byref(err),
            )
        if not p:
            if err.value:
                # the key exists but its value could not be read — an I/O
                # failure must not masquerade as "key not found"
                raise OSError(f"tpums_get I/O failure for key {key!r}")
            return None
        try:
            return ctypes.string_at(p, vlen.value).decode("utf-8")
        finally:
            self._lib.tpums_free_buf(p)

    def delete(self, key: str) -> None:
        k = key.encode("utf-8")
        with self._call_lock:
            self._lib.tpums_delete(self._live_handle(), k, len(k))

    def __len__(self) -> int:
        with self._call_lock:
            return int(self._lib.tpums_count(self._live_handle()))

    def flush(self) -> None:
        with self._call_lock:
            if self._lib.tpums_flush(self._live_handle()) != 0:
                raise OSError("tpums_flush failed")

    def keys(self) -> List[str]:
        """All live keys (keys are small; values stay on disk)."""
        out: List[str] = []

        def cb(kp, klen, _ctx):
            out.append(ctypes.string_at(kp, klen).decode("utf-8"))

        cb_ref = _KEY_CB(cb)
        with self._call_lock:
            if self._lib.tpums_keys(self._live_handle(), cb_ref, None) != 0:
                raise OSError("tpums_keys failed")
        return out

    def items(self) -> Iterator[Tuple[str, str]]:
        """Stream (key, value) pairs: the key set is snapshotted under the
        store lock, values are fetched lazily — a larger-than-RAM store is
        never materialized at once.  Keys deleted mid-iteration are skipped."""
        for k in self.keys():
            v = self.get(k)
            if v is not None:
                yield k, v

    @property
    def log_bytes(self) -> int:
        with self._call_lock:
            return int(self._lib.tpums_log_bytes(self._live_handle()))

    @property
    def live_bytes(self) -> int:
        with self._call_lock:
            return int(self._lib.tpums_live_bytes(self._live_handle()))

    def compact(self) -> None:
        with self._call_lock:
            if self._lib.tpums_compact(self._live_handle()) != 0:
                raise OSError("tpums_compact failed")

    def maybe_compact(self, min_bytes: int = 16 << 20) -> bool:
        if self.log_bytes > min_bytes and self.live_bytes * 2 < self.log_bytes:
            self.compact()
            return True
        return False

    def close(self) -> None:
        with self._call_lock:
            if self._h:
                self._lib.tpums_close(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeModelTable:
    """ModelTable-compatible surface backed by the persistent store: state
    lives on disk incrementally (RocksDB semantics), so checkpoints are a
    flush + offset marker rather than a full snapshot, and the served model
    can exceed RAM."""

    OFFSET_KEY = "\x01__journal_offset__"

    def __init__(self, store: NativeStore):
        self.store = store
        self._lock = threading.RLock()
        self.puts = 0
        # mutation counter, same contract as ModelTable.version: derived
        # read-side caches (the DOT merged range index) key on it — without
        # it every DOT request would rescan the whole store
        self.version = 0
        self._listeners = []
        self._batch_listeners = []

    def add_change_listener(self, fn, batch_fn=None) -> None:
        """fn(key) on every put (same contract as ModelTable); optional
        ``batch_fn(keys)`` replaces the per-key calls for batched ingest."""
        with self._lock:
            self._listeners.append(fn)
            self._batch_listeners.append(batch_fn)

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self.store.put(key, value)
            self.puts += 1
            self.version += 1
            for fn in self._listeners:
                fn(key)

    def put_many(self, pairs) -> None:
        """Batched ingest (same contract as ModelTable.put_many)."""
        pairs = list(pairs)
        if not pairs:
            return
        self.put_many_columns([k for k, _ in pairs], [v for _, v in pairs])

    def put_many_columns(self, keys, values, hashes=None) -> None:
        """Columnar batched ingest (same contract as
        ``ModelTable.put_many_columns``; ``hashes`` accepted and unused —
        the store hashes internally): one lock acquisition and one
        batched listener notification per chunk.  The store writes stay
        per-row (each is one FFI append), but the listener fan-out no
        longer costs a Python call per key."""
        n = len(keys)
        if n == 0:
            return
        with self._lock:
            store_put = self.store.put
            for key, value in zip(keys, values):
                store_put(key, value)
            self.puts += n
            self.version += 1
            for fn, batch_fn in zip(self._listeners, self._batch_listeners):
                if batch_fn is not None:
                    batch_fn(keys)
                else:
                    for key in keys:
                        fn(key)

    def ingest_lines(self, data: bytes, mode: int) -> Tuple[int, int]:
        """Native bulk ingest of a journal chunk — ONE FFI call instead of
        a Python parse + ctypes put per row.  Only valid when no change
        listeners are registered (the consumer checks and falls back to
        the Python path otherwise, so e.g. top-k dirty tracking keeps
        seeing every key).  -> (rows, parse errors)."""
        with self._lock:
            rows, errs = self.store.ingest_buf(data, mode)
            self.puts += rows
            self.version += 1
            return rows, errs

    def get(self, key: str) -> Optional[str]:
        return self.store.get(key)

    def __len__(self) -> int:
        n = len(self.store)
        return n - (1 if self.store.get(self.OFFSET_KEY) is not None else 0)

    def items(self) -> Iterator[Tuple[str, str]]:
        for k, v in self.store.items():
            if not k.startswith("\x01"):
                yield k, v


class NativeArena:
    """Read-only handle onto a shared-memory factor arena (serve/arena.py)
    written in place by the consumer's mmap.  The handle is interchangeable
    with a NativeStore for every READ verb — ``tpums_get``/``tpums_count``/
    ``tpums_keys_chunk``/... dispatch on the leading handle tag — so
    ``NativeLookupServer(NativeArena(dir), ...)`` serves GET/MGET/B2 and
    builds TOPK/DOT indexes straight from the shared pages with zero
    per-request (or per-row) Python→C++ pushes.  Mutating verbs fail: the
    Python writer owns the pages.
    """

    def __init__(self, directory: str):
        self._lib = _load_lib()
        os.makedirs(directory, exist_ok=True)
        self._h = self._lib.tpums_arena_open(directory.encode("utf-8"))
        if not self._h:
            raise OSError(f"tpums_arena_open failed for {directory}")
        self.directory = directory
        self._call_lock = threading.RLock()

    def _live_handle(self):
        h = self._h
        if not h:
            raise OSError(f"arena {self.directory} is closed")
        return h

    def refresh(self) -> bool:
        """Force a remap check (normally implicit per read).  False while
        no generation file exists yet (writer not started)."""
        with self._call_lock:
            return self._lib.tpums_arena_refresh(self._live_handle()) == 0

    def get(self, key: str) -> Optional[str]:
        k = key.encode("utf-8")
        vlen = ctypes.c_uint32()
        err = ctypes.c_int()
        with self._call_lock:
            p = self._lib.tpums_get(
                self._live_handle(), k, len(k), ctypes.byref(vlen),
                ctypes.byref(err),
            )
        if not p:
            return None  # torn/odd slots read as missing, never as an error
        try:
            return ctypes.string_at(p, vlen.value).decode("utf-8")
        finally:
            self._lib.tpums_free_buf(p)

    def __len__(self) -> int:
        with self._call_lock:
            return int(self._lib.tpums_count(self._live_handle()))

    @property
    def read_retries(self) -> int:
        """Cumulative seqlock read retries (torn/odd slots observed)."""
        with self._call_lock:
            return int(
                self._lib.tpums_arena_read_retries(self._live_handle()))

    def stats(self) -> dict:
        """Gauge snapshot: rows / capacity / resident_bytes / retries /
        load_factor (all 0 while the writer has not created the arena)."""
        vals = [ctypes.c_double(0.0) for _ in range(5)]
        with self._call_lock:
            rc = self._lib.tpums_arena_stats(
                self._live_handle(), *[ctypes.byref(v) for v in vals])
        if rc != 0:
            raise OSError("tpums_arena_stats failed (not an arena handle?)")
        names = ("rows", "capacity", "resident_bytes", "retries",
                 "load_factor")
        return {n: v.value for n, v in zip(names, vals)}

    def write_stats(self) -> Optional[dict]:
        """Write-plane counters from the ``writer.stats`` sidecar the native
        batch writer maintains (batch rows/seconds, CAS outcomes), or None
        while no native writer has ever run against this arena."""
        vals = [ctypes.c_double(0.0) for _ in range(4)]
        with self._call_lock:
            rc = self._lib.tpums_arena_write_stats(
                self._live_handle(), *[ctypes.byref(v) for v in vals])
        if rc != 0:
            return None
        names = ("batch_rows", "batch_seconds", "cas_success", "cas_retry")
        return {n: v.value for n, v in zip(names, vals)}

    def write_cpu_seconds(self) -> Optional[float]:
        """Thread-CPU seconds the native write plane burned (sidecar
        write_cpu_ns) — the fleet profile's ``native;arena_writer`` row;
        None while no native writer has run or the .so predates the
        export."""
        fn = getattr(self._lib, "tpums_arena_write_cpu_seconds", None)
        if fn is None:
            return None
        val = ctypes.c_double(0.0)
        with self._call_lock:
            rc = fn(self._live_handle(), ctypes.byref(val))
        return val.value if rc == 0 else None

    def close(self) -> None:
        with self._call_lock:
            if self._h:
                self._lib.tpums_close(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeLookupServer:
    """C++ epoll lookup server (``native/lookup_server.cpp``) serving point GETs
    straight from an open NativeStore — the Netty-KvState-parity data plane
    with no Python on the hot path.  Speaks the full verb surface of
    ``serve.server.LookupServer`` (tab protocol plus the HELLO-negotiated
    B2 binary frames of ``serve.proto``).  ``topk_suffixes=(item, user)``
    (e.g. ``("-I", "-U")`` for ALS planes) enables catalog-scored
    TOPK/TOPKV in the C++ server; left None, those verbs answer E like a
    Python server with no registered handler.  HEALTH/METRICS are always
    served: the C++ plane keeps per-verb request/latency/error counters on
    the shared ``obs.metrics.LATENCY_BUCKETS_S`` ladder, so the fleet
    scrape merges native and Python snapshots with identical bounds.
    """

    def __init__(self, store: NativeStore, state_name: str,
                 job_id: str = "local", host: str = "0.0.0.0", port: int = 0,
                 topk_suffixes: Optional[Tuple[str, str]] = None):
        from ..obs import metrics as obs_metrics

        self._lib = store._lib
        self._store = store  # keep the store alive while the server reads it
        item_suf, user_suf = topk_suffixes or (None, None)
        bounds = list(obs_metrics.LATENCY_BUCKETS_S)
        # the ladder crosses the FFI as exact doubles (never re-derived in
        # C++), so merge_snapshots' bounds equality check holds by identity
        bounds_arr = (ctypes.c_double * len(bounds))(*bounds)
        self._h = self._lib.tpums_server_start3(
            store._h,
            state_name.encode("utf-8"),
            job_id.encode("utf-8"),
            host.encode("utf-8"),
            port,
            item_suf.encode("utf-8") if item_suf else None,
            user_suf.encode("utf-8") if user_suf else None,
            bounds_arr,
            len(bounds),
        )
        if not self._h:
            raise OSError(
                f"tpums_server_start failed on {host}:{port} (port in use?)"
            )
        self.state_name = state_name
        self.job_id = job_id
        self.port = int(self._lib.tpums_server_port(self._h))
        # tail-forensics span spill: when TPUMS_TRACE is a file path (the
        # Python plane's event sink, obs/tracing.py), traced requests on
        # this server append their server_reply span records to the SAME
        # file — one fleet-wide spill for obs.forensics to collect
        tpath = os.environ.get("TPUMS_TRACE", "").strip()
        if tpath not in ("", "0", "1", "-"):
            self.set_trace(tpath)

    def set_trace(self, path: Optional[str],
                  max_bytes: Optional[int] = None,
                  keep: Optional[int] = None) -> None:
        """Point the C++ span spill at ``path`` (None/"" disables it).
        ``max_bytes``/``keep`` default to the TPUMS_TRACE_MAX_BYTES /
        TPUMS_TRACE_KEEP rotation knobs, matching the Python sink."""
        if not self._h:
            return

        def _env_int(name: str, default: int) -> int:
            try:
                return int(os.environ.get(name, "") or default)
            except ValueError:
                return default

        if max_bytes is None:
            max_bytes = _env_int("TPUMS_TRACE_MAX_BYTES", 0)  # 0 = C default
        if keep is None:
            keep = _env_int("TPUMS_TRACE_KEEP", -1)  # -1 = C default
        self._lib.tpums_server_set_trace(
            self._h, path.encode("utf-8") if path else None,
            max_bytes, keep)

    def set_health(self, health_json: Optional[str]) -> None:
        """Push the owning job's health dict (one-line JSON) into the C++
        HEALTH verb; the server splices in the live key count and
        metrics_uri.  ``None`` reverts to the synthesized always-ready
        report."""
        if self._h:
            self._lib.tpums_server_set_health(
                self._h,
                health_json.encode("utf-8") if health_json else None,
            )

    @property
    def requests(self) -> int:
        return int(self._lib.tpums_server_requests(self._h)) if self._h else 0

    def io_stats(self) -> dict:
        """Reply-path syscall accounting for the batched socket loop:
        ``recv_calls`` / ``reply_syscalls`` / ``reply_bytes`` cumulative
        counters plus ``uring`` (whether the io_uring backend passed its
        runtime probe).  The syscalls-per-frame tests read deltas from here
        instead of strace."""
        if not self._h:
            return {"recv_calls": 0, "reply_syscalls": 0, "reply_bytes": 0,
                    "uring": False}
        recv = ctypes.c_uint64(0)
        reply = ctypes.c_uint64(0)
        rbytes = ctypes.c_uint64(0)
        uring = ctypes.c_int(0)
        self._lib.tpums_server_io_stats(
            self._h, ctypes.byref(recv), ctypes.byref(reply),
            ctypes.byref(rbytes), ctypes.byref(uring))
        return {"recv_calls": int(recv.value),
                "reply_syscalls": int(reply.value),
                "reply_bytes": int(rbytes.value),
                "uring": bool(uring.value)}

    def start(self) -> "NativeLookupServer":
        return self  # started in __init__; method mirrors LookupServer's API

    def stop(self) -> None:
        if self._h:
            self._lib.tpums_server_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class NativeStateBackend:
    """State backend for ServingJob: the table IS the durable store.

    ``snapshot`` = fsync + journal-offset marker (cheap, incremental);
    ``restore`` = reopen + read marker; compaction happens opportunistically
    at checkpoint time.
    """

    kind = "rocksdb"

    def __init__(self, checkpoint_uri: str):
        self.store = NativeStore(checkpoint_uri)

    def make_table(self, n_shards: int = 8) -> NativeModelTable:
        del n_shards  # single log; key routing is the hash index itself
        return NativeModelTable(self.store)

    def snapshot(self, table, offset: int) -> None:
        self.store.put(NativeModelTable.OFFSET_KEY, str(offset))
        self.store.flush()
        self.store.maybe_compact()

    def restore(self, table) -> Optional[int]:
        payload = self.store.get(NativeModelTable.OFFSET_KEY)
        return int(payload) if payload is not None else None

    def close(self) -> None:
        self.store.close()
