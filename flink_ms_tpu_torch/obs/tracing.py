"""Request tracing over the tab-separated wire protocol: the subset of
``flink_ms_tpu/obs/tracing.py`` that the serving job and its clients use.

A trace is a 16-hex-char id that a client stamps onto a request as a
trailing ``tid=<id>`` tab field; the server strips it before verb dispatch,
records a ``server_reply`` span event and echoes ``tid=<id>`` back on the
reply line.  Crossing the process boundary the field widens to
``tid=<tid>/<sid>`` (the client's rpc span), and the server echoes the raw
value, so a traced request gets the reference's reply bytes.  Untraced
traffic is byte-identical to the seed protocol in both directions.

Events (one dict each, ``ts``/``tid``/``kind`` plus span fields) always
land in an in-process ring buffer; with ``TPUMS_TRACE`` set to a path they
are also appended to that file as JSON lines (``-`` = stderr), the
reference's sink and format.  Spans (``span``, ``span_event``) and the
pool adapter of the fleet's fan-outs (``call_with_trace``) are the
reference's; ``sample_trace`` rolls ``TPUMS_TRACE_SAMPLE`` for the update
plane's trace roots.  The file sink rotates at ``TPUMS_TRACE_MAX_BYTES``
(default 64 MiB), keeping ``TPUMS_TRACE_KEEP`` (default 3) older files as
``<path>.1`` .. ``<path>.K``, the reference's names; ``load_events`` reads
any such file, either package's.  Spans also publish their kind on a
cross-thread stage stack (``push_stage``/``pop_stage``/``thread_stages``)
for a sampling profiler.
"""

from __future__ import annotations

import json
import os
import random
import secrets
import sys
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from . import metrics as _metrics

TID_FIELD = "tid="
_RING_CAP = 4096
_DEFAULT_MAX_BYTES = 64 << 20
_DEFAULT_KEEP = 3


class _TraceLocal(threading.local):
    # class-level defaults: the untraced read is a plain attribute hit
    tid = None
    spans = None


_local = _TraceLocal()
_ring_lock = threading.Lock()
_ring: Deque[dict] = deque(maxlen=_RING_CAP)
_file_lock = threading.Lock()
_file_handle = None
_file_path_cached: Optional[str] = None
_file_bytes = 0
_file_max_bytes = _DEFAULT_MAX_BYTES


# Cross-thread stage registry for a sampling profiler: the span stack is
# thread-LOCAL, so spans also publish their kind here, keyed by thread
# ident.  Each thread touches only its own list and a sampler only reads;
# under the GIL a rare torn read costs one mis-attributed sample.
_thread_stages: Dict[int, List[str]] = {}


def push_stage(kind: str) -> None:
    """Mark this thread as inside ``kind`` (span enter does this)."""
    ident = threading.get_ident()
    stack = _thread_stages.get(ident)
    if stack is None:
        stack = _thread_stages[ident] = []
    stack.append(kind)


def pop_stage() -> None:
    ident = threading.get_ident()
    stack = _thread_stages.get(ident)
    if stack:
        stack.pop()
        if not stack:
            _thread_stages.pop(ident, None)


def thread_stages() -> Dict[int, str]:
    """Sampler view: thread ident -> innermost active stage name; threads
    outside any stage are absent."""
    out: Dict[int, str] = {}
    for ident, stack in list(_thread_stages.items()):
        try:
            if stack:
                out[ident] = stack[-1]
        except IndexError:  # racing pop on the owner thread
            continue
    return out


def new_trace_id() -> str:
    """16 hex chars."""
    return secrets.token_hex(8)


def new_span_id() -> str:
    """8 hex chars, unique within one trace."""
    return secrets.token_hex(4)


def current_trace() -> Optional[str]:
    return _local.tid


def set_trace(tid: Optional[str]) -> Optional[str]:
    """Install ``tid`` as this thread's trace context -> previous value."""
    prev = _local.tid
    _local.tid = tid
    return prev


class trace_span:
    """``with trace_span() as tid:`` installs a (fresh or given) trace id
    for the block and restores the previous context on exit."""

    __slots__ = ("tid", "_prev")

    def __init__(self, tid: Optional[str] = None):
        self.tid = tid or new_trace_id()
        self._prev = None

    def __enter__(self) -> str:
        self._prev = set_trace(self.tid)
        return self.tid

    def __exit__(self, *exc) -> None:
        set_trace(self._prev)


def current_span_id() -> Optional[str]:
    """Innermost open span on this thread, or None outside any span."""
    stack = _local.spans
    return stack[-1] if stack else None


def current_context() -> Optional[str]:
    """The value to hand ``call_with_trace`` when fanning out to a pool:
    ``tid/sid`` while a span is open (so the worker's spans parent under
    it), the bare tid otherwise, None when untraced."""
    tid = current_trace()
    if tid is None:
        return None
    sid = current_span_id()
    return f"{tid}/{sid}" if sid else tid


class span:
    """``with span("stage", op=...):`` one timed node in the request's
    causal tree: a span id parented under the innermost open span on this
    thread, and one event with ``sid``/``psid``/``t0``/``dur_s`` on exit.
    A no-op when no trace context is active."""

    __slots__ = ("kind", "fields", "tid", "sid", "_psid", "_t0")

    def __init__(self, kind: str, tid: Optional[str] = None, **fields):
        self.kind = kind
        self.fields = fields
        self.tid = tid
        self.sid = None

    def __enter__(self) -> "span":
        tid = self.tid if self.tid is not None else current_trace()
        if tid is None:
            return self
        self.tid = tid
        self.sid = new_span_id()
        self._psid = current_span_id()
        if _local.spans is None:
            _local.spans = []
        _local.spans.append(self.sid)
        push_stage(self.kind)
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.sid is None:
            return
        _local.spans.pop()
        pop_stage()
        if exc_type is not None:
            self.fields.setdefault("error", repr(exc))
        event(self.kind, tid=self.tid, sid=self.sid, psid=self._psid,
              t0=self._t0, dur_s=time.time() - self._t0, **self.fields)


def span_event(kind: str, tid: Optional[str] = None,
               dur_s: Optional[float] = None, t0: Optional[float] = None,
               sid: Optional[str] = None, psid: Optional[str] = None,
               **fields) -> Optional[dict]:
    """One-shot span record for call sites that already know the duration.
    None when untraced."""
    tid = tid if tid is not None else current_trace()
    if tid is None:
        return None
    return event(kind, tid=tid, sid=sid if sid is not None else new_span_id(),
                 psid=psid if psid is not None else current_span_id(),
                 t0=t0, dur_s=dur_s, **fields)


def call_with_trace(tid: Optional[str], fn, *args, **kwargs):
    """Run ``fn`` with ``tid`` installed: the pool-submit adapter of the
    sharded and HA fan-outs, so worker threads inherit the submitting
    request's context.  ``tid`` may be the composite ``tid/sid`` of
    ``current_context()``: the sid seeds the worker thread's span stack."""
    if tid is None:
        return fn(*args, **kwargs)
    base, psid = split_tid(tid)
    prev = set_trace(base)
    prev_stack = _local.spans
    _local.spans = [psid] if psid else []
    try:
        return fn(*args, **kwargs)
    finally:
        set_trace(prev)
        _local.spans = prev_stack if prev_stack is not None else []


def trace_sample_rate() -> float:
    """``TPUMS_TRACE_SAMPLE`` clamped to [0, 1]; 0 when unset or garbage."""
    try:
        rate = float(os.environ.get("TPUMS_TRACE_SAMPLE") or "0")
    except ValueError:
        return 0.0
    return max(0.0, min(1.0, rate))


def sample_trace() -> Optional[str]:
    """A fresh trace id with probability ``TPUMS_TRACE_SAMPLE``, else None:
    the update plane's trace roots follow the knob, not the batch rate."""
    r = trace_sample_rate()
    if r <= 0.0:
        return None
    if r < 1.0 and random.random() >= r:
        return None
    return new_trace_id()


# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------

def stamp(request: str, tid: Optional[str] = None) -> str:
    """Append ``\\ttid=<id>`` when a trace is active; otherwise return the
    request untouched."""
    tid = tid if tid is not None else current_trace()
    if tid is None:
        return request
    return f"{request}\t{TID_FIELD}{tid}"


def unstamp_reply(reply: str, tid: str) -> str:
    """Strip the server's tid echo off a reply: only the exact suffix for
    the id sent, so payloads that contain tabs (MGET) stay intact."""
    suffix = f"\t{TID_FIELD}{tid}"
    if reply.endswith(suffix):
        return reply[: -len(suffix)]
    return reply


def pop_tid(parts: List[str]) -> Optional[str]:
    """Server side: remove and return a trailing ``tid=`` field of a split
    request (mutates ``parts``); None when untraced.  The value is the raw
    wire form, possibly ``tid/sid``, so the server echoes it verbatim."""
    if len(parts) >= 2 and parts[-1].startswith(TID_FIELD):
        return parts.pop()[len(TID_FIELD):]
    return None


def wire_tid(tid: str, sid: Optional[str] = None) -> str:
    """``tid/sid`` when the caller has an open span for this RPC, the bare
    tid otherwise."""
    return f"{tid}/{sid}" if sid else tid


def split_tid(raw: Optional[str]):
    """A raw wire tid -> ``(trace_id, parent_span_id or None)``."""
    if raw and "/" in raw:
        base, _, psid = raw.partition("/")
        return base, (psid or None)
    return raw, None


# ---------------------------------------------------------------------------
# event log
# ---------------------------------------------------------------------------

def _trace_file() -> Optional[str]:
    v = os.environ.get("TPUMS_TRACE", "").strip()
    if v in ("", "0", "1"):
        return None
    return v


def trace_file_path() -> Optional[str]:
    """The active JSONL spill path (None when TPUMS_TRACE is off or the
    stderr sink ``-``)."""
    p = _trace_file()
    return None if p == "-" else p


def event(kind: str, tid: Optional[str] = None, **fields) -> dict:
    """Record one structured event: always into the in-process ring, and
    as one JSON line to ``TPUMS_TRACE`` when that names a path."""
    ev: Dict = {"ts": time.time(),
                "tid": tid if tid is not None else current_trace(),
                "kind": kind}
    ev.update(fields)
    if "sid" in ev:
        _metrics.get_registry().counter("tpums_trace_spans_total").inc()
    elif "psid" not in ev:
        psid = current_span_id()
        if psid is not None:
            ev["psid"] = psid
    with _ring_lock:
        _ring.append(ev)
    path = _trace_file()
    if path is not None:
        line = json.dumps(ev, separators=(",", ":"), default=str)
        if path == "-":
            print(line, file=sys.stderr)
        else:
            _append_line(path, line)
    return ev


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _append_line(path: str, line: str) -> None:
    global _file_handle, _file_path_cached, _file_bytes, _file_max_bytes
    with _file_lock:
        if _file_handle is None or _file_path_cached != path:
            if _file_handle is not None:
                try:
                    _file_handle.close()
                except OSError:
                    pass
            _file_handle = open(path, "a", buffering=1)
            _file_path_cached = path
            try:
                _file_bytes = os.path.getsize(path)
            except OSError:
                _file_bytes = 0
            # the rotation knobs are read once per open
            _file_max_bytes = _env_int("TPUMS_TRACE_MAX_BYTES",
                                       _DEFAULT_MAX_BYTES)
        if _file_bytes >= _file_max_bytes > 0:
            _rotate_locked(path)
        _file_handle.write(line + "\n")
        _file_bytes += len(line) + 1


def _rotate_locked(path: str) -> None:
    """Size-capped keep-K rotation: path -> path.1 -> ... -> path.K, the
    oldest dropped.  Caller holds ``_file_lock``."""
    global _file_handle, _file_bytes
    try:
        _file_handle.close()
    except OSError:
        pass
    keep = max(0, _env_int("TPUMS_TRACE_KEEP", _DEFAULT_KEEP))
    try:
        if keep == 0:
            os.remove(path)
        else:
            for i in range(keep - 1, 0, -1):
                src = f"{path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{path}.{i + 1}")
            os.replace(path, f"{path}.1")
    except OSError:
        pass  # cross-process rotation race: the loser keeps appending
    _file_handle = open(path, "a", buffering=1)
    _file_bytes = 0


def recent_events(tid: Optional[str] = None,
                  kind: Optional[str] = None) -> List[dict]:
    """The ring buffer, optionally filtered by tid and/or kind."""
    with _ring_lock:
        evs = list(_ring)
    if tid is not None:
        evs = [e for e in evs if e.get("tid") == tid]
    if kind is not None:
        evs = [e for e in evs if e.get("kind") == kind]
    return evs


def clear_events() -> None:
    with _ring_lock:
        _ring.clear()


def load_events(path: str) -> List[dict]:
    """Parse a JSONL event file of either package (cross-process
    correlation).  Malformed lines are skipped: the file is append-shared
    across processes."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def events_counter(kind: str, **labels) -> None:
    """Event + matching ``tpums_events_total`` counter in one call."""
    event(kind, **labels)
    _metrics.get_registry().counter("tpums_events_total", kind=kind).inc()
