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
plane's trace roots.  Head sampling of requests, the profiler's stage stacks,
size-capped rotation of the file sink (``TPUMS_TRACE_MAX_BYTES``) and
``load_events`` are not ported yet (ROADMAP.md, Queue 1, item
'Observability'): with a rotation knob set the port says so once on stderr
and appends without rotating.
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
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.sid is None:
            return
        _local.spans.pop()
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


def _append_line(path: str, line: str) -> None:
    global _file_handle, _file_path_cached
    with _file_lock:
        if _file_handle is None or _file_path_cached != path:
            if _file_handle is not None:
                try:
                    _file_handle.close()
                except OSError:
                    pass
            _file_handle = open(path, "a", buffering=1)
            _file_path_cached = path
            if os.environ.get("TPUMS_TRACE_MAX_BYTES") or \
                    os.environ.get("TPUMS_TRACE_KEEP"):
                print("[trace] rotation of the trace file is not ported yet "
                      "(ROADMAP.md, Queue 1, item 'Observability'); "
                      f"appending to {path} without a size cap",
                      file=sys.stderr)
        _file_handle.write(line + "\n")


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


def events_counter(kind: str, **labels) -> None:
    """Event + matching ``tpums_events_total`` counter in one call."""
    event(kind, **labels)
    _metrics.get_registry().counter("tpums_events_total", kind=kind).inc()
