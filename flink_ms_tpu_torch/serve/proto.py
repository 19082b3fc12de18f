"""Binary batched wire protocol v2 ("B2") shared by clients and servers.

Own copy of ``flink_ms_tpu/serve/proto.py``: the frames, opcodes and
HELLO extensions are the reference's byte for byte, so a client of either
package talks to a server of either package.  The port's server refuses
the ``su=1`` extension (the push plane, ROADMAP.md, Queue 1, item 'Push
plane'); the codec keeps it so the frames stay the reference's.

The serving plane speaks two framings over the same TCP port:

* **tab** (v1) — one ``\\t``-separated request line per query, one reply line
  per request.  This is the only framing an un-negotiated connection may use,
  and it is frozen: old clients stay byte-identical on the wire (pinned by
  ``tests/test_native_protocol.py``).
* **B2** (v2) — a length-prefixed batch frame negotiated by sending the text
  line ``HELLO\\tB2`` as the first request.  A server that understands v2
  answers ``HELLO\\tB2`` and both directions switch to binary frames; an old
  server answers ``E\\tbad request`` and the client falls back to tab.

Frame layout (both directions)::

    b"B2"  varint(body_len)  body
    body = varint(record_count)  record*

A *request* record is one opcode byte followed by the tab-protocol fields for
that verb (everything after the verb token), each encoded as
``varint(len) + utf8 bytes``.  A *reply* record is ``varint(len) + bytes`` of
exactly the tab-protocol reply line without its trailing newline — so binary
and tab replies are equal by construction, per verb.

varints are unsigned LEB128 (7 bits per byte, little-endian), capped at 10
bytes.  Structural corruption (bad magic, oversized frame, truncated body,
unknown opcode, trailing bytes) raises :class:`ProtoError`; servers answer a
single-record error frame ``E\\tbad frame: <reason>`` and close.  Field
*content* is unconstrained bytes-of-UTF-8 — keys containing ``\\x85`` or
``\\u2028`` style separators round-trip unharmed .
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

MAGIC = b"B2"

# The negotiation handshake, sent as a plain tab-protocol line.  Optional
# extensions ride as extra tab fields, each self-describing: ``tn=<tenant>``
# (admission identity, serve/admission.py), ``tr=1`` (per-record trace
# field, obs/tracing.py), ``st=1`` (per-read staleness reporting,
# serve/georepl.py — every reply record gains a trailing ``st=<seconds>``
# field) and ``su=1`` (push plane, serve/push.py — the client accepts
# UNSOLICITED ``PUSH\t`` frames between replies; SUBSCRIBE on a B2
# connection requires it).  A HELLO with any OTHER extra field is malformed
# and answers ``E\tbad request`` — pinned, so old and new servers refuse
# unknown extensions identically (the native C++ plane refuses ``su=1``
# this way: push serving is Python-plane only).  The accept reply stays
# the frozen two-field line either way.
HELLO_VERB = "HELLO"
HELLO_LINE = "HELLO\tB2"
HELLO_REPLY = "HELLO\tB2"
TRACE_EXT = "tr=1"
STALE_EXT = "st=1"
PUSH_EXT = "su=1"
STALE_FIELD = "st="  # request: trailing tab field opting one read into
                     # staleness reporting; reply: trailing ``st=<seconds>``
_TENANT_FIELD = "tn="  # mirrors serve/admission.py TENANT_FIELD (no import:
                       # proto stays dependency-free)


def parse_hello(parts: Sequence[str]) -> Optional[dict]:
    """Validate a split HELLO line -> ``{"proto", "tenant", "trace",
    "stale", "push"}`` or None when structurally malformed (unknown
    extension, duplicate tenant).  The caller still refuses protos other
    than ``B2``."""
    if len(parts) < 2 or parts[0] != HELLO_VERB:
        return None
    tenant: Optional[str] = None
    trace = False
    stale = False
    push = False
    for ext in parts[2:]:
        if ext.startswith(_TENANT_FIELD) and tenant is None:
            tenant = ext[len(_TENANT_FIELD):]
        elif ext == TRACE_EXT and not trace:
            trace = True
        elif ext == STALE_EXT and not stale:
            stale = True
        elif ext == PUSH_EXT and not push:
            push = True
        else:
            return None
    return {"proto": parts[1], "tenant": tenant, "trace": trace,
            "stale": stale, "push": push}


def pop_stale(parts: List[str]) -> bool:
    """Pop a strictly-trailing ``st=1`` staleness opt-in field off a split
    tab request -> True when present.  Mirrors ``admission.pop_tenant`` /
    ``tracing.pop_tid``: append order on the wire is ``st=`` then ``tn=``
    then ``tid=``, so the server pops tid, tenant, stale."""
    if len(parts) > 1 and parts[-1] == STALE_EXT:
        parts.pop()
        return True
    return False

# Opcode byte per verb.  Order is frozen; new verbs append.
OPCODES = {
    "GET": 1,
    "MGET": 2,
    "TOPK": 3,
    "TOPKV": 4,
    "DOT": 5,
    "COUNT": 6,
    "HEALTH": 7,
    "METRICS": 8,
    "PING": 9,
    "SUBSCRIBE": 10,
    "RESUME": 11,
    "UNSUB": 12,
}
VERB_BY_OP = {op: verb for verb, op in OPCODES.items()}

# Number of length-prefixed fields following the opcode byte.  Fields are the
# tab-protocol parts after the verb, in order (MGET keeps its comma-joined key
# list as one field — key charset rules are identical to the tab protocol).
FIELD_COUNTS = {
    "GET": 2,      # state, key
    "MGET": 2,     # state, keys_csv
    "TOPK": 3,     # state, id, k
    "TOPKV": 3,    # state, k, payload
    "DOT": 3,      # state, range, payload
    "COUNT": 1,    # state
    "HEALTH": 1,   # state
    "METRICS": 0,
    "PING": 0,
    "SUBSCRIBE": 4,  # state, kind (KEY|TOPK), arg, k
    "RESUME": 5,     # state, kind, arg, k, cursor ("<sub_id>:<seq>")
    "UNSUB": 1,      # sub_id
}

# Caps.  Requests are client-authored and small; replies can carry wide MGET /
# TOPK payloads so get more headroom.  Both ends enforce their receive-side cap.
MAX_REQUEST_BODY = 8 << 20
MAX_REPLY_BODY = 64 << 20
_MAX_VARINT_BYTES = 10


class ProtoError(ValueError):
    """Structurally malformed B2 frame (not a per-verb semantic error)."""


def encode_varint(n: int) -> bytes:
    if n < 0:
        raise ProtoError("bad varint")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf, pos: int) -> Optional[Tuple[int, int]]:
    """Decode an unsigned LEB128 at ``buf[pos:]``.

    Returns ``(value, next_pos)``, or ``None`` if the buffer ends before the
    varint terminates.  Raises :class:`ProtoError` once the encoding provably
    exceeds the 10-byte cap.
    """
    shift = 0
    value = 0
    end = len(buf)
    for i in range(_MAX_VARINT_BYTES):
        if pos + i >= end:
            return None
        b = buf[pos + i]
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos + i + 1
        shift += 7
    raise ProtoError("bad varint")


# hot-path tables: one-byte varints cover every realistic field length and
# record count, so the encoders below index these instead of calling
# encode_varint per field (the codec runs once per request on the client
# AND once per request on the Python server — it must stay in the noise
# next to a ~1.5 us/req pipelined tab round trip)
_B1 = [bytes([i]) for i in range(0x80)]
_OPCODE_BYTES = {verb: bytes([op]) for verb, op in OPCODES.items()}


def record_from_line(line: str, tid: Optional[str] = None) -> bytes:
    """Encode one tab-protocol request line as a B2 request record.

    ``tid`` is only legal on a ``tr=1``-negotiated connection: the record
    grows exactly one trailing length-prefixed field carrying the raw wire
    tid (empty = this record untraced).  Without negotiation the layout is
    the frozen v2 record, byte-identical to the seed encoder.
    """
    parts = line.split("\t")
    verb = parts[0]
    opb = _OPCODE_BYTES.get(verb)
    if opb is None:
        raise ProtoError("unknown verb: %s" % verb)
    nfields = FIELD_COUNTS[verb]
    if len(parts) - 1 != nfields:
        raise ProtoError("verb %s takes %d fields, got %d" % (verb, nfields, len(parts) - 1))
    if tid is not None:
        parts = parts + [tid]
    pieces = [opb]
    for f in parts[1:]:
        raw = f.encode("utf-8")
        n = len(raw)
        pieces.append(_B1[n] if n < 0x80 else encode_varint(n))
        pieces.append(raw)
    return b"".join(pieces)


def record_to_parts(body, pos: int, end: int,
                    trace: bool = False) -> Tuple[List[str], int]:
    """Decode one request record from ``body[pos:end]``.

    Returns ``(parts, next_pos)`` where ``parts`` is the tab-protocol parts
    list (verb first).  On a ``trace`` (``tr=1``) connection every record
    carries one extra trailing field; when non-empty it is surfaced as a
    trailing ``tid=<raw>`` part, exactly where the tab plane's
    ``pop_tid`` expects it.  Raises :class:`ProtoError` on structural
    corruption.
    """
    if pos >= end:
        raise ProtoError("bad body")
    op = body[pos]
    pos += 1
    verb = VERB_BY_OP.get(op)
    if verb is None:
        raise ProtoError("bad body")
    parts = [verb]
    for _ in range(FIELD_COUNTS[verb] + (1 if trace else 0)):
        if pos >= end:
            raise ProtoError("bad body")
        flen = body[pos]
        if flen < 0x80:  # one-byte varint fast path
            pos += 1
        else:
            dv = decode_varint(body, pos)
            if dv is None:
                raise ProtoError("bad body")
            flen, pos = dv
        if pos + flen > end:
            raise ProtoError("bad body")
        try:
            parts.append(bytes(body[pos:pos + flen]).decode("utf-8"))
        except UnicodeDecodeError:
            raise ProtoError("bad body")
        pos += flen
    if trace:
        raw_tid = parts.pop()
        if raw_tid:
            parts.append("tid=" + raw_tid)
    return parts, pos


def encode_request_frame(lines: Sequence[str],
                         tids: Optional[Sequence[Optional[str]]] = None
                         ) -> bytes:
    """Encode a batch of tab-protocol request lines as one B2 frame.
    ``tids`` (tr=1 connections only) aligns with ``lines``; None entries
    encode as the empty trace field."""
    n = len(lines)
    pieces = [_B1[n] if n < 0x80 else encode_varint(n)]
    body_len = len(pieces[0])
    for i, line in enumerate(lines):
        rec = record_from_line(
            line, None if tids is None else (tids[i] or ""))
        body_len += len(rec)
        pieces.append(rec)
    if body_len > MAX_REQUEST_BODY:
        raise ProtoError("frame too large")
    return MAGIC + encode_varint(body_len) + b"".join(pieces)


def _decode_frame(buf, pos: int, max_body: int) -> Optional[Tuple[int, int]]:
    """Common header parse: returns ``(body_start, body_end)`` offsets into
    ``buf`` or None if incomplete."""
    avail = len(buf) - pos
    if avail < 1:
        return None
    if buf[pos] != 0x42 or (avail >= 2 and buf[pos + 1] != 0x32):  # b"B2"
        raise ProtoError("bad magic")
    if avail < 2:
        return None
    dv = decode_varint(buf, pos + 2)
    if dv is None:
        return None
    body_len, body_start = dv
    if body_len > max_body:
        raise ProtoError("frame too large")
    if len(buf) - body_start < body_len:
        return None
    return body_start, body_start + body_len


def decode_request_frame(buf, pos: int = 0, trace: bool = False
                         ) -> Optional[Tuple[List[List[str]], int]]:
    """Decode one request frame from ``buf[pos:]``.

    Returns ``(records, next_pos)`` where each record is a parts list, or
    ``None`` when the buffer does not yet hold a complete frame.  Raises
    :class:`ProtoError` on structural corruption.  ``trace`` reflects the
    connection's ``tr=1`` negotiation (see :func:`record_to_parts`).
    """
    if isinstance(buf, memoryview):
        buf = buf.tobytes()
    hdr = _decode_frame(buf, pos, MAX_REQUEST_BODY)
    if hdr is None:
        return None
    rpos, end = hdr
    dv = decode_varint(buf, rpos)
    if dv is None or dv[1] > end:
        raise ProtoError("bad body")
    count, rpos = dv
    records: List[List[str]] = []
    for _ in range(count):
        parts, rpos = record_to_parts(buf, rpos, end, trace)
        records.append(parts)
    if rpos != end:
        raise ProtoError("bad body")
    return records, end


def encode_reply_frame(texts: Sequence[str]) -> bytes:
    """Encode reply lines (without trailing newlines) as one B2 frame."""
    n = len(texts)
    pieces = [_B1[n] if n < 0x80 else encode_varint(n)]
    body_len = len(pieces[0])
    for t in texts:
        raw = t.encode("utf-8")
        tlen = len(raw)
        pre = _B1[tlen] if tlen < 0x80 else encode_varint(tlen)
        body_len += len(pre) + tlen
        pieces.append(pre)
        pieces.append(raw)
    return MAGIC + encode_varint(body_len) + b"".join(pieces)


def decode_reply_frame(buf, pos: int = 0) -> Optional[Tuple[List[str], int]]:
    """Decode one reply frame from ``buf[pos:]`` (None when incomplete)."""
    if isinstance(buf, memoryview):
        buf = buf.tobytes()
    hdr = _decode_frame(buf, pos, MAX_REPLY_BODY)
    if hdr is None:
        return None
    rpos, end = hdr
    dv = decode_varint(buf, rpos)
    if dv is None or dv[1] > end:
        raise ProtoError("bad body")
    count, rpos = dv
    texts: List[str] = []
    for _ in range(count):
        if rpos >= end:
            raise ProtoError("bad body")
        tlen = buf[rpos]
        if tlen < 0x80:  # one-byte varint fast path
            rpos += 1
        else:
            dv = decode_varint(buf, rpos)
            if dv is None:
                raise ProtoError("bad body")
            tlen, rpos = dv
        if rpos + tlen > end:
            raise ProtoError("bad body")
        try:
            texts.append(buf[rpos:rpos + tlen].decode("utf-8"))
        except UnicodeDecodeError:
            raise ProtoError("bad body")
        rpos += tlen
    if rpos != end:
        raise ProtoError("bad body")
    return texts, end


def error_frame(reason: str) -> bytes:
    """The single-record frame servers send before closing a corrupt stream."""
    return encode_reply_frame(["E\tbad frame: " + reason])


class FrameReader:
    """Blocking reply-frame reader over a file-like socket reader.

    Keeps leftover bytes between calls so back-to-back frames that arrive in
    one TCP segment are not lost — required by the pipelined client, which can
    have several reply frames in flight.
    """

    def __init__(self, rfile):
        self._rfile = rfile
        self._buf = bytearray()

    def read_frame(self) -> List[str]:
        """Read one reply frame.

        Raises :class:`ProtoError` on corruption and :class:`ConnectionError`
        on EOF mid-frame (including EOF before any bytes, so callers can
        treat it like a dropped connection and retry).
        """
        rfile = self._rfile
        while True:
            res = decode_reply_frame(self._buf)
            if res is not None:
                texts, consumed = res
                del self._buf[:consumed]
                return texts
            chunk = rfile.read1(65536) if hasattr(rfile, "read1") else rfile.read(65536)
            if not chunk:
                raise ConnectionError("EOF mid-frame (%d bytes buffered)" % len(self._buf))
            self._buf += chunk
