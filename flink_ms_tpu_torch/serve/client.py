"""Query client: the counterpart of the reference's ``QueryClientHelper``.

Own copy of ``flink_ms_tpu/serve/client.py``'s ``RetryPolicy`` and
``QueryClient``: the tab and ``B2`` framings, pipelined windows, tenancy,
staleness opt-in and trace stamps, with the reference's wire bytes, so it
talks to a lookup server of either package.

``query_state(name, key)`` returns the value payload or None for unknown
keys (the reference maps ``UnknownKeyOrNamespaceException`` to
``Optional.empty()``, QueryClientHelper.java:135-137).  Network and timeout
errors raise, as queryState's throws clause says.  With ``push=True``
(or ``TPUMS_PUSH=1``) the B2 HELLO carries ``su=1``: the subscribe calls
then materialize a key or a top-k query on the server, and its deltas
arrive as PUSH frames that the read paths route into ``next_push``.
"""

from __future__ import annotations

import os
import random
import socket
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from ..obs import tracing as obs_tracing
from . import admission as admission_ctl
from . import proto as wire_proto


@dataclass(frozen=True)
class RetryPolicy:
    """Connection-retry policy of ``QueryClient._roundtrip``.

    ``attempts`` counts TOTAL tries (1 = no retry).  Between failures the
    delay grows exponentially from ``backoff_s`` (doubling per retry,
    capped at ``max_backoff_s``) with up to ``jitter`` fractional noise so
    a thundering herd of clients doesn't re-land in lockstep.  The default
    — two attempts, zero backoff — is exactly the pre-HA behavior: one
    immediate reconnect (server restart is expected; the serving job has
    fixed-delay restart semantics)."""

    attempts: int = 2
    backoff_s: float = 0.0
    max_backoff_s: float = 2.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff must be >= 0")
        if not (0 <= self.jitter <= 1):
            raise ValueError("jitter must be in [0, 1]")

    def delay_s(self, failure_index: int) -> float:
        """Sleep before retry #``failure_index`` (0-based: the delay after
        the first failure)."""
        base = min(self.backoff_s * (2.0 ** failure_index),
                   self.max_backoff_s)
        if base <= 0:
            return 0.0
        return base * (1.0 + self.jitter * random.random())

    def sleep(self, failure_index: int) -> None:
        d = self.delay_s(failure_index)
        if d > 0:
            time.sleep(d)


def parse_mget_reply(reply: str, n_keys: int) -> list:
    """An MGET reply -> payloads in key order, None per missing key."""
    if not reply.startswith("M\t"):
        raise RuntimeError(f"mget failed: {reply}")
    items = reply[2:].split("\t")
    if len(items) != n_keys:
        raise RuntimeError(
            f"mget returned {len(items)} items for {n_keys} keys"
        )
    out = []
    for it in items:
        if it == "N":
            out.append(None)
        elif it.startswith("V"):
            out.append(it[1:])
        else:  # per-key store error ("E" slot from the native server)
            raise RuntimeError(f"mget item failed: {it!r}")
    return out


class QueryClient:
    def __init__(
        self,
        host: str = "localhost",
        port: int = 6123,
        timeout_s: float = 5.0,
        job_id: Optional[str] = None,
        retry: Optional[RetryPolicy] = None,
        proto: Optional[str] = None,
        tenant: Optional[str] = None,
        stale: Optional[bool] = None,
        push: Optional[bool] = None,
    ):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        # tenancy (serve/admission.py): OFF by default.  With a tenant set
        # (explicitly, or ambiently via TPUMS_TENANT) tab requests carry a
        # trailing ``tn=<tenant>`` field and the B2 HELLO binds the tenant
        # to the connection; with no tenant the wire is byte-identical to
        # the seed protocol (the same opt-in contract as trace ids)
        if tenant is None:
            tenant = os.environ.get("TPUMS_TENANT", "")
        self.tenant = tenant.strip() or None
        self.job_id = job_id  # accepted for reference-CLI parity; the local
        # lookup server serves a single job, so the id is informational
        self.retry = retry or RetryPolicy()
        # wire framing (serve/proto.py): "tab" = the frozen v1 line protocol
        # (default — byte-identical to the seed client), "b2" = negotiate
        # the binary batch framing and FAIL if the server refuses, "auto" =
        # try B2, fall back to tab against an old server (which answers the
        # HELLO with E\tbad request).  TPUMS_PROTO sets the default.
        mode = (proto or os.environ.get("TPUMS_PROTO") or "tab").lower()
        if mode not in ("tab", "b2", "auto"):
            raise ValueError(f"proto must be tab|b2|auto, got {mode!r}")
        self.proto = mode
        # B2 per-record tracing is opt-in via TPUMS_TRACE_B2: it widens the
        # HELLO (``tr=1``) and every request record by one field, so the
        # default keeps binary wire bytes identical to the seed encoder —
        # the same opt-in contract as the tab plane's tid field.  An old
        # server refuses the extended HELLO and auto mode falls back to tab
        # (where tracing needs no negotiation).
        self._want_b2_trace = os.environ.get("TPUMS_TRACE_B2", "0") != "0"
        # per-read staleness reporting: opt-in, same
        # wire contract as tenancy — tab requests gain a trailing ``st=1``
        # field and every reply a trailing ``st=<seconds>`` the client
        # strips into ``last_staleness_s``; the B2 HELLO binds it per
        # connection (``st=1`` extension).  Off (the default) keeps both
        # planes byte-identical to the seed protocol.
        if stale is None:
            stale = os.environ.get("TPUMS_GEO_STALE_READS", "0") != "0"
        self.stale = bool(stale)
        # the exact wire field a staleness-opted request carries
        self._stale_ext = wire_proto.STALE_EXT
        self.last_staleness_s: Optional[float] = None
        # push plane (serve/push.py): opt-in, same wire contract as the
        # extensions above — the HELLO gains ``su=1`` and the connection
        # may then receive unsolicited ``PUSH\t...`` frames between
        # replies, which the read paths below route into ``_pushes``
        # instead of treating as the next reply.  Off (the default) keeps
        # the wire byte-identical to the seed protocol.  Subscribing
        # needs a B2 connection: the binary frame reader owns an explicit
        # buffer, so buffered-vs-inflight pushes are separable without
        # racing the line reader (the tab SUBSCRIBE verb still exists on
        # the server for raw-socket clients).
        if push is None:
            push = os.environ.get("TPUMS_PUSH", "0") != "0"
        self.push = bool(push)
        if self.push and self.proto == "tab":
            raise ValueError("push=True needs a B2 connection "
                             "(proto='b2' or 'auto')")
        self._pushes = deque()  # (sub_id, seq, payload) awaiting next_push
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._binary = False  # per-connection: set by the HELLO exchange
        self._b2_trace = False  # per-connection: tr=1 accepted
        self._b2_stale = False  # per-connection: st=1 accepted
        self._b2_push = False  # per-connection: su=1 accepted
        self._frame_reader = None

    def _connect(self):
        sock = socket.create_connection((self.host, self.port), self.timeout_s)
        sock.settimeout(self.timeout_s)
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._binary = False
        self._b2_trace = False
        self._b2_stale = False
        self._b2_push = False
        self._frame_reader = None
        if self.proto in ("b2", "auto"):
            # with a tenant, the HELLO carries it (connection-scoped — B2
            # records have fixed field counts); ``tr=1`` asks for the
            # per-record trace field the same way.  An old server refuses
            # an extended HELLO exactly like a plain one, so auto mode
            # still falls back to tab, where tenant and tid ride
            # per-request with no negotiation.
            hello = wire_proto.HELLO_LINE
            if self.tenant is not None:
                hello += f"\t{admission_ctl.TENANT_FIELD}{self.tenant}"
            if self._want_b2_trace:
                hello += f"\t{wire_proto.TRACE_EXT}"
            if self.stale:
                hello += f"\t{self._stale_ext}"
            if self.push:
                hello += f"\t{wire_proto.PUSH_EXT}"
            sock.sendall(hello.encode("utf-8") + b"\n")
            line = self._rfile.readline()
            if not line:
                raise ConnectionError(
                    "lookup server closed the connection during HELLO")
            reply = line.decode("utf-8").rstrip("\n")
            if reply == wire_proto.HELLO_REPLY:
                self._binary = True
                self._b2_trace = self._want_b2_trace
                self._b2_stale = self.stale
                self._b2_push = self.push
                self._frame_reader = wire_proto.FrameReader(self._rfile)
            elif self.proto == "b2":
                self.close()
                raise RuntimeError(
                    f"server refused B2 negotiation: {reply}")
            # auto: the refusal consumed the HELLO; the connection stays a
            # perfectly good tab-protocol connection

    def _roundtrip(self, request: str) -> str:
        """One request/reply exchange, retried per ``self.retry`` on
        connection-class failures (reconnect + backoff between tries).
        Safe because every verb is an idempotent read; an empty read
        (server closed mid-exchange) counts as a retryable failure too.

        When a trace context is active (``obs.tracing``), the request is
        stamped with a trailing ``tid=`` field, the server's echo is
        stripped off the reply before any parsing (so tab-bearing payloads
        like MGET stay intact), and a ``client_rpc`` span event records
        the round-trip — including retries, which is how a failover shows
        up in a request's event chain.  The wire carries ``tid/sid`` so
        the server's span parents under this rpc across the process
        boundary.  With no context active the wire bytes are identical to
        the seed protocol.  On a B2-negotiated connection the request
        rides a one-record binary frame; the tid travels in the record's
        extra trace field only when ``tr=1`` was negotiated
        (``TPUMS_TRACE_B2``) — otherwise the frame bytes stay identical
        and the client_rpc span is local-only."""
        tid = obs_tracing.current_trace()
        sid = wt = None
        if tid is not None:
            sid = obs_tracing.new_span_id()
            psid = obs_tracing.current_span_id()
            wt = obs_tracing.wire_tid(tid, sid)
            t0 = time.perf_counter()
            t0_wall = time.time()
        # append order st=, tn=, tid= — the reverse of the server's pops
        # (tid, then tenant, then stale; serve/server.py _dispatch_parts).
        # With none of them set ``line`` IS the request and the wire stays
        # byte-identical to the seed protocol.
        line = request
        if self.stale:
            line = f"{line}\t{self._stale_ext}"
        if self.tenant is not None:
            line = f"{line}\t{admission_ctl.TENANT_FIELD}{self.tenant}"
        data = line.encode("utf-8") + b"\n"
        failures = 0
        while True:
            try:
                if self._sock is None:
                    self._connect()
                if self._binary:
                    self._sock.sendall(wire_proto.encode_request_frame(
                        [request],
                        tids=[wt] if self._b2_trace else None))
                    texts = self._read_reply_frame()
                    if len(texts) != 1:
                        raise ConnectionError(
                            f"reply frame carried {len(texts)} records "
                            "for a 1-record request")
                    if tid is not None:
                        dt = time.perf_counter() - t0
                        obs_tracing.event(
                            "client_rpc", tid=tid, sid=sid, psid=psid,
                            t0=t0_wall, dur_s=round(dt, 9),
                            verb=request.split("\t", 1)[0],
                            host=self.host, port=self.port,
                            retries=failures, lat_s=round(dt, 6))
                    if self._b2_stale:
                        return self._pop_reply_stale(texts[0])
                    return texts[0]
                wire = data if wt is None else (
                    f"{line}\t{obs_tracing.TID_FIELD}{wt}\n"
                    .encode("utf-8"))
                self._sock.sendall(wire)
                reply = self._read_reply_line()
                if tid is not None:
                    reply = obs_tracing.unstamp_reply(reply, wt)
                    dt = time.perf_counter() - t0
                    obs_tracing.event(
                        "client_rpc", tid=tid, sid=sid, psid=psid,
                        t0=t0_wall, dur_s=round(dt, 9),
                        verb=request.split("\t", 1)[0],
                        host=self.host, port=self.port, retries=failures,
                        lat_s=round(dt, 6))
                if self.stale:
                    reply = self._pop_reply_stale(reply)
                return reply
            except (BrokenPipeError, ConnectionResetError, ConnectionError,
                    OSError) as e:
                self.close()
                failures += 1
                if tid is not None:
                    # retries parent under the rpc span, so a failover
                    # shows up INSIDE the slow rpc in the assembled tree
                    obs_tracing.event(
                        "client_retry", tid=tid, psid=sid, host=self.host,
                        port=self.port, attempt=failures, error=str(e))
                if failures >= self.retry.attempts:
                    raise
                self.retry.sleep(failures - 1)

    def query_state(self, name: str, key: str) -> Optional[str]:
        if "\t" in key or "\n" in key:
            raise ValueError("keys must not contain tabs/newlines")
        reply = self._roundtrip(f"GET\t{name}\t{key}")
        if reply.startswith("V\t"):
            return reply[2:]
        if reply == "N":
            return None
        raise RuntimeError(f"query failed: {reply}")

    def query_states(self, name: str, keys) -> list:
        """Batched point lookups — ONE round trip for any number of keys
        (the MGET verb).  Returns payloads in key order, None per missing
        key.  This is the edge over the reference, whose online SGD pays two
        network hops per rating (SGD.java:172-173)."""
        keys = list(keys)
        if not keys:
            return []
        for key in keys:
            if "\t" in key or "\n" in key or "," in key:
                raise ValueError("keys must not contain tabs/newlines/commas")
        return parse_mget_reply(
            self._roundtrip(f"MGET\t{name}\t{','.join(keys)}"), len(keys))

    def sparse_dot(self, name: str, range_: int, vec) -> tuple:
        """Server-side sparse dot over range-partitioned SVM rows — the
        whole ``{fid: val}`` query in ONE round trip (the DOT verb), no
        bucket payloads shipped or parsed client-side.

        -> (dot, missing_buckets) where missing_buckets lists the ranges
        with no model row (the reference prints a console message per
        missing range, RangePartitionSVMPredict.java:85-90)."""
        payload = ";".join(f"{int(f)}:{float(v)!r}" for f, v in
                           (vec.items() if hasattr(vec, "items") else vec))
        reply = self._roundtrip(f"DOT\t{name}\t{int(range_)}\t{payload}")
        if not reply.startswith("D\t"):
            raise RuntimeError(f"dot failed: {reply}")
        dot_s, _, missing_s = reply[2:].partition("\t")
        missing = [int(b) for b in missing_s.split(",") if b]
        return float(dot_s), missing

    def pipeline(self, requests, window: int = 32) -> list:
        """Pipelined round trips: keep up to ``window`` requests in flight
        on this connection before reading replies (the protocol answers
        one reply line per request, strictly in order, so replies map back
        positionally).  The server drains a burst of in-flight requests
        into one read and submits its TOPK/TOPKV members to the
        microbatcher together — a single pipelining client can therefore
        fill cross-request batches all by itself, where a strict
        request/reply client would serialize one dispatch per query.

        No transparent reconnect here (unlike ``_roundtrip``): a broken
        pipe mid-window leaves an unknown number of requests processed,
        so the error propagates to the caller.

        On a B2-negotiated connection the window becomes the frame size:
        each batch of up to ``window`` requests ships as ONE binary frame,
        with up to two frames in flight (double buffering — the server
        answers frame N while frame N+1 is on the wire), and the server
        hands the whole frame to the top-k microbatcher at once.  Tab mode
        only APPROXIMATES that batch via a racy socket drain; the frame
        makes it structural."""
        requests = list(requests)
        for req in requests:
            if "\n" in req:
                raise ValueError("requests must be single lines")
        if window < 1:
            raise ValueError("window must be >= 1")
        if self._sock is None:
            self._connect()
        tid = obs_tracing.current_trace()
        sid = wt = None
        if tid is not None:
            # ONE span (and one wire tid/sid) for the whole window: the
            # server's per-request spans all parent under this pipeline
            # span, so a pipelined fan-out leg is still one
            # reconstructable chain
            sid = obs_tracing.new_span_id()
            psid = obs_tracing.current_span_id()
            wt = obs_tracing.wire_tid(tid, sid)
            t0 = time.perf_counter()
            t0_wall = time.time()
        if self._binary:
            chunks = [requests[i:i + window]
                      for i in range(0, len(requests), window)]
            replies: list = []
            inflight: list = []  # record count per unanswered frame
            next_send = 0
            while len(replies) < len(requests):
                while next_send < len(chunks) and len(inflight) < 2:
                    chunk = chunks[next_send]
                    self._sock.sendall(wire_proto.encode_request_frame(
                        chunk,
                        tids=[wt] * len(chunk)
                        if self._b2_trace else None))
                    inflight.append(len(chunk))
                    next_send += 1
                texts = self._read_reply_frame()
                expect = inflight.pop(0)
                if len(texts) != expect:
                    raise ConnectionError(
                        f"reply frame carried {len(texts)} records, "
                        f"expected {expect}")
                replies.extend(texts)
            if tid is not None:
                dt = time.perf_counter() - t0
                obs_tracing.event(
                    "client_pipeline", tid=tid, sid=sid, psid=psid,
                    t0=t0_wall, dur_s=round(dt, 9), host=self.host,
                    port=self.port, n=len(requests), window=window,
                    lat_s=round(dt, 6))
            if self._b2_stale:
                replies = [self._pop_reply_stale(r) for r in replies]
            return replies
        if self.stale:
            # tab plane: staleness per request, stamped FIRST so the
            # server's pops (tid, tenant, stale) compose
            ssuffix = f"\t{self._stale_ext}"
            requests = [req + ssuffix for req in requests]
        if self.tenant is not None:
            # tab plane: tenant per request (before the tid, same order as
            # _roundtrip, so the server's two pops compose)
            tsuffix = f"\t{admission_ctl.TENANT_FIELD}{self.tenant}"
            requests = [req + tsuffix for req in requests]
        if wt is not None:
            suffix = f"\t{obs_tracing.TID_FIELD}{wt}"
            requests = [req + suffix for req in requests]
        if self._sock is None:
            self._connect()
        replies, sent = [], 0
        # refill at a low watermark (half the window) instead of one-for-
        # one per reply: one-for-one degenerates into lockstep singles —
        # the server answers its burst, the client trickles requests back
        # one at a time, and no two requests are ever in the socket buffer
        # together for the microbatcher to coalesce
        low = max(1, window // 2)
        while len(replies) < len(requests):
            inflight = sent - len(replies)
            if sent < len(requests) and window - inflight >= low:
                burst_end = min(len(requests), len(replies) + window)
                data = "".join(
                    req + "\n" for req in requests[sent:burst_end]
                )
                self._sock.sendall(data.encode("utf-8"))
                sent = burst_end
                continue
            replies.append(self._read_reply_line())
        if tid is not None:
            replies = [obs_tracing.unstamp_reply(r, wt) for r in replies]
            dt = time.perf_counter() - t0
            obs_tracing.event(
                "client_pipeline", tid=tid, sid=sid, psid=psid,
                t0=t0_wall, dur_s=round(dt, 9), host=self.host,
                port=self.port, n=len(requests), window=window,
                lat_s=round(dt, 6))
        if self.stale:
            replies = [self._pop_reply_stale(r) for r in replies]
        return replies

    def _read_reply_frame(self) -> list:
        """One reply frame off the B2 connection, routing any unsolicited
        ``PUSH`` frames (single-record, prefix-tagged: no reply verb shares
        the prefix) into the push queue instead of returning them as the
        next reply.  This keeps the request/reply pairing intact on a
        subscribed connection; on a pull-only connection the predicate
        never fires."""
        while True:
            texts = self._frame_reader.read_frame()
            if len(texts) == 1 and wire_proto.is_push_text(texts[0]):
                self._queue_push(texts[0])
                continue
            return texts

    def _read_reply_line(self) -> str:
        """One tab reply line, routing unsolicited push lines the same way
        (tab subscriptions are raw-socket territory, but a reader that
        tolerates the frames costs one prefix check per line)."""
        while True:
            line = self._rfile.readline()
            if not line:
                raise ConnectionError("lookup server closed the connection")
            reply = line.decode("utf-8").rstrip("\n")
            if wire_proto.is_push_text(reply):
                self._queue_push(reply)
                continue
            return reply

    def _queue_push(self, text: str) -> None:
        from .push import parse_push  # lazy: keeps the client numpy-free

        self._pushes.append(parse_push(text))

    # ------------------------------------------------------------------
    # push plane (serve/push.py; requires push=True)
    # ------------------------------------------------------------------

    def subscribe_key(self, name: str, key: str) -> dict:
        """SUBSCRIBE to a key -> ``{"sub_id", "seq", "snapshot"}`` where
        snapshot is the current value ("" when absent).  Each later change
        arrives via ``next_push`` as the new value with the next seq."""
        if "\t" in key or "\n" in key:
            raise ValueError("keys must not contain tabs/newlines")
        self._require_push()
        return self._parse_sub_reply(
            self._roundtrip(f"SUBSCRIBE\t{name}\tKEY\t{key}\t0"))

    def subscribe_topk(self, name: str, factors_payload: str,
                       k: int) -> dict:
        """SUBSCRIBE to a top-k query -> ``{"sub_id", "seq", "snapshot"}``
        with the materialized ``item:score;...`` shortlist.  Deltas
        (``+item:score`` / ``-item`` entries) arrive via ``next_push``;
        fold them with ``push.apply_delta``."""
        if "\t" in factors_payload or "\n" in factors_payload:
            raise ValueError("factor payloads must not contain tabs/newlines")
        self._require_push()
        return self._parse_sub_reply(self._roundtrip(
            f"SUBSCRIBE\t{name}\tTOPK\t{factors_payload}\t{int(k)}"))

    def resume_subscription(self, name: str, kind: str, arg: str, k: int,
                            sub_id: str, last_seq: int) -> dict:
        """RESUME after a reconnect -> ``{"mode": "replay", "sub_id",
        "seq"}`` (missed deltas follow as ordinary pushes) or ``{"mode":
        "snapshot", "sub_id", "seq", "snapshot"}``: a FRESH subscription
        whose snapshot is the catch-up (new id: the old stream cannot be
        bridged, e.g. the engine that held it is gone)."""
        self._require_push()
        reply = self._roundtrip(
            f"RESUME\t{name}\t{kind}\t{arg}\t{int(k)}\t{sub_id}:{int(last_seq)}")
        if reply.startswith("R\t"):
            _, rid, from_seq = reply.split("\t")
            return {"mode": "replay", "sub_id": rid, "seq": int(from_seq)}
        return self._parse_sub_reply(reply)

    def unsubscribe(self, sub_id: str) -> None:
        self._require_push()
        reply = self._roundtrip(f"UNSUB\t{sub_id}")
        if reply != f"U\t{sub_id}":
            raise RuntimeError(f"unsubscribe failed: {reply}")

    def next_push(self, timeout_s: float = 1.0):
        """The next queued push -> ``(sub_id, seq, payload)``, or None
        after ``timeout_s`` with nothing pushed.  Polls the frame
        reader's buffer FIRST (a push that shared a TCP segment with a
        reply is already buffered, invisible to select), then waits on
        the socket."""
        if self._pushes:
            return self._pushes.popleft()
        if not self._binary or self._frame_reader is None:
            raise RuntimeError("push needs an open B2 connection "
                               "(push=True + a prior request)")
        import select as _select

        deadline = time.monotonic() + timeout_s
        while not self._pushes:
            texts = self._frame_reader.poll_frame()
            if texts is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                readable, _, _ = _select.select(
                    [self._sock], [], [], remaining)
                if not readable:
                    return None
                texts = self._frame_reader.read_frame()
            if len(texts) == 1 and wire_proto.is_push_text(texts[0]):
                self._queue_push(texts[0])
            else:
                raise ConnectionError(
                    "non-push reply frame with no request in flight: "
                    f"{texts[:1]!r}")
        return self._pushes.popleft()

    def _require_push(self) -> None:
        if not self.push:
            raise RuntimeError(
                "push plane not enabled on this client (pass push=True)")

    @staticmethod
    def _parse_sub_reply(reply: str) -> dict:
        if not reply.startswith("S\t"):
            raise RuntimeError(f"subscribe failed: {reply}")
        _, sub_id, seq, payload = reply.split("\t", 3)
        return {"mode": "snapshot", "sub_id": sub_id, "seq": int(seq),
                "snapshot": payload}

    def _pop_reply_stale(self, reply: str) -> str:
        """Strip the trailing ``st=<seconds>`` field the server appends to
        every reply of a staleness-opted read, recording the value in
        ``last_staleness_s``.  The server ALWAYS appends the field when
        asked (0.000 on the home region), so on an opted-in connection the
        trailing field is unambiguous even for payloads containing
        ``st=``."""
        head, sep, tail = reply.rpartition("\t")
        if sep and tail.startswith(wire_proto.STALE_FIELD):
            try:
                self.last_staleness_s = float(
                    tail[len(wire_proto.STALE_FIELD):])
            except ValueError:
                return reply
            return head
        return reply

    def topk_pipelined(self, name: str, user_ids, k: int,
                       window: int = 32) -> list:
        """Batched device-scored top-k for many users: all queries ride
        one pipelined window, so the server coalesces them into shared
        dispatches.  Returns one result list per user id, in order (None
        per unknown user)."""
        reqs = []
        for uid in user_ids:
            if "\t" in uid or "\n" in uid:
                raise ValueError("user ids must not contain tabs/newlines")
            reqs.append(f"TOPK\t{name}\t{uid}\t{k}")
        return [self._parse_topk_reply(r)
                for r in self.pipeline(reqs, window)]

    def topk_by_vector_pipelined(self, name: str, factor_payloads, k: int,
                                 window: int = 32) -> list:
        """TOPKV over many explicit query vectors in one pipelined window
        (the sharded fan-out's bulk path).  Returns one result list per
        payload, in order."""
        reqs = []
        for payload in factor_payloads:
            if "\t" in payload or "\n" in payload:
                raise ValueError(
                    "factor payloads must not contain tabs/newlines")
            reqs.append(f"TOPKV\t{name}\t{k}\t{payload}")
        out = []
        for reply in self.pipeline(reqs, window):
            parsed = self._parse_topk_reply(reply)
            out.append([] if parsed is None else parsed)
        return out

    def topk(self, name: str, user_id: str, k: int):
        """Device-scored top-k recommendations for a user; returns a list of
        (item_id, score) or None if the user is unknown."""
        reply = self._roundtrip(f"TOPK\t{name}\t{user_id}\t{k}")
        return self._parse_topk_reply(reply)

    def topk_by_vector(self, name: str, factors_payload: str, k: int):
        """Top-k against an explicit query vector (``f1;f2;...`` payload) —
        the TOPKV verb.  Used by the sharded client to score a worker's
        catalog slice when the user's row lives on a different worker."""
        if "\t" in factors_payload or "\n" in factors_payload:
            raise ValueError("factor payloads must not contain tabs/newlines")
        reply = self._roundtrip(f"TOPKV\t{name}\t{k}\t{factors_payload}")
        out = self._parse_topk_reply(reply)
        return [] if out is None else out

    @staticmethod
    def _parse_topk_reply(reply: str):
        if reply == "N":
            return None
        if not reply.startswith("V\t"):
            raise RuntimeError(f"topk failed: {reply}")
        payload = reply[2:]
        out = []
        if payload:
            for tok in payload.split(";"):
                item, _, score = tok.rpartition(":")
                out.append((item, float(score)))
        return out

    def count(self, name: str) -> int:
        """Key count of a state (the COUNT verb) — the ops/metrics surface,
        and the full-ingest barrier for harnesses that cannot reach into a
        remote worker's table."""
        reply = self._roundtrip(f"COUNT\t{name}")
        if reply.startswith("C\t"):
            return int(reply[2:])
        raise RuntimeError(f"count failed: {reply}")

    def health(self, name: str) -> dict:
        """Liveness/readiness report of a state (the HEALTH verb): state
        name, key count, ingest backlog in journal bytes, and whether the
        serving job is ``ready`` (caught up) or still ``replaying`` its
        journal after a (re)start.  Supervisors and load balancers gate
        traffic on ``ready`` instead of inferring liveness from COUNT."""
        reply = self._roundtrip(f"HEALTH\t{name}")
        if not reply.startswith("H\t"):
            raise RuntimeError(f"health failed: {reply}")
        import json

        return json.loads(reply[2:])

    def topology(self, name: str) -> dict:
        """The elastic fields of HEALTH: the worker's topology group, the
        generation it was launched into, and the group's ACTIVE generation
        as the worker last observed it.  ``topology_gen > generation`` is
        the generation-changed hint: the client should re-resolve the
        topology record (``serve/elastic.py``)."""
        report = self.health(name)
        return {
            "topology_group": report.get("topology_group"),
            "generation": report.get("generation"),
            "topology_gen": report.get("topology_gen"),
        }

    def metrics(self) -> dict:
        """The server process's full metrics snapshot (the METRICS verb):
        counters/gauges/histograms as the ``obs.metrics`` snapshot schema."""
        reply = self._roundtrip("METRICS")
        if not reply.startswith("J\t"):
            raise RuntimeError(f"metrics failed: {reply}")
        import json

        return json.loads(reply[2:])

    def ping(self) -> str:
        return self._roundtrip("PING")

    def close(self) -> None:
        self._binary = False
        self._frame_reader = None
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
            self._rfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
