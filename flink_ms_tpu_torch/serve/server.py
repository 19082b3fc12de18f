"""Lookup server: the serving data plane, counterpart of Flink's Netty
KvState server queried by ``QueryClientHelper.queryState``
(``QueryClientHelper.java:104-139``).

Own copy of ``flink_ms_tpu/serve/server.py``'s ``LookupServer``: the same
verbs, framings and reply bytes, so a client of either package gets the
same replies from a server of either package for the same table.

Line protocol over TCP (persistent connections, thread per client):

    request:  ``GET\\t<state>\\t<key>``, ``MGET\\t<state>\\t<k1>,<k2>,...``,
              ``TOPK\\t<state>\\t<user_id>\\t<k>``,
              ``TOPKV\\t<state>\\t<k>\\t<f1;f2;...>``, ``COUNT\\t<state>``,
              ``HEALTH\\t<state>``, ``DOT\\t<state>\\t<range>\\t<fid>:<val>;...``,
              ``METRICS``, ``PING``
    response: ``V\\t<value>`` found (top-k payload ``item:score;...``), ``N``
              unknown key, ``M\\t<i1>\\t<i2>...`` the MGET reply (``N``
              missing, ``V<value>`` found, in request order), ``E\\t<msg>``
              error, ``C\\t<n>`` COUNT, ``H\\t<json>`` HEALTH,
              ``D\\t<dot>\\t<missing_buckets_csv>`` DOT, ``J\\t<json>``
              METRICS (the process's metrics snapshot), ``PONG\\t<job_id>\\t<states>``

Optional trailing request fields, popped before verb dispatch in the order
``tid=`` (tracing: a ``server_reply`` span event, and the tid echoed on the
reply), ``tn=`` (the admission tenant; over quota answers
``E\\tover quota``), ``st=1`` (the reply gains ``st=<seconds>``, the
staleness behind a home region; 0.000 here, where no follower record
exists).  A client may send ``HELLO\\tB2`` (with the ``tn=``, ``tr=1``,
``st=1`` extensions) to switch the connection to the length-prefixed
binary ``B2`` frames of ``serve/proto.py``; a whole frame, like a
pipelined burst of tab lines, is submitted to the top-k microbatcher
before any reply is resolved, so it coalesces into one device dispatch.

TOPK/TOPKV go to the handler in ``topk_handlers`` (``serve/topk.py``'s
``make_als_topk_handler``: the device-resident factor index behind the
cross-request batcher of ``serve/microbatch.py``).

The push plane (``serve/push.py``): ``SUBSCRIBE``, ``RESUME`` and
``UNSUB`` answer ``S``/``R``/``U`` and the engine sends unsolicited
``PUSH`` frames between replies.  On tab sending a verb opts the
connection in; on B2 the verbs need the ``su=1`` HELLO first and answer
``E\\tbad request`` without it, as the reference does.  The engine is
built at the first subscription (it attaches table listeners, which make
ingest run the Python listener path), and a connection's subscriptions
end with it.

``PROFILE`` answers the process profiler's stage-keyed folded stacks as
one ``P\\t<json>`` line (``obs/profiler.py``), as the reference's does.
"""

from __future__ import annotations

import socketserver
import threading
import time
from typing import Dict, Optional

from ..core.formats import RangePayloadCache, gather_sorted, sort_dedup_last
from ..obs import metrics as obs_metrics
from ..obs import profiler as obs_profiler
from ..obs import tracing as obs_tracing
from . import admission as admission_ctl
from . import proto
from . import push as push_plane
from .table import ModelTable


class _ConnPushSink:
    """Per-connection ordered write gate shared by the reply writer and
    the push engine (serve/push.py).

    Replies and unsolicited PUSH frames leave through ONE lock, so engine
    writes never interleave bytes with a reply write.  ``arm()`` (called
    by the engine while a subscribe/resume reply is still pending) flips
    pushes into a deferred buffer that ``write_reply`` flushes right
    after the reply bytes — a delta can therefore never overtake its own
    S/R baseline on the wire.  Pull-only connections pay one uncontended
    lock acquisition per reply burst and write byte-identical output."""

    __slots__ = ("_wfile", "_binary", "_lock", "_deferred", "used")

    def __init__(self, wfile, binary: bool):
        self._wfile = wfile
        self._binary = binary
        self._lock = threading.Lock()
        self._deferred = None
        self.used = False  # a push verb bound subscriptions to this conn

    def arm(self) -> None:
        with self._lock:
            if self._deferred is None:
                self._deferred = []

    def defer(self, texts) -> None:
        with self._lock:
            if self._deferred is None:
                self._deferred = []
            self._deferred.extend(texts)

    def send_push(self, text: str) -> None:
        with self._lock:
            if self._deferred is not None:
                self._deferred.append(text)
                return
            self._write(text)

    def _write(self, text: str) -> None:
        if self._binary:
            self._wfile.write(proto.encode_reply_frame([text]))
        else:
            self._wfile.write((text + "\n").encode("utf-8"))

    def write_reply(self, data: bytes) -> None:
        """Reply bytes, then any deferred pushes, one critical section."""
        with self._lock:
            self._wfile.write(data)
            deferred, self._deferred = self._deferred, None
            if deferred:
                for text in deferred:
                    self._write(text)


class _DeferredReply:
    """A reply whose value is still in flight in the top-k microbatcher.
    ``resolve()`` parks until the dispatcher scatters the result back and
    renders the same wire reply the synchronous path would have.

    ``post`` (set by ``_dispatch_async``) runs at resolve time — that is
    the only moment a deferred verb's true latency is known, so metric
    observation, span events and the tid echo all live there; it receives
    the rendered reply plus the resolver (whose ``pending`` attribute,
    when present, carries the microbatcher's span fields)."""

    __slots__ = ("_resolver", "post")

    def __init__(self, resolver):
        self._resolver = resolver
        self.post = None

    def resolve(self) -> str:
        try:
            payload = self._resolver()
        except Exception as e:
            reply = f"E\ttopk failed: {e}"
        else:
            reply = "N" if payload is None else f"V\t{payload}"
        if self.post is not None:
            reply = self.post(reply, self._resolver)
        return reply


class LookupServer:
    def __init__(
        self,
        tables: Dict[str, ModelTable],
        host: str = "0.0.0.0",
        port: int = 6123,
        job_id: str = "local",
        topk_handlers: Optional[Dict[str, object]] = None,
        health_fn=None,
        admission: Optional[admission_ctl.AdmissionController] = None,
        staleness_fn=None,
    ):
        self.tables = tables
        self.job_id = job_id
        self.topk_handlers = topk_handlers or {}
        # per-read staleness provider (serve/georepl.py): a callable ->
        # seconds this server's state trails its home region, or None on
        # a non-follower.  Only consulted for requests that opted in via
        # the ``st=`` wire field — untagged traffic never pays the call.
        self.staleness_fn = staleness_fn
        # per-tenant admission control (serve/admission.py): None unless a
        # TPUMS_ADMIT_* rate knob is set (or a controller is injected) —
        # the admission-off hot path costs one attribute check
        self.admission = (admission if admission is not None
                          else admission_ctl.AdmissionController.from_env())
        # HEALTH verb provider: a callable -> dict describing the owning
        # job's liveness (ServingJob.health).  A bare server (tests, ad-hoc
        # tables) synthesizes a minimal always-ready report instead.
        self.health_fn = health_fn
        # DOT verb caches: per-payload parse cache (payload-string-keyed =
        # coherent by construction) feeding a per-state merged sorted index
        # keyed on the table's mutation version
        self._dot_cache = RangePayloadCache()
        self._dot_merged: Dict[str, tuple] = {}
        self._dot_build_lock = threading.Lock()
        self.requests = 0  # observability; also lets tests assert round trips
        # per-verb instrument cache: (requests counter, latency histogram,
        # error counter), created lazily so only verbs actually served
        # appear in the exposition
        self._obs_verbs: Dict[str, tuple] = {}
        self._obs_burst = obs_metrics.get_registry().histogram(
            "tpums_server_burst_size", bounds=obs_metrics.SIZE_BUCKETS)
        # live persistent connections + their handler threads: clients hold
        # sockets open across many requests, so TCPServer.shutdown() alone
        # leaves handlers serving AFTER stop() returns, racing whatever the
        # owning job tears down next
        self._conns: set = set()
        self._conn_threads: set = set()
        self._conn_lock = threading.Lock()
        # push plane (serve/push.py): built lazily at the FIRST subscribe,
        # because the engine's table listeners make ingest take the Python
        # listener path; pull-only deployments never pay it
        self._push_engine: Optional[push_plane.PushEngine] = None
        self._push_create_lock = threading.Lock()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                """Line loop with explicit framing (not rfile.readline):
                after blocking for the first request, every further
                COMPLETE line already buffered or immediately readable is
                drained into the same burst, and the burst's TOPK/TOPKV
                queries are all submitted to the microbatcher BEFORE any
                reply is awaited — so a pipelined client's in-flight
                window coalesces into one batched dispatch exactly like
                concurrent connections do.  Replies keep strict request
                order (the wire contract is unchanged)."""
                import select

                with outer._conn_lock:
                    outer._conns.add(self.connection)
                    outer._conn_threads.add(threading.current_thread())
                sock = self.connection
                buf = bytearray()
                eof = False
                # tenant bound to THIS connection by an extended HELLO
                # (``HELLO\tB2\ttn=<t>``) — the B2 record layout has no
                # room for a per-request field, so on the binary plane
                # tenancy is a connection property.  ``tr=1`` likewise
                # binds per-record tracing: every subsequent request
                # record carries one extra trailing tid field.
                conn_tenant = None
                conn_trace = False
                conn_stale = False  # ``st=1``: staleness on every reply
                conn_push = False   # ``su=1``: B2 push frames accepted
                # one ordered write gate per connection: replies and any
                # engine pushes share it (on tab, sending a push verb is
                # the opt-in, so the sink is always offered to dispatch)
                sink = _ConnPushSink(self.wfile, binary=False)
                try:
                    while True:
                        # block for at least one complete line (or EOF)
                        while not eof and buf.find(b"\n") < 0:
                            try:
                                chunk = sock.recv(65536)
                            except (ConnectionResetError, OSError):
                                return
                            if not chunk:
                                eof = True
                                break
                            buf += chunk
                        # opportunistic non-blocking drain: whatever the
                        # client already put on the wire joins this burst
                        while not eof:
                            try:
                                readable, _, _ = select.select(
                                    [sock], [], [], 0)
                            except (OSError, ValueError):
                                break
                            if not readable:
                                break
                            try:
                                chunk = sock.recv(65536)
                            except (ConnectionResetError, OSError):
                                chunk = b""
                            if not chunk:
                                eof = True
                                break
                            buf += chunk
                        lines = []
                        hello = False
                        while True:
                            nl = buf.find(b"\n")
                            if nl < 0:
                                break
                            raw = bytes(buf[:nl])
                            del buf[:nl + 1]
                            lines.append(raw.decode("utf-8"))
                            hello_b = proto.HELLO_LINE.encode("utf-8")
                            if raw == hello_b or raw.startswith(
                                    hello_b + b"\t"):
                                # candidate protocol switch: only a HELLO
                                # whose every extension parses (tn=/tr=/
                                # st=/su=) flips the connection — anything
                                # else stays a normal line and answers
                                # E\tbad request below, exactly like an
                                # old server
                                ext = proto.parse_hello(
                                    raw.decode("utf-8").split("\t"))
                                if ext is not None:
                                    # whatever follows the HELLO line is
                                    # already B2 frames — stop
                                    # line-splitting, leave it buffered,
                                    # bind the extensions to the conn
                                    conn_tenant = ext["tenant"] or None
                                    conn_trace = ext["trace"]
                                    conn_stale = ext["stale"]
                                    conn_push = ext["push"]
                                    hello = True
                                    break
                        if eof and buf and not hello:
                            # trailing request without a newline is still
                            # answered (readline()-at-EOF parity)
                            lines.append(buf.decode("utf-8"))
                            buf.clear()
                        if not lines:
                            return
                        if len(lines) > 1:
                            # only multi-line bursts are recorded: a
                            # single-line burst is the complement
                            # (requests_total minus the histogram count)
                            # and observing the constant 1 per request is
                            # measurable on a ~0.1 ms round trip
                            outer._obs_burst.observe(len(lines))
                        # submit ALL, then resolve in order
                        replies = [
                            outer._dispatch_async(ln, burst=len(lines),
                                                  push_sink=sink)
                            for ln in lines
                        ]
                        if len(lines) > 1:
                            # the burst is fully submitted: let the
                            # dispatcher fire without waiting out the
                            # coalescing window for arrivals that were
                            # never coming
                            outer._flush_batchers()
                        out = b"".join(
                            (r.resolve() if isinstance(r, _DeferredReply)
                             else r).encode("utf-8") + b"\n"
                            for r in replies
                        )
                        try:
                            sink.write_reply(out)
                        except (BrokenPipeError, OSError):
                            return
                        if hello:
                            outer._serve_binary(sock, self.wfile, buf, eof,
                                                tenant=conn_tenant,
                                                trace=conn_trace,
                                                stale=conn_stale,
                                                push=conn_push)
                            return
                        if eof:
                            return
                finally:
                    outer._drop_push_sink(sink)
                    with outer._conn_lock:
                        outer._conns.discard(self.connection)
                        outer._conn_threads.discard(
                            threading.current_thread())

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _merged_range_index(self, state: str, table) -> tuple:
        """(sorted fid array, aligned weight array, bucket-id set) over
        every parseable bucket row of `state`, rebuilt when the table's
        mutation version moves.  Per-bucket parses ride the payload-keyed
        cache, so a rebuild after a republish only re-parses changed rows.
        Rows whose key is not an int or whose payload is not ``idx:w;...``
        are skipped — on a flat-model table the index is empty and every
        queried bucket reports missing, which is what DOT against an
        un-partitioned state means."""
        ver = getattr(table, "version", None)
        cached = self._dot_merged.get(state)
        if cached is not None and ver is not None and cached[0] == ver:
            return cached[1], cached[2], cached[3]
        # single-flight rebuild: with a stale entry available, serve it
        # rather than pile K handler threads onto K identical O(model)
        # rebuilds after one mutation (same serve-stale design as the
        # top-k index); the FIRST build has nothing to serve, so it blocks
        if not self._dot_build_lock.acquire(blocking=cached is None):
            return cached[1], cached[2], cached[3]
        try:
            return self._rebuild_merged_range_index(state, table)
        finally:
            self._dot_build_lock.release()

    def _rebuild_merged_range_index(self, state: str, table) -> tuple:
        import numpy as np

        ver = getattr(table, "version", None)
        cached = self._dot_merged.get(state)
        if cached is not None and ver is not None and cached[0] == ver:
            return cached[1], cached[2], cached[3]  # built while we waited
        # the per-payload cache must hold every bucket row, or each rebuild
        # re-parses the evicted ones forever (FIFO churn at >cap buckets)
        n_rows = len(table)
        if n_rows * 2 > self._dot_cache.max_entries:
            self._dot_cache.max_entries = n_rows * 2
        rows = []
        for key, payload in table.items():
            try:
                rows.append((int(key), payload))
            except ValueError:
                continue
        # rows concatenate in ASCENDING BUCKET order (table iteration is
        # shard-hash order, not publish order, so cross-row duplicate-fid
        # last-wins is pinned to something every plane can reproduce)
        rows.sort(key=lambda r: r[0])
        fid_parts, w_parts, buckets = [], [], set()
        for bucket, payload in rows:
            try:
                idx, w = self._dot_cache.lookup(payload)
            except ValueError:
                continue  # not an idx:w;... row (e.g. a flat-model row)
            buckets.add(bucket)
            fid_parts.append(idx)
            w_parts.append(w)
        if fid_parts:
            # cross-bucket duplicate fids resolve last-wins, like in-row
            fids, ws = sort_dedup_last(np.concatenate(fid_parts),
                                       np.concatenate(w_parts))
        else:
            fids = np.zeros(0, np.int64)
            ws = np.zeros(0, np.float64)
        buckets = frozenset(buckets)
        if ver is not None:
            self._dot_merged[state] = (ver, fids, ws, buckets)
        return fids, ws, buckets

    def _dispatch(self, line: str) -> str:
        """Synchronous dispatch (compat surface): resolves any deferred
        top-k reply before returning."""
        reply = self._dispatch_async(line)
        return reply.resolve() if isinstance(reply, _DeferredReply) else reply

    def _flush_batchers(self) -> None:
        """Release every handler's coalescing window (burst submitted)."""
        for handler in self.topk_handlers.values():
            batcher = getattr(handler, "batcher", None)
            if batcher is not None:
                try:
                    batcher.flush()
                except Exception:
                    pass

    def _dispatch_async(self, line: str, burst: int = 1, push_sink=None):
        """-> reply str, or a _DeferredReply for TOPK/TOPKV riding the
        microbatcher (the handler loop submits a whole pipelined burst
        before resolving any, so the burst shares a device dispatch).
        ``burst`` is the number of lines in the read burst this line
        belongs to — burst members must enqueue rather than take the
        batcher's idle inline path, or the burst serializes back into
        singles."""
        return self._dispatch_parts(line.split("\t"), burst,
                                    push_sink=push_sink)

    def _dispatch_parts(self, parts, burst: int = 1, traced: bool = True,
                        tenant: Optional[str] = None,
                        echo_tid: bool = True, stale: bool = False,
                        push_sink=None):
        """Dispatch over already-split fields — the shared core of the tab
        line loop and the B2 frame loop (binary records arrive pre-split,
        and their fields may legally contain tabs, so they must never take
        a join-then-resplit detour).

        Also the observability choke point: pops an optional trailing
        ``tid=`` trace field FIRST (so every verb handler below sees the
        seed protocol's exact field counts — untraced traffic is
        byte-identical in both directions; an un-negotiated binary
        connection passes ``traced=False``, a ``tr=1`` one gets its
        per-record tid surfaced as the same trailing field but with
        ``echo_tid=False`` — B2 replies are never suffixed), times the
        dispatch, feeds the per-verb counter/latency instruments, and
        echoes the tid on the reply.  Deferred top-k replies do all of
        that at resolve time via the post hook, when their true latency
        is known.

        Tenancy + admission happen here too, before any handler work: a
        trailing ``tn=`` field is popped the same way (tab plane only —
        B2 passes the connection's HELLO-bound tenant via ``tenant``),
        and the tenant's token bucket is charged.  Over quota the request
        is answered ``E\\tover quota`` without touching a table or the
        microbatcher — shedding must cost less than serving.  ``push_sink``
        is the connection's write gate where push verbs are allowed (every
        tab connection; a B2 one after ``su=1``), else None."""
        self.requests += 1
        tid = obs_tracing.pop_tid(parts) if traced else None
        if tenant is None and traced:
            tenant = admission_ctl.pop_tenant(parts)
        if not stale and traced:
            # tab-plane per-read staleness opt-in; on B2 the HELLO binds
            # it per connection and arrives via the ``stale`` argument
            stale = proto.pop_stale(parts)
        verb = parts[0] if parts and parts[0] else "?"
        if verb == proto.HELLO_VERB:
            # the accept reply is frozen (old and new clients parse it
            # alike): an ``st=1`` HELLO extension binds staleness to the
            # CONNECTION (handler loop), never to the handshake reply
            stale = False
        t0 = time.perf_counter()
        if self.admission is not None and \
                not self.admission.admit(tenant, verb):
            return self._finish(verb, tid, t0, admission_ctl.SHED_REPLY,
                                shed=True, echo=echo_tid, stale=stale)
        if verb == "METRICS" and len(parts) == 1:
            return self._finish(verb, tid, t0, self._metrics_reply(),
                                echo=echo_tid, stale=stale)
        if verb == "PROFILE" and len(parts) == 1:
            # the profiling plane's scrape verb: the process profiler's
            # folded stacks as one P\t<json> line (the METRICS pattern
            # applied to profiles — obs/profiler.py)
            return self._finish(verb, tid, t0, self._profile_reply(),
                                echo=echo_tid, stale=stale)
        reply = self._handle(parts, burst, push_sink)
        if isinstance(reply, _DeferredReply):
            reply.post = lambda rendered, resolver: self._finish(
                verb, tid, t0, rendered, resolver, echo=echo_tid,
                stale=stale)
            return reply
        return self._finish(verb, tid, t0, reply, echo=echo_tid,
                            stale=stale)

    def _serve_binary(self, sock, wfile, buf: bytearray, eof: bool,
                      tenant: Optional[str] = None,
                      trace: bool = False, stale: bool = False,
                      push: bool = False) -> None:
        """B2 frame loop, entered after an accepted HELLO (``serve.proto``).

        One request frame in -> one reply frame out, records answered in
        order; a whole frame is submitted to the microbatcher before any
        reply is resolved, so a client batch coalesces into one device
        dispatch exactly like a tab-mode pipelined burst.  Structural
        corruption answers a single-record ``E\\tbad frame: <reason>``
        frame and closes; a partial frame at EOF is dropped silently (the
        tab plane's unterminated-line parity does not apply — a frame is
        atomic or absent).

        ``push`` (the HELLO's ``su=1``) arms the connection for the push
        plane: subscribe verbs get a sink, and engine deltas ride the
        same write gate as replies (single-record ``PUSH`` frames between
        reply frames).  Without it the subscribe verbs answer the generic
        ``E\\tbad request`` and the wire stays byte-identical."""
        sink = _ConnPushSink(wfile, binary=True)
        try:
            while True:
                try:
                    res = proto.decode_request_frame(buf, trace=trace)
                except proto.ProtoError as e:
                    try:
                        wfile.write(proto.error_frame(str(e)))
                    except (BrokenPipeError, OSError):
                        pass
                    return
                if res is None:
                    if eof:
                        return
                    try:
                        chunk = sock.recv(65536)
                    except (ConnectionResetError, OSError):
                        return
                    if not chunk:
                        eof = True
                        continue
                    buf += chunk
                    continue
                records, consumed = res
                del buf[:consumed]
                if len(records) > 1:
                    self._obs_burst.observe(len(records))
                replies = [
                    # tr=1 records surface their tid as the standard
                    # trailing field (decoder contract), so
                    # ``traced=trace`` reuses the tab plane's pop/span
                    # path — but B2 replies are never tid-suffixed (the
                    # client keeps its own request order)
                    self._dispatch_parts(parts, burst=len(records),
                                         traced=trace, tenant=tenant,
                                         echo_tid=False, stale=stale,
                                         push_sink=sink if push else None)
                    for parts in records
                ]
                if len(records) > 1:
                    self._flush_batchers()
                texts = [
                    r.resolve() if isinstance(r, _DeferredReply) else r
                    for r in replies
                ]
                try:
                    sink.write_reply(proto.encode_reply_frame(texts))
                except (BrokenPipeError, OSError):
                    return
        finally:
            self._drop_push_sink(sink)

    def _verb_obs(self, verb: str) -> tuple:
        inst = self._obs_verbs.get(verb)
        if inst is None:
            reg = obs_metrics.get_registry()
            inst = (
                reg.histogram("tpums_server_latency_seconds", verb=verb),
                reg.counter("tpums_server_errors_total", verb=verb),
            )
            self._obs_verbs[verb] = inst
        return inst

    def _finish(self, verb: str, tid: Optional[str], t0: float,
                reply: str, resolver=None, shed: bool = False,
                echo: bool = True, stale: bool = False) -> str:
        """Request epilogue: per-verb metrics, span event + tid echo for
        traced requests.  ``resolver`` (deferred top-k only) may expose a
        ``pending`` with the microbatcher's span fields — queue wait,
        batch size, device seconds — which join the event AND become
        synthesized child spans (``mb_queue_wait``/``mb_device``) under
        the ``server_reply`` span, so one slow traced query shows WHERE
        its time went.

        ``tid`` is the RAW wire value (possibly ``tid/sid`` — the sid is
        the CLIENT's rpc span, which parents this server's span across
        the process boundary); it is echoed verbatim so the client's
        exact-suffix unstamp keeps working.  ``echo=False`` (B2) skips
        the suffix — frames carry no reply-side tid.

        ``shed`` marks an admission reject: it is an E-reply on the wire
        but NOT a server error — it rides its own counter
        (``tpums_admission_shed_total``), so deliberate shedding never
        reads as the fleet failing."""
        dt = time.perf_counter() - t0
        trace_id, psid = obs_tracing.split_tid(tid) if tid is not None \
            else (None, None)
        if obs_metrics.metrics_enabled():
            # ONE locked observation per request: the per-verb request
            # count is the latency histogram's count, and the
            # ``tpums_server_requests_total`` counter series is
            # synthesized from it at snapshot time (synthesize_requests)
            # instead of paying a second lock on every request
            latency, errors = self._verb_obs(verb)
            # the tid rides along so an exemplar (obs/metrics.py) can link
            # this bucket to this trace; None for untraced requests
            latency.observe(dt, tid=trace_id)
            if reply.startswith("E") and not shed:
                errors.inc()
        if tid is not None:
            t_end = time.time()
            sid = obs_tracing.new_span_id()
            fields = {"verb": verb, "job_id": self.job_id,
                      "port": self.port, "lat_s": round(dt, 6),
                      "ok": not reply.startswith("E")}
            if shed:
                fields["shed"] = True
            pending = getattr(resolver, "pending", None)
            if pending is not None:
                for name in ("queue_wait_s", "batch_size", "device_s"):
                    v = getattr(pending, name, None)
                    if v is not None:
                        fields[name] = round(v, 6) if isinstance(v, float) \
                            else v
            obs_tracing.event("server_reply", tid=trace_id, sid=sid,
                              psid=psid, t0=t_end - dt,
                              dur_s=round(dt, 9), **fields)
            if pending is not None:
                # synthesize the microbatch stages as child spans — the
                # batcher records durations, not span ids, so the tree
                # shape is rebuilt here from the request timeline
                qw = getattr(pending, "queue_wait_s", None)
                dev = getattr(pending, "device_s", None)
                if qw is not None:
                    obs_tracing.event(
                        "mb_queue_wait", tid=trace_id,
                        sid=obs_tracing.new_span_id(), psid=sid,
                        t0=t_end - dt, dur_s=round(qw, 9))
                if dev is not None:
                    obs_tracing.event(
                        "mb_device", tid=trace_id,
                        sid=obs_tracing.new_span_id(), psid=sid,
                        t0=t_end - dev, dur_s=round(dev, 9),
                        batch_size=getattr(pending, "batch_size", None))
        if stale:
            # staleness rides BEFORE the tid echo: the client strips its
            # exact tid suffix first, then pops the trailing st field
            reply = (f"{reply}\t{proto.STALE_FIELD}"
                     f"{self._staleness_value():.3f}")
        if tid is not None and echo:
            reply = f"{reply}\t{obs_tracing.TID_FIELD}{tid}"
        return reply

    def _staleness_value(self) -> float:
        """Seconds this server's state trails its home region; 0.0 on the
        home region itself (or when the provider fails — a read that got
        an answer is not staler for the status file being unreadable)."""
        if self.staleness_fn is None:
            return 0.0
        try:
            v = self.staleness_fn()
        except Exception:
            return 0.0
        return 0.0 if v is None else max(float(v), 0.0)

    def _metrics_reply(self) -> str:
        """The METRICS verb: the whole process-wide registry as ONE
        JSON line (the protocol is line-framed; the Prometheus rendering
        of the same snapshot is a client-side transform — obs/scrape.py)."""
        try:
            snap = obs_metrics.synthesize_requests(
                obs_metrics.get_registry().snapshot(
                    meta={"job_id": self.job_id, "port": self.port,
                          "plane": "python"}))
            return "J\t" + obs_metrics.snapshot_to_json_line(snap)
        except Exception as e:
            return f"E\tmetrics failed: {e}"

    def _profile_reply(self) -> str:
        """The PROFILE verb: the process profiler's stage-keyed folded
        stacks as ONE ``P\\t<json>`` line.  Always answers — with the
        profiler off the stacks are empty but the line still parses, so
        fleet scrapes see 'no samples', not an error."""
        try:
            return obs_profiler.profile_reply_line(
                meta={"job_id": self.job_id, "port": self.port,
                      "plane": "python"})
        except Exception as e:
            return f"E\tprofile failed: {e}"

    def _push(self) -> push_plane.PushEngine:
        """The lazily built push engine (serve/push.py).  The first call,
        at the first SUBSCRIBE this process serves, registers the table
        change listeners; see the constructor for why that waits."""
        eng = self._push_engine
        if eng is None:
            with self._push_create_lock:
                eng = self._push_engine
                if eng is None:
                    eng = push_plane.PushEngine(
                        self.tables, self.topk_handlers, scope=self.job_id)
                    self._push_engine = eng
        return eng

    def _drop_push_sink(self, sink) -> None:
        """Connection epilogue: drop every subscription bound to it."""
        if sink is None or not sink.used:
            return
        eng = self._push_engine
        if eng is not None:
            eng.drop_sink(sink)

    def _handle(self, parts, burst: int = 1, push_sink=None):
        """Verb dispatch over already-split fields (tid removed)."""
        if parts[0] == "PING":
            return f"PONG\t{self.job_id}\t{','.join(self.tables)}"
        if parts[0] == proto.HELLO_VERB and \
                proto.parse_hello(parts) is not None:
            # protocol negotiation: the handler loop flips the connection
            # to B2 on the exact accept line (an old server answers
            # E\tbad request here, which clients read as "tab only").
            # Accepted extensions — a tenant binding (``tn=<t>``) and/or
            # per-record tracing (``tr=1``) — were already captured by
            # the handler loop; the reply stays the frozen 2-field accept
            # so old and new clients parse it alike.  A HELLO with any
            # other extra field stays the generic E\tbad request.
            if parts[1] == "B2":
                return proto.HELLO_REPLY
            return f"E\tunsupported proto: {parts[1]}"
        if parts[0] == "COUNT" and len(parts) == 2:
            # key count of a state — the ops/metrics surface (Flink exposes
            # state sizes the same way) and the ingest barrier multi-process
            # harnesses use instead of reaching into a worker's table
            _, state = parts
            table = self.tables.get(state)
            if table is None:
                return f"E\tunknown state: {state}"
            return f"C\t{len(table)}"
        if parts[0] == "HEALTH" and len(parts) == 2:
            # liveness/readiness in ONE verb: key count, ingest backlog and
            # the replaying-vs-ready flag, so supervisors and load
            # balancers don't have to infer health from COUNT deltas
            _, state = parts
            table = self.tables.get(state)
            if table is None:
                return f"E\tunknown state: {state}"
            import json as _json

            try:
                if self.health_fn is not None:
                    report = dict(self.health_fn())
                    report.setdefault("state", state)
                else:
                    report = {
                        "state": state, "ready": True, "status": "ready",
                        "backlog_bytes": 0,
                    }
                report["keys"] = len(table)
                report.setdefault("job_id", self.job_id)
                # elastic plane: keep the HEALTH payload schema uniform —
                # a non-elastic worker answers the topology fields with
                # null rather than omitting them (client.topology relies
                # on the keys existing)
                report.setdefault("topology_group", None)
                report.setdefault("generation", None)
                report.setdefault("topology_gen", None)
                # pointer to this replica's metrics snapshot: same
                # endpoint, METRICS verb (scrape clients need no extra
                # port discovery)
                report.setdefault(
                    "metrics_uri",
                    f"tpums://{self.host}:{self.port}/METRICS")
                return "H\t" + _json.dumps(report)
            except Exception as e:
                return f"E\thealth failed: {e}"
        if parts[0] == "GET" and len(parts) == 3:
            _, state, key = parts
            table = self.tables.get(state)
            if table is None:
                return f"E\tunknown state: {state}"
            value = table.get(key)
            return "N" if value is None else f"V\t{value}"
        if parts[0] == "MGET" and len(parts) == 3:
            _, state, keys_csv = parts
            table = self.tables.get(state)
            if table is None:
                return f"E\tunknown state: {state}"
            items = []
            for key in keys_csv.split(","):
                value = table.get(key)
                items.append("N" if value is None else f"V{value}")
            return "M\t" + "\t".join(items)
        if parts[0] == "DOT" and len(parts) == 4:
            # server-side sparse dot over range-partitioned rows: ONE round
            # trip for the whole sparse query, resolved against a merged
            # sorted index over every bucket row (version-keyed, so one
            # searchsorted answers the query instead of one numpy gather
            # per bucket) — no payload shipping/parsing on the client
            # (RangePartitionSVMPredict.java:63,80-101 intent)
            _, state, range_s, qpayload = parts
            table = self.tables.get(state)
            if table is None:
                return f"E\tunknown state: {state}"
            try:
                import numpy as np

                range_ = int(range_s)
                if range_ < 1:
                    return "E\trange must be >= 1"
                # light-weight query parse (the payload is our own client's
                # wire format): one split, one numpy text-parse pass; any
                # garbage token raises and returns an E line.  The strict
                # alternating-separator validator in parse_svm_range_payload
                # costs more than the whole MGET verb at 70-nnz queries.
                acc, missing = 0.0, []
                stripped = qpayload.rstrip(";")
                if stripped:
                    toks = stripped.replace(":", ";").split(";")
                    # structural check: exactly one
                    # colon per segment and no empty interior segments —
                    # an even token count alone would accept "1:2:3:4"
                    n_pairs = len(toks) // 2
                    if (len(toks) % 2
                            or stripped.count(":") != n_pairs
                            or stripped.count(";") != n_pairs - 1):
                        raise ValueError(f"malformed pair in {stripped[:40]!r}")
                    flat = np.array(toks)
                    qf = flat[0::2].astype(np.int64)
                    qv = flat[1::2].astype(np.float64)
                    fids, ws, bucket_set = self._merged_range_index(
                        state, table)
                    got, hit = gather_sorted(fids, ws, qf)
                    acc = float(qv @ got)
                    # a bucket with no model row can only show up among the
                    # missed fids — the common all-hit query skips this
                    missed = qf[~hit]
                    if missed.size:
                        missing = [int(b) for b in
                                   np.unique(missed // range_).tolist()
                                   if int(b) not in bucket_set]
            except Exception as e:
                return f"E\tdot failed: {e}"
            return f"D\t{acc!r}\t{','.join(str(b) for b in missing)}"
        if parts[0] in ("TOPK", "TOPKV") and len(parts) == 4:
            # TOPK resolves the user's factors server-side; TOPKV scores an
            # explicit query vector (operands: state, k, payload)
            if parts[0] == "TOPK":
                _, state, query_arg, k_s = parts
            else:
                _, state, k_s, query_arg = parts
            handler = self.topk_handlers.get(state)
            if handler is None or (
                parts[0] == "TOPKV" and not hasattr(handler, "by_vector")
            ):
                return f"E\tno topk index for state: {state}"
            try:
                k = int(k_s)
                if k < 1:
                    return "E\tk must be >= 1"
                submit = getattr(handler, "submit_query", None)
                if submit is not None:
                    # enqueue NOW, render the reply at resolve time: the
                    # caller can submit a whole burst before parking, so
                    # pipelined requests coalesce in the microbatcher
                    return _DeferredReply(
                        submit(parts[0], query_arg, k, burst=burst))
                fn = handler if parts[0] == "TOPK" else handler.by_vector
                payload = fn(query_arg, k)
            except Exception as e:
                return f"E\ttopk failed: {e}"
            return "N" if payload is None else f"V\t{payload}"
        if parts[0] in ("SUBSCRIBE", "RESUME") and \
                len(parts) == (5 if parts[0] == "SUBSCRIBE" else 6):
            # push plane (serve/push.py).  ``push_sink`` is the opt-in
            # gate: on B2 it exists only after a ``su=1`` HELLO; on tab
            # the verb itself is the opt-in, so the sink is always
            # offered.  Without a sink the verbs answer the generic bad
            # request, byte-identical to a server without a push plane.
            if push_sink is None:
                return "E\tbad request"
            _, state, kind, arg, k_s = parts[:5]
            try:
                k = int(k_s)
            except ValueError:
                return "E\tbad request"
            try:
                eng = self._push()
                push_sink.used = True
                if parts[0] == "SUBSCRIBE":
                    sub_id, seq, snapshot = eng.subscribe(
                        state, kind, arg, k, push_sink)
                    return f"S\t{sub_id}\t{seq}\t{snapshot}"
                mode, sub_id, seq, snapshot = eng.resume(
                    state, kind, arg, k, parts[5], push_sink)
                if mode == "replay":
                    return f"R\t{sub_id}\t{seq}"
                return f"S\t{sub_id}\t{seq}\t{snapshot}"
            except push_plane.PushError as e:
                return f"E\t{e}"
            except Exception as e:
                return f"E\tsubscribe failed: {e}"
        if parts[0] == "UNSUB" and len(parts) == 2:
            if push_sink is None:
                return "E\tbad request"
            eng = self._push_engine
            if eng is not None and eng.unsubscribe(parts[1]):
                return f"U\t{parts[1]}"
            return f"E\tunknown subscription: {parts[1]}"
        return "E\tbad request"

    def start(self) -> "LookupServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="lookup-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread:
            # shutdown() waits for serve_forever, so only a started server
            # may call it
            self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        # quiesce persistent connections: shutting the sockets unblocks the
        # handlers' readline, then join them so no request is in flight
        # when the caller tears down the backing state
        import socket as _socket

        with self._conn_lock:
            conns = list(self._conns)
            threads = list(self._conn_threads)
        for c in conns:
            try:
                c.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
        for t in threads:
            t.join(timeout=5)
        # stop the top-k microbatcher dispatchers (drains their queues
        # first, so no late in-flight query parks forever); handlers
        # without a close() — plain callables in tests — are fine as-is
        for h in self.topk_handlers.values():
            close = getattr(h, "close", None)
            if callable(close):
                try:
                    close()
                except Exception:
                    pass
        # the quiesce guarantee must be ENFORCED, not assumed: a handler
        # wedged in _dispatch (e.g. a long device-side TOPK) surviving the
        # join would race the caller's store teardown — make it loud
        wedged = [t.name for t in threads if t.is_alive()]
        # stop the push-delivery thread (after the handler quiesce: a
        # handler mid-SUBSCRIBE must not race the engine teardown)
        if self._push_engine is not None:
            try:
                self._push_engine.close()
            except Exception:
                pass
        if wedged:
            import logging

            logging.getLogger(__name__).error(
                "server stop(): %d handler thread(s) still alive after "
                "quiesce join: %s — backing state teardown may race a live "
                "request", len(wedged), wedged,
            )
