"""Geo-aware stateless edge proxy: one B2 front door for the shard fleets.

Own copy of ``flink_ms_tpu/serve/edge.py``: the same proxy, push hub,
client and CLI, with the reference's knobs, defaults and wire bytes in
both directions; it owns no device.  A proxy of either package fronts
workers of either package, and a client of either package talks to a
proxy of either package.  ``spawn_edge_procs`` starts
``python -m flink_ms_tpu_torch.serve.edge`` with this repo prepended to
the child's ``PYTHONPATH``, as ``sharded.spawn_worker_procs`` does.

The reference serves every query through a fat client library
(``QueryClientHelper.queryState``) that knows the registry and every
shard — the shape our ``HAShardedClient``/``ElasticClient`` still have.
That is fine for benches and wrong for millions of devices: a real
client should hold ONE cheap connection to a nearby stateless proxy and
know nothing about shards, generations, replicas or regions.  This
module is that proxy.  It speaks the frozen tab/B2 wire protocol on
both sides (``serve/proto.py``), so nothing in the data plane changes:

- **Connection multiplexing.**  Thousands of idle downstream client
  connections (tab or B2, negotiated per connection exactly like the
  server) funnel over a small pool of persistent upstream B2 pipelines
  per shard endpoint.  Requests queued for the same endpoint re-batch
  into dense frames (up to ``TPUMS_EDGE_BATCH`` records), so the
  worker's microbatcher/native reply path sees the 64-query frames it
  was built for even when every downstream client sends singles.
- **Consistent-hash routing with topology-generation following.**  The
  proxy routes ``owner_of(key, shards)`` (serve/sharded.py — the hash
  IS the location) against the registry topology record, re-resolving
  on the heartbeat cadence, on HEALTH ``topology_gen`` hints and on any
  upstream connection failure — the same discipline as
  ``ElasticClient``, so reshards and rollouts never error through the
  proxy.  Fan-out verbs (TOPK/TOPKV/COUNT, multi-owner MGET) run
  against one topology snapshot per attempt and retry whole-op.
- **Cross-request GET coalescing.**  Identical in-flight GETs collapse
  into one upstream request whose reply text fans out byte-identically
  to every waiter (``tpums_edge_coalesce_hits_total``).
- **Hedged requests.**  When a GET's primary replica has not answered
  within the shard's recent latency percentile
  (``TPUMS_EDGE_HEDGE_PCT``), the same idempotent read is issued to a
  different replica; first reply wins, the loser is drained and
  discarded (a pipelined B2 stream cannot un-send, so "cancellation"
  means the reply is consumed and never delivered twice).
- **Edge admission.**  ``serve/admission.py`` token buckets run HERE,
  before a single byte reaches a worker: an over-quota tenant gets the
  wire-frozen ``E\tover quota`` straight from the proxy.
- **Geo routing with the ``st=`` bound.**  A proxy started with
  ``--region`` serves reads from its region's follower fleet and fails
  over to the home fleet when replication lag
  (``georepl.staleness_of``) exceeds the client's bound.  The bound
  rides the existing staleness opt-in field: ``st=1`` is the frozen
  opt-in (proxy default bound applies), ``st=<seconds>`` — accepted by
  the PROXY only, never forwarded upstream — pins a per-request (tab)
  or per-connection (B2 HELLO) bound.

Knobs (all optional): ``TPUMS_EDGE_BATCH`` (64), ``TPUMS_EDGE_PIPES``
(2 upstream pipelines per endpoint), ``TPUMS_EDGE_HEDGE`` (1),
``TPUMS_EDGE_HEDGE_PCT`` (95), ``TPUMS_EDGE_HEDGE_MIN_MS`` (1.0),
``TPUMS_EDGE_HEDGE_WARMUP`` (64 samples), ``TPUMS_EDGE_COALESCE`` (1),
``TPUMS_EDGE_STALE_BOUND_S`` (unset = follow only per-request bounds),
``TPUMS_EDGE_COOLDOWN_S`` (0.5), ``TPUMS_EDGE_RETRIES`` (4).

CLI (one process per proxy; SIGTERM drains and exits)::

    python -m flink_ms_tpu_torch.serve.edge --group als \
        [--host H --port 0 --portFile P --replica 0 --region eu]

Proxies register under ``registry.edge_group(group)`` (one heartbeated
entry per proxy) so ``EdgeClient``, the scraper and the smoke/chaos
harnesses all discover them the same way; the METRICS verb answers with
the proxy's own registry snapshot (``tpums_edge_*`` series), which
``obs/scrape.py`` folds into ``fleet_signals``.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import admission as admission_mod
from . import georepl
from . import proto
from . import push as push_mod
from . import registry
from .client import QueryClient, RetryPolicy
from .elastic import generation_group
from .ha import resolve_shard_endpoints
from .sharded import owner_of
from ..obs import metrics as obs_metrics
from ..obs import profiler as obs_profiler
from ..obs import tracing as obs_tracing

__all__ = [
    "EdgeProxy", "EdgeClient", "spawn_edge_procs", "stop_edge_procs",
    "main",
]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_flag(name: str, default: bool = True) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip() not in ("", "0", "false", "no")


def _parse_hello_ext(parts: Sequence[str]) -> Optional[dict]:
    """``proto.parse_hello`` plus the proxy-only numeric staleness bound:
    ``st=<seconds>`` in a HELLO binds a per-connection bound (``st=1``
    stays the frozen opt-in with the proxy's default bound).  Returns the
    parse dict with an extra ``"bound"`` key, or None when malformed —
    exactly as strict as the server, so unknown extensions still answer
    ``E\tbad request``."""
    base = proto.parse_hello(parts)
    if base is not None:
        base["bound"] = None
        return base
    bound = None
    norm = list(parts)
    for i, ext in enumerate(norm[2:], start=2):
        if (ext.startswith(proto.STALE_FIELD) and ext != proto.STALE_EXT
                and bound is None):
            try:
                bound = float(ext[len(proto.STALE_FIELD):])
            except ValueError:
                return None
            norm[i] = proto.STALE_EXT
    if bound is None:
        return None
    base = proto.parse_hello(norm)
    if base is None:
        return None
    base["bound"] = max(bound, 0.0)
    return base


def _pop_stale_bound(parts: List[str]) -> Tuple[bool, Optional[float]]:
    """Tab-plane staleness opt-in pop, widened for the proxy: a trailing
    ``st=<float>`` field opts the read in; any value other than the
    frozen ``1`` is also the per-request staleness BOUND in seconds.
    -> (opted_in, bound_or_None)."""
    if len(parts) > 1 and parts[-1].startswith(proto.STALE_FIELD):
        raw = parts[-1][len(proto.STALE_FIELD):]
        try:
            v = float(raw)
        except ValueError:
            return False, None
        parts.pop()
        return True, (None if raw == "1" else max(v, 0.0))
    return False, None


async def _read_uvarint(reader: asyncio.StreamReader) -> int:
    n = 0
    shift = 0
    while True:
        b = (await reader.readexactly(1))[0]
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n
        shift += 7
        if shift > 70:
            raise proto.ProtoError("bad varint")


def _swallow(fut: "asyncio.Future") -> None:
    # abandoned hedge loser / cancelled leg: retrieve the outcome so the
    # loop never logs "exception was never retrieved"
    if not fut.cancelled():
        fut.exception()


class _LatencyWindow:
    """Small per-shard reservoir of recent GET round trips; the hedge
    trigger is a percentile of it.  Sorting is amortized (recomputed
    every 32 inserts), so the hot path pays one deque append."""

    __slots__ = ("_buf", "_sorted", "_dirty")

    def __init__(self, cap: int = 512):
        self._buf: collections.deque = collections.deque(maxlen=cap)
        self._sorted: list = []
        self._dirty = 0

    def add(self, v: float) -> None:
        self._buf.append(v)
        self._dirty += 1

    def __len__(self) -> int:
        return len(self._buf)

    def quantile(self, pct: float) -> Optional[float]:
        if self._dirty >= 32 or not self._sorted:
            self._sorted = sorted(self._buf)
            self._dirty = 0
        s = self._sorted
        if not s:
            return None
        return s[min(int(len(s) * pct / 100.0), len(s) - 1)]


class _UpstreamPipe:
    """One persistent B2 pipeline to one worker endpoint.

    Requests from any number of downstream connections queue here; the
    writer coroutine drains the queue into dense frames (up to ``batch``
    records) and the reader resolves reply futures strictly in order —
    the B2 contract is one reply record per request record, FIFO.  The
    upstream HELLO always negotiates ``tr=1`` (so downstream trace ids
    pass through to worker spans) and ``st=1`` (so every reply carries
    the worker's staleness, which the proxy strips and re-stamps only
    for downstream readers that opted in)."""

    def __init__(self, host: str, port: int, batch: int,
                 timeout_s: float = 5.0, push: bool = False):
        self.host = host
        self.port = port
        self._batch = max(1, batch)
        self._timeout_s = timeout_s
        self._push = push  # negotiate su=1: the hub's subscription pipes
        # push-plane hooks (only set on hub-owned pipes): unsolicited
        # PUSH texts route here instead of the reply window, and a
        # connection-class death notifies the hub so it can resubscribe
        self.on_push = None
        self.on_dead = None
        self._send_q: Optional[asyncio.Queue] = None
        self._inflight: collections.deque = collections.deque()
        self._r: Optional[asyncio.StreamReader] = None
        self._w: Optional[asyncio.StreamWriter] = None
        self._tasks: list = []
        self._alive = False
        self._ever_connected = False
        self._lock: Optional[asyncio.Lock] = None

    async def request(self, line: str, tid: Optional[str] = None
                      ) -> Tuple[str, float]:
        await self._ensure_connected()
        fut = asyncio.get_running_loop().create_future()
        self._send_q.put_nowait((line, tid or "", fut))
        return await fut

    async def _ensure_connected(self) -> None:
        if self._alive:
            return
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            if self._alive:
                return
            try:
                r, w = await asyncio.wait_for(
                    asyncio.open_connection(self.host, self.port,
                                            limit=proto.MAX_REPLY_BODY),
                    timeout=self._timeout_s)
            except (OSError, asyncio.TimeoutError) as e:
                raise ConnectionError(
                    f"edge upstream {self.host}:{self.port}: {e}") from e
            hello = (f"{proto.HELLO_LINE}\t{proto.TRACE_EXT}"
                     f"\t{proto.STALE_EXT}")
            if self._push:
                hello += f"\t{proto.PUSH_EXT}"
            hello += "\n"
            w.write(hello.encode("utf-8"))
            try:
                await w.drain()
                line = await asyncio.wait_for(r.readline(),
                                              timeout=self._timeout_s)
            except (OSError, asyncio.TimeoutError) as e:
                w.close()
                raise ConnectionError(
                    f"edge upstream HELLO {self.host}:{self.port}: {e}"
                ) from e
            if line.decode("utf-8", "replace").rstrip("\n") != \
                    proto.HELLO_REPLY:
                w.close()
                raise ConnectionError(
                    f"edge upstream {self.host}:{self.port} refused B2")
            self._r, self._w = r, w
            self._send_q = asyncio.Queue()
            self._inflight.clear()
            self._alive = True
            if self._ever_connected:
                obs_metrics.get_registry().counter(
                    "tpums_edge_upstream_reconnects_total").inc()
            self._ever_connected = True
            self._tasks = [
                asyncio.ensure_future(self._writer_loop()),
                asyncio.ensure_future(self._reader_loop()),
            ]

    async def _writer_loop(self) -> None:
        try:
            while True:
                item = await self._send_q.get()
                batch = [item]
                while len(batch) < self._batch:
                    try:
                        batch.append(self._send_q.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                for _, _, fut in batch:
                    self._inflight.append(fut)
                frame = proto.encode_request_frame(
                    [b[0] for b in batch], tids=[b[1] for b in batch])
                self._w.write(frame)
                await self._w.drain()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._die(e)

    async def _reader_loop(self) -> None:
        try:
            while True:
                magic = await self._r.readexactly(2)
                if magic != proto.MAGIC:
                    raise ConnectionError("bad upstream frame magic")
                body_len = await _read_uvarint(self._r)
                if body_len > proto.MAX_REPLY_BODY:
                    raise ConnectionError("oversized upstream frame")
                body = await self._r.readexactly(body_len)
                decoded = proto.decode_reply_frame(
                    proto.MAGIC + proto.encode_varint(body_len) + body)
                if decoded is None:
                    raise ConnectionError("truncated upstream frame")
                for text in decoded[0]:
                    if proto.is_push_text(text):
                        # unsolicited by design: a subscription delta.
                        # Never enters the reply window — the in-order
                        # request/reply pairing below stays intact.
                        cb = self.on_push
                        if cb is not None:
                            try:
                                cb(text)
                            except Exception:
                                pass
                        continue
                    if not self._inflight:
                        raise ConnectionError("unsolicited upstream reply")
                    fut = self._inflight.popleft()
                    head, sep, tail = text.rpartition("\t")
                    st = 0.0
                    if sep and tail.startswith(proto.STALE_FIELD):
                        try:
                            st = float(tail[len(proto.STALE_FIELD):])
                            text = head
                        except ValueError:
                            pass
                    if not fut.done():
                        fut.set_result((text, st))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._die(e)

    def _die(self, exc: Exception) -> None:
        """Connection-class failure: fail every in-flight and queued
        future with ConnectionError (the routing layer's retry signal)
        and reset so the next request reconnects lazily."""
        if not self._alive:
            return
        self._alive = False
        err = exc if isinstance(exc, ConnectionError) else ConnectionError(
            f"edge upstream {self.host}:{self.port}: {exc}")
        while self._inflight:
            fut = self._inflight.popleft()
            if not fut.done():
                fut.set_exception(err)
        if self._send_q is not None:
            while True:
                try:
                    _, _, fut = self._send_q.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if not fut.done():
                    fut.set_exception(err)
        for t in self._tasks:
            if not t.done():
                t.cancel()
        self._tasks = []
        if self._w is not None:
            try:
                self._w.close()
            except Exception:
                pass
            self._r = self._w = None
        cb = self.on_dead
        if cb is not None:
            try:
                cb(err)
            except Exception:
                pass

    async def close(self) -> None:
        self.on_dead = None  # intentional close is not a failure
        self._die(ConnectionError("edge proxy shutting down"))


class _Endpoint:
    """One worker replica as the proxy sees it: a small pool of
    persistent pipes, round-robined per request, plus a failure
    cooldown stamp the fleet's picker honors."""

    def __init__(self, host: str, port: int, n_pipes: int, batch: int):
        self.host = host
        self.port = port
        self.pipes = [_UpstreamPipe(host, port, batch)
                      for _ in range(max(1, n_pipes))]
        self._rr = 0
        self.down_until = 0.0

    async def request(self, line: str, tid: Optional[str] = None
                      ) -> Tuple[str, float]:
        self._rr = (self._rr + 1) % len(self.pipes)
        try:
            return await self.pipes[self._rr].request(line, tid)
        except (OSError, asyncio.IncompleteReadError) as e:
            raise ConnectionError(str(e)) from e

    async def close(self) -> None:
        for p in self.pipes:
            await p.close()


class _Fleet:
    """Topology-following endpoint set for ONE (possibly region-scoped)
    serving group.  Mirrors ``ElasticClient``'s refresh discipline:
    re-read the topology record on a cadence, immediately on a
    ``topology_gen`` hint newer than the resolved generation, and
    forced after any connection-class failure.  Endpoints (and their
    warm pipes) persist across refreshes keyed by (host, port), so a
    generation swap that keeps a replica does not drop its
    connections."""

    def __init__(self, group: str, *, pipes_per_endpoint: int, batch: int,
                 refresh_s: float, cooldown_s: float):
        self.group = group
        self.gen: Optional[int] = None
        self.shards = 0
        self._by_shard: Dict[int, List[_Endpoint]] = {}
        self._eps: Dict[Tuple[str, int], _Endpoint] = {}
        self._rr: Dict[int, int] = collections.defaultdict(int)
        self.lat: Dict[int, _LatencyWindow] = collections.defaultdict(
            _LatencyWindow)
        self._pipes_n = pipes_per_endpoint
        self._batch = batch
        self._refresh_s = refresh_s
        self._cooldown_s = cooldown_s
        self._last = 0.0
        self._hint: Optional[int] = None

    def note_gen(self, gen) -> None:
        try:
            gen = int(gen)
        except (TypeError, ValueError):
            return
        if self.gen is None or gen > self.gen:
            self._hint = gen

    def maybe_refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        hinted = self._hint is not None and (self.gen is None
                                             or self._hint > self.gen)
        if (not force and not hinted and self.gen is not None
                and now - self._last < self._refresh_s):
            return
        self._last = now
        rec = registry.resolve_topology(self.group)
        if rec is None:
            return
        try:
            gen = int(rec.get("gen", 0))
            shards = int(rec.get("shards", 0))
        except (TypeError, ValueError):
            return
        if shards <= 0:
            return
        ggroup = generation_group(self.group, gen)
        by_shard: Dict[int, List[_Endpoint]] = {}
        keep = set()
        for s in range(shards):
            eps: List[_Endpoint] = []
            try:
                endpoints = resolve_shard_endpoints(ggroup, s)
            except Exception:
                endpoints = []
            for host, port in endpoints:
                key = (host, int(port))
                ep = self._eps.get(key)
                if ep is None:
                    ep = self._eps[key] = _Endpoint(
                        host, int(port), self._pipes_n, self._batch)
                eps.append(ep)
                keep.add(key)
            if eps:
                by_shard[s] = eps
        if not by_shard:
            return
        self.gen, self.shards, self._by_shard = gen, shards, by_shard
        if self._hint is not None and self._hint <= gen:
            self._hint = None
        for key, ep in list(self._eps.items()):
            if key not in keep:
                del self._eps[key]
                asyncio.ensure_future(ep.close())

    def snapshot(self) -> Tuple[int, int, Dict[int, List[_Endpoint]]]:
        """A routing-consistent (generation, shards, endpoints) view:
        every leg of one fan-out must split keys and send against the
        SAME snapshot, or a concurrent reshard could silently misroute
        a leg."""
        self.maybe_refresh()
        if not self.shards:
            self.maybe_refresh(force=True)
        if not self.shards:
            raise ConnectionError(
                f"no serving topology for group {self.group!r}")
        return self.gen, self.shards, self._by_shard

    def pick(self, by_shard: Dict[int, List[_Endpoint]], shard: int,
             exclude: Optional[_Endpoint] = None) -> _Endpoint:
        eps = by_shard.get(shard) or []
        now = time.monotonic()
        pool = [e for e in eps if e.down_until <= now and e is not exclude]
        if not pool:
            pool = [e for e in eps if e is not exclude] or list(eps)
        if not pool:
            raise ConnectionError(
                f"no endpoints for shard {shard} of {self.group!r}")
        i = self._rr[shard]
        self._rr[shard] = i + 1
        return pool[i % len(pool)]

    def mark_down(self, ep: _Endpoint) -> None:
        ep.down_until = time.monotonic() + self._cooldown_s

    async def close(self) -> None:
        for ep in self._eps.values():
            await ep.close()
        self._eps.clear()
        self._by_shard.clear()


class _Conn:
    """Per-downstream-connection negotiated state (mirrors the server's
    handler loop: tenancy/tracing/staleness are connection properties on
    B2, per-request fields on tab)."""

    __slots__ = ("binary", "tenant", "trace", "stale", "bound", "push",
                 "put", "subs")

    def __init__(self):
        self.binary = False
        self.tenant: Optional[str] = None
        self.trace = False
        self.stale = False
        self.bound: Optional[float] = None
        self.push = False  # B2 su=1 opt-in (tab subscribes self-opt-in)
        self.put = None  # enqueue-bytes hook into this conn's writer queue
        self.subs: set = set()  # downstream sub_ids bound to this conn


class EdgeProxy:
    """The asyncio proxy core.  ``start()`` spins a dedicated event-loop
    thread (in-process embedding for tests/benches); the module CLI runs
    one proxy per process.  Stateless by construction: everything it
    knows it re-derives from the registry, so killing a proxy loses
    nothing but its sockets."""

    def __init__(
        self,
        group: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        replica: int = 0,
        region: Optional[str] = None,
        admission: Optional["admission_mod.AdmissionController"] = None,
        hedge: Optional[bool] = None,
        coalesce: Optional[bool] = None,
        batch: Optional[int] = None,
        pipes_per_endpoint: Optional[int] = None,
        hedge_pct: Optional[float] = None,
        hedge_min_ms: Optional[float] = None,
        hedge_warmup: Optional[int] = None,
        stale_bound_s: Optional[float] = None,
        refresh_s: Optional[float] = None,
        cooldown_s: Optional[float] = None,
        retries: Optional[int] = None,
        register: bool = True,
    ):
        self.group = group
        self.host = host
        self.port = port
        self.replica = int(replica)
        self.region = region if region is not None \
            else registry.default_region()
        self._qgroup = registry.qualify_group(group)
        self._admission = admission if admission is not None \
            else admission_mod.AdmissionController.from_env()
        self._hedge = _env_flag("TPUMS_EDGE_HEDGE", True) \
            if hedge is None else bool(hedge)
        self._coalesce = _env_flag("TPUMS_EDGE_COALESCE", True) \
            if coalesce is None else bool(coalesce)
        self._batch = _env_int("TPUMS_EDGE_BATCH", 64) \
            if batch is None else int(batch)
        self._pipes_n = _env_int("TPUMS_EDGE_PIPES", 2) \
            if pipes_per_endpoint is None else int(pipes_per_endpoint)
        self._hedge_pct = _env_float("TPUMS_EDGE_HEDGE_PCT", 95.0) \
            if hedge_pct is None else float(hedge_pct)
        self._hedge_min_ms = _env_float("TPUMS_EDGE_HEDGE_MIN_MS", 1.0) \
            if hedge_min_ms is None else float(hedge_min_ms)
        self._hedge_warmup = _env_int("TPUMS_EDGE_HEDGE_WARMUP", 64) \
            if hedge_warmup is None else int(hedge_warmup)
        self._stale_bound_s = _env_float("TPUMS_EDGE_STALE_BOUND_S", None) \
            if stale_bound_s is None else float(stale_bound_s)
        self._refresh_s = registry.heartbeat_interval_s() \
            if refresh_s is None else float(refresh_s)
        self._cooldown_s = _env_float("TPUMS_EDGE_COOLDOWN_S", 0.5) \
            if cooldown_s is None else float(cooldown_s)
        self._retries = _env_int("TPUMS_EDGE_RETRIES", 4) \
            if retries is None else int(retries)
        self._register = bool(register)
        self._edge_group = registry.edge_group(group, self.region)
        self._job_id = f"{self._edge_group}/proxy-{self.replica}"
        self._fleet: Optional[_Fleet] = None
        self._home_fleet: Optional[_Fleet] = None
        self._local_journal: Optional[str] = None
        self._topic: Optional[str] = None
        self._hub: Optional["_PushHub"] = None  # lazy: first SUBSCRIBE
        self._inflight_gets: Dict[tuple, "asyncio.Future"] = {}
        # leader's upstream tid per in-flight coalesce key, so waiters'
        # traces can link to the ONE upstream span answering them all
        self._inflight_tids: Dict[tuple, Optional[str]] = {}
        self._last_shed_event = 0.0
        self._server: Optional[asyncio.AbstractServer] = None
        self._bg: list = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "EdgeProxy":
        if self._thread is not None:
            return self
        # the proxy serves traffic, so it profiles like a worker
        # (TPUMS_PROF=0 kills it fleet-wide)
        obs_profiler.ensure_started()
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True,
            name=f"tpums-edge-{self.replica}")
        self._thread.start()
        try:
            asyncio.run_coroutine_threadsafe(
                self._astart(), self._loop).result(timeout=30)
        except Exception:
            self.stop()
            raise
        return self

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    def stop(self) -> None:
        if self._thread is None:
            return
        try:
            asyncio.run_coroutine_threadsafe(
                self._astop(), self._loop).result(timeout=10)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
        self._thread = None

    def __enter__(self) -> "EdgeProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _mk_fleet(self, group: str) -> _Fleet:
        return _Fleet(group, pipes_per_endpoint=self._pipes_n,
                      batch=self._batch, refresh_s=self._refresh_s,
                      cooldown_s=self._cooldown_s)

    async def _astart(self) -> None:
        # geo wiring: with a region and a published region topology the
        # proxy fronts its region's (follower) fleet and keeps a second
        # router at the home fleet for staleness-bound failover; without
        # either it fronts the plain group
        geo = georepl.resolve_region_topology(self.group) \
            if self.region else None
        if geo:
            home = (geo.get("geo") or {}).get("home")
            self._topic = geo.get("topic")
            local_group = registry.qualify_region(self._qgroup, self.region)
            self._fleet = self._mk_fleet(local_group)
            if home and home != self.region:
                self._home_fleet = self._mk_fleet(
                    registry.qualify_region(self._qgroup, home))
                self._local_journal = georepl.region_journal_dir(
                    self.group, self.region)
        else:
            self._fleet = self._mk_fleet(
                registry.qualify_region(self._qgroup, self.region)
                if self.region else self._qgroup)
        self._fleet.maybe_refresh(force=True)
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=1 << 20)
        self.port = self._server.sockets[0].getsockname()[1]
        if self._register:
            self._register_once()
            self._bg.append(asyncio.ensure_future(self._heartbeat_loop()))
        self._bg.append(asyncio.ensure_future(self._refresh_loop()))

    async def _astop(self) -> None:
        if self._hub is not None:
            try:
                await self._hub.close()
            except Exception:
                pass
            self._hub = None
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
            self._server = None
        for t in self._bg:
            t.cancel()
        self._bg = []
        for fleet in (self._fleet, self._home_fleet):
            if fleet is not None:
                await fleet.close()
        # retire lingering connection handlers/pipe loops so the loop
        # stops clean (no destroyed-pending-task noise at teardown)
        pending = [t for t in asyncio.all_tasks()
                   if t is not asyncio.current_task() and not t.done()]
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.wait(pending, timeout=2)
        if self._register:
            try:
                registry.unregister(self._job_id)
            except Exception:
                pass

    def _register_once(self) -> None:
        registry.register(
            self._job_id, self.host, self.port, "edge",
            replica_of=self._edge_group, replica=self.replica,
            ready=True, ttl_s=registry.replica_ttl_s())

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(registry.heartbeat_interval_s())
            try:
                self._register_once()
            except Exception:
                pass

    async def _refresh_loop(self) -> None:
        while True:
            await asyncio.sleep(self._refresh_s)
            for fleet in (self._fleet, self._home_fleet):
                if fleet is not None:
                    try:
                        fleet.maybe_refresh()
                    except Exception:
                        pass

    # -- downstream connection handling -----------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        gauge = obs_metrics.get_registry().gauge(
            "tpums_edge_open_connections")
        gauge.inc(1)
        conn = _Conn()
        q: asyncio.Queue = asyncio.Queue()
        wtask = asyncio.ensure_future(self._conn_writer(writer, q))
        tasks: set = set()
        loop = asyncio.get_running_loop()

        def track(coro) -> None:
            t = asyncio.ensure_future(coro)
            tasks.add(t)
            t.add_done_callback(tasks.discard)
            q.put_nowait(t)

        def put_now(data: bytes) -> None:
            fut = loop.create_future()
            fut.set_result(data)
            q.put_nowait(fut)

        conn.put = put_now
        try:
            while True:  # tab line phase
                try:
                    raw = await reader.readline()
                except (ValueError, ConnectionError, OSError):
                    return
                if not raw:
                    return
                if raw.endswith(b"\n"):
                    text = raw[:-1].decode("utf-8", "replace")
                    at_eof = False
                else:
                    # trailing request without a newline is still answered
                    # (readline()-at-EOF parity with the server)
                    text = raw.decode("utf-8", "replace")
                    at_eof = True
                parts = text.split("\t")
                if parts[0] == proto.HELLO_VERB and len(parts) >= 2:
                    ext = _parse_hello_ext(parts)
                    if ext is not None and ext["proto"] == "B2":
                        conn.binary = True
                        conn.tenant = ext["tenant"] or None
                        conn.trace = ext["trace"]
                        conn.stale = ext["stale"]
                        conn.bound = ext.get("bound")
                        conn.push = ext.get("push", False)
                        put_now((proto.HELLO_REPLY + "\n").encode("utf-8"))
                        break
                    if ext is not None:
                        put_now(f"E\tunsupported proto: {parts[1]}\n"
                                .encode("utf-8"))
                        if at_eof:
                            return
                        continue
                    # malformed extension: the generic refusal, exactly
                    # like an old server
                    put_now(b"E\tbad request\n")
                    if at_eof:
                        return
                    continue
                track(self._serve_line(parts, conn))
                if at_eof:
                    return
            while True:  # B2 frame phase
                records = await self._read_request_frame(reader, conn.trace)
                if records is None:
                    return
                track(self._serve_frame(records, conn))
        except proto.ProtoError as e:
            put_now(proto.error_frame(str(e)) if conn.binary
                    else f"E\tbad frame: {e}\n".encode("utf-8"))
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            return
        finally:
            if conn.subs and self._hub is not None:
                self._hub.drop_conn(conn)
            try:
                q.put_nowait(None)
                await wtask
            except Exception:
                # e.g. the loop is already closing under proxy.stop()
                wtask.cancel()
            for t in list(tasks):
                t.cancel()
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass
            gauge.inc(-1)

    async def _conn_writer(self, writer: asyncio.StreamWriter,
                           q: asyncio.Queue) -> None:
        """FIFO reply writer: requests are served concurrently, replies
        go out strictly in arrival order (the wire contract on both
        planes).  A broken downstream socket flips to drain mode so the
        in-flight futures are still consumed."""
        broken = False
        while True:
            fut = await q.get()
            if fut is None:
                return
            try:
                data = await fut
            except (asyncio.CancelledError, Exception):
                continue
            if broken:
                continue
            try:
                writer.write(data)
                await writer.drain()
            except (ConnectionError, OSError):
                broken = True

    async def _read_request_frame(self, reader: asyncio.StreamReader,
                                  trace: bool) -> Optional[list]:
        try:
            magic = await reader.readexactly(2)
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None  # clean EOF between frames
            raise proto.ProtoError("truncated frame")
        if magic != proto.MAGIC:
            raise proto.ProtoError("bad magic")
        body_len = await _read_uvarint(reader)
        if body_len > proto.MAX_REQUEST_BODY:
            raise proto.ProtoError("frame too large")
        body = await reader.readexactly(body_len)
        decoded = proto.decode_request_frame(
            proto.MAGIC + proto.encode_varint(body_len) + body, trace=trace)
        if decoded is None:
            raise proto.ProtoError("truncated frame")
        return decoded[0]

    async def _serve_line(self, parts: List[str], conn: _Conn) -> bytes:
        reply = await self._serve_parts(parts, conn)
        return (reply + "\n").encode("utf-8")

    async def _serve_frame(self, records: List[List[str]],
                           conn: _Conn) -> bytes:
        texts = await asyncio.gather(
            *[self._serve_parts(r, conn) for r in records])
        return proto.encode_reply_frame(list(texts))

    # -- request dispatch --------------------------------------------------

    async def _serve_parts(self, parts: List[str], conn: _Conn) -> str:
        t0 = time.perf_counter()
        tid = obs_tracing.pop_tid(parts)
        # Edge proxy span: a traced request gets ONE ``edge_proxy`` span
        # parented under the client's rpc span, and every upstream leg
        # carries ``trace_id/proxy_sid`` — so worker ``server_reply``
        # spans parent under the PROXY span, not directly under the
        # client, and the trace tree shows the extra hop instead of
        # silently eliding the tier that routed/coalesced/hedged it.
        # The downstream echo keeps the RAW incoming tid (the client's
        # exact-suffix unstamp depends on it); untraced traffic carries
        # no extra field in either direction — byte-identical, test-pinned.
        up_tid = None
        trace_id = psid = proxy_sid = None
        if tid is not None:
            trace_id, psid = obs_tracing.split_tid(tid)
            proxy_sid = obs_tracing.new_span_id()
            up_tid = obs_tracing.wire_tid(trace_id, proxy_sid)
        if conn.binary:
            tenant = conn.tenant
            stale, bound = conn.stale, conn.bound
        else:
            tenant = admission_mod.pop_tenant(parts)
            stale, bound = _pop_stale_bound(parts)
        verb = parts[0] if parts else ""
        reg = obs_metrics.get_registry()
        reg.counter("tpums_edge_requests_total", verb=verb or "?").inc()
        st_val = 0.0
        try:
            reply, st_val = await self._dispatch(
                verb, parts, tenant, bound, up_tid, conn)
        except asyncio.CancelledError:
            raise
        except (ConnectionError, OSError) as e:
            reg.counter("tpums_edge_errors_total", verb=verb or "?").inc()
            reply = f"E\tupstream unavailable: {e}"
        except Exception as e:
            reg.counter("tpums_edge_errors_total", verb=verb or "?").inc()
            reply = f"E\tproxy error: {e}"
        dt = time.perf_counter() - t0
        reg.histogram("tpums_edge_latency_seconds",
                      verb=verb or "?").observe(dt)
        if tid is not None:
            obs_tracing.event("edge_proxy", tid=trace_id, sid=proxy_sid,
                              psid=psid, t0=time.time() - dt,
                              dur_s=round(dt, 9), verb=verb or "?",
                              proxy=self._job_id,
                              ok=not reply.startswith("E"))
        if stale:
            # staleness rides BEFORE the tid echo, mirroring the server
            reply = f"{reply}\t{proto.STALE_FIELD}{st_val:.3f}"
        if tid is not None and not conn.binary:
            reply = f"{reply}\t{obs_tracing.TID_FIELD}{tid}"
        return reply

    async def _dispatch(self, verb: str, parts: List[str],
                        tenant: Optional[str], bound: Optional[float],
                        tid: Optional[str],
                        conn: Optional[_Conn] = None) -> Tuple[str, float]:
        if verb == "PING" and len(parts) == 1:
            return f"PONG\t{self._job_id}\t", 0.0
        if verb == "METRICS" and len(parts) == 1:
            return self._metrics_reply(), 0.0
        if verb == "PROFILE" and len(parts) == 1:
            return self._profile_reply(), 0.0
        if verb == proto.HELLO_VERB:
            return "E\tbad request", 0.0
        expect = proto.FIELD_COUNTS.get(verb)
        if expect is None or len(parts) != expect + 1:
            return "E\tbad request", 0.0
        adm = self._admission
        if adm is not None and not adm.admit(tenant, verb):
            # shed at the edge: not one byte of this request reaches a
            # worker, and the reply is the wire-frozen admission refusal
            name = tenant or admission_mod.DEFAULT_TENANT
            obs_metrics.get_registry().counter(
                "tpums_edge_shed_total", tenant=name).inc()
            now = time.monotonic()
            if now - self._last_shed_event > 1.0:  # ring-flood throttle
                self._last_shed_event = now
                obs_tracing.event("edge_shed", tenant=name, verb=verb,
                                  proxy=self._job_id)
            return admission_mod.SHED_REPLY, 0.0
        if verb in ("SUBSCRIBE", "RESUME", "UNSUB"):
            return await self._push_verb(verb, parts, conn)
        fleet = self._route_fleet(bound)
        if verb == "GET":
            return await self._get(fleet, parts[1], parts[2], tid)
        if verb == "MGET":
            return await self._mget(fleet, parts[1], parts[2], tid)
        if verb == "TOPK":
            return await self._topk(fleet, parts[1], parts[2], parts[3],
                                    tid)
        if verb == "TOPKV":
            return await self._fan_topkv(fleet, parts[1], parts[2],
                                         parts[3], tid)
        if verb == "DOT":
            # range-partitioned rows shard by their range key, so the
            # range id routes exactly like a GET key
            return await self._keyed(fleet, parts[2], "\t".join(parts),
                                     tid, hedge=False)
        if verb == "COUNT":
            return await self._count(fleet, parts[1], tid)
        if verb == "HEALTH":
            return await self._health(fleet, parts[1], tid)
        return "E\tbad request", 0.0

    def _route_fleet(self, bound: Optional[float]) -> _Fleet:
        """Geo choice: the region's own fleet while its replication lag
        is within the effective staleness bound, the home fleet once it
        is not.  Single-region proxies always answer locally."""
        if self._home_fleet is None:
            return self._fleet
        b = bound if bound is not None else self._stale_bound_s
        if b is None or self._local_journal is None or self._topic is None:
            return self._fleet
        st = georepl.staleness_of(self._local_journal, self._topic)
        if st is not None and st > b:
            obs_metrics.get_registry().counter(
                "tpums_edge_geo_failovers_total").inc()
            return self._home_fleet
        return self._fleet

    # -- verb implementations ----------------------------------------------

    async def _get(self, fleet: _Fleet, state: str, key: str,
                   tid: Optional[str]) -> Tuple[str, float]:
        line = f"GET\t{state}\t{key}"
        if not self._coalesce:
            return await self._keyed(fleet, key, line, tid, hedge=True)
        ck = (fleet.group, state, key)
        fut = self._inflight_gets.get(ck)
        if fut is not None:
            obs_metrics.get_registry().counter(
                "tpums_edge_coalesce_hits_total").inc()
            if tid is not None:
                # the waiter's trace sent NO upstream bytes — link it to
                # the leader's one in-flight upstream span so the trace
                # still explains where its answer came from instead of
                # showing a request that apparently answered itself
                w_trace, w_psid = obs_tracing.split_tid(tid)
                obs_tracing.event(
                    "edge_coalesce_link", tid=w_trace,
                    sid=obs_tracing.new_span_id(), psid=w_psid,
                    upstream=self._inflight_tids.get(ck),
                    state=state, key=key)
            # shield: one downstream waiter hanging up must not cancel
            # the shared upstream fetch under everyone else
            return await asyncio.shield(fut)
        fut = asyncio.ensure_future(
            self._keyed(fleet, key, line, tid, hedge=True))
        self._inflight_gets[ck] = fut
        self._inflight_tids[ck] = tid
        fut.add_done_callback(lambda f, ck=ck: self._uncoalesce(ck, f))
        return await asyncio.shield(fut)

    def _uncoalesce(self, ck: tuple, fut) -> None:
        if self._inflight_gets.get(ck) is fut:
            del self._inflight_gets[ck]
            self._inflight_tids.pop(ck, None)
        _swallow(fut)

    async def _keyed(self, fleet: _Fleet, key: str, line: str,
                     tid: Optional[str], hedge: bool) -> Tuple[str, float]:
        """Single-owner request with whole-op retry: every attempt
        re-snapshots the topology (the owner moves on a reshard) and a
        connection-class failure forces a refresh before the next try —
        this is what keeps cutovers error-free through the proxy."""
        last: Optional[Exception] = None
        for attempt in range(self._retries):
            _, shards, by_shard = fleet.snapshot()
            shard = owner_of(key, shards)
            try:
                return await self._send_hedged(fleet, by_shard, shard,
                                               line, tid, hedge=hedge)
            except (ConnectionError, OSError) as e:
                last = e
                fleet.maybe_refresh(force=True)
                await asyncio.sleep(min(0.02 * (attempt + 1), 0.2))
        raise last if last is not None else ConnectionError("route failed")

    def _hedge_delay(self, fleet: _Fleet, shard: int) -> Optional[float]:
        if not self._hedge:
            return None
        lw = fleet.lat[shard]
        if len(lw) < self._hedge_warmup:
            return None
        q = lw.quantile(self._hedge_pct)
        if q is None:
            return None
        return max(q, self._hedge_min_ms / 1000.0)

    async def _send_hedged(self, fleet: _Fleet, by_shard: dict, shard: int,
                           line: str, tid: Optional[str],
                           hedge: bool = True) -> Tuple[str, float]:
        ep = fleet.pick(by_shard, shard)
        t0 = time.perf_counter()
        primary = asyncio.ensure_future(ep.request(line, tid))
        delay = self._hedge_delay(fleet, shard) if hedge else None
        if delay is not None:
            done, _ = await asyncio.wait({primary}, timeout=delay)
            if not done:
                try:
                    alt = fleet.pick(by_shard, shard, exclude=ep)
                except ConnectionError:
                    alt = None
                if alt is not None and alt is not ep:
                    reg = obs_metrics.get_registry()
                    reg.counter("tpums_edge_hedges_total",
                                result="fired").inc()
                    obs_tracing.event(
                        "edge_hedge", shard=shard, host=ep.host,
                        port=ep.port, alt_port=alt.port,
                        delay_s=round(delay, 6))
                    hedged = asyncio.ensure_future(alt.request(line, tid))
                    res, hedged_won = await self._first_win(
                        fleet, ep, alt, primary, hedged)
                    dt = time.perf_counter() - t0
                    fleet.lat[shard].add(dt)
                    if tid is not None:
                        self._hedge_leg_spans(tid, shard, dt, hedged_won,
                                              ep, alt)
                    return res
        try:
            res = await primary
        except (ConnectionError, OSError):
            fleet.mark_down(ep)
            raise
        fleet.lat[shard].add(time.perf_counter() - t0)
        return res

    def _hedge_leg_spans(self, tid: str, shard: int, dur_s: float,
                         hedged_won: bool, ep: _Endpoint,
                         alt: _Endpoint) -> None:
        """One span per hedge leg, parented under the PROXY span (the
        upstream tid carries its sid), marked won/lost — a hedged trace
        shows BOTH upstream attempts and which one answered, instead of
        one mystery leg whose latency matches neither worker."""
        trace_id, psid = obs_tracing.split_tid(tid)
        t0_wall = time.time() - dur_s
        for leg, port, won in (("primary", ep.port, not hedged_won),
                               ("backup", alt.port, hedged_won)):
            obs_tracing.event(
                "edge_hedge_leg", tid=trace_id,
                sid=obs_tracing.new_span_id(), psid=psid,
                t0=t0_wall, dur_s=round(dur_s, 9), leg=leg,
                shard=shard, port=port,
                result="won" if won else "lost")

    async def _first_win(self, fleet: _Fleet, ep: _Endpoint,
                         alt: _Endpoint, primary, hedged
                         ) -> Tuple[Tuple[str, float], bool]:
        """First successful reply wins; the loser's reply (the pipeline
        cannot un-send it) is drained and discarded, never delivered —
        the no-double-delivery contract.  Returns the winning reply plus
        whether the BACKUP leg won (the caller records per-leg spans)."""
        pending = {primary, hedged}
        winner = None
        first_exc: Optional[Exception] = None
        while pending and winner is None:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED)
            for f in done:
                if f.exception() is None:
                    if winner is None:
                        winner = f
                else:
                    if first_exc is None:
                        first_exc = f.exception()
                    fleet.mark_down(ep if f is primary else alt)
        if winner is None:
            raise first_exc if first_exc is not None \
                else ConnectionError("hedge failed")
        if winner is hedged:
            obs_metrics.get_registry().counter(
                "tpums_edge_hedges_total", result="won").inc()
        for f in (primary, hedged):
            if f is not winner:
                if f.done():
                    _swallow(f)
                else:
                    f.add_done_callback(_swallow)
        return winner.result(), winner is hedged

    async def _mget(self, fleet: _Fleet, state: str, keys_csv: str,
                    tid: Optional[str]) -> Tuple[str, float]:
        keys = keys_csv.split(",")
        last: Optional[Exception] = None
        for attempt in range(self._retries):
            _, shards, by_shard = fleet.snapshot()
            by_owner: Dict[int, List[int]] = {}
            for i, k in enumerate(keys):
                by_owner.setdefault(owner_of(k, shards), []).append(i)
            owners = sorted(by_owner)
            legs = [asyncio.ensure_future(self._send_hedged(
                fleet, by_shard, w,
                "MGET\t%s\t%s" % (state,
                                  ",".join(keys[p] for p in by_owner[w])),
                tid, hedge=True)) for w in owners]
            results = await asyncio.gather(*legs, return_exceptions=True)
            conn_exc = next(
                (r for r in results
                 if isinstance(r, (ConnectionError, OSError))), None)
            if conn_exc is not None:
                last = conn_exc
                fleet.maybe_refresh(force=True)
                await asyncio.sleep(min(0.02 * (attempt + 1), 0.2))
                continue
            for r in results:
                if isinstance(r, BaseException):
                    raise r
            out: List[Optional[str]] = [None] * len(keys)
            st = 0.0
            for w, (text, leg_st) in zip(owners, results):
                st = max(st, leg_st)
                if not text.startswith("M\t"):
                    return text, st  # propagate the worker's error reply
                items = text[2:].split("\t")
                pos = by_owner[w]
                if len(items) != len(pos):
                    return ("E\tproxy error: mget leg returned "
                            f"{len(items)} items for {len(pos)} keys"), st
                for p, it in zip(pos, items):
                    out[p] = it
            return "M\t" + "\t".join(out), st
        raise last if last is not None else ConnectionError("route failed")

    async def _topk(self, fleet: _Fleet, state: str, uid: str, k_s: str,
                    tid: Optional[str]) -> Tuple[str, float]:
        # the sharded contract (serve/sharded.py): resolve the user's
        # factor row from its owner, then score every shard's catalog
        # slice with it and merge — the proxy does the fan-out so thin
        # clients get cross-shard TOPK from a plain QueryClient
        text, st = await self._get(fleet, state, f"{uid}-U", tid)
        if text == "N":
            return "N", st
        if not text.startswith("V\t"):
            return text, st
        reply, st2 = await self._fan_topkv(fleet, state, k_s, text[2:], tid)
        return reply, max(st, st2)

    async def _fan_topkv(self, fleet: _Fleet, state: str, k_s: str,
                         payload: str, tid: Optional[str]
                         ) -> Tuple[str, float]:
        try:
            k = int(k_s)
        except ValueError:
            return "E\tbad request", 0.0
        line = f"TOPKV\t{state}\t{k_s}\t{payload}"
        last: Optional[Exception] = None
        for attempt in range(self._retries):
            _, shards, by_shard = fleet.snapshot()
            legs = [asyncio.ensure_future(self._send_hedged(
                fleet, by_shard, s, line, tid, hedge=True))
                for s in range(shards)]
            results = await asyncio.gather(*legs, return_exceptions=True)
            conn_exc = next(
                (r for r in results
                 if isinstance(r, (ConnectionError, OSError))), None)
            if conn_exc is not None:
                last = conn_exc
                fleet.maybe_refresh(force=True)
                await asyncio.sleep(min(0.02 * (attempt + 1), 0.2))
                continue
            for r in results:
                if isinstance(r, BaseException):
                    raise r
            merged: List[Tuple[str, float]] = []
            st = 0.0
            for text, leg_st in results:
                st = max(st, leg_st)
                if text == "N":
                    continue
                if not text.startswith("V\t"):
                    return text, st
                for tok in text[2:].split(";"):
                    if not tok:
                        continue
                    item, _, score = tok.rpartition(":")
                    try:
                        merged.append((item, float(score)))
                    except ValueError:
                        return f"E\tproxy error: bad topk token {tok!r}", st
            merged.sort(key=lambda it: -it[1])
            return ("V\t" + ";".join(f"{i}:{s!r}" for i, s in merged[:k]),
                    st)
        raise last if last is not None else ConnectionError("route failed")

    async def _count(self, fleet: _Fleet, state: str,
                     tid: Optional[str]) -> Tuple[str, float]:
        line = f"COUNT\t{state}"
        last: Optional[Exception] = None
        for attempt in range(self._retries):
            _, shards, by_shard = fleet.snapshot()
            legs = [asyncio.ensure_future(self._send_hedged(
                fleet, by_shard, s, line, tid, hedge=False))
                for s in range(shards)]
            results = await asyncio.gather(*legs, return_exceptions=True)
            conn_exc = next(
                (r for r in results
                 if isinstance(r, (ConnectionError, OSError))), None)
            if conn_exc is not None:
                last = conn_exc
                fleet.maybe_refresh(force=True)
                await asyncio.sleep(min(0.02 * (attempt + 1), 0.2))
                continue
            total = 0
            st = 0.0
            for r in results:
                if isinstance(r, BaseException):
                    raise r
                text, leg_st = r
                st = max(st, leg_st)
                if not text.startswith("C\t"):
                    return text, st
                total += int(text[2:])
            return f"C\t{total}", st
        raise last if last is not None else ConnectionError("route failed")

    async def _health(self, fleet: _Fleet, state: str,
                      tid: Optional[str]) -> Tuple[str, float]:
        text, st = await self._keyed(fleet, "", f"HEALTH\t{state}", tid,
                                     hedge=False)
        if text.startswith("H\t"):
            try:
                fleet.note_gen(json.loads(text[2:]).get("topology_gen"))
            except (ValueError, AttributeError):
                pass
        return text, st

    async def _push_verb(self, verb: str, parts: List[str],
                         conn: Optional[_Conn]) -> Tuple[str, float]:
        """Push-plane verbs at the proxy: downstream subscriptions are
        PROXY-owned (ids, seqs and replay rings minted here from the
        proxy's own registry epoch), backed by ONE upstream subscription
        per distinct (state, kind, arg, k) query class — the fan-out
        that lets a thousand devices ride a single worker delta stream.
        Same opt-in discipline as the server: B2 needs ``su=1`` in the
        HELLO, tab subscribes self-opt-in."""
        if conn is None or conn.put is None:
            return "E\tbad request", 0.0
        if conn.binary and not conn.push:
            return "E\tbad request", 0.0
        hub = self._push_hub()
        if verb == "UNSUB":
            if hub.unsubscribe(parts[1], conn):
                return f"U\t{parts[1]}", 0.0
            return f"E\tunknown subscription: {parts[1]}", 0.0
        state, kind, arg, k_s = parts[1:5]
        try:
            k = int(k_s)
        except ValueError:
            return "E\tbad request", 0.0
        if verb == "SUBSCRIBE":
            return await hub.subscribe(conn, state, kind, arg, k), 0.0
        return await hub.resume(conn, state, kind, arg, k, parts[5]), 0.0

    def _push_hub(self) -> "_PushHub":
        # single-threaded on the proxy loop: no lock needed
        if self._hub is None:
            self._hub = _PushHub(self)
        return self._hub

    def _metrics_reply(self) -> str:
        try:
            snap = obs_metrics.synthesize_requests(
                obs_metrics.get_registry().snapshot(
                    meta={"job_id": self._job_id, "port": self.port,
                          "plane": "edge"}))
            return "J\t" + obs_metrics.snapshot_to_json_line(snap)
        except Exception as e:
            return f"E\tmetrics failed: {e}"

    def _profile_reply(self) -> str:
        """PROFILE at the proxy: the edge's own event-loop samples, so a
        fleet flamegraph shows proxy CPU next to worker CPU."""
        try:
            return obs_profiler.profile_reply_line(
                meta={"job_id": self._job_id, "port": self.port,
                      "plane": "edge"})
        except Exception as e:
            return f"E\tprofile failed: {e}"


def _fold_str(shortlist: Dict[str, str], payload: str) -> None:
    """Fold a TOPK delta payload into a shortlist dict keeping scores as
    the STRINGS the worker formatted — the hub re-emits them verbatim,
    so downstream bytes never drift through a float round-trip."""
    for entry in payload.split(";"):
        if not entry:
            continue
        if entry.startswith("-"):
            shortlist.pop(entry[1:], None)
        elif entry.startswith("+"):
            item, _, score = entry[1:].rpartition(":")
            shortlist[item] = score


def _parse_shortlist(snapshot: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for tok in snapshot.split(";"):
        if tok:
            item, _, score = tok.rpartition(":")
            out[item] = score
    return out


def _diff_topk(old: Dict[str, str], new: Dict[str, str]) -> str:
    """Delta payload transforming shortlist ``old`` into ``new`` —
    the same ``+item:score`` / ``-item`` grammar the workers emit."""
    ups = [f"+{i}:{s}" for i, s in new.items() if old.get(i) != s]
    downs = [f"-{i}" for i in old if i not in new]
    return ";".join(ups + downs)


class _ShardSub:
    """One upstream subscription leg: a dedicated su=1 pipe to one
    worker, the worker-minted sub id/seq, and the per-shard shortlist
    (TOPK) or value (KEY) it materializes."""

    __slots__ = ("pipe", "sub_id", "seq", "shortlist", "value")

    def __init__(self, pipe: _UpstreamPipe):
        self.pipe = pipe
        self.sub_id = ""
        self.seq = 0
        self.shortlist: Dict[str, str] = {}
        self.value = ""


class _SpecEntry:
    """One distinct subscribed query class: the upstream legs (one per
    shard for TOPK, the owner shard for KEY), the merged downstream-
    visible state, and every downstream subscription fanned out from
    it."""

    __slots__ = ("spec", "shards", "downs", "merged", "value", "init",
                 "resync_task", "closed")

    def __init__(self, spec: tuple):
        self.spec = spec  # (state, kind, arg, k)
        self.shards: Dict[int, _ShardSub] = {}
        self.downs: Dict[str, "_DownSub"] = {}
        self.merged: Dict[str, str] = {}  # TOPK: item -> score string
        self.value = ""  # KEY: last pushed value
        self.init: Optional["asyncio.Future"] = None
        self.resync_task: Optional["asyncio.Future"] = None
        self.closed = False


class _DownSub:
    """One downstream subscription: proxy-minted id, its own seq space
    and bounded replay ring, bound to (at most) one downstream
    connection.  Unbinding (the conn died) keeps the ring growing so a
    RESUME from the reconnected client replays exactly the missed
    window."""

    __slots__ = ("sub_id", "spec", "seq", "ring", "conn", "send")

    def __init__(self, sub_id: str, spec: tuple):
        self.sub_id = sub_id
        self.spec = spec
        self.seq = 0
        self.ring: collections.deque = collections.deque()
        self.conn: Optional[_Conn] = None
        self.send = None

    def bind(self, conn: _Conn) -> None:
        self.conn = conn
        if conn.binary:
            self.send = lambda text, p=conn.put: p(
                proto.encode_reply_frame([text]))
        else:
            self.send = lambda text, p=conn.put: p(
                (text + "\n").encode("utf-8"))

    def unbind(self) -> None:
        self.conn = None
        self.send = None


class _PushHub:
    """The proxy's push fan-out plane.

    Dedup is the point: N downstream subscriptions to the same
    (state, kind, arg, k) share ONE spec entry, whose upstream legs are
    the only subscriptions the workers ever see — a worker delta costs
    one upstream frame and fans out to every downstream client.  The
    proxy claims its own push epoch (``registry.next_push_epoch`` on the
    edge group), so downstream ids never collide with worker-minted ids
    and a restarted proxy can never accidentally resurrect a dead
    sub id.

    Failure story (the zero-miss / zero-dup contract): an upstream pipe
    death or sequence gap triggers a RESYNC — fresh upstream SUBSCRIBEs
    against the CURRENT topology, then a diff of the rebuilt merged
    state against the last state pushed downstream, emitted as one
    ordinary delta.  Downstream clients see a contiguous seq stream
    through worker kills, reshards (the resubscribe follows the new
    generation) and region failover; they never see the turbulence.
    All state is soft: a killed PROXY loses its rings, and a client's
    RESUME at a survivor answers with a fresh-id snapshot — the
    documented no-bridge fallback, still zero-miss."""

    def __init__(self, proxy: "EdgeProxy"):
        self._proxy = proxy
        self._epoch: Optional[int] = None
        self._n = 0
        self._ring_cap = push_mod.ring_capacity()
        self._specs: Dict[tuple, _SpecEntry] = {}
        self._downs: Dict[str, Tuple[_SpecEntry, _DownSub]] = {}

    # -- downstream verbs --------------------------------------------------

    async def subscribe(self, conn: _Conn, state: str, kind: str,
                        arg: str, k: int) -> str:
        if kind not in (push_mod.KIND_KEY, push_mod.KIND_TOPK):
            return "E\tbad request"
        spec = (state, kind, arg, k)
        try:
            entry = await self._entry(spec)
        except Exception as e:
            return f"E\tsubscribe failed: {e}"
        ds = _DownSub(self._next_sub_id(), spec)
        ds.bind(conn)
        entry.downs[ds.sub_id] = ds
        self._downs[ds.sub_id] = (entry, ds)
        conn.subs.add(ds.sub_id)
        reg = obs_metrics.get_registry()
        reg.gauge("tpums_push_subs_active", state=state, kind=kind).inc(1)
        self._update_fanout()
        return f"S\t{ds.sub_id}\t0\t{self._snapshot_of(entry)}"

    async def resume(self, conn: _Conn, state: str, kind: str, arg: str,
                     k: int, cursor: str) -> str:
        sub_id, _, seq_s = cursor.rpartition(":")
        try:
            cur = int(seq_s)
        except ValueError:
            return "E\tbad request"
        got = self._downs.get(sub_id)
        reg = obs_metrics.get_registry()
        if got is not None:
            entry, ds = got
            ring_lo = ds.ring[0][0] if ds.ring else ds.seq + 1
            if (ds.spec == (state, kind, arg, k) and cur <= ds.seq
                    and cur >= ring_lo - 1):
                if ds.conn is not None and ds.conn is not conn:
                    ds.conn.subs.discard(sub_id)
                ds.bind(conn)
                conn.subs.add(sub_id)
                reg.counter("tpums_push_resume_total",
                            result="replay").inc()
                # the R ack is already queued ahead of these in the
                # conn's FIFO writer, so replays cannot overtake it
                for s, payload in list(ds.ring):
                    if s > cur:
                        ds.send(push_mod.format_push(ds.sub_id, s,
                                                     payload))
                return f"R\t{ds.sub_id}\t{cur}"
        reg.counter("tpums_push_resume_total", result="snapshot").inc()
        return await self.subscribe(conn, state, kind, arg, k)

    def unsubscribe(self, sub_id: str, conn: Optional[_Conn]) -> bool:
        got = self._downs.pop(sub_id, None)
        if got is None:
            return False
        entry, ds = got
        entry.downs.pop(sub_id, None)
        if ds.conn is not None:
            ds.conn.subs.discard(sub_id)
        obs_metrics.get_registry().gauge(
            "tpums_push_subs_active", state=ds.spec[0],
            kind=ds.spec[1]).inc(-1)
        if not entry.downs:
            self._teardown(entry)
        self._update_fanout()
        return True

    def drop_conn(self, conn: _Conn) -> None:
        """Downstream connection died: unbind its subs but KEEP their
        rings accumulating, so a reconnect + RESUME replays the gap."""
        for sub_id in list(conn.subs):
            got = self._downs.get(sub_id)
            if got is not None:
                got[1].unbind()
        conn.subs.clear()

    # -- upstream plumbing -------------------------------------------------

    def _next_sub_id(self) -> str:
        if self._epoch is None:
            try:
                self._epoch = registry.next_push_epoch(
                    self._proxy._edge_group)
            except Exception:
                self._epoch = (int(time.time()) % 1000000) * 100 \
                    + os.getpid() % 100
        self._n += 1
        return f"e{self._epoch}-{self._n}"

    async def _entry(self, spec: tuple) -> _SpecEntry:
        entry = self._specs.get(spec)
        if entry is not None:
            if entry.init is not None and not entry.init.done():
                await asyncio.shield(entry.init)
            return entry
        entry = _SpecEntry(spec)
        entry.init = asyncio.get_running_loop().create_future()
        self._specs[spec] = entry
        try:
            await self._establish(entry)
        except Exception as e:
            self._specs.pop(spec, None)
            entry.init.set_exception(e)
            _swallow(entry.init)
            raise
        if spec[1] == push_mod.KIND_KEY:
            sh = next(iter(entry.shards.values()))
            entry.value = sh.value
        else:
            entry.merged = self._merged_topk(entry)
        entry.init.set_result(True)
        return entry

    async def _establish(self, entry: _SpecEntry) -> None:
        """Fresh upstream SUBSCRIBEs for every leg of ``entry`` against
        the current topology, with the same whole-op retry discipline as
        the query path (refresh on connection-class failure)."""
        state, kind, arg, k = entry.spec
        fleet = self._proxy._fleet
        last: Optional[Exception] = None
        for attempt in range(self._proxy._retries):
            _, shards, by_shard = fleet.snapshot()
            targets = [owner_of(arg, shards)] \
                if kind == push_mod.KIND_KEY else list(range(shards))
            new: Dict[int, _ShardSub] = {}
            try:
                for s in targets:
                    new[s] = await self._sub_shard(entry, fleet,
                                                   by_shard, s)
            except (ConnectionError, OSError) as e:
                last = e
                for sh in new.values():
                    await sh.pipe.close()
                fleet.maybe_refresh(force=True)
                await asyncio.sleep(min(0.02 * (attempt + 1), 0.2))
                continue
            for sh in entry.shards.values():
                await sh.pipe.close()
            entry.shards = new
            return
        raise last if last is not None \
            else ConnectionError("push subscribe failed")

    async def _sub_shard(self, entry: _SpecEntry, fleet: _Fleet,
                         by_shard: dict, shard: int) -> _ShardSub:
        state, kind, arg, k = entry.spec
        ep = fleet.pick(by_shard, shard)
        pipe = _UpstreamPipe(ep.host, ep.port, 1, push=True)
        sh = _ShardSub(pipe)
        pipe.on_push = lambda text, e=entry, s=sh: \
            self._on_up_push(e, s, text)
        pipe.on_dead = lambda exc, e=entry: self._schedule_resync(e)
        try:
            text, _ = await pipe.request(
                f"SUBSCRIBE\t{state}\t{kind}\t{arg}\t{k}")
        except (ConnectionError, OSError):
            await pipe.close()
            raise
        if not text.startswith("S\t"):
            await pipe.close()
            raise ConnectionError(
                f"upstream refused subscription: {text}")
        _, usub, useq, snap = text.split("\t", 3)
        sh.sub_id = usub
        sh.seq = int(useq)
        if kind == push_mod.KIND_TOPK:
            sh.shortlist = _parse_shortlist(snap)
        else:
            sh.value = snap
        return sh

    def _on_up_push(self, entry: _SpecEntry, sh: _ShardSub,
                    text: str) -> None:
        try:
            sub_id, seq, payload = push_mod.parse_push(text)
        except ValueError:
            return
        if entry.closed or sh.sub_id != sub_id:
            return  # a dead epoch's stream: ignore
        if seq != sh.seq + 1:
            self._schedule_resync(entry)  # gap: rebuild, never guess
            return
        sh.seq = seq
        obs_metrics.get_registry().counter(
            "tpums_push_upstream_deltas_total",
            state=entry.spec[0]).inc()
        if entry.spec[1] == push_mod.KIND_KEY:
            sh.value = payload
            if payload != entry.value:
                entry.value = payload
                self._emit(entry, payload)
        else:
            _fold_str(sh.shortlist, payload)
            self._refresh_merged(entry)

    def _refresh_merged(self, entry: _SpecEntry) -> None:
        new = self._merged_topk(entry)
        delta = _diff_topk(entry.merged, new)
        if delta:
            entry.merged = new
            self._emit(entry, delta)

    def _merged_topk(self, entry: _SpecEntry) -> Dict[str, str]:
        # union of the per-shard shortlists (each a top-k superset of
        # its slice, so the union contains the global top-k), best score
        # wins, stable (score, item) order
        pool: Dict[str, str] = {}
        for sh in entry.shards.values():
            for item, s in sh.shortlist.items():
                if item not in pool or float(s) > float(pool[item]):
                    pool[item] = s
        top = sorted(pool.items(),
                     key=lambda it: (-float(it[1]), it[0]))
        return dict(top[:entry.spec[3]])

    def _snapshot_of(self, entry: _SpecEntry) -> str:
        if entry.spec[1] == push_mod.KIND_KEY:
            return entry.value
        return ";".join(
            f"{i}:{s}" for i, s in sorted(
                entry.merged.items(),
                key=lambda it: (-float(it[1]), it[0])))

    def _emit(self, entry: _SpecEntry, payload: str) -> None:
        reg = obs_metrics.get_registry()
        state, kind = entry.spec[0], entry.spec[1]
        for ds in list(entry.downs.values()):
            ds.seq += 1
            if len(ds.ring) >= self._ring_cap:
                ds.ring.popleft()
                reg.counter("tpums_push_ring_evictions_total").inc()
            ds.ring.append((ds.seq, payload))
            if ds.send is not None:
                try:
                    ds.send(push_mod.format_push(ds.sub_id, ds.seq,
                                                 payload))
                except Exception:
                    pass
            reg.counter("tpums_push_notifications_total", state=state,
                        kind=kind).inc()

    def _schedule_resync(self, entry: _SpecEntry) -> None:
        if entry.closed or (entry.resync_task is not None
                            and not entry.resync_task.done()):
            return
        entry.resync_task = asyncio.ensure_future(self._resync(entry))

    async def _resync(self, entry: _SpecEntry) -> None:
        """Upstream turbulence (worker kill, reshard cutover, region
        failover): resubscribe against the live topology and emit the
        catch-up as ONE ordinary delta — downstream seqs stay
        contiguous, nothing is missed, nothing is repeated."""
        backoff = 0
        while not entry.closed:
            try:
                for sh in entry.shards.values():
                    await sh.pipe.close()
                entry.shards = {}
                await self._establish(entry)
                break
            except (ConnectionError, OSError):
                backoff += 1
                await asyncio.sleep(min(0.05 * backoff, 0.5))
        if entry.closed:
            return
        obs_metrics.get_registry().counter(
            "tpums_push_upstream_resyncs_total",
            state=entry.spec[0]).inc()
        if entry.spec[1] == push_mod.KIND_KEY:
            sh = next(iter(entry.shards.values()))
            if sh.value != entry.value:
                entry.value = sh.value
                self._emit(entry, sh.value)
        else:
            self._refresh_merged(entry)

    def _teardown(self, entry: _SpecEntry) -> None:
        entry.closed = True
        self._specs.pop(entry.spec, None)
        if entry.resync_task is not None:
            entry.resync_task.cancel()
        for sh in entry.shards.values():
            asyncio.ensure_future(sh.pipe.close())
        entry.shards = {}

    def _update_fanout(self) -> None:
        ups = sum(len(e.shards) for e in self._specs.values())
        obs_metrics.get_registry().gauge(
            "tpums_push_fanout_ratio").set(
                len(self._downs) / ups if ups else 0.0)

    def upstream_subscriptions(self) -> int:
        return sum(len(e.shards) for e in self._specs.values())

    def downstream_subscriptions(self) -> int:
        return len(self._downs)

    async def close(self) -> None:
        for entry in list(self._specs.values()):
            entry.closed = True
            if entry.resync_task is not None:
                entry.resync_task.cancel()
            for sh in entry.shards.values():
                await sh.pipe.close()
            entry.shards = {}
        self._specs.clear()
        self._downs.clear()


class EdgeClient(QueryClient):
    """A ``QueryClient`` pointed at the edge tier: thin by construction
    (no registry resolution per request, no shard math, no fan-out), it
    holds one connection to one proxy and rotates to the next proxy on
    connection failure — the reconnect is what lets survivors absorb a
    dead proxy's clients.  Discovers proxies from the registry
    (``registry.edge_group``) or takes explicit ``endpoints``.

    ``stale_bound_s`` opts every read into staleness reporting AND pins
    the proxy-enforced geo bound by sending ``st=<seconds>`` instead of
    the frozen ``st=1``."""

    def __init__(self, group: Optional[str] = None,
                 endpoints: Optional[Sequence[Tuple[str, int]]] = None,
                 prefer: int = 0, region: Optional[str] = None,
                 stale_bound_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None, **kw):
        if endpoints is None:
            if group is None:
                raise ValueError(
                    "EdgeClient needs a group or explicit endpoints")
            entries = registry.resolve_replicas(
                registry.edge_group(group, region))
            entries.sort(key=lambda e: (e.get("replica") or 0,
                                        e.get("port") or 0))
            endpoints = [(e.get("host", "127.0.0.1"), int(e["port"]))
                         for e in entries if e.get("port")]
        endpoints = [(str(h), int(p)) for h, p in endpoints]
        if not endpoints:
            raise ConnectionError(
                f"no edge proxies registered for group {group!r}")
        self._endpoints = endpoints
        self._ep_idx = int(prefer) % len(endpoints)
        self._rotate = False
        if retry is None:
            retry = RetryPolicy(attempts=max(4, len(endpoints) + 2),
                                backoff_s=0.05, max_backoff_s=0.5)
        stale = kw.pop("stale", None)
        if stale_bound_s is not None:
            stale = True
        host, port = endpoints[self._ep_idx]
        super().__init__(host=host, port=port, retry=retry, stale=stale,
                         **kw)
        if stale_bound_s is not None:
            self._stale_ext = \
                f"{proto.STALE_FIELD}{float(stale_bound_s):g}"

    def _connect(self):
        if self._rotate and len(self._endpoints) > 1:
            self._ep_idx = (self._ep_idx + 1) % len(self._endpoints)
            self.host, self.port = self._endpoints[self._ep_idx]
            obs_metrics.get_registry().counter(
                "tpums_client_proxy_reconnects_total").inc()
            obs_tracing.event("proxy_reconnect", host=self.host,
                              port=self.port)
        self._rotate = False
        try:
            return super()._connect()
        except (ConnectionError, OSError):
            self._rotate = True
            raise

    def close(self) -> None:
        if self._sock is not None:
            # a close with a live socket is (almost always) the retry
            # loop reacting to a failure: rotate to the next proxy on
            # the reconnect so a dead proxy's clients drain to survivors
            self._rotate = True
        super().close()

    def topk_many(self, name: str, user_ids: Sequence[str], k: int,
                  window: int = 32) -> list:
        """The sharded/HA clients' bulk surface, served by the proxy's
        fan-out: one pipelined TOPK per user.  ``pipeline`` has no
        transparent reconnect, so retry (and rotate) whole-batch here —
        every verb is an idempotent read."""
        failures = 0
        while True:
            try:
                return self.topk_pipelined(name, list(user_ids), k,
                                           window=window)
            except (ConnectionError, OSError):
                self.close()
                failures += 1
                if failures >= self.retry.attempts:
                    raise
                self.retry.sleep(failures - 1)


def spawn_edge_procs(group: str, count: int, port_dir: str, *,
                     host: str = "127.0.0.1", region: Optional[str] = None,
                     env: Optional[dict] = None,
                     extra_args: Sequence[str] = (),
                     timeout_s: float = 30.0):
    """Launch ``count`` edge proxy processes -> (procs, ports).  Mirrors
    ``sharded.spawn_worker_procs``: each proxy writes its bound port to
    ``<port_dir>/edge-<i>.port`` once it is serving and registered."""
    os.makedirs(port_dir, exist_ok=True)
    child_env = dict(os.environ)
    child_env.update(env or {})
    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    prior = child_env.get("PYTHONPATH", "")
    child_env["PYTHONPATH"] = repo + (os.pathsep + prior if prior else "")
    procs = []
    port_files = []
    for i in range(count):
        pf = os.path.join(port_dir, f"edge-{i}.port")
        try:
            os.unlink(pf)
        except OSError:
            pass
        port_files.append(pf)
        cmd = [sys.executable, "-m", "flink_ms_tpu_torch.serve.edge",
               "--group", group, "--host", host, "--port", "0",
               "--replica", str(i), "--portFile", pf]
        if region:
            cmd += ["--region", region]
        cmd += list(extra_args)
        procs.append(subprocess.Popen(cmd, env=child_env, cwd=repo))
    ports = []
    deadline = time.time() + timeout_s
    for pf in port_files:
        while True:
            try:
                with open(pf) as f:
                    ports.append(int(f.read().strip()))
                break
            except (OSError, ValueError):
                if time.time() > deadline:
                    stop_edge_procs(procs)
                    raise TimeoutError(
                        f"edge proxy never wrote its port file {pf}")
                time.sleep(0.05)
    return procs, ports


def stop_edge_procs(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + 5
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 0.1))
        except Exception:
            p.kill()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flink_ms_tpu_torch.serve.edge",
        description="tpu-ms edge proxy: one stateless front door for a "
                    "serving group's shard fleet")
    ap.add_argument("--group", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--portFile", default=None)
    ap.add_argument("--replica", type=int, default=0)
    ap.add_argument("--region", default=None)
    args = ap.parse_args(argv)
    # an edge process fronts thousands of sockets: lift the fd ceiling
    # to the hard limit before binding
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except Exception:
        pass
    proxy = EdgeProxy(args.group, host=args.host, port=args.port,
                      replica=args.replica, region=args.region)
    proxy.start()
    if args.portFile:
        tmp = f"{args.portFile}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(str(proxy.port))
        os.replace(tmp, args.portFile)
    stop = threading.Event()
    import signal as _signal

    def _on_term(signum, frame):
        stop.set()

    _signal.signal(_signal.SIGTERM, _on_term)
    _signal.signal(_signal.SIGINT, _on_term)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        proxy.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
