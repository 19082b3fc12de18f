"""High-availability serving plane: replicated shards, heartbeat-supervised
recovery, and client-side failover.

Own copy of ``flink_ms_tpu/serve/ha.py``: the same client, supervisor,
registry entries and CLI flags; the supervisor spawns the port's worker
(``python -m flink_ms_tpu_torch.serve.sharded``) on ``device`` (default
``cuda``, passed to every child as ``--device``), and starts every member
at once before it awaits their port files (the reference awaits each
before it starts the next), so their imports and replays overlap.  A
client of either package fails over across workers of either package.

The reference serves each key-group from exactly one Flink task slot, so a
TaskManager death makes that key range unqueryable until the fixed-delay
restart completes — the sharded plane here reproduced that faithfully
(``sharded.py``: one process per shard; a ``kill -9`` turns the victim's
key range into connection errors for seconds).  This module is the
subsystem production serving stacks put on top:

- **Replica sets** — ``--replication R`` launches R workers per shard.
  Each replica consumes the SAME journal range with the SAME ownership
  filter; the journal is a replayable log, so replicas converge to the
  same last-writer-wins table without any inter-replica coordination.
- **Liveness** — every worker heartbeats its registry entry on the
  ``TPUMS_HEARTBEAT_S`` cadence (``registry.py``); readers treat an entry
  whose heartbeat is past ``TPUMS_REPLICA_TTL_S`` as dead.  pid-liveness
  stays as the fast local check.
- **Client failover** — ``HAShardedClient`` resolves the live replicas of
  every shard through the registry, routes to a sticky healthy replica,
  and on connection/timeout errors retries against the NEXT replica with
  bounded exponential backoff (``client.RetryPolicy``), re-resolving from
  the registry when the set changes.  Replicas still replaying (registry
  ``ready=False``) are not routed traffic.
- **Supervised recovery** — ``ReplicaSupervisor`` respawns a replica whose
  process died or whose heartbeat lapsed.  The rejoining replica replays
  the journal behind a readiness gate (``ServingJob._ready`` +  the
  ``HEALTH`` verb): it registers ``ready=False`` until its offset passes
  the journal end observed at start, so it never serves a half-replayed
  table.

Failure model (what IS and ISN'T guaranteed): queries are idempotent
reads, so failover retries are always safe.  With R >= 2 live replicas per
shard, a single replica failure is absorbed with zero client-visible
errors (bounded added latency: the failed attempt + backoff).  Losing ALL
replicas of a shard makes that key range unavailable until a respawned
replica passes readiness — exactly the R=1 (reference) behavior.  Replicas
are eventually consistent with the journal; during failover a client may
read a value the dead replica had applied but the failover target hasn't
yet (the journal replay closes the gap; last-writer-wins makes it
convergent, never corrupt).

Shard count is fixed for the lifetime of a supervisor — ``hash%N``
ownership is baked in at launch.  Live RESHAPING (changing N under
traffic) is the elastic plane's job (``serve/elastic.py``): it runs a
whole new ReplicaSupervisor per topology generation and cuts clients over
atomically; this module stays the fixed-shape building block.

Replicated launcher CLI (the HA analog of ``serve.sharded``):

    python -m flink_ms_tpu_torch.serve.ha --numWorkers 2 --replication 2 \
        --journalDir DIR --topic T [--stateBackend memory] \
        [--jobGroup G] [--portDir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.params import Params
from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from . import registry
from .client import QueryClient, RetryPolicy
from .sharded import owner_of

Endpoint = Tuple[str, int]


def shard_group(job_group: str, shard: int) -> str:
    """The logical replica-group id shard ``shard`` registers under."""
    return f"{job_group}/shard-{shard}"


def _entry_endpoint(entry: dict, default_host: str = "127.0.0.1") -> Endpoint:
    host = entry.get("host") or ""
    if not host or host == "0.0.0.0":
        host = default_host
    return host, int(entry["port"])


def resolve_shard_endpoints(
    job_group: str, shard: int, ready_only: bool = True,
    default_host: str = "127.0.0.1",
) -> List[Endpoint]:
    """Live replica endpoints of one shard, readiness-gated.

    ``ready_only`` drops replicas still replaying their journal; when NO
    replica is ready the non-ready ones are returned as a last resort —
    a cold-starting R=1 deployment must stay addressable (its queries
    block on replay progress, they don't 404)."""
    members = registry.resolve_replicas(shard_group(job_group, shard))
    ready = [e for e in members if e.get("ready")]
    chosen = ready if (ready_only and ready) else members
    return [_entry_endpoint(e, default_host) for e in chosen]


# ---------------------------------------------------------------------------
# client-side failover
# ---------------------------------------------------------------------------

# failure classes that mean "this replica, not this request": connection
# refused/reset, timeouts, broken pipes.  RuntimeError (an E reply) is a
# REQUEST error and must propagate — retrying it elsewhere would just
# repeat it.
_FAILOVER_ERRORS = (ConnectionError, OSError)


class _ShardSet:
    """Per-shard replica bookkeeping: resolved endpoints, one persistent
    QueryClient per endpoint, per-replica health (cooldown after failure),
    and a sticky preference for the last replica that answered."""

    __slots__ = ("endpoints", "clients", "down_until", "prefer",
                 "last_refresh")

    def __init__(self):
        self.endpoints: List[Endpoint] = []
        self.clients: Dict[Endpoint, QueryClient] = {}
        self.down_until: Dict[Endpoint, float] = {}
        self.prefer: Optional[Endpoint] = None
        self.last_refresh = 0.0


class HAShardedClient:
    """Failover-aware sharded client: routes each key to its owning shard
    (same FNV-1a routing as ``ShardedQueryClient``), but every shard is
    backed by a replica SET resolved from the registry.  Connection-class
    failures mark the replica down (cooldown) and the request retries on
    the next replica under ``retry``'s attempt/backoff budget; the set is
    re-resolved from the registry when it goes stale or exhausts.

    Not thread-safe (same contract as ``ShardedQueryClient``): give each
    load-generating thread its own instance.

    ``resolver(shard) -> [(host, port), ...]`` overrides registry-based
    resolution (tests, static deployments)."""

    def __init__(
        self,
        num_workers: int,
        job_group: Optional[str] = None,
        resolver: Optional[Callable[[int], List[Endpoint]]] = None,
        timeout_s: float = 5.0,
        retry: Optional[RetryPolicy] = None,
        refresh_s: Optional[float] = None,
        cooldown_s: Optional[float] = None,
        seq_fanout_keys: int = 8,
        proto: Optional[str] = None,
        tenant: Optional[str] = None,
    ):
        if num_workers < 1:
            raise ValueError("need at least one shard")
        if resolver is None and not job_group:
            raise ValueError("need a job_group (registry resolution) or an "
                             "explicit resolver")
        self.num_workers = num_workers
        self.job_group = job_group
        self._resolver = resolver or (
            lambda shard: resolve_shard_endpoints(job_group, shard)
        )
        self.timeout_s = timeout_s
        # wire framing for every per-replica QueryClient (serve/proto.py:
        # tab|b2|auto; None defers to TPUMS_PROTO).  "auto" is the natural
        # fleet setting — mixed old/new replicas each negotiate what they
        # speak, and a failover reconnect renegotiates per endpoint.
        self.proto = proto
        # tenant identity stamped by every per-replica QueryClient
        # (serve/admission.py); None defers to TPUMS_TENANT in the client
        self.tenant = tenant
        # failover budget: enough attempts to visit every replica of a
        # small set twice, with fast bounded backoff — a lone kill at R=2
        # must be absorbed inside one client call
        self.retry = retry or RetryPolicy(
            attempts=5, backoff_s=0.05, max_backoff_s=1.0)
        self.refresh_s = (
            registry.heartbeat_interval_s() if refresh_s is None
            else refresh_s
        )
        self.cooldown_s = (
            registry.heartbeat_interval_s() if cooldown_s is None
            else cooldown_s
        )
        self.seq_fanout_keys = seq_fanout_keys
        self.failovers = 0      # observability: replica-switch count
        self.refreshes = 0
        reg = obs_metrics.get_registry()
        self._obs_failovers = reg.counter("tpums_client_failovers_total")
        self._obs_refreshes = reg.counter("tpums_client_refreshes_total")
        self._obs_reg = reg
        self._shards = [_ShardSet() for _ in range(num_workers)]
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=num_workers)

    # -- replica-set maintenance ------------------------------------------

    def _refresh(self, shard: int, force: bool = False) -> None:
        ss = self._shards[shard]
        now = time.monotonic()
        if not force and ss.endpoints and (
            now - ss.last_refresh < self.refresh_s
        ):
            return
        eps = list(self._resolver(shard))
        ss.last_refresh = now
        self.refreshes += 1
        self._obs_refreshes.inc()
        if eps == ss.endpoints:
            return
        # close clients of endpoints that left the set (a respawned
        # replica comes back on a NEW port; the old one is garbage)
        for ep in set(ss.clients) - set(eps):
            try:
                ss.clients.pop(ep).close()
            except Exception:
                pass
            ss.down_until.pop(ep, None)
        ss.endpoints = eps
        if ss.prefer not in eps:
            ss.prefer = None

    def _candidates(self, shard: int) -> List[Endpoint]:
        """Endpoints in try-order: sticky preferred first, then the other
        healthy replicas, then cooled-down ones (their cooldown may have
        expired, and with nothing else alive they're still worth a try)."""
        ss = self._shards[shard]
        now = time.monotonic()
        healthy = [ep for ep in ss.endpoints
                   if ss.down_until.get(ep, 0.0) <= now]
        cooling = [ep for ep in ss.endpoints if ep not in healthy]
        if ss.prefer in healthy:
            healthy.remove(ss.prefer)
            healthy.insert(0, ss.prefer)
        return healthy + cooling

    def _client(self, shard: int, ep: Endpoint) -> QueryClient:
        ss = self._shards[shard]
        c = ss.clients.get(ep)
        if c is None:
            # internal retry OFF: the failover layer owns retries, and an
            # in-client reconnect to a dead replica would just double the
            # time spent discovering it's dead
            c = QueryClient(ep[0], ep[1], timeout_s=self.timeout_s,
                            retry=RetryPolicy(attempts=1),
                            proto=self.proto, tenant=self.tenant)
            ss.clients[ep] = c
        return c

    # which wire verb each client op's final failure burns budget against
    # (the SLO layer attributes client-visible errors per verb)
    _OP_VERB = {
        "query_state": "GET", "query_states": "MGET",
        "topk_by_vector_pipelined": "TOPKV", "count": "COUNT",
        "ping": "PING", "health": "HEALTH",
    }

    def _count_error(self, op: str) -> None:
        self._obs_reg.counter(
            "tpums_client_errors_total",
            verb=self._OP_VERB.get(op, op.upper())).inc()

    def _call(self, shard: int, op: str, *args):
        """Run ``QueryClient.<op>(*args)`` against shard ``shard`` with
        failover: connection-class errors cool the replica down and move
        to the next candidate, re-resolving from the registry between
        passes, until the retry budget is spent."""
        ss = self._shards[shard]
        self._refresh(shard)
        failures = 0
        last_err: Optional[Exception] = None
        while failures < self.retry.attempts:
            candidates = self._candidates(shard)
            if not candidates:
                failures += 1
                if failures >= self.retry.attempts:
                    break
                self.retry.sleep(failures - 1)
                self._refresh(shard, force=True)
                continue
            for ep in candidates:
                c = self._client(shard, ep)
                try:
                    out = getattr(c, op)(*args)
                except _FAILOVER_ERRORS as e:
                    last_err = e
                    c.close()
                    ss.down_until[ep] = time.monotonic() + self.cooldown_s
                    if ss.prefer == ep:
                        ss.prefer = None
                    self.failovers += 1
                    self._obs_failovers.inc()
                    # a failover under an active trace joins the request's
                    # event chain — the retry that follows carries the
                    # SAME tid to the next replica, so the chain shows
                    # both the dead endpoint and the one that answered
                    obs_tracing.event(
                        "failover", shard=shard, op=op,
                        host=ep[0], port=ep[1], error=str(e))
                    failures += 1
                    if failures >= self.retry.attempts:
                        self._count_error(op)
                        raise
                    self.retry.sleep(failures - 1)
                    continue
                ss.prefer = ep
                return out
            # full pass failed: the set itself is stale (respawned
            # replicas live on new ports) — force re-resolution
            self._refresh(shard, force=True)
        self._count_error(op)
        if last_err is not None:
            raise last_err
        raise ConnectionError(
            f"no live replicas for shard {shard}"
            + (f" of group {self.job_group!r}" if self.job_group else "")
        )

    # -- query surface (ShardedQueryClient-compatible) ---------------------

    def owner(self, key: str) -> int:
        return owner_of(key, self.num_workers)

    def query_state(self, name: str, key: str) -> Optional[str]:
        return self._call(self.owner(key), "query_state", name, key)

    def query_states(self, name: str, keys) -> list:
        """Batched lookups: one failover-guarded MGET per owning shard,
        concurrent when the request is large enough to amortize the pool
        dispatch (same threshold rationale as ``ShardedQueryClient``)."""
        keys = list(keys)
        out: List[Optional[str]] = [None] * len(keys)
        by_owner: Dict[int, List[int]] = {}
        for pos, key in enumerate(keys):
            by_owner.setdefault(self.owner(key), []).append(pos)
        if len(by_owner) == 1 or len(keys) < self.seq_fanout_keys:
            for w, positions in by_owner.items():
                vals = self._call(w, "query_states", name,
                                  [keys[p] for p in positions])
                for p, v in zip(positions, vals):
                    out[p] = v
            return out
        from concurrent.futures import wait as _futures_wait

        # pool threads don't inherit thread-local trace context: capture
        # the submitting request's tid NOW and re-install it per task, so
        # every shard leg of a traced fan-out carries the same id (and,
        # via the ``tid/sid`` composite, parents under the open span)
        tid = obs_tracing.current_context()
        futures = {
            w: self._pool.submit(
                obs_tracing.call_with_trace, tid,
                self._call, w, "query_states", name,
                [keys[p] for p in positions],
            )
            for w, positions in by_owner.items()
        }
        _futures_wait(list(futures.values()))
        for w, positions in by_owner.items():
            for p, v in zip(positions, futures[w].result()):
                out[p] = v
        return out

    def topk(self, name: str, user_id: str, k: int):
        return self.topk_many(name, [user_id], k)[0]

    def topk_many(self, name: str, user_ids: Sequence[str], k: int) -> list:
        """Fan-out top-k with per-shard failover: factor rows resolve
        through failover-guarded MGETs, then each shard's catalog slice is
        scored on whichever replica is alive (pipelined TOPKV), merged
        best-k per user."""
        user_ids = list(user_ids)
        payloads = self.query_states(name, [f"{u}-U" for u in user_ids])
        known = [i for i, p in enumerate(payloads) if p is not None]
        out: list = [None] * len(user_ids)
        if not known:
            return out
        vecs = [payloads[i] for i in known]
        from concurrent.futures import wait as _futures_wait

        with obs_tracing.span("fanout", op="topk_many",
                              shards=self.num_workers,
                              queries=len(known), k=k):
            ctx = obs_tracing.current_context()
            futs = [
                self._pool.submit(
                    obs_tracing.call_with_trace, ctx,
                    self._call, w, "topk_by_vector_pipelined",
                    name, vecs, k)
                for w in range(self.num_workers)
            ]
            _futures_wait(futs)
            per_worker = [f.result() for f in futs]
        for j, i in enumerate(known):
            merged: List[Tuple[str, float]] = []
            for worker_results in per_worker:
                merged.extend(worker_results[j])
            merged.sort(key=lambda it: -it[1])
            out[i] = merged[:k]
        return out

    def total_count(self, name: str) -> int:
        return sum(
            self._call(w, "count", name) for w in range(self.num_workers)
        )

    def shard_health(self, name: str, shard: int) -> dict:
        """HEALTH of whichever replica of ``shard`` answers."""
        return self._call(shard, "health", name)

    def ping_all(self) -> List[str]:
        return [self._call(w, "ping") for w in range(self.num_workers)]

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        for ss in self._shards:
            for c in ss.clients.values():
                c.close()
            ss.clients.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# replica-set launcher + heartbeat supervisor
# ---------------------------------------------------------------------------

class ReplicaSupervisor:
    """Launches R replicas per shard as ``serve.sharded`` worker processes
    and keeps the set whole: a replica whose process died or whose registry
    heartbeat lapsed past TTL is respawned (after ``respawn_delay_s``).
    The respawned process replays the journal and announces itself
    ``ready=False`` until caught up — readiness-gated clients route no
    traffic to it until then, so recovery is never visible as bad reads.

    The supervisor is the HA analog of the reference's JobManager restart
    strategy, except restarts are per-REPLICA (the shard keeps serving
    from its siblings) instead of per-job."""

    def __init__(
        self,
        num_workers: int,
        replication: int,
        journal_dir: str,
        topic: str,
        port_dir: str,
        job_group: Optional[str] = None,
        state_backend: str = "memory",
        host: str = "127.0.0.1",
        extra_args: Sequence[str] = (),
        check_interval_s: Optional[float] = None,
        respawn_delay_s: float = 0.25,
        spawn_timeout_s: float = 120.0,
        env: Optional[dict] = None,
        device: str = "cuda",
    ):
        if num_workers < 1 or replication < 1:
            raise ValueError("need numWorkers >= 1 and replication >= 1")
        self.num_workers = num_workers
        self.replication = replication
        self.journal_dir = journal_dir
        self.topic = topic
        self.port_dir = port_dir
        self.job_group = job_group or f"ha-{uuid.uuid4().hex[:8]}"
        self.state_backend = state_backend
        self.host = host
        self.extra_args = tuple(extra_args)
        self.check_interval_s = (
            registry.heartbeat_interval_s() if check_interval_s is None
            else check_interval_s
        )
        self.respawn_delay_s = respawn_delay_s
        self.spawn_timeout_s = spawn_timeout_s
        self._env = env
        self.device = device
        self.procs: Dict[Tuple[int, int], object] = {}
        self.ports: Dict[Tuple[int, int], int] = {}
        self.respawns = 0
        self.events: List[dict] = []  # (t, shard, replica, action) log —
        # the chaos harness and the bench read recovery timelines off this
        self._due: Dict[Tuple[int, int], float] = {}  # respawn-at times
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- identity ----------------------------------------------------------

    def job_id(self, shard: int, replica: int) -> str:
        return f"{self.job_group}:s{shard}r{replica}"

    def group_of(self, shard: int) -> str:
        return shard_group(self.job_group, shard)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaSupervisor":
        os.makedirs(self.port_dir, exist_ok=True)
        try:
            # every member starts at once (their imports and replays
            # overlap), then each one's port file is awaited
            launched = [self._launch(shard, replica)
                        for shard in range(self.num_workers)
                        for replica in range(self.replication)]
            for member in launched:
                self._await_port(*member)
        except Exception:
            self.stop()
            raise
        self._thread = threading.Thread(
            target=self._monitor_loop, name="replica-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        from .sharded import stop_worker_procs

        with self._lock:
            procs = list(self.procs.values())
        stop_worker_procs(procs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- spawn / monitor ---------------------------------------------------

    def _spawn(self, shard: int, replica: int) -> None:
        self._await_port(*self._launch(shard, replica))

    def _launch(self, shard: int, replica: int):
        """Start one member's process -> (shard, replica, proc, port file)."""
        import subprocess

        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        base_env = dict(os.environ if self._env is None else self._env)
        prior = base_env.get("PYTHONPATH", "")
        base_env["PYTHONPATH"] = repo + (os.pathsep + prior if prior else "")
        pf = os.path.join(self.port_dir, f"ha-port-{shard}-{replica}.json")
        if os.path.exists(pf):
            os.unlink(pf)
        # own the proc before waiting on the port file: if the wait below
        # raises, stop() must still be able to kill this replica, and the
        # monitor must supervise it rather than the corpse it replaced.
        # The stop flag is read under the lock stop() takes to collect the
        # procs, so a launch either lands in that collection or never runs
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError(
                    f"replica s{shard}r{replica}: the supervisor of "
                    f"{self.job_group!r} is stopped")
            proc = subprocess.Popen(
                [sys.executable, "-m", "flink_ms_tpu_torch.serve.sharded",
                 "--workerIndex", str(shard), "--device", self.device,
                 "--numWorkers", str(self.num_workers),
                 "--replicaIndex", str(replica),
                 "--jobGroup", self.job_group,
                 "--journalDir", self.journal_dir, "--topic", self.topic,
                 "--stateBackend", self.state_backend, "--host", self.host,
                 "--port", "0", "--portFile", pf, *self.extra_args],
                env=base_env, cwd=repo,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
            self.procs[(shard, replica)] = proc
        return shard, replica, proc, pf

    def _await_port(self, shard: int, replica: int, proc, pf: str) -> None:
        deadline = time.time() + self.spawn_timeout_s
        port = None
        while port is None:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica s{shard}r{replica} died at spawn "
                    f"rc={proc.returncode}"
                )
            if time.time() > deadline:
                proc.kill()
                raise RuntimeError(
                    f"replica s{shard}r{replica} port wait exceeded "
                    f"{self.spawn_timeout_s:.0f}s"
                )
            try:
                with open(pf) as f:
                    port = json.load(f)["port"]
            except (OSError, ValueError, KeyError):
                # not written yet (or, pre-atomic-publish workers, written
                # partially): keep polling until the deadline
                time.sleep(0.02)
        with self._lock:
            self.ports[(shard, replica)] = port
        self.events.append({
            "t": time.time(), "shard": shard, "replica": replica,
            "action": "spawn", "port": port,
        })
        obs_tracing.events_counter(
            "replica_spawn", group=self.job_group, shard=shard,
            replica=replica, port=port)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self._check_once()
            except Exception:
                # supervision must outlive transient registry/proc errors
                pass

    def _check_once(self) -> None:
        now = time.time()
        with self._lock:
            members = list(self.procs.items())
        for (shard, replica), proc in members:
            if self._stop.is_set():
                # stop() runs beside this check when its join times out:
                # the members it killed are not this loop's to respawn
                return
            key = (shard, replica)
            dead = proc.poll() is not None
            if not dead:
                # heartbeat-expiry detection: resolve() applies both the
                # pid check and the TTL contract; a wedged-but-alive
                # process whose heartbeats stopped is dead for serving
                # purposes and gets recycled
                entry = registry.resolve(self.job_id(shard, replica))
                if entry is None:
                    try:
                        proc.kill()
                    except Exception:
                        pass
                    dead = True
                    self.events.append({
                        "t": now, "shard": shard, "replica": replica,
                        "action": "heartbeat_expired",
                    })
                    obs_tracing.events_counter(
                        "replica_heartbeat_expired", group=self.job_group,
                        shard=shard, replica=replica)
            if not dead:
                self._due.pop(key, None)
                continue
            due = self._due.setdefault(key, now + self.respawn_delay_s)
            if now < due:
                continue
            self._due.pop(key, None)
            self.events.append({
                "t": now, "shard": shard, "replica": replica,
                "action": "respawn",
            })
            obs_tracing.events_counter(
                "replica_respawn", group=self.job_group, shard=shard,
                replica=replica)
            try:
                self._spawn(shard, replica)
                self.respawns += 1
            except Exception:
                # spawn failed (port exhaustion, fork pressure): retry on
                # the next monitor tick
                self._due[key] = time.time() + self.respawn_delay_s

    # -- observability -----------------------------------------------------

    def endpoints(self, shard: int, ready_only: bool = True
                  ) -> List[Endpoint]:
        return resolve_shard_endpoints(
            self.job_group, shard, ready_only=ready_only,
            default_host=self.host,
        )

    def wait_all_ready(self, timeout_s: float = 120.0) -> bool:
        """Block until every (shard, replica) has a ready registry entry —
        the launch barrier harnesses use before opening traffic."""
        deadline = time.time() + timeout_s
        want = self.num_workers * self.replication
        while time.time() < deadline:
            ready = 0
            for shard in range(self.num_workers):
                members = registry.resolve_replicas(self.group_of(shard))
                ready += sum(1 for e in members if e.get("ready"))
            if ready >= want:
                return True
            if self._stop.is_set():
                return False
            time.sleep(0.05)
        return False

    def client(self, **kw) -> HAShardedClient:
        kw.setdefault("num_workers", self.num_workers)
        kw.setdefault("job_group", self.job_group)
        return HAShardedClient(**kw)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_supervisor(params: Params) -> ReplicaSupervisor:
    import tempfile

    num_workers = params.get_int("numWorkers", 1)
    replication = params.get_int("replication", 2)
    port_dir = params.get("portDir") or tempfile.mkdtemp(prefix="tpums_ha_")
    extra: List[str] = []
    for passthrough in ("svm", "shards", "checkPointInterval",
                        "checkpointDataUri", "nativeServer", "ingestMode",
                        "topologyGroup", "topologyGen",
                        "snapshots", "snapshotMinBytes", "compact",
                        "updatePlane", "updatePartitions", "updateBatch",
                        "pollInterval"):
        if params.has(passthrough):
            extra += [f"--{passthrough}", params.get(passthrough)]
    sup = ReplicaSupervisor(
        num_workers, replication,
        params.get_required("journalDir"), params.get_required("topic"),
        port_dir,
        job_group=params.get("jobGroup"),
        state_backend=params.get("stateBackend", "memory"),
        host=params.get("host", "127.0.0.1"),
        extra_args=extra,
        device=params.get("device", "cuda"),
    ).start()
    print(
        f"[serve:ha] group {sup.job_group}: {num_workers} shard(s) x "
        f"{replication} replica(s) on journal topic '{sup.topic}'",
        file=sys.stderr,
    )
    return sup


def main(argv=None) -> None:
    import signal

    sup = run_supervisor(
        Params.from_args(sys.argv[1:] if argv is None else argv))
    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass
    try:
        while not stop.is_set():
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    sup.stop()


if __name__ == "__main__":
    main()
