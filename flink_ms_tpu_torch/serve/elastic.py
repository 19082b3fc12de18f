"""Elastic serving plane: topology generations, live resharding with zero
failed queries, and a metrics-driven autoscaler.

Own copy of ``flink_ms_tpu/serve/elastic.py``: the same topology records,
leases, generation groups and CLI flags, so a controller or client of
either package follows a group the other package published.  Every
generation's workers are the port's (``serve/ha.py``), on ``device``
(default ``cuda``).

The sharded/HA planes fix the shard count at launch — ``hash%N`` ownership
is baked into every worker's ingest filter and every client's routing
table, so the reference's only answer to a traffic spike is a full
restart.  This module makes N a RUNTIME property using exactly the
primitives the sharded and HA planes provide: journal-replay bootstrap
behind a readiness gate, the heartbeat registry, and the fleet metrics
scrape.

**Topology generations.**  A job GROUP's active shape lives in one
registry topology record ``(gen, shards, replicas)``
(``registry.publish_topology`` — atomic, CAS-guarded).  Generation g's
workers run under the generation-suffixed job group ``G@g<gen>``
(``generation_group``), so the whole per-generation stack — shard groups,
replica resolution, heartbeats, supervision, failover — is the UNCHANGED
HA machinery applied to a disposable namespace.  Topologies are
immutable: scale-out AND scale-in both mean "build generation g+1 from
the journal, cut over, drain g".

**Cutover protocol** (``ScaleController.scale_to``):

1. acquire the group's controller lease (single-writer; a second
   controller refuses, or defers until the lease frees — its choice);
2. spawn generation g+1 as a fresh ``ReplicaSupervisor`` worker set with
   ``hash%N'`` ownership; the new workers bootstrap by replaying the
   SHARED journal and register ``ready=False`` until caught up;
3. wait all-shards-ready (refreshing the lease throughout);
4. atomically publish the new topology with ``expect_gen=g`` — a CAS
   loss (``TopologyConflict``) aborts and tears g+1 down, never the
   active fleet;
5. drain: wait a grace period for clients to observe the new record,
   then stop generation g and GC its dead registry entries.

Failure model during cutover: generation g serves the WHOLE time — g+1
warming is invisible to traffic.  If g+1 dies mid-bootstrap (OOM, crash,
SIGKILL chaos), its supervisor respawns the member and replay resumes;
if bootstrap cannot complete inside the deadline the controller aborts,
tears g+1 down, and the topology record still names g — nothing
happened, no query failed.  Only after ALL of g+1 is ready does the
record flip, and the flip is atomic: a client resolves either g or g+1,
never a mix.

**Client** (``ElasticClient``): wraps ``HAShardedClient`` per generation.
It re-resolves the topology record on a refresh cadence, on a
generation-changed hint (the HEALTH verb carries ``topology_gen``, the
active generation each worker observed at heartbeat time), and on
resolution miss — a connection-class failure after the old generation
drained forces a topology re-read and ONE transparent retry against the
new generation.  Queries are idempotent reads, so the retry is always
safe; in-flight traffic rides through the swap.

**Autoscaler**: a policy loop over the obs fleet scrape
(``obs.scrape.fleet_signals``: qps, query-verb p99, ingest backlog) that
drives ``ScaleController`` with hysteresis (scale-out and scale-in
thresholds far apart) and a cooldown between operations; ``dry_run``
only logs decisions.

CLI::

    python -m flink_ms_tpu_torch.serve.elastic --group G --journalDir D \
        --topic T --shards 2 [--replication 1] [--autoscale] [--dryRun] \
        [--minShards 1] [--maxShards 8] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..core.params import Params
from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from . import registry
from .client import RetryPolicy
from .ha import HAShardedClient, ReplicaSupervisor, _FAILOVER_ERRORS

GEN_SEP = "@g"


def generation_group(group: str, gen: int) -> str:
    """The job group generation ``gen`` of ``group`` runs under — a
    disposable namespace the whole HA stack treats as just another
    deployment."""
    return f"{group}{GEN_SEP}{gen}"


class ControllerBusy(RuntimeError):
    """Another live controller holds the group's scaling lease."""


class ScaleError(RuntimeError):
    """The new generation could not be brought up; the active topology is
    unchanged."""


class ScaleController:
    """Owns a group's rescaling: builds each new topology generation as a
    fresh ``ReplicaSupervisor``, cuts the topology record over atomically,
    and drains the superseded generation.

    One controller instance can drive many sequential scale operations;
    concurrent operations on one GROUP are excluded by the registry
    controller lease (``defer=True`` waits for the lease instead of
    raising ``ControllerBusy``).

    ``checkpoint_uri`` (fs/rocksdb backends) is suffixed per generation
    (``.../gen-<g>``) — generations must never share checkpoint state,
    their shard counts disagree about which keys a worker owns."""

    def __init__(
        self,
        group: str,
        journal_dir: str,
        topic: str,
        port_dir: Optional[str] = None,
        state_backend: str = "memory",
        host: str = "127.0.0.1",
        replication: int = 1,
        extra_args: Sequence[str] = (),
        checkpoint_uri: Optional[str] = None,
        drain_grace_s: Optional[float] = None,
        ready_timeout_s: float = 120.0,
        defer: bool = False,
        lease_wait_s: float = 30.0,
        env: Optional[dict] = None,
        snapshots: Optional[bool] = None,
        snapshot_min_bytes: Optional[int] = None,
        device: str = "cuda",
    ):
        # tenant-scope the group (registry.qualify_group is idempotent and
        # a no-op without TPUMS_TENANT, so single-tenant callers see the
        # exact pre-tenancy behavior)
        self.group = registry.qualify_group(group)
        self.journal_dir = journal_dir
        self.topic = topic
        self.port_dir = port_dir or tempfile.mkdtemp(prefix="tpums_elastic_")
        self.state_backend = state_backend
        self.host = host
        self.replication = replication
        self.extra_args = tuple(extra_args)
        self.snapshots = snapshots
        self.snapshot_min_bytes = snapshot_min_bytes
        self.checkpoint_uri = checkpoint_uri
        # drain grace: long enough for every client refresh cadence to
        # observe the new record before the old generation stops serving
        self.drain_grace_s = (
            2.0 * registry.heartbeat_interval_s() if drain_grace_s is None
            else drain_grace_s
        )
        self.ready_timeout_s = ready_timeout_s
        self.defer = defer
        self.lease_wait_s = lease_wait_s
        self._env = env
        self.device = device
        self.supervisors: Dict[int, ReplicaSupervisor] = {}  # gen -> sup
        self.warming: Optional[ReplicaSupervisor] = None  # chaos target
        self._stops = 0   # stop() calls: a cutover begun before one aborts
        self.events: List[dict] = []  # cutover timeline (bench/smoke)
        self.scales = 0

    # -- introspection -----------------------------------------------------

    def current(self) -> Optional[dict]:
        return registry.resolve_topology(self.group)

    @property
    def active_supervisor(self) -> Optional[ReplicaSupervisor]:
        topo = self.current()
        if topo is None:
            return None
        return self.supervisors.get(int(topo["gen"]))

    # event-kind namespace: subclasses operating a different protocol on
    # the same machinery announce under their own prefix so the SLO layer
    # can tell a reshape from a model rollout (serve/rollout.py)
    _EVENT_PREFIX = "elastic"

    def _event(self, kind: str, **fields) -> None:
        self.events.append({"t": time.time(), "kind": kind, **fields})
        obs_tracing.events_counter(f"{self._EVENT_PREFIX}_{kind}",
                                   group=self.group, **fields)

    # -- lease -------------------------------------------------------------

    def _acquire_lease(self) -> str:
        token = registry.acquire_controller_lease(self.group)
        if token is not None:
            return token
        if not self.defer:
            raise ControllerBusy(
                f"group {self.group!r}: another controller holds the "
                "scaling lease"
            )
        deadline = time.time() + self.lease_wait_s
        while time.time() < deadline:
            time.sleep(registry.heartbeat_interval_s() / 2)
            token = registry.acquire_controller_lease(self.group)
            if token is not None:
                return token
        raise ControllerBusy(
            f"group {self.group!r}: scaling lease still held after "
            f"{self.lease_wait_s:.0f}s deferral"
        )

    # -- the cutover -------------------------------------------------------

    def _spawn_generation(self, gen: int, shards: int, replicas: int
                          ) -> ReplicaSupervisor:
        extra = list(self.extra_args)
        extra += ["--topologyGroup", self.group, "--topologyGen", str(gen)]
        # snapshot-first bootstrap knobs: a warming g+1 worker bulk-loads
        # the newest valid snapshot family published by generation g and
        # replays only the journal tail — the cutover cost stays O(state)
        # as the journal grows (serve/snapshot.py)
        if self.snapshots is not None:
            extra += ["--snapshots", "true" if self.snapshots else "false"]
        if self.snapshot_min_bytes is not None:
            extra += ["--snapshotMinBytes", str(self.snapshot_min_bytes)]
        if self.checkpoint_uri:
            extra += ["--checkpointDataUri",
                      f"{self.checkpoint_uri.rstrip('/')}/gen-{gen}"]
        return ReplicaSupervisor(
            shards, replicas, self.journal_dir, self.topic,
            os.path.join(self.port_dir, f"gen-{gen}"),
            job_group=generation_group(self.group, gen),
            state_backend=self.state_backend, host=self.host,
            extra_args=extra, env=self._env, device=self.device,
        )

    def _verify_generation(self, gen: int,
                           sup: ReplicaSupervisor) -> None:
        """Pre-publish verification gate, called after the all-ready
        barrier and before the CAS publish — subclass hook (the rollout
        controller row-counts and MSE-probes the warming model here,
        serve/rollout.py).  Raising aborts the cutover: the warming
        generation is torn down and the active topology stays untouched."""

    def _publish_topology(self, shards: int, replicas: int, *,
                          expect_gen: int) -> dict:
        """The CAS publish — subclass hook (the rollout controller
        attaches the generation's model binding)."""
        return registry.publish_topology(
            self.group, shards, replicas, expect_gen=expect_gen)

    def scale_to(self, shards: int, replicas: Optional[int] = None,
                 force: bool = False) -> dict:
        """Rescale the group to ``shards`` x ``replicas`` -> the published
        topology record.  Also the bootstrap path: the first call on a
        fresh group publishes generation 1.

        ``force`` builds generation g+1 even when the shape is unchanged —
        the model-rollout path, where g+1 differs by WHAT it serves, not
        by its shape (serve/rollout.py).

        Raises ``ControllerBusy`` (lease held), ``ScaleError`` (the new
        generation never became ready — it is torn down and the active
        topology is untouched), or ``registry.TopologyConflict`` (another
        controller cut over concurrently; ditto)."""
        if replicas is None:
            replicas = self.replication
        token = self._acquire_lease()
        new_sup: Optional[ReplicaSupervisor] = None
        cur_gen = 0
        stops = self._stops
        try:
            topo = self.current()
            cur_gen = int(topo["gen"]) if topo else 0
            if topo and not force and int(topo["shards"]) == shards and \
                    int(topo["replicas"]) == replicas:
                return topo  # already the requested shape
            gen = cur_gen + 1
            t0 = time.time()
            self._event("scale_start", from_gen=cur_gen, to_gen=gen,
                        shards=shards, replicas=replicas)
            # expose the warming supervisor BEFORE start(): the launch
            # barrier (port-file waits) dominates bootstrap time, and the
            # chaos harness needs the whole window to target a warming
            # member — not the instant between launch and readiness
            new_sup = self._spawn_generation(gen, shards, replicas)
            self.warming = new_sup
            new_sup.start()
            # all-shards-ready barrier, in lease-refresh slices: a long
            # journal replay must not let the lease lapse and invite a
            # second controller to steal mid-bootstrap
            deadline = time.time() + self.ready_timeout_s
            ready = False
            while time.time() < deadline:
                if new_sup.wait_all_ready(timeout_s=1.0):
                    ready = True
                    break
                if self._stops != stops:
                    break
                registry.refresh_controller_lease(self.group, token)
            if self._stops != stops:
                raise ScaleError(
                    f"generation {gen} of {self.group!r}: the controller "
                    "was stopped during the cutover")
            if not ready:
                raise ScaleError(
                    f"generation {gen} of {self.group!r} not ready after "
                    f"{self.ready_timeout_s:.0f}s — aborting, generation "
                    f"{cur_gen} stays active"
                )
            # pre-publish verification gate (no-op here; the rollout
            # controller validates the warming MODEL before it can win)
            self._verify_generation(gen, new_sup)
            registry.refresh_controller_lease(self.group, token)
            # atomic cutover: from here on resolvers see the new shape
            record = self._publish_topology(
                shards, replicas, expect_gen=cur_gen)
            self.supervisors[gen] = new_sup
            self.warming = None
            new_sup = None  # ownership transferred; don't tear down
            self.scales += 1
            self._event("cutover", gen=gen, shards=shards,
                        replicas=replicas,
                        cutover_s=round(time.time() - t0, 3))
            self._drain(cur_gen, active_gen=gen)
            return record
        except Exception:
            if new_sup is not None:  # warming gen failed: tear it down
                self.warming = None
                try:
                    new_sup.stop()
                except Exception:
                    pass
                self._event("scale_abort", to_gen=cur_gen + 1)
            raise
        finally:
            registry.release_controller_lease(self.group, token)

    def _drain(self, gen: int, active_gen: int) -> None:
        """Retire a superseded generation: grace for clients to swap, stop
        its supervisor (if this controller owns it), GC its dead entries."""
        if gen <= 0:
            return
        time.sleep(self.drain_grace_s)
        old = self.supervisors.pop(gen, None)
        if old is not None:
            old.stop()
        reaped = registry.gc_generation_entries(self.group, active_gen)
        self._event("drained", gen=gen, reaped=reaped)

    # -- lifecycle ---------------------------------------------------------

    def client(self, **kw) -> "ElasticClient":
        kw.setdefault("group", self.group)
        return ElasticClient(**kw)

    def stop(self, drop_topology: bool = False) -> None:
        """Stop every generation this controller owns (teardown, not a
        cutover).  ``drop_topology`` also removes the group's record."""
        # a cutover running on another thread (the autoscaler's) sees the
        # count move and aborts, and its warming generation is stopped
        # here, so no member outlives this call
        self._stops += 1
        warming, self.warming = self.warming, None
        if warming is not None:
            try:
                warming.stop()
            except Exception:
                pass
        for gen in sorted(self.supervisors):
            try:
                self.supervisors.pop(gen).stop()
            except Exception:
                pass
        if drop_topology:
            registry.drop_topology(self.group)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class ElasticClient:
    """Topology-following client: resolves the group's active generation,
    serves queries through a per-generation ``HAShardedClient``, and swaps
    generations underneath in-flight traffic.

    Re-resolution triggers (any one suffices):

    - cadence: every ``refresh_s`` (default: the heartbeat interval) the
      topology record is re-read — one small local file read;
    - hint: callers may feed ``note_topology_gen()`` with the
      ``topology_gen`` field a HEALTH reply carried;
    - miss: a connection-class failure that exhausted the inner client's
      failover budget forces a topology re-read, and if the generation
      moved the call transparently retries ONCE on the new generation
      (idempotent reads make this always safe).

    Not thread-safe (same contract as ``HAShardedClient``)."""

    def __init__(
        self,
        group: str,
        timeout_s: float = 5.0,
        retry: Optional[RetryPolicy] = None,
        refresh_s: Optional[float] = None,
        resolve_timeout_s: float = 30.0,
        **client_kw,
    ):
        # same tenant scoping as the controller: with TPUMS_TENANT set,
        # client and controller resolve the same qualified record
        self.group = registry.qualify_group(group)
        self.timeout_s = timeout_s
        self.retry = retry
        self.refresh_s = (
            registry.heartbeat_interval_s() if refresh_s is None
            else refresh_s
        )
        self._client_kw = client_kw
        self.generation = 0
        self.num_workers = 0
        self.generation_swaps = 0
        self._inner: Optional[HAShardedClient] = None
        self._last_refresh = 0.0
        self._hinted_gen = 0
        deadline = time.time() + resolve_timeout_s
        while True:
            if self._maybe_swap(force=True):
                break
            if time.time() > deadline:
                raise ConnectionError(
                    f"no topology record for group {group!r} after "
                    f"{resolve_timeout_s:.0f}s"
                )
            time.sleep(0.05)

    # -- topology tracking -------------------------------------------------

    def note_topology_gen(self, gen: Optional[int]) -> None:
        """Feed a generation-changed hint (the ``topology_gen`` field of a
        HEALTH reply); a gen ahead of ours forces re-resolution on the
        next call."""
        if gen is not None and int(gen) > self.generation:
            self._hinted_gen = int(gen)

    def _maybe_swap(self, force: bool = False) -> bool:
        """Re-read the topology record when due -> True if a client for
        the active generation is installed."""
        now = time.monotonic()
        if not force and self._inner is not None and \
                self._hinted_gen <= self.generation and \
                now - self._last_refresh < self.refresh_s:
            return True
        self._last_refresh = now
        topo = self._resolve_topology_retrying()
        if topo is None:
            return self._inner is not None
        gen = int(topo["gen"])
        if gen == self.generation and self._inner is not None:
            return True
        old = self._inner
        self._inner = HAShardedClient(
            int(topo["shards"]),
            job_group=generation_group(self.group, gen),
            timeout_s=self.timeout_s, retry=self.retry,
            **self._client_kw,
        )
        self.generation = gen
        self.num_workers = int(topo["shards"])
        self._hinted_gen = 0
        if old is not None:
            self.generation_swaps += 1
            obs_tracing.event("generation_swap", group=self.group, gen=gen,
                              shards=self.num_workers)
            try:
                old.close()
            except Exception:
                pass
        return True

    def _resolve_topology_retrying(self):
        """Topology read with the read ERROR distinguished from the record
        being GONE.  A transient registry failure (unreadable dir, torn
        write beyond the registry's own one-re-read guard) used to look
        identical to "no record" and was silently swallowed; now it earns
        a short bounded backoff and a counter, and on persistent failure
        the caller keeps serving the last known generation."""
        delay = 0.01
        for attempt in range(3):
            try:
                return registry.resolve_topology(self.group, strict=True)
            except (OSError, ValueError):
                obs_metrics.get_registry().counter(
                    "tpums_client_topology_refresh_errors_total",
                    group=self.group).inc()
                if attempt < 2:
                    time.sleep(delay)
                    delay *= 4
        return None

    def _call(self, op: str, *args):
        self._maybe_swap()
        try:
            return getattr(self._inner, op)(*args)
        except _FAILOVER_ERRORS:
            # resolution miss: the set may be a drained generation — force
            # a topology re-read; a moved generation earns ONE retry
            was = self.generation
            self._maybe_swap(force=True)
            if self.generation == was:
                raise
            # absorbed by the swap: count it per verb so the SLO layer can
            # attribute cutover-window retries separately from failovers
            obs_metrics.get_registry().counter(
                "tpums_client_gen_retries_total",
                verb=HAShardedClient._OP_VERB.get(op, op.upper())).inc()
            return getattr(self._inner, op)(*args)

    # -- query surface (HAShardedClient-compatible) ------------------------

    def query_state(self, name: str, key: str):
        return self._call("query_state", name, key)

    def query_states(self, name: str, keys) -> list:
        return self._call("query_states", name, list(keys))

    def topk(self, name: str, user_id: str, k: int):
        return self._call("topk", name, user_id, k)

    def topk_many(self, name: str, user_ids, k: int) -> list:
        return self._call("topk_many", name, list(user_ids), k)

    def total_count(self, name: str) -> int:
        return self._call("total_count", name)

    def shard_health(self, name: str, shard: int) -> dict:
        report = self._call("shard_health", name, shard)
        self.note_topology_gen(report.get("topology_gen"))
        return report

    def ping_all(self) -> List[str]:
        return self._call("ping_all")

    def close(self) -> None:
        if self._inner is not None:
            self._inner.close()
            self._inner = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------

@dataclass
class AutoscalerPolicy:
    """Hysteresis thresholds for the scaling decision.  ``decide`` is pure
    (no I/O, no clock reads beyond its arguments) so the policy is unit-
    testable without a fleet.

    Scale-OUT when any pressure signal crosses its high mark; scale-IN
    only when EVERY signal sits below the low marks — the wide gap between
    ``qps_high_per_shard`` and ``qps_low_per_shard`` is the hysteresis
    band that keeps a load level near one threshold from flapping the
    fleet, and ``cooldown_s`` spaces operations out so a fresh
    generation's warmup never feeds the next decision."""

    qps_high_per_shard: float = 500.0
    qps_low_per_shard: float = 100.0
    p99_high_s: float = 0.050
    backlog_high_bytes: int = 8 << 20
    min_shards: int = 1
    max_shards: int = 8
    cooldown_s: float = 30.0

    def decide(self, signals: dict, current_shards: int, now: float,
               last_scale_t: float) -> dict:
        """-> {"target": shards|None, "reason": str}."""
        if now - last_scale_t < self.cooldown_s:
            return {"target": None, "reason": "cooldown"}
        qps = signals.get("qps") or 0.0
        p99 = signals.get("p99_s")
        backlog = signals.get("backlog_bytes") or 0
        per_shard = qps / max(current_shards, 1)
        pressure = []
        if per_shard > self.qps_high_per_shard:
            pressure.append(f"qps/shard {per_shard:.0f} > "
                            f"{self.qps_high_per_shard:.0f}")
        if p99 is not None and p99 > self.p99_high_s:
            pressure.append(f"p99 {p99 * 1e3:.1f}ms > "
                            f"{self.p99_high_s * 1e3:.1f}ms")
        if backlog > self.backlog_high_bytes:
            pressure.append(f"backlog {backlog} > {self.backlog_high_bytes}")
        if pressure:
            target = min(current_shards * 2, self.max_shards)
            if target > current_shards:
                return {"target": target, "reason": "; ".join(pressure)}
            return {"target": None, "reason": "at max_shards: "
                    + "; ".join(pressure)}
        calm = (
            per_shard < self.qps_low_per_shard
            and (p99 is None or p99 < self.p99_high_s / 2)
            and backlog < self.backlog_high_bytes // 4
        )
        if calm:
            target = max(current_shards // 2, self.min_shards)
            if target < current_shards:
                return {
                    "target": target,
                    "reason": f"qps/shard {per_shard:.0f} < "
                              f"{self.qps_low_per_shard:.0f}",
                }
        return {"target": None, "reason": "steady"}


class Autoscaler:
    """Policy loop: scrape the fleet on a cadence, turn the window into
    signals (``obs.scrape.fleet_signals``), ask the policy, drive the
    controller.  ``dry_run`` logs the decision it WOULD take and touches
    nothing — the mode an operator trials a policy in before handing it
    the fleet."""

    def __init__(
        self,
        controller: ScaleController,
        policy: Optional[AutoscalerPolicy] = None,
        interval_s: float = 5.0,
        dry_run: bool = False,
    ):
        self.controller = controller
        self.policy = policy or AutoscalerPolicy()
        self.interval_s = interval_s
        self.dry_run = dry_run
        self.decisions: List[dict] = []
        self.last_scale_t = 0.0
        self._prev_fleet: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> dict:
        """One observe -> decide -> (maybe) act cycle -> the decision."""
        from ..obs.scrape import fleet_signals, scrape_fleet

        fleet = scrape_fleet()["fleet"]
        if self._prev_fleet is None:
            self._prev_fleet = fleet
            return {"target": None, "reason": "first scrape (no window)"}
        signals = fleet_signals(self._prev_fleet, fleet)
        self._prev_fleet = fleet
        topo = self.controller.current()
        shards = int(topo["shards"]) if topo else 0
        decision = self.policy.decide(
            signals, shards, time.time(), self.last_scale_t)
        decision.update(signals=signals, current_shards=shards,
                        dry_run=self.dry_run, t=time.time())
        self.decisions.append(decision)
        target = decision["target"]
        if target is not None and shards:
            obs_tracing.events_counter(
                "autoscale_decision", group=self.controller.group,
                target=target, reason=decision["reason"],
                dry_run=self.dry_run)
            if self.dry_run:
                print(f"[elastic:dry-run] would scale "
                      f"{self.controller.group} {shards} -> {target} "
                      f"({decision['reason']})", file=sys.stderr)
            else:
                try:
                    self.controller.scale_to(target)
                    self.last_scale_t = time.time()
                except (ControllerBusy, registry.TopologyConflict,
                        ScaleError) as e:
                    decision["error"] = str(e)
        return decision

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception:
                pass  # the loop must outlive transient scrape errors

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_elastic(params: Params) -> ScaleController:
    # worker-arg passthrough (mirrors ha.run_supervisor): every generation's
    # ReplicaSupervisor spawns workers with these, so a --nativeServer true
    # deployment rescales between native fleets (the warming generation's
    # C++ servers answer the readiness gate's HEALTH probes themselves);
    # TPUMS_TABLE reaches the workers through the inherited environment
    extra: List[str] = []
    for passthrough in ("svm", "checkPointInterval", "nativeServer",
                        "ingestMode", "snapshots", "snapshotMinBytes",
                        "compact", "updatePlane", "updatePartitions",
                        "updateBatch", "pollInterval"):
        if params.has(passthrough):
            extra += [f"--{passthrough}", params.get(passthrough)]
    ctl = ScaleController(
        params.get("group", "elastic"),
        params.get_required("journalDir"), params.get_required("topic"),
        port_dir=params.get("portDir"),
        state_backend=params.get("stateBackend", "memory"),
        host=params.get("host", "127.0.0.1"),
        replication=params.get_int("replication", 1),
        extra_args=extra,
        checkpoint_uri=params.get("checkpointDataUri"),
        device=params.get("device", "cuda"),
    )
    record = ctl.scale_to(params.get_int("shards", 2))
    print(
        f"[serve:elastic] group {ctl.group} generation {record['gen']}: "
        f"{record['shards']} shard(s) x {record['replicas']} replica(s)",
        file=sys.stderr,
    )
    return ctl


def main(argv=None) -> None:
    import signal

    params = Params.from_args(sys.argv[1:] if argv is None else argv)
    ctl = run_elastic(params)
    scaler: Optional[Autoscaler] = None
    if params.get_bool("autoscale", False):
        scaler = Autoscaler(
            ctl,
            AutoscalerPolicy(
                min_shards=params.get_int("minShards", 1),
                max_shards=params.get_int("maxShards", 8),
                cooldown_s=float(params.get("cooldownS", "30")),
            ),
            interval_s=float(params.get("scrapeIntervalS", "5")),
            dry_run=params.get_bool("dryRun", False),
        ).start()
        print(f"[serve:elastic] autoscaler on "
              f"({'dry-run' if scaler.dry_run else 'live'})",
              file=sys.stderr)
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
    if scaler is not None:
        scaler.stop()
    ctl.stop()


if __name__ == "__main__":
    main()
