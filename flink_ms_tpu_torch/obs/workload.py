"""Production-rehearsal workload engine — realistic open-loop traffic with
coordinated-omission-safe latency accounting.

Own copy of ``flink_ms_tpu/obs/workload.py``: the same draws for the
same seeds (``ZipfKeys``, ``VerbMix``, ``PhaseSchedule``,
``_seed_journal``), the same engine and report, and the same edge arm
(``edge > 0``: the port's proxies, ``serve/edge.py``, in front of the
fleet).  ``run_rehearsal`` and the CLI take ``device`` (default
``cuda``), which the spawned group's ``ScaleController`` hands to every
member.

The pieces, composable on their own or through ``run_rehearsal``:

- ``ZipfKeys``         zipfian key popularity over a permuted id space, so
                       hot keys spread across shard owners instead of
                       clustering on one worker.
- ``VerbMix``          weighted blend over the serving verb surface
                       (GET/MGET/TOPK/TOPKV) plus ``UPDATE`` — SGD-style
                       factor writes through the journal.
- ``PhaseSchedule``    piecewise-constant rate plan: diurnal half-sine
                       ramps (``diurnal``) and warm/ramp/burst/cool plans
                       with a correlated burst (``ramp_burst``).
- ``OpenLoopPacer``    the pacing primitive: hands out *intended* send
                       times at a fixed rate and never skips a slot, so a
                       stalled server builds measurable backlog instead of
                       silently throttling the load (coordinated omission).
- ``WorkloadRecorder`` per-verb instruments on the shared
                       ``LATENCY_BUCKETS_S`` ladder: attributed latency
                       (done - *intended*; the SLO statistic) and service
                       latency (done - actual send) recorded side by side,
                       so client percentiles and fleet-scrape percentiles
                       are the same bucketed statistic.
- ``WorkloadEngine``   N paced worker threads draining a prefilled op
                       queue; phase transitions land in the obs event ring.
- ``run_rehearsal``    the closed loop: spawn an elastic sharded group,
                       drive the engine while the autoscaler and a chaos
                       kill act on the same fleet, scrape windows, and emit
                       an SLO report (``obs/slo.py``) attributing every
                       error and excursion to a timeline event.

CLI::

    python -m flink_ms_tpu_torch.obs.workload --rehearsal [--out SLO_REPORT.json]
        [--device cuda|cpu --shards 2 --replication 2 --durationS 12 --baseQps 120
         --burstQps 480 --autoscale live|dry|off --kill 1 --seed 0
         --abusiveQps 0    # >0: add an over-quota "abuse" tenant on top
         --subscribers 0   # >0: that many live push subscriptions ride
                           # the run (serve/push.py) and the SLO report
                           # gates update->push freshness
         --pushP99Ms 250]
    python -m flink_ms_tpu_torch.obs.workload --group <topology-group> ...
        # attach mode: drive load + report against an ALREADY-RUNNING
        # elastic group instead of spawning one (no kill, no autoscaler)
"""

from __future__ import annotations

import bisect
import itertools
import json
import math
import os
import queue
import random
import signal
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import metrics as obs_metrics
from . import tracing as obs_tracing

__all__ = [
    "ZipfKeys", "VerbMix", "Phase", "PhaseSchedule", "OpenLoopPacer",
    "WorkloadRecorder", "ServingOps", "WorkloadEngine", "run_rehearsal",
    "main",
]

# instrument names — client twins of the server-side series, same ladder
CLIENT_LATENCY_HIST = "tpums_client_latency_seconds"     # done - intended
CLIENT_SERVICE_HIST = "tpums_client_service_seconds"     # done - sent
CLIENT_REQUESTS = "tpums_client_requests_total"
CLIENT_ERRORS = "tpums_client_errors_total"


class ZipfKeys:
    """Zipf(s) popularity over ``n`` keys with a seeded permutation of the
    id space: rank r (0-based) gets weight (r+1)^-s, but WHICH id holds
    rank r is shuffled, so the hot set is spread across shard owners the
    way real key hashes are — not clustered on worker 0."""

    def __init__(self, n: int, exponent: float = 1.1, seed: int = 0):
        if n <= 0:
            raise ValueError("need at least one key")
        self.n = n
        self.exponent = exponent
        ids = list(range(n))
        random.Random(seed).shuffle(ids)
        self.ids = ids                       # rank -> id
        weights = [(r + 1) ** -exponent for r in range(n)]
        self._cdf = list(itertools.accumulate(weights))
        self._total = self._cdf[-1]

    def sample(self, rng: random.Random) -> int:
        """One id drawn by popularity (rank 0 hottest)."""
        rank = bisect.bisect_left(self._cdf, rng.random() * self._total)
        return self.ids[min(rank, self.n - 1)]

    def hot_share(self, top_frac: float = 0.01) -> float:
        """Probability mass on the hottest ``top_frac`` of keys (skew
        diagnostic: uniform would give ``top_frac``)."""
        k = max(1, int(self.n * top_frac))
        return self._cdf[k - 1] / self._total


class VerbMix:
    """Weighted verb blend.  ``choose(rng)`` draws one verb; weights need
    not sum to anything in particular."""

    def __init__(self, weights: Dict[str, float]):
        items = [(v, w) for v, w in weights.items() if w > 0]
        if not items:
            raise ValueError("verb mix needs at least one positive weight")
        self.weights = dict(items)
        self._verbs = [v for v, _ in items]
        self._cum = list(itertools.accumulate(w for _, w in items))
        self._total = self._cum[-1]

    @classmethod
    def from_string(cls, spec: str) -> "VerbMix":
        """Parse ``"GET=60,MGET=15,TOPK=10,UPDATE=15"``."""
        weights: Dict[str, float] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            verb, _, w = part.partition("=")
            weights[verb.strip().upper()] = float(w) if w else 1.0
        return cls(weights)

    def choose(self, rng: random.Random) -> str:
        return self._verbs[
            bisect.bisect_left(self._cum, rng.random() * self._total)]

    def to_dict(self) -> Dict[str, float]:
        return dict(self.weights)


@dataclass(frozen=True)
class Phase:
    """One piecewise-constant segment of the rate plan."""
    name: str
    duration_s: float
    rate_qps: float


class PhaseSchedule:
    """A sequence of ``Phase`` segments; the engine derives one intended
    send time per scheduled request from it (open loop: the plan never
    reacts to server speed)."""

    def __init__(self, phases: Sequence[Phase]):
        self.phases = list(phases)
        if not self.phases:
            raise ValueError("schedule needs at least one phase")

    @property
    def duration_s(self) -> float:
        return sum(p.duration_s for p in self.phases)

    def rate_at(self, t: float) -> float:
        off = 0.0
        for p in self.phases:
            if t < off + p.duration_s:
                return p.rate_qps
            off += p.duration_s
        return 0.0

    def phase_at(self, t: float) -> Optional[Phase]:
        off = 0.0
        for p in self.phases:
            if t < off + p.duration_s:
                return p
            off += p.duration_s
        return None

    def windows(self) -> List[Tuple[float, float, Phase]]:
        """[(start_offset, end_offset, phase), ...]"""
        out, off = [], 0.0
        for p in self.phases:
            out.append((off, off + p.duration_s, p))
            off += p.duration_s
        return out

    def intended_offsets(self) -> List[Tuple[float, str]]:
        """Every scheduled send as (offset_s, phase_name), evenly paced
        within each phase at 1/rate.  This is the open-loop contract: the
        list is fixed up front and every slot is sent (or recorded late),
        never skipped."""
        out: List[Tuple[float, str]] = []
        off = 0.0
        for p in self.phases:
            if p.rate_qps > 0:
                n = int(p.duration_s * p.rate_qps)
                step = 1.0 / p.rate_qps
                out.extend((off + i * step, p.name) for i in range(n))
            off += p.duration_s
        return out

    @classmethod
    def diurnal(cls, base_qps: float, peak_qps: float, duration_s: float,
                steps: int = 8) -> "PhaseSchedule":
        """Half-sine day: base -> peak -> base over ``duration_s`` in
        ``steps`` constant-rate segments."""
        steps = max(2, steps)
        seg = duration_s / steps
        phases = []
        for i in range(steps):
            frac = math.sin(math.pi * (i + 0.5) / steps)
            rate = base_qps + (peak_qps - base_qps) * frac
            phases.append(Phase(f"diurnal{i}", seg, rate))
        return cls(phases)

    @classmethod
    def ramp_burst(cls, base_qps: float, peak_qps: float, burst_qps: float,
                   warm_s: float, ramp_s: float, burst_s: float,
                   cool_s: float, ramp_steps: int = 3) -> "PhaseSchedule":
        """Warm at base, ramp linearly to peak, hold a correlated burst
        (every client surging together), cool back to base.  The burst
        phase name contains ``burst`` — the SLO attribution layer treats
        it as a first-class excursion cause."""
        phases = [Phase("warm", warm_s, base_qps)]
        ramp_steps = max(1, ramp_steps)
        for i in range(ramp_steps):
            rate = base_qps + (peak_qps - base_qps) * (i + 1) / ramp_steps
            phases.append(Phase(f"ramp{i}", ramp_s / ramp_steps, rate))
        phases.append(Phase("burst", burst_s, burst_qps))
        phases.append(Phase("cool", cool_s, base_qps))
        return cls(phases)


class OpenLoopPacer:
    """Fixed-rate slot dispenser for open-loop load: ``next_slot()``
    returns the *intended* send time (``time.perf_counter`` domain),
    sleeping only when ahead of schedule.  When the caller falls behind
    (a stalled server), slots return immediately with past timestamps —
    the backlog is real and the latency recorded from the intended time
    carries it, which is exactly the coordinated-omission fix."""

    def __init__(self, rate_qps: float, t0: Optional[float] = None):
        if rate_qps <= 0:
            raise ValueError("rate must be positive")
        self.interval_s = 1.0 / rate_qps
        self.t_next = time.perf_counter() if t0 is None else t0

    def next_slot(self) -> float:
        t = self.t_next
        self.t_next = t + self.interval_s
        now = time.perf_counter()
        if t > now:
            time.sleep(t - now)
        return t

    @property
    def lag_s(self) -> float:
        """How far behind schedule the caller currently is."""
        return max(0.0, time.perf_counter() - self.t_next)


class WorkloadRecorder:
    """Per-verb client-side instruments on the shared latency ladder.

    Two histograms per verb, same buckets as the server's
    ``tpums_server_latency_seconds``:

    - ``tpums_client_latency_seconds{verb=}``  done - INTENDED send
      (coordinated-omission-safe; the SLO statistic)
    - ``tpums_client_service_seconds{verb=}``  done - actual send
      (comparable to the fleet-scraped server percentile)

    plus request/error counters and a bounded ring of timestamped error
    samples for event attribution.  Defaults to a PRIVATE registry so a
    rehearsal doesn't pollute the process-global one the fleet scrape of
    an in-process worker would see."""

    def __init__(self, registry: Optional[obs_metrics.MetricsRegistry] = None,
                 max_error_samples: int = 512):
        self.registry = registry or obs_metrics.MetricsRegistry()
        self.max_error_samples = max_error_samples
        self.error_samples: List[dict] = []
        self.error_count = 0
        self._lock = threading.Lock()
        self._instruments: Dict[str, tuple] = {}

    def _for_verb(self, verb: str) -> tuple:
        inst = self._instruments.get(verb)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(verb)
                if inst is None:
                    inst = (
                        self.registry.histogram(CLIENT_LATENCY_HIST,
                                                verb=verb),
                        self.registry.histogram(CLIENT_SERVICE_HIST,
                                                verb=verb),
                        self.registry.counter(CLIENT_REQUESTS, verb=verb),
                        self.registry.counter(CLIENT_ERRORS, verb=verb),
                    )
                    self._instruments[verb] = inst
        return inst

    def record(self, verb: str, intended_t: float, sent_t: float,
               done_t: float, ok: bool, error: Optional[str] = None,
               phase: Optional[str] = None,
               wall_ts: Optional[float] = None) -> None:
        lat_h, svc_h, req_c, err_c = self._for_verb(verb)
        lat_h.observe(max(done_t - intended_t, 0.0))
        svc_h.observe(max(done_t - sent_t, 0.0))
        req_c.inc()
        if not ok:
            err_c.inc()
            with self._lock:
                self.error_count += 1
                if len(self.error_samples) < self.max_error_samples:
                    self.error_samples.append({
                        "ts": time.time() if wall_ts is None else wall_ts,
                        "verb": verb,
                        "phase": phase,
                        "error": error,
                        "latency_s": round(max(done_t - intended_t, 0.0), 6),
                    })

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def verb_stats(self) -> Dict[str, dict]:
        """Per-verb summary off the live instruments: counts, availability,
        and bucketed p50/p99 for both the attributed and service series."""
        out: Dict[str, dict] = {}
        for verb, (lat_h, svc_h, req_c, err_c) in sorted(
                self._instruments.items()):
            n, errs = req_c.value, err_c.value
            stats = {
                "requests": n,
                "errors": errs,
                "availability": round((n - errs) / n, 6) if n else None,
            }
            for prefix, h in (("", lat_h), ("service_", svc_h)):
                for q in (50, 99):
                    v = h.quantile(q)
                    stats[f"{prefix}p{q}_ms"] = (
                        None if math.isnan(v) else round(v * 1e3, 3))
            out[verb] = stats
        return out


class ServingOps:
    """Executes workload verbs against a sharded serving group.

    ``client_factory`` builds one client per worker thread (the elastic/HA
    clients are single-threaded by contract).  ``UPDATE`` is an SGD-style
    factor write: a fresh factor row for a popular user appended to the
    journal every consumer tails — the write half of the paper's
    train->serve->update loop, paced inside the same blend as the reads.

    ``execute`` returns False for a semantic miss (every seeded key must
    resolve) and raises on transport errors; both count as request errors.

    Verbs may carry a tenant tag — ``"GET~abuse"`` — resolved through
    ``client_factories[tag]`` to a per-tag (per-tenant) client, so one
    engine drives a multi-tenant blend and the recorder's per-verb stats
    split by tenant for free.
    """

    VERBS = ("GET", "MGET", "TOPK", "TOPKV", "UPDATE")

    def __init__(self, client_factory: Callable[[], object], keys: ZipfKeys,
                 state: str, journal=None, dim: int = 4,
                 mget_size: int = 4, topk_k: int = 8, topkv_users: int = 2,
                 update_plane=None,
                 client_factories: Optional[Dict[str, Callable]] = None):
        self.client_factory = client_factory
        # tag -> factory for tenant-tagged verbs; "" is the untagged default
        self.client_factories = dict(client_factories or {})
        self.client_factories.setdefault("", client_factory)
        self.keys = keys
        self.state = state
        self.journal = journal
        self.dim = dim
        self.mget_size = mget_size
        self.topk_k = topk_k
        self.topkv_users = topkv_users
        # serve/update_plane.UpdatePlaneClient: when set, UPDATE submits a
        # real rating into the sharded update plane (the co-located SGD
        # workers do the factor math) instead of appending a synthetic
        # factor row straight to the journal
        self.update_plane = update_plane
        self._tl = threading.local()
        self._journal_lock = threading.Lock()

    def _client(self, tag: str = ""):
        clients = getattr(self._tl, "clients", None)
        if clients is None:
            clients = self._tl.clients = {}
        c = clients.get(tag)
        if c is None:
            factory = self.client_factories.get(tag)
            if factory is None:
                raise ValueError(f"no client factory for verb tag {tag!r}")
            c = clients[tag] = factory()
        return c

    def execute(self, verb: str, rng: random.Random) -> bool:
        verb, _, tag = verb.partition("~")
        c = self._client(tag)
        if verb == "GET":
            return c.query_state(
                self.state, f"{self.keys.sample(rng)}-U") is not None
        if verb == "MGET":
            ks = [f"{self.keys.sample(rng)}-U"
                  for _ in range(self.mget_size)]
            return all(v is not None
                       for v in c.query_states(self.state, ks))
        if verb == "TOPK":
            return c.topk(self.state, str(self.keys.sample(rng)),
                          self.topk_k) is not None
        if verb == "TOPKV":
            users = [str(self.keys.sample(rng))
                     for _ in range(self.topkv_users)]
            return all(r is not None for r in
                       c.topk_many(self.state, users, self.topk_k))
        if verb == "UPDATE":
            if self.update_plane is not None:
                # the closed loop for real: a rating routed through the
                # sharded update plane — co-located SGD does the math and
                # publishes the resulting factor rows
                uid = self.keys.sample(rng)
                iid = self.keys.sample(rng)
                self.update_plane.submit(uid, iid, rng.uniform(0.5, 5.0))
                return True
            if self.journal is None:
                raise RuntimeError("UPDATE verb needs a journal or an "
                                   "update plane")
            from ..core import formats as F
            uid = self.keys.sample(rng)
            row = F.format_als_row(
                uid, "U", [rng.gauss(0.0, 1.0) for _ in range(self.dim)])
            with self._journal_lock:
                self.journal.append([row])
            return True
        raise ValueError(f"unknown verb {verb!r}")

    def close_local(self) -> None:
        """Close THIS thread's clients (each engine worker calls it on the
        way out)."""
        clients = getattr(self._tl, "clients", None)
        if clients:
            self._tl.clients = {}
            for c in clients.values():
                try:
                    c.close()
                except Exception:
                    pass


class WorkloadEngine:
    """Open-loop engine: the full op list (intended time, verb, phase) is
    materialized from the schedule up front, then ``threads`` workers
    drain it in order, sleeping only when AHEAD of an op's intended time.
    A slow server never slows the schedule down — late ops execute
    immediately and their latency, measured from the intended time,
    carries the queueing delay.  Phase starts are announced on the obs
    event ring (``workload_phase``) so the SLO layer can attribute
    excursions to bursts."""

    def __init__(self, ops, schedule: PhaseSchedule, mix: VerbMix,
                 recorder: Optional[WorkloadRecorder] = None,
                 threads: int = 4, seed: int = 0, name: str = "workload"):
        self.ops = ops
        self.schedule = schedule
        self.mix = mix
        self.recorder = recorder or WorkloadRecorder()
        self.threads = max(1, threads)
        self.seed = seed
        self.name = name
        self.stop_flag = threading.Event()

    def _build_plan(self) -> List[Tuple[float, str, str]]:
        rng = random.Random(self.seed)
        return [(off, self.mix.choose(rng), phase)
                for off, phase in self.schedule.intended_offsets()]

    def run(self) -> dict:
        plan = self._build_plan()
        scheduled_by_verb: Dict[str, int] = {}
        for _, verb, _ in plan:
            scheduled_by_verb[verb] = scheduled_by_verb.get(verb, 0) + 1
        q: "queue.SimpleQueue" = queue.SimpleQueue()
        for item in plan:
            q.put(item)
        # small lead so workers spawned below don't start behind schedule
        t0 = time.perf_counter() + 0.05
        wall0 = time.time() + 0.05
        max_lag = [0.0] * self.threads
        completed = [0] * self.threads
        ok_count = [0] * self.threads

        def worker(widx: int) -> None:
            rng = random.Random((self.seed << 8) + widx)
            try:
                while not self.stop_flag.is_set():
                    try:
                        off, verb, phase = q.get_nowait()
                    except queue.Empty:
                        break
                    intended = t0 + off
                    now = time.perf_counter()
                    if intended > now:
                        time.sleep(intended - now)
                    else:
                        max_lag[widx] = max(max_lag[widx], now - intended)
                    sent = time.perf_counter()
                    ok, err = True, None
                    try:
                        ok = bool(self.ops.execute(verb, rng))
                        if not ok:
                            err = "miss"
                    except Exception as e:
                        ok, err = False, repr(e)
                    done = time.perf_counter()
                    completed[widx] += 1
                    ok_count[widx] += 1 if ok else 0
                    self.recorder.record(
                        verb, intended, sent, done, ok, error=err,
                        phase=phase, wall_ts=wall0 + (done - t0))
            finally:
                close = getattr(self.ops, "close_local", None)
                if close is not None:
                    close()

        workers = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(self.threads)]
        for w in workers:
            w.start()
        # announce phases at their PLANNED times (the plan is open-loop, so
        # the wall-clock phase windows are known up front)
        phase_windows = []
        for start, end, p in self.schedule.windows():
            target = t0 + start
            while not self.stop_flag.is_set():
                now = time.perf_counter()
                if now >= target:
                    break
                time.sleep(min(0.1, target - now))
            if self.stop_flag.is_set():
                break
            obs_tracing.event("workload_phase", workload=self.name,
                              phase=p.name, rate_qps=p.rate_qps,
                              duration_s=p.duration_s)
            phase_windows.append({
                "name": p.name, "rate_qps": p.rate_qps,
                "t_start": wall0 + start, "t_end": wall0 + end,
            })
        for w in workers:
            w.join()
        dur = time.perf_counter() - t0
        total, n_ok = sum(completed), sum(ok_count)
        return {
            "name": self.name,
            "scheduled": len(plan),
            "scheduled_by_verb": scheduled_by_verb,
            "completed": total,
            "ok": n_ok,
            "errors": total - n_ok,
            "goodput": round(n_ok / len(plan), 6) if plan else None,
            "duration_s": round(dur, 3),
            "planned_duration_s": round(self.schedule.duration_s, 3),
            "achieved_qps": round(total / dur, 1) if dur > 0 else None,
            "max_sched_lag_s": round(max(max_lag), 3) if max_lag else 0.0,
            "threads": self.threads,
            "mix": self.mix.to_dict(),
            "phases": phase_windows,
            "t_start": wall0,
            "t_end": wall0 + dur,
            "verbs": self.recorder.verb_stats(),
        }

    def stop(self) -> None:
        self.stop_flag.set()


# ---------------------------------------------------------------------------
# closed-loop rehearsal
# ---------------------------------------------------------------------------

DEFAULT_VERB_WEIGHTS = {
    "GET": 55.0, "MGET": 15.0, "TOPK": 8.0, "TOPKV": 4.0, "UPDATE": 18.0,
}

# event kinds the rehearsal timeline keeps (everything the SLO layer can
# attribute an excursion to, plus the phases themselves)
_TIMELINE_KINDS = (
    "workload_phase", "rehearsal_kill", "chaos_kill", "chaos_kill_warming",
    "chaos_teardown",
    "elastic_scale_start", "elastic_cutover", "elastic_drained",
    "elastic_scale_abort", "generation_swap", "failover",
    "replica_respawn", "autoscale_decision",
    "rollout_scale_start", "rollout_cutover", "rollout_drained",
    "rollout_scale_abort", "rollout_verified", "rollout_rollback",
    "edge_hedge", "edge_shed", "proxy_reconnect",
)

# query verbs an abusive tenant replays (UPDATE rides the journal/update
# plane, not the admission-controlled query path)
_ABUSE_VERBS = ("GET", "MGET", "TOPK", "TOPKV")
ABUSIVE_TENANT = "abuse"


def _run_subscriber(idx: int, live_group: str, edge: int, state: str,
                    key: str, stop: threading.Event, stats: dict,
                    lock: threading.Lock) -> None:
    """One push subscriber (serve/push.py): hold a ``su=1`` connection
    with a KEY subscription on a hot factor row, drain deltas until
    told to stop.  A dead connection (replica kill, reshard cutover,
    proxy death) reconnects and RESUMEs at the last delivered seq — the
    replay-or-snapshot answer is counted either way, so the stats show
    churn without ever double-counting a delta."""
    from ..serve import registry as reg_mod
    from ..serve.client import QueryClient
    from ..serve.elastic import generation_group
    from ..serve.ha import resolve_shard_endpoints
    from ..serve.sharded import owner_of

    qgroup = reg_mod.qualify_group(live_group)

    def connect():
        if edge > 0:
            from ..serve.edge import EdgeClient
            return EdgeClient(live_group, proto="b2", push=True,
                              timeout_s=10.0)
        topo = reg_mod.resolve_topology(qgroup)
        if topo is None:
            raise ConnectionError(f"no topology for {live_group!r}")
        gen, shards = int(topo["gen"]), int(topo["shards"])
        eps = resolve_shard_endpoints(generation_group(qgroup, gen),
                                      owner_of(key, shards))
        if not eps:
            raise ConnectionError(f"no endpoints for key {key!r}")
        host, port = eps[idx % len(eps)]
        return QueryClient(host=host, port=port, proto="b2", push=True,
                           timeout_s=10.0)

    c = None
    sub = None
    backoff = 0
    while not stop.is_set():
        try:
            if c is None:
                c = connect()
                if sub is None:
                    got = c.subscribe_key(state, key)
                else:
                    got = c.resume_subscription(
                        state, "KEY", key, 0, sub["sub_id"], sub["seq"])
                    with lock:
                        stats["resumes"] += 1
                sub = {"sub_id": got["sub_id"], "seq": got["seq"]}
                backoff = 0
            p = c.next_push(timeout_s=0.25)
            if p is not None:
                sub["seq"] = p[1]
                with lock:
                    stats["pushes"] += 1
        except Exception:
            with lock:
                stats["errors"] += 1
            try:
                if c is not None:
                    c.close()
            except Exception:
                pass
            c = None
            backoff = min(backoff + 1, 10)
            stop.wait(0.05 * backoff)
    try:
        if c is not None:
            c.close()
    except Exception:
        pass


def _seed_journal(base: str, topic: str, users: int, dim: int, seed: int):
    from ..core import formats as F
    from ..serve.journal import Journal

    journal = Journal(os.path.join(base, "bus"), topic)
    rng = random.Random(seed)
    rows = [F.format_als_row(u, "U",
                             [rng.gauss(0.0, 1.0) for _ in range(dim)])
            for u in range(users)]
    rows += [F.format_als_row(i, "I",
                              [rng.gauss(0.0, 1.0) for _ in range(dim)])
             for i in range(users)]
    journal.append(rows)
    return journal


def run_rehearsal(
    out_path: Optional[str] = None,
    shards: int = 2,
    replication: int = 2,
    users: int = 400,
    dim: int = 4,
    base_qps: float = 120.0,
    peak_qps: float = 240.0,
    burst_qps: float = 480.0,
    warm_s: float = 2.0,
    ramp_s: float = 3.0,
    burst_s: float = 4.0,
    cool_s: float = 2.0,
    threads: int = 4,
    seed: int = 0,
    verb_weights: Optional[Dict[str, float]] = None,
    autoscale: str = "off",          # off | dry | live
    kill: bool = False,
    kill_at_s: Optional[float] = None,
    scrape_interval_s: float = 1.0,
    spec=None,
    group: str = "rehearsal",
    attach_group: Optional[str] = None,
    zipf_exponent: float = 1.1,
    update_plane: bool = True,
    abusive_qps: float = 0.0,
    watch: bool = False,
    watch_rules=None,
    watch_canary=None,
    watch_interval_s: float = 0.5,
    edge: int = 0,
    subscribers: int = 0,
    push_p99_ms: float = 250.0,
    device: str = "cuda",
) -> dict:
    """The closed loop: elastic sharded group + open-loop zipfian mixed-verb
    engine + autoscaler + one chaos kill, all acting on the same fleet,
    reported as an SLO artifact (``obs/slo.py``) with every error and
    excursion attributed to a timeline event.

    With ``attach_group`` set, drives load against an already-running
    elastic group instead (no spawn, no kill, no autoscaler) — the
    operator-facing smoke mode.

    With ``abusive_qps > 0`` the blend becomes two-tenant: a second,
    ``~abuse``-tagged replay of the query verbs is layered ON TOP of the
    in-quota schedule (in-quota offered rates are unchanged) and the
    ``abuse`` tenant's admission quota is set to HALF its base offered
    rate (``TPUMS_ADMIT_TENANT_QPS``), so it runs persistently over quota
    while the untagged tenant stays unlimited.  Abusive verbs carry
    objective-free SLO entries — their sheds are attributed
    (``admission_shed``), not breached — and the report's gate becomes
    "in-quota traffic unharmed while the abuser is shed".

    With ``watch=True`` a live ``obs.watch.FleetWatcher`` runs through the
    load window (its own cadence, ``watch_interval_s``; rules default to
    the fleet baseline or ``watch_rules``; an optional ``watch_canary``
    probes live model quality) and the report gains an ``"alerts"``
    section — the live incident timeline with per-kill detection latency
    and attribution, instead of only the terminal SLO post-mortem.

    With ``edge > 0`` that many edge proxies (``serve/edge.py``) are
    spawned in front of the fleet and EVERY client thread becomes an
    ``EdgeClient`` — the full verb mix runs through the proxy tier
    (multiplexing, coalescing, hedging, edge admission), and the SLO
    attribution must still come out clean: ``edge_hedge``/``edge_shed``/
    ``proxy_reconnect`` are timeline events, never unattributed errors.
    In attach mode the proxies must already be registered for the group.

    ``device`` is the spawned members' (``ScaleController(device=...)``),
    ``"cuda"`` by default; without CUDA the caller passes ``"cpu"``.

    With ``subscribers > 0`` that many live push subscriptions
    (``serve/push.py``: KEY subs on the zipf-hot factor rows, through
    the edge tier when ``edge > 0``) ride the whole run, draining
    deltas fed by the UPDATE verb's factor writes.  The report gains a
    ``"push"`` section — subscriber population, deltas delivered,
    resume churn, and the fleet's update→push p99 off
    ``tpums_push_latency_seconds`` — and the overall gate additionally
    requires that p99 under ``push_p99_ms`` with at least one delta
    delivered: push freshness becomes an SLO, not a hope.
    """
    from . import slo as obs_slo
    from .scrape import scrape_fleet
    from ..parallel.mesh import resolve_device
    from ..serve.client import RetryPolicy
    from ..serve.consumer import ALS_STATE

    resolve_device(device)
    if autoscale not in ("off", "dry", "live"):
        raise ValueError("autoscale must be off|dry|live")

    weights = dict(verb_weights or DEFAULT_VERB_WEIGHTS)
    if abusive_qps > 0:
        q_weights = {v: w for v, w in weights.items() if v in _ABUSE_VERBS}
        if not q_weights:
            raise ValueError("abusive tenant needs at least one query verb "
                             "in the mix")
        # layer the abusive replay on top: schedule rates grow by
        # (1 + abusive/base) and the tagged share is sized so the UNTAGGED
        # offered rates match the caller's base/peak/burst exactly while
        # the abuser offers abusive_qps at base (scaling with the plan)
        k = abusive_qps / base_qps
        scale = k * sum(weights.values()) / sum(q_weights.values())
        for v, w in q_weights.items():
            weights[f"{v}~{ABUSIVE_TENANT}"] = w * scale
        base_qps, peak_qps, burst_qps = (
            base_qps * (1 + k), peak_qps * (1 + k), burst_qps * (1 + k))
    mix = VerbMix(weights)
    schedule = PhaseSchedule.ramp_burst(
        base_qps, peak_qps, burst_qps, warm_s, ramp_s, burst_s, cool_s)
    if spec is None:
        spec = obs_slo.SLOSpec(
            list(obs_slo.SLOSpec.default(
                sorted(v for v in mix.weights if "~" not in v)).objectives)
            + [obs_slo.SLOObjective(verb=v, availability=None, p99_ms=None,
                                    burn_rate_max=None, goodput_min=None)
               for v in sorted(mix.weights) if "~" in v])

    saved_env = {k: os.environ.get(k) for k in
                 ("TPUMS_REGISTRY_DIR", "TPUMS_HEARTBEAT_S",
                  "TPUMS_REPLICA_TTL_S", "TPUMS_ADMIT_TENANT_QPS")}
    base = tempfile.mkdtemp(prefix="tpums_rehearsal_")
    ctl = None
    autoscaler = None
    watcher = None
    edge_procs: list = []
    sampler_stop = threading.Event()
    scrapes: List[Tuple[float, dict]] = []

    def sampler() -> None:
        while not sampler_stop.wait(scrape_interval_s):
            try:
                snap = scrape_fleet()
                scrapes.append((time.time(), snap["fleet"]))
            except Exception:
                pass

    try:
        if attach_group is None:
            # fast liveness for a short rehearsal (operator values win)
            if saved_env["TPUMS_HEARTBEAT_S"] is None:
                os.environ["TPUMS_HEARTBEAT_S"] = "0.25"
            if saved_env["TPUMS_REPLICA_TTL_S"] is None:
                os.environ["TPUMS_REPLICA_TTL_S"] = "1.5"
            if saved_env["TPUMS_REGISTRY_DIR"] is None:
                os.environ["TPUMS_REGISTRY_DIR"] = os.path.join(
                    base, "registry")
            if abusive_qps > 0:
                # quota = half the abuser's base offered rate: persistently
                # 2x over quota, so the shedder works for the whole run
                os.environ["TPUMS_ADMIT_TENANT_QPS"] = (
                    f"{ABUSIVE_TENANT}={abusive_qps / 2:g}")
            from ..serve.elastic import (Autoscaler, AutoscalerPolicy,
                                         ScaleController)

            journal = _seed_journal(base, "models", users, dim, seed)
            # real sharded updates: the workers co-host the update plane
            # (serve/update_plane.py) and the UPDATE verb submits ratings
            # into it instead of appending synthetic factor rows
            extra_args = (["--updatePlane", "true",
                           "--pollInterval", "0.02"]
                          if update_plane else [])
            ctl = ScaleController(group, journal.dir, "models",
                                  port_dir=os.path.join(base, "ports"),
                                  ready_timeout_s=180,
                                  extra_args=extra_args, device=device)
            ctl.scale_to(shards, replicas=replication)
            live_group = group
            if edge > 0:
                from ..serve.edge import spawn_edge_procs
                edge_procs, _ = spawn_edge_procs(
                    live_group, edge, os.path.join(base, "edge_ports"))
            if autoscale != "off":
                # trip on the burst, not the ramp: threshold above the
                # per-shard peak rate but below the per-shard burst rate
                policy = AutoscalerPolicy(
                    qps_high_per_shard=(peak_qps / shards) * 1.3,
                    qps_low_per_shard=0.0,       # no scale-in mid-rehearsal
                    p99_high_s=10.0,             # qps-driven, deterministic
                    min_shards=shards,
                    max_shards=shards * 2,
                    cooldown_s=max(burst_s, 5.0),
                )
                autoscaler = Autoscaler(ctl, policy, interval_s=1.0,
                                        dry_run=(autoscale == "dry"))
                autoscaler.start()
        else:
            journal = None
            live_group = attach_group
            kill = False
            autoscale = "off"

        if edge > 0:
            # every worker thread talks to the proxy tier: one thin
            # connection, no shard/generation knowledge client-side
            def client_factory():
                from ..serve.edge import EdgeClient
                return EdgeClient(
                    live_group, timeout_s=10.0,
                    retry=RetryPolicy(attempts=6, backoff_s=0.02,
                                      max_backoff_s=0.5))
        else:
            def client_factory():
                from ..serve.elastic import ElasticClient
                return ElasticClient(
                    live_group, timeout_s=10.0,
                    retry=RetryPolicy(attempts=6, backoff_s=0.02,
                                      max_backoff_s=0.5))

        client_factories = None
        if abusive_qps > 0:
            def abusive_factory():
                # tenant= rides the wire (tab: trailing tn= field; B2:
                # HELLO-bound); sheds come back as "E\tover quota"
                # RuntimeErrors, which the HA client does NOT failover on
                if edge > 0:
                    from ..serve.edge import EdgeClient
                    return EdgeClient(
                        live_group, timeout_s=10.0,
                        retry=RetryPolicy(attempts=6, backoff_s=0.02,
                                          max_backoff_s=0.5),
                        tenant=ABUSIVE_TENANT)
                from ..serve.elastic import ElasticClient
                return ElasticClient(
                    live_group, timeout_s=10.0,
                    retry=RetryPolicy(attempts=6, backoff_s=0.02,
                                      max_backoff_s=0.5),
                    tenant=ABUSIVE_TENANT)
            client_factories = {ABUSIVE_TENANT: abusive_factory}

        upd_client = None
        if update_plane and journal is not None:
            from ..serve.update_plane import UpdatePlaneClient
            upd_client = UpdatePlaneClient(journal.dir, "models")
        zkeys = ZipfKeys(users, zipf_exponent, seed)
        ops = ServingOps(client_factory, zkeys,
                         ALS_STATE, journal=journal, dim=dim,
                         update_plane=upd_client,
                         client_factories=client_factories)
        recorder = WorkloadRecorder()
        engine = WorkloadEngine(ops, schedule, mix, recorder=recorder,
                                threads=threads, seed=seed,
                                name="rehearsal")

        # warm the serving path before the clock starts: the first TOPK
        # per worker builds its device index — inside the open loop that
        # stall would masquerade as a schedule-wide latency excursion no
        # timeline event explains
        warm_rng = random.Random(seed + 1)
        for verb in ("GET", "MGET", "TOPK", "TOPKV"):
            if verb in mix.weights:
                for _ in range(2):
                    try:
                        ops.execute(verb, warm_rng)
                    except Exception:
                        break
        ops.close_local()

        # push subscriber population: live subscriptions on the hottest
        # factor rows, fed by the UPDATE verb's writes for the whole run
        push_stop = threading.Event()
        push_stats = {"pushes": 0, "resumes": 0, "errors": 0}
        push_lock = threading.Lock()
        sub_threads: List[threading.Thread] = []
        if subscribers > 0:
            hot_n = max(1, min(16, users))
            for i in range(subscribers):
                key = f"{zkeys.ids[i % hot_n]}-U"
                t = threading.Thread(
                    target=_run_subscriber,
                    args=(i, live_group, edge, ALS_STATE, key, push_stop,
                          push_stats, push_lock),
                    daemon=True, name=f"tpums-sub-{i}")
                t.start()
                sub_threads.append(t)

        # the SLO timeline starts HERE: the bring-up cutover above is
        # plumbing, not an excursion cause
        t_run_start = time.time()
        # first scrape before load, then a sampling thread through the run
        fleet_before = scrape_fleet()["fleet"]
        scrapes.append((time.time(), fleet_before))
        sampler_t = threading.Thread(target=sampler, daemon=True)
        sampler_t.start()

        if watch:
            from .watch import FleetWatcher
            watcher = FleetWatcher(interval_s=watch_interval_s,
                                   rules=watch_rules,
                                   canary=watch_canary,
                                   scope=live_group).start()

        killer_t = None
        if kill and ctl is not None:
            if kill_at_s is None:
                kill_at_s = warm_s + ramp_s / 2.0
            t_kill = time.time() + kill_at_s

            def killer() -> None:
                while time.time() < t_kill and not sampler_stop.is_set():
                    time.sleep(0.05)
                sup = ctl.active_supervisor
                if sup is None:
                    return
                # last replica of shard 0: with R>=2 failover keeps the
                # shard serving; with R=1 this is a real outage the report
                # must attribute
                victim = (0, replication - 1)
                proc = sup.procs.get(victim)
                if proc is not None and proc.poll() is None:
                    obs_tracing.event("rehearsal_kill", shard=victim[0],
                                      replica=victim[1], pid=proc.pid,
                                      group=sup.group_of(victim[0]))
                    proc.send_signal(signal.SIGKILL)

            killer_t = threading.Thread(target=killer, daemon=True)
            killer_t.start()

        summary = engine.run()

        if killer_t is not None:
            killer_t.join(timeout=10)
        if autoscaler is not None:
            autoscaler.stop()
        # give in-flight deltas a beat to land before stopping the drain
        if sub_threads:
            time.sleep(0.5)
            push_stop.set()
            for t in sub_threads:
                t.join(timeout=10)
        sampler_stop.set()
        sampler_t.join(timeout=10)
        alerts_section = None
        if watcher is not None:
            # one last synchronous tick so a kill in the final moments is
            # still observed before the loop stops
            try:
                watcher.tick()
            except Exception:
                pass
            watcher.stop()
            alerts_section = watcher.watch_summary()
            alerts_section["transitions"] = list(watcher.engine.history)
        fleet_after = scrape_fleet()["fleet"]
        scrapes.append((time.time(), fleet_after))

        # the autoscaler announces its own acted-on decisions via
        # events_counter("autoscale_decision"), so the ring has everything
        timeline = sorted(
            (e for e in obs_tracing.recent_events()
             if e.get("ts", 0) >= t_run_start
             and e.get("kind") in _TIMELINE_KINDS),
            key=lambda e: e.get("ts", 0))

        report = obs_slo.build_report(
            spec=spec,
            workload=summary,
            recorder=recorder,
            fleet_before=fleet_before,
            fleet_after=fleet_after,
            fleet_samples=scrapes,
            timeline=timeline,
            meta={
                "mode": "attach" if attach_group else "spawn",
                "group": live_group,
                "shards": shards,
                "replication": replication,
                "autoscale": autoscale,
                "kill": bool(kill),
                "users": users,
                "zipf_exponent": zipf_exponent,
                "seed": seed,
                "abusive_qps": abusive_qps,
                "edge": edge,
                "subscribers": subscribers,
            },
        )
        if alerts_section is not None:
            report["alerts"] = alerts_section
        if subscribers > 0:
            # push freshness as an SLO: the fleet's own update→push
            # ladder (tpums_push_latency_seconds) must hold its p99
            # under budget AND at least one delta must have actually
            # reached a subscriber — a silent push plane with a vacuous
            # histogram does not pass.  Folded over the sampler's scrape
            # SERIES, not the endpoint pair: an autoscaler cutover or a
            # chaos kill mid-run replaces the worker processes whose
            # counters held the window, and the endpoint difference
            # would read a healthy plane as a silent one (push_freshness
            # is reset-aware pair by pair).
            from .scrape import fleet_signals, push_freshness
            sig = fleet_signals(fleet_before, fleet_after)
            fresh = push_freshness(scrapes)
            p99_s = fresh["p99_s"]
            with push_lock:
                delivered = push_stats["pushes"]
                resumes = push_stats["resumes"]
                sub_errors = push_stats["errors"]
            fresh_ok = bool(delivered > 0 and p99_s is not None
                            and p99_s * 1e3 <= push_p99_ms)
            report["push"] = {
                "subscribers": subscribers,
                "pushes_received": delivered,
                "resumes": resumes,
                "subscriber_errors": sub_errors,
                "subs_active": sig.get("push_subs_active"),
                "deltas_per_s": (fresh["deltas"] / fresh["dt_s"]
                                 if fresh["dt_s"] > 0 else 0.0),
                "p99_ms": (round(p99_s * 1e3, 3)
                           if p99_s is not None else None),
                "p99_budget_ms": push_p99_ms,
                "fresh_ok": fresh_ok,
            }
            report["ok"] = bool(report["ok"] and fresh_ok)
        if out_path:
            with open(out_path, "w") as f:
                json.dump(report, f, indent=1, default=str)
                f.write("\n")
            report["report_path"] = os.path.abspath(out_path)
        return report
    finally:
        sampler_stop.set()
        if watcher is not None:
            try:
                watcher.stop()
            except Exception:
                pass
        if autoscaler is not None:
            try:
                autoscaler.stop()
            except Exception:
                pass
        if edge_procs:
            try:
                from ..serve.edge import stop_edge_procs
                stop_edge_procs(edge_procs)
            except Exception:
                pass
        if ctl is not None:
            try:
                ctl.stop(drop_topology=True)
            except Exception:
                pass
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        import shutil
        shutil.rmtree(base, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    from . import slo as obs_slo
    from ..core.params import Params

    params = Params.from_args(sys.argv[1:] if argv is None else argv)
    if not (params.has("rehearsal") or params.has("group")):
        print(__doc__)
        return 2
    weights = (VerbMix.from_string(params.get("mix")).to_dict()
               if params.has("mix") else None)
    duration = float(params.get("durationS", "12"))
    # split the duration 2:3:4:3 across warm/ramp/burst/cool
    report = run_rehearsal(
        out_path=params.get("out", "SLO_REPORT.json"),
        shards=params.get_int("shards", 2),
        replication=params.get_int("replication", 2),
        users=params.get_int("users", 400),
        base_qps=float(params.get("baseQps", "120")),
        peak_qps=float(params.get("peakQps", "240")),
        burst_qps=float(params.get("burstQps", "480")),
        warm_s=duration * 2 / 12, ramp_s=duration * 3 / 12,
        burst_s=duration * 4 / 12, cool_s=duration * 3 / 12,
        threads=params.get_int("threads", 4),
        seed=params.get_int("seed", 0),
        verb_weights=weights,
        autoscale=params.get("autoscale", "live"),
        kill=params.get_int("kill", 1) != 0,
        group=params.get("newGroup", "rehearsal"),
        attach_group=params.get("group", None),
        zipf_exponent=float(params.get("zipf", "1.1")),
        abusive_qps=float(params.get("abusiveQps", "0")),
        watch=params.get_int("watch", 0) != 0,
        edge=params.get_int("edge", 0),
        subscribers=params.get_int("subscribers", 0),
        push_p99_ms=float(params.get("pushP99Ms", "250")),
        device=params.get("device", "cuda"),
    )
    sys.stderr.write(obs_slo.human_summary(report) + "\n")
    out = {
        "ok": report["ok"],
        "report": report.get("report_path"),
        "verbs": {v: {"availability": s["availability"],
                      "p99_ms": s["p99_ms"]}
                  for v, s in report["verbs"].items()},
        "breaches": len(report["breaches"]),
        "unattributed_errors": report["errors"]["unattributed"],
    }
    if "alerts" in report:
        out["alerts"] = {k: report["alerts"][k] for k in
                         ("fired_total", "unattributed_page", "detection")}
    if "push" in report:
        out["push"] = {k: report["push"][k] for k in
                       ("pushes_received", "p99_ms", "fresh_ok")}
    print(json.dumps(out, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
