"""Declarative SLOs + error-budget accounting over the fleet scrape.

Own copy of ``flink_ms_tpu/obs/slo.py``, whole: the same objectives,
burn-rate math, attribution and ``tpums.slo_report/1`` schema, so one
snapshot timeline gives the same report JSON and summary text in either
package.  The port's workload engine (``obs/workload.py``) produces the
client-side histograms; ``build_report`` takes any recorder with its
duck-typed surface.

The serving plane already exposes one shared latency ladder
(``metrics.LATENCY_BUCKETS_S``) from both ends: the workload engine's
client-side histograms (``obs/workload.py``) and every worker's
``tpums_server_latency_seconds`` reached through the fleet scrape.  This
module turns those raw series into the artifact an operator gates a
deploy on:

- ``SLOObjective`` / ``SLOSpec``   per-verb targets: availability, p99
  latency, max error-budget burn rate, goodput under shed.
- ``burn_rate``                    error-budget math: observed error rate
  over the budget (1 - availability target); 1.0 = burning exactly the
  budget, 14.4 = the classic "page now" multi-window threshold.
- ``verb_windows``                 per-verb request/error/latency deltas
  between two fleet merges (``diff_snapshots`` semantics, verb-labelled).
- ``build_report``                 the ``SLOReport`` JSON: per-verb
  measurements vs objectives, windowed burn rates over the scrape
  samples, a timeline, and attribution — every error sample and every
  breached objective is matched to the event that explains it (chaos
  kill, elastic cutover, correlated burst, failover); what cannot be
  matched is surfaced as ``unattributed``.
- ``human_summary`` / ``validate_report``  operator text + schema check.

The report's ``p99_ms`` is the coordinated-omission-safe client statistic
(latency from *intended* send); ``service_p99_ms`` (actual send -> reply)
is the series comparable to the fleet-scraped server percentile, and the
report carries the bucket-index distance between the two
(``p99_bucket_delta``; 0 or 1 = client and fleet agree within one bucket
of the shared ladder).
"""

from __future__ import annotations

import bisect
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics as obs_metrics

__all__ = [
    "SLOObjective", "SLOSpec", "burn_rate", "verb_windows", "bucket_index",
    "build_report", "human_summary", "validate_report", "SCHEMA",
]

SCHEMA = "tpums.slo_report/1"

# client verb -> the server-side verb label its wire traffic lands on
# (client TOPK/TOPKV resolve factors via MGET then stream TOPKV; UPDATE is
# a journal write — no server query verb at all)
CLIENT_TO_SERVER_VERB: Dict[str, Optional[str]] = {
    "GET": "GET", "MGET": "MGET", "TOPK": "TOPKV", "TOPKV": "TOPKV",
    "UPDATE": None,
}

# event kinds that can legitimately explain an excursion
DISRUPTIVE_KINDS = frozenset({
    "rehearsal_kill", "chaos_kill", "chaos_kill_warming",
    # control-plane kill (the autopilot chaos arm): attributable like any
    # kill, but deliberately NOT in watch.KILL_KINDS — the contract under
    # test is that killing the controller must NOT page, so detection
    # latency is meaningless for it
    "chaos_kill_controller",
    "chaos_teardown",
    "elastic_scale_start", "elastic_cutover", "elastic_drained",
    "elastic_scale_abort", "generation_swap", "failover",
    "replica_respawn", "autoscale_decision",
    # model rollout protocol (serve/rollout.py — the elastic cutover
    # kinds under the rollout controller's event prefix)
    "rollout_scale_start", "rollout_cutover", "rollout_drained",
    "rollout_scale_abort", "rollout_verified", "rollout_rollback",
    # edge proxy tier (serve/edge.py): a fired hedge, an edge-side
    # admission shed and a client rotating to a surviving proxy are all
    # deliberate tail/failure management — attributable, never paged as
    # unexplained
    "edge_hedge", "edge_shed", "proxy_reconnect",
})

DEFAULT_ATTRIBUTION_WINDOW_S = 5.0

# an admission-shed request errors with this marker in the reply
# (serve/admission.py SHED_REPLY — string-matched here rather than
# imported so the obs layer stays importable without the serving stack).
# Sheds attribute to a synthetic ``admission_shed`` cause: deliberate
# policy, never an unexplained failure.
ADMISSION_SHED_MARKER = "over quota"


@dataclass(frozen=True)
class SLOObjective:
    """Targets for one verb; ``None`` disables that dimension."""
    verb: str
    availability: Optional[float] = 0.999
    p99_ms: Optional[float] = None
    burn_rate_max: Optional[float] = None
    goodput_min: Optional[float] = None

    def to_dict(self) -> dict:
        return {"verb": self.verb, "availability": self.availability,
                "p99_ms": self.p99_ms, "burn_rate_max": self.burn_rate_max,
                "goodput_min": self.goodput_min}

    @classmethod
    def from_dict(cls, d: dict) -> "SLOObjective":
        return cls(verb=d["verb"],
                   availability=d.get("availability"),
                   p99_ms=d.get("p99_ms"),
                   burn_rate_max=d.get("burn_rate_max"),
                   goodput_min=d.get("goodput_min"))


class SLOSpec:
    """A set of per-verb objectives."""

    def __init__(self, objectives: Sequence[SLOObjective]):
        self.objectives = tuple(objectives)
        self._by_verb = {o.verb: o for o in self.objectives}

    def for_verb(self, verb: str) -> Optional[SLOObjective]:
        return self._by_verb.get(verb)

    def to_dict(self) -> dict:
        return {"objectives": [o.to_dict() for o in self.objectives]}

    @classmethod
    def from_dict(cls, d: dict) -> "SLOSpec":
        return cls([SLOObjective.from_dict(o)
                    for o in d.get("objectives", [])])

    # per-verb defaults: point reads are held tight, fan-out scoring gets
    # a looser latency budget, writes are availability-only (their latency
    # is a local journal append)
    _DEFAULTS = {
        "GET": dict(availability=0.999, p99_ms=50.0, burn_rate_max=2.0,
                    goodput_min=0.99),
        "MGET": dict(availability=0.999, p99_ms=75.0, burn_rate_max=2.0,
                     goodput_min=0.99),
        "TOPK": dict(availability=0.995, p99_ms=250.0, burn_rate_max=2.0,
                     goodput_min=0.99),
        "TOPKV": dict(availability=0.995, p99_ms=250.0, burn_rate_max=2.0,
                      goodput_min=0.99),
        "UPDATE": dict(availability=0.999, p99_ms=None, burn_rate_max=2.0,
                       goodput_min=0.99),
    }

    @classmethod
    def default(cls, verbs: Sequence[str]) -> "SLOSpec":
        return cls([SLOObjective(verb=v, **cls._DEFAULTS.get(
            v, dict(availability=0.999, p99_ms=None,
                    burn_rate_max=2.0, goodput_min=0.99)))
            for v in verbs])


def burn_rate(requests: float, errors: float,
              availability_target: Optional[float]) -> Optional[float]:
    """Observed error rate as a multiple of the error budget: 1.0 burns
    the budget exactly at target pace; >1 exhausts it early."""
    if not requests or availability_target is None:
        return None
    budget = 1.0 - availability_target
    if budget <= 0:
        return None
    return (errors / requests) / budget


def bucket_index(v_s: Optional[float],
                 bounds: Sequence[float] = obs_metrics.LATENCY_BUCKETS_S
                 ) -> Optional[int]:
    """Which ladder bucket a latency falls in (None for missing/nan)."""
    if v_s is None or (isinstance(v_s, float) and math.isnan(v_s)):
        return None
    return bisect.bisect_left(list(bounds), v_s)


def _series_by_verb(snapshot: dict, kind: str, name: str) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for e in snapshot.get(kind, []):
        if e["name"] == name:
            verb = e.get("labels", {}).get("verb")
            if verb is not None:
                out[verb] = e
    return out


def verb_windows(before: dict, after: dict,
                 hist_name: str = "tpums_server_latency_seconds",
                 errors_name: str = "tpums_server_errors_total"
                 ) -> Dict[str, dict]:
    """Per-verb deltas between two fleet merges::

        {verb: {"requests", "errors", "hist": delta-hist-entry|None}}

    ``requests`` comes off the latency histogram's count (every request
    observes exactly once — same invariant ``synthesize_requests`` uses);
    ``hist`` is the bucket-wise delta, quantile-able via
    ``snapshot_quantile``."""
    b_h = _series_by_verb(before, "histograms", hist_name)
    a_h = _series_by_verb(after, "histograms", hist_name)
    b_e = _series_by_verb(before, "counters", errors_name)
    a_e = _series_by_verb(after, "counters", errors_name)
    out: Dict[str, dict] = {}
    for verb, h in a_h.items():
        prev = b_h.get(verb, {"counts": [0] * len(h["counts"]),
                              "count": 0, "sum": 0.0})
        dc = h["count"] - prev["count"]
        hist = None
        if dc > 0:
            hist = {"name": h["name"], "labels": dict(h.get("labels", {})),
                    "le": list(h["le"]),
                    "counts": [a - b for a, b in
                               zip(h["counts"], prev["counts"])],
                    "count": dc, "sum": h["sum"] - prev["sum"]}
        errs = (a_e.get(verb, {}).get("value", 0)
                - b_e.get(verb, {}).get("value", 0))
        if dc > 0 or errs:
            out[verb] = {"requests": max(dc, 0), "errors": max(errs, 0),
                         "hist": hist}
    return out


def _attribute_time(ts: float, timeline: Sequence[dict],
                    phases: Sequence[dict],
                    window_s: float) -> Optional[dict]:
    """The event that explains an excursion at wall time ``ts``: the
    nearest disruptive timeline event within +/- ``window_s`` (an error
    can precede its cutover/recovery event, so the window is symmetric),
    else the burst phase covering ``ts``."""
    best, best_dt = None, None
    for e in timeline:
        if e.get("kind") not in DISRUPTIVE_KINDS:
            continue
        dt = abs(ts - e.get("ts", 0.0))
        if dt <= window_s and (best_dt is None or dt < best_dt):
            best, best_dt = e, dt
    if best is not None:
        return {"kind": best["kind"], "ts": best.get("ts"),
                "dt_s": round(best_dt, 3)}
    for p in phases:
        if "burst" in p.get("name", "") and \
                p.get("t_start", 0) - window_s <= ts <= \
                p.get("t_end", 0) + window_s:
            return {"kind": "workload_phase", "phase": p["name"],
                    "ts": p.get("t_start"), "dt_s": 0.0}
    return None


def _client_verb_series(recorder_snapshot: dict) -> Dict[str, dict]:
    lat = _series_by_verb(recorder_snapshot, "histograms",
                          "tpums_client_latency_seconds")
    svc = _series_by_verb(recorder_snapshot, "histograms",
                          "tpums_client_service_seconds")
    req = _series_by_verb(recorder_snapshot, "counters",
                          "tpums_client_requests_total")
    err = _series_by_verb(recorder_snapshot, "counters",
                          "tpums_client_errors_total")
    out: Dict[str, dict] = {}
    for verb in sorted(set(lat) | set(req)):
        out[verb] = {
            "latency": lat.get(verb),
            "service": svc.get(verb),
            "requests": req.get(verb, {}).get("value", 0),
            "errors": err.get(verb, {}).get("value", 0),
        }
    return out


def _q_ms(hist_entry: Optional[dict], q: float) -> Optional[float]:
    if not hist_entry or not hist_entry.get("count"):
        return None
    v = obs_metrics.snapshot_quantile(hist_entry, q)
    return None if math.isnan(v) else round(v * 1e3, 3)


def build_report(
    spec: SLOSpec,
    workload: dict,
    recorder,
    fleet_before: dict,
    fleet_after: dict,
    fleet_samples: Sequence[Tuple[float, dict]] = (),
    timeline: Sequence[dict] = (),
    meta: Optional[dict] = None,
    attribution_window_s: float = DEFAULT_ATTRIBUTION_WINDOW_S,
) -> dict:
    """Assemble the ``SLOReport`` artifact.

    ``workload`` is a ``WorkloadEngine.run()`` summary; ``recorder`` any
    object with ``snapshot()`` plus ``error_samples``/``error_count``
    (duck-typed so tests can fake it); ``fleet_samples`` the periodic
    ``(wall_ts, fleet-merge)`` scrapes the windowed burn rates come from.
    """
    phases = workload.get("phases", [])
    timeline = list(timeline)
    client = _client_verb_series(recorder.snapshot())
    server = verb_windows(fleet_before, fleet_after)

    # windowed burn: per consecutive scrape pair, per server verb
    window_burns: List[dict] = []
    samples = list(fleet_samples)
    for (t_a, snap_a), (t_b, snap_b) in zip(samples, samples[1:]):
        for verb, w in verb_windows(snap_a, snap_b).items():
            obj = spec.for_verb(verb)
            target = obj.availability if obj else 0.999
            br = burn_rate(w["requests"], w["errors"], target)
            if br is not None:
                window_burns.append({"verb": verb, "t_start": t_a,
                                     "t_end": t_b, "requests":
                                     w["requests"], "errors": w["errors"],
                                     "burn_rate": round(br, 3)})

    scheduled_by_verb = workload.get("scheduled_by_verb", {})
    verbs: Dict[str, dict] = {}
    breaches: List[dict] = []
    for verb in sorted(client):
        c = client[verb]
        obj = spec.for_verb(verb)
        n, errs = c["requests"], c["errors"]
        availability = round((n - errs) / n, 6) if n else None
        p99_ms = _q_ms(c["latency"], 99)
        service_p99_ms = _q_ms(c["service"], 99)
        server_verb = CLIENT_TO_SERVER_VERB.get(verb, verb)
        srv = server.get(server_verb) if server_verb else None
        fleet_p99_ms = _q_ms(srv["hist"], 99) if srv else None
        ci = bucket_index(service_p99_ms / 1e3
                          if service_p99_ms is not None else None)
        fi = bucket_index(fleet_p99_ms / 1e3
                          if fleet_p99_ms is not None else None)
        bucket_delta = (abs(ci - fi)
                        if ci is not None and fi is not None else None)
        scheduled = scheduled_by_verb.get(verb, n)
        goodput = round((n - errs) / scheduled, 6) if scheduled else None
        overall_burn = burn_rate(
            n, errs, obj.availability if obj else 0.999)
        peak = max((w["burn_rate"] for w in window_burns
                    if w["verb"] == server_verb), default=None)
        entry = {
            "requests": n,
            "errors": errs,
            "availability": availability,
            "p99_ms": p99_ms,                      # from INTENDED send
            "p50_ms": _q_ms(c["latency"], 50),
            "service_p99_ms": service_p99_ms,      # from actual send
            "server_verb": server_verb,
            "fleet_requests": srv["requests"] if srv else None,
            "fleet_errors": srv["errors"] if srv else None,
            "fleet_p99_ms": fleet_p99_ms,
            "p99_bucket_delta": bucket_delta,
            "p99_bucket_agreement": (bucket_delta <= 1
                                     if bucket_delta is not None else None),
            "goodput": goodput,
            "burn_rate": (round(overall_burn, 3)
                          if overall_burn is not None else None),
            "burn_peak": peak,
            "objectives": {},
        }
        checks = []
        if obj is not None:
            if obj.availability is not None:
                checks.append(("availability", availability,
                               obj.availability,
                               availability is None
                               or availability >= obj.availability))
            if obj.p99_ms is not None:
                checks.append(("p99_ms", p99_ms, obj.p99_ms,
                               p99_ms is None or p99_ms <= obj.p99_ms))
            if obj.burn_rate_max is not None:
                measured = entry["burn_rate"]
                checks.append(("burn_rate", measured, obj.burn_rate_max,
                               measured is None
                               or measured <= obj.burn_rate_max))
            if obj.goodput_min is not None:
                checks.append(("goodput", goodput, obj.goodput_min,
                               goodput is None or goodput >= obj.goodput_min))
        verb_ok = True
        for name, measured, target, ok in checks:
            entry["objectives"][name] = {
                "target": target, "measured": measured, "ok": ok}
            if not ok:
                verb_ok = False
                # pick the moment that best explains the breach: the worst
                # burn window for rate/availability breaches, else the
                # run's midpoint (latency breaches are excursions whose
                # cause sits somewhere inside the run)
                worst = max((w for w in window_burns
                             if w["verb"] == server_verb),
                            key=lambda w: w["burn_rate"], default=None)
                at = (worst["t_end"] if worst and name in
                      ("availability", "burn_rate", "goodput")
                      else (workload.get("t_start", 0)
                            + workload.get("t_end", 0)) / 2)
                breaches.append({
                    "verb": verb, "objective": name,
                    "measured": measured, "target": target,
                    "attributed_to": _attribute_time(
                        at, timeline, phases, attribution_window_s),
                })
        entry["ok"] = verb_ok
        verbs[verb] = entry

    # per-error attribution
    attributed = 0
    error_samples_out = []
    for s in getattr(recorder, "error_samples", []):
        if ADMISSION_SHED_MARKER in str(s.get("error") or ""):
            # shed by admission control: the cause is the policy itself,
            # not any timeline event — an over-quota tenant being bounced
            # is the system WORKING, and must never read as unattributed
            cause = {"kind": "admission_shed"}
        else:
            cause = _attribute_time(s.get("ts", 0.0), timeline, phases,
                                    attribution_window_s)
        if cause is not None:
            attributed += 1
        error_samples_out.append(dict(s, attributed_to=cause))
    total_errors = getattr(recorder, "error_count", len(error_samples_out))
    sampled = len(error_samples_out)
    # errors beyond the sample cap inherit the sampled attribution ratio
    # conservatively: they count as unattributed unless every sample was
    # attributed
    if sampled and attributed == sampled:
        unattributed = 0
    elif sampled:
        unattributed = total_errors - attributed
    else:
        unattributed = total_errors

    report = {
        "schema": SCHEMA,
        "ts": time.time(),
        "meta": dict(meta or {}),
        "spec": spec.to_dict(),
        "workload": {k: v for k, v in workload.items() if k != "verbs"},
        "verbs": verbs,
        "window_burns": window_burns,
        "timeline": timeline,
        "breaches": breaches,
        "errors": {
            "total": total_errors,
            "sampled": sampled,
            "attributed": attributed,
            "unattributed": unattributed,
            "samples": error_samples_out,
        },
        "ok": (all(v["ok"] for v in verbs.values()) if verbs else False)
        and unattributed == 0,
    }
    return report


def human_summary(report: dict) -> str:
    """Operator-facing text rendering of an ``SLOReport``."""
    lines = []
    meta = report.get("meta", {})
    wl = report.get("workload", {})
    lines.append(
        f"SLO report — {'PASS' if report.get('ok') else 'FAIL'}"
        f" ({meta.get('mode', '?')} mode, shards={meta.get('shards')},"
        f" autoscale={meta.get('autoscale')}, kill={meta.get('kill')})")
    lines.append(
        f"  workload: {wl.get('completed')}/{wl.get('scheduled')} ops in "
        f"{wl.get('duration_s')}s ({wl.get('achieved_qps')} qps, "
        f"max sched lag {wl.get('max_sched_lag_s')}s)")
    header = (f"  {'verb':<7} {'reqs':>7} {'avail':>8} {'p99':>9} "
              f"{'fleet p99':>10} {'burn':>6} {'ok':>4}")
    lines.append(header)
    for verb, v in report.get("verbs", {}).items():
        avail = v.get("availability")
        p99 = v.get("p99_ms")
        fp99 = v.get("fleet_p99_ms")
        burn = v.get("burn_rate")
        lines.append(
            f"  {verb:<7} {v.get('requests', 0):>7} "
            f"{avail if avail is not None else '-':>8} "
            f"{(str(p99) + 'ms') if p99 is not None else '-':>9} "
            f"{(str(fp99) + 'ms') if fp99 is not None else '-':>10} "
            f"{burn if burn is not None else '-':>6} "
            f"{'yes' if v.get('ok') else 'NO':>4}")
    errs = report.get("errors", {})
    lines.append(f"  errors: {errs.get('total', 0)} total, "
                 f"{errs.get('attributed', 0)} attributed, "
                 f"{errs.get('unattributed', 0)} unattributed")
    for b in report.get("breaches", []):
        cause = b.get("attributed_to")
        cause_s = (f"{cause['kind']}"
                   + (f"/{cause.get('phase')}" if cause and
                      cause.get("phase") else "")
                   if cause else "UNATTRIBUTED")
        lines.append(
            f"  breach: {b['verb']}.{b['objective']} measured="
            f"{b['measured']} target={b['target']} -> {cause_s}")
    kills = sum(1 for e in report.get("timeline", [])
                if "kill" in e.get("kind", ""))
    cuts = sum(1 for e in report.get("timeline", [])
               if e.get("kind") == "elastic_cutover")
    lines.append(f"  timeline: {len(report.get('timeline', []))} events "
                 f"({kills} kills, {cuts} cutovers)")
    return "\n".join(lines)


def validate_report(report: dict) -> List[str]:
    """Schema check -> list of problems (empty = valid).  Used by the
    tier-1 smoke test and CI gating, so it validates structure, not
    pass/fail."""
    problems: List[str] = []
    if not isinstance(report, dict):
        return ["report is not a dict"]
    if report.get("schema") != SCHEMA:
        problems.append(f"schema != {SCHEMA!r}")
    for key in ("ts", "spec", "workload", "verbs", "timeline", "breaches",
                "errors", "ok"):
        if key not in report:
            problems.append(f"missing key {key!r}")
    verbs = report.get("verbs")
    if not isinstance(verbs, dict) or not verbs:
        problems.append("verbs empty or not a dict")
    else:
        for verb, v in verbs.items():
            for key in ("requests", "errors", "availability", "p99_ms",
                        "service_p99_ms", "fleet_p99_ms",
                        "p99_bucket_agreement", "burn_rate", "objectives",
                        "ok"):
                if key not in v:
                    problems.append(f"verbs[{verb!r}] missing {key!r}")
    errs = report.get("errors")
    if not isinstance(errs, dict):
        problems.append("errors not a dict")
    else:
        for key in ("total", "attributed", "unattributed", "samples"):
            if key not in errs:
                problems.append(f"errors missing {key!r}")
    for i, b in enumerate(report.get("breaches", [])):
        for key in ("verb", "objective", "measured", "target",
                    "attributed_to"):
            if key not in b:
                problems.append(f"breaches[{i}] missing {key!r}")
    return problems
