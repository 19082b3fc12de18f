"""Fleet scrape: walk the job registry, pull every live replica's METRICS
snapshot, and aggregate per shard and fleet-wide; and the autoscaler's
inputs from two fleet snapshots.

Own copy of the subset of ``flink_ms_tpu/obs/scrape.py`` that the elastic
plane's autoscaler reads (``serve/elastic.py`` ``Autoscaler.run_once``):
``scrape_endpoint``, ``scrape_fleet`` (one ``METRICS`` round trip per
live registry entry on a small thread pool, merged with
``metrics.merge_snapshots`` per ``replica_of`` shard group and fleet-wide)
and ``fleet_signals``, whole.  ``fleet_signals`` reads every series the
reference reads; a series that no module of the port publishes (alert,
recall, arena, edge, autopilot, profiler gauges) reads as the reference
reads it when the series is absent: zero, or None, and the alert fields
fall back to the registry's published alert record.  ``push_freshness``
(the reset-aware update->push freshness over a series of scrapes), the CLI
(``--prom``, ``--raw``) and ``scrape_fleet_profiles`` (one ``PROFILE``
round trip per live entry, merged with ``profiler.merge_profiles``: Python
sample seconds and the native server's per-verb ``native;<verb>``
self-time in one profile) are the reference's.

CLI::

    python -m flink_ms_tpu_torch.obs.scrape            # aggregated JSON
    python -m flink_ms_tpu_torch.obs.scrape --prom     # Prometheus text
    python -m flink_ms_tpu_torch.obs.scrape --raw      # per-replica snapshots
"""

from __future__ import annotations

import json
import socket
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from ..serve import registry
from .metrics import (LATENCY_BUCKETS_S, merge_snapshots, render_prometheus,
                      snapshot_quantile)
from .profiler import merge_profiles, scrape_profile

__all__ = ["scrape_endpoint", "scrape_fleet", "fleet_signals",
           "scrape_fleet_profiles", "push_freshness", "snapshot_quantile",
           "main"]

# scrape fan-out width: enough that one wedged endpoint can't stretch the
# scrape past ~one timeout even on a wide fleet, small enough that a
# watch tick doesn't spawn a thread herd
_SCRAPE_POOL_MAX = 16

def scrape_endpoint(host: str, port: int, timeout_s: float = 2.0
                    ) -> Optional[dict]:
    """One METRICS round-trip -> parsed snapshot dict, or None when the
    endpoint is unreachable or doesn't speak the verb.  Both planes speak
    it: the C++ native server exports per-verb series on the
    same bucket ladder, tagged ``meta.plane = "native"``."""
    host = host or "localhost"
    if host == "0.0.0.0":
        host = "localhost"
    try:
        with socket.create_connection((host, int(port)),
                                      timeout=timeout_s) as sock:
            sock.sendall(b"METRICS\n")
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = sock.recv(1 << 16)
                if not chunk:
                    break
                buf += chunk
    except OSError:
        return None
    line = buf.decode("utf-8", "replace").strip()
    if not line.startswith("J\t"):
        return None
    try:
        snap = json.loads(line[2:])
    except ValueError:
        return None
    return snap if isinstance(snap, dict) else None


def scrape_fleet(timeout_s: float = 2.0) -> dict:
    """Scrape every live registry entry CONCURRENTLY and aggregate.

    Returns::

        {"replicas":  [{"job_id", "shard_group", "replica", "ready",
                        "host", "port", "snapshot"|None,
                        "stale", "scrape_s"}, ...],
         "per_shard": {shard_group: merged-snapshot, ...},
         "fleet":     merged-snapshot,
         "scraped": N, "unreachable": M,
         "scrape_duration_s": wall seconds for the whole fan-out}

    Replica polls run on a small thread pool with the per-endpoint
    ``timeout_s``, so one dead or wedged replica costs the scrape ONE
    timeout instead of serially stalling the cadence behind it; a replica
    that failed to answer carries ``stale: True`` (its last-known state
    may still exist in a retained store) and ``scrape_s`` records its
    individual round-trip.

    ``shard_group`` falls back to the job_id for unsharded jobs, so a
    single standalone worker still aggregates sanely.

    Native-plane snapshots (``meta.plane == "native"``) are REQUIRED to
    carry the shared latency ladder: ``merge_snapshots`` silently skips a
    histogram whose bounds disagree, which for a native worker would mean
    the autoscaler's p99 quietly loses a whole plane's traffic — that is a
    build-skew bug, so it raises here instead of degrading.
    """
    t_start = time.time()
    entries = registry.list_jobs()
    expected_le = list(LATENCY_BUCKETS_S)

    def poll(entry: dict) -> tuple:
        t0 = time.time()
        snap = scrape_endpoint(entry.get("host", "localhost"),
                               entry["port"], timeout_s=timeout_s)
        return snap, time.time() - t0

    if entries:
        with ThreadPoolExecutor(
                max_workers=min(len(entries), _SCRAPE_POOL_MAX),
                thread_name_prefix="tpums-scrape") as pool:
            polled = list(pool.map(poll, entries))
    else:
        polled = []

    replicas: List[dict] = []
    per_group: Dict[str, List[dict]] = {}
    unreachable = 0
    for entry, (snap, scrape_s) in zip(entries, polled):
        if snap is not None and (
                snap.get("meta", {}).get("plane") == "native"):
            for h in snap.get("histograms", []):
                if (h.get("name") == "tpums_server_latency_seconds"
                        and list(h.get("le", [])) != expected_le):
                    raise ValueError(
                        f"native worker {entry.get('job_id')!r} "
                        f"({entry.get('host')}:{entry.get('port')}) exports "
                        "tpums_server_latency_seconds with foreign bucket "
                        "bounds — native/Python build skew; rebuild "
                        "libtpums.so against this obs/metrics.py")
        group = entry.get("replica_of") or entry.get("job_id", "?")
        replicas.append({
            "job_id": entry.get("job_id"),
            "shard_group": group,
            "replica": entry.get("replica"),
            "ready": entry.get("ready"),
            "host": entry.get("host"),
            "port": entry.get("port"),
            "snapshot": snap,
            "stale": snap is None,
            "scrape_s": round(scrape_s, 6),
        })
        if snap is None:
            unreachable += 1
        else:
            per_group.setdefault(group, []).append(snap)
    all_snaps = [s for snaps in per_group.values() for s in snaps]
    return {
        "replicas": replicas,
        "per_shard": {g: merge_snapshots(s) for g, s in per_group.items()},
        "fleet": merge_snapshots(all_snaps),
        "scraped": len(all_snaps),
        "unreachable": unreachable,
        "scrape_duration_s": round(time.time() - t_start, 6),
    }


# verbs that are plumbing, not user traffic — excluded from the qps signal
# so a scrape/health poller can't talk an autoscaler into scaling out
_NON_QUERY_VERBS = frozenset({"HEALTH", "METRICS", "PING", "PROFILE",
                              "SUBSCRIBE", "RESUME", "UNSUB"})


def scrape_fleet_profiles(timeout_s: float = 2.0) -> dict:
    """``scrape_fleet`` for the continuous-profiling plane: one PROFILE
    round-trip per live registry entry, merged with the associative
    ``profiler.merge_profiles`` fold (per-stack seconds sum — exactly how
    METRICS snapshots merge through ``merge_snapshots``).

    Returns::

        {"replicas": [{"job_id", "host", "port", "profile"|None}, ...],
         "fleet":    merged profile (Python sample-seconds and native
                     per-verb CPU self-time in ONE stacks dict),
         "scraped": N, "unreachable": M, "scrape_duration_s": ...}

    A replica that answers METRICS but not PROFILE (pre-profiler build)
    counts unreachable here but is NOT an error — the fleet profile is
    simply missing that plane until its next rollout."""
    t_start = time.time()
    entries = registry.list_jobs()

    def poll(entry: dict) -> Optional[dict]:
        return scrape_profile(entry.get("host", "localhost"),
                              entry["port"], timeout_s=timeout_s)

    if entries:
        with ThreadPoolExecutor(
                max_workers=min(len(entries), _SCRAPE_POOL_MAX),
                thread_name_prefix="tpums-profscrape") as pool:
            polled = list(pool.map(poll, entries))
    else:
        polled = []

    replicas = []
    profiles = []
    for entry, prof in zip(entries, polled):
        replicas.append({"job_id": entry.get("job_id"),
                         "host": entry.get("host"),
                         "port": entry.get("port"),
                         "profile": prof})
        if prof is not None:
            profiles.append(prof)
    return {
        "replicas": replicas,
        "fleet": merge_profiles(profiles),
        "scraped": len(profiles),
        "unreachable": len(entries) - len(profiles),
        "scrape_duration_s": round(time.time() - t_start, 6),
    }


def _query_hists(snapshot: dict) -> List[dict]:
    return [h for h in snapshot.get("histograms", [])
            if h["name"] == "tpums_server_latency_seconds"
            and h.get("labels", {}).get("verb") not in _NON_QUERY_VERBS]


def fleet_signals(before: dict, after: dict,
                  dt_s: Optional[float] = None) -> dict:
    """Autoscaler inputs from two fleet snapshots (``scrape_fleet()``'s
    ``fleet`` merges) taken ``dt_s`` apart (defaults to the snapshots' own
    timestamp delta)::

        {"qps":            query verbs/s over the window (HEALTH/METRICS/
                           PING excluded — pollers must not look like load),
         "p99_s":          interpolated p99 of the window's query-verb
                           latency observations (None with no traffic),
         "backlog_bytes":  fleet ingest backlog at AFTER (gauge level),
         "shed_per_s":     admission-shed requests/s over the window
                           (``tpums_admission_shed_total`` delta across
                           all tenants/verbs — serve/admission.py),
         "admission_pressure": worst per-tenant bucket drain in [0, 1]
                           at AFTER (max ``tpums_admission_pressure``,
                           saturating at 1.0 — fleet merges sum the
                           gauge across replicas of the same tenant),
         "dt_s", "requests": the window itself}

    The admission fields make the shedder and the autoscaler act on the
    same numbers: sustained shed with low pressure elsewhere means a hot
    tenant, shed AND high qps means the fleet itself needs more shards.

    Retrieval-plane health (``serve/topk.py``/``serve/ann.py``
    maintenance):

        {"topk_rebuilds_per_s": full index rebuilds/s over the window
                           (``tpums_topk_rebuilds_total`` delta — a
                           sustained rate means structural churn is
                           outrunning the incremental scatter path),
         "topk_dirty_depth": fleet-summed dirty backlog at AFTER
                           (unabsorbed streaming updates),
         "topk_staleness_s": WORST per-process index staleness at AFTER
                           (the gauge is pid-labeled precisely so this
                           can be a max — a fleet SUM of stalenesses
                           means nothing),
         "ann_recall":     worst measured IVF recall probe across the
                           fleet at AFTER (min over pid-labeled
                           ``tpums_ann_recall_probe`` series; None when
                           no replica has an ANN tier built)}

    Watch-plane state (``obs/watch.py``):

        {"alerts_firing": currently-firing alert count (the watcher's
                          ``tpums_alerts_firing`` gauge when present in
                          AFTER, else the registry's published alert
                          record),
         "alerts_max_severity": "info"/"warn"/"page" or None}

    Autopilot progress (``serve/autopilot.py``):

        {"autopilot_retrains":  retrains completed over the window
                           (``tpums_autopilot_retrains_total`` delta),
         "autopilot_rollouts":  automatic rollouts over the window,
         "autopilot_rollbacks": drift-triggered rollbacks over the window,
         "autopilot_heldout_mse": newest candidate's held-out MSE at
                           AFTER (min across processes; None until an
                           evaluation has run)}

    Geo-replication plane (``serve/georepl.py``):

        {"georepl_lag_bytes":   fleet-summed un-replicated journal
                           backlog at AFTER (``tpums_georepl_lag_bytes``
                           across topics/regions),
         "georepl_lag_seconds": WORST follower staleness at AFTER (max
                           over ``tpums_georepl_lag_seconds`` — a fleet
                           sum of times means nothing)}

    Shared-memory arena plane (``serve/arena.py``):

        {"arena_resident_bytes": fleet-summed resident arena pages at
                           AFTER (both the Python writer's gauge and the
                           C++ server's METRICS splice feed this),
         "arena_read_retries_per_s": seqlock read retries/s over the
                           window — sustained retries mean hot-row write
                           contention on the lock-free read path,
         "arena_load_factor": WORST index load factor at AFTER (growth/
                           rehash predictor),
         "arena_publish_seconds": newest O(state) snapshot publish
                           latency (max across workers; None until an
                           arena snapshot has published)}

    Native write plane (``native/arena.cpp`` batch writer +
    CAS updates; both the Python writer's registry and the C++ server's
    METRICS splice of the ``writer.stats`` sidecar feed these):

        {"arena_batch_rows_per_s": rows applied by the native columnar
                           batch writer/s over the window — the write
                           path's throughput signal; a fall to ~0 while
                           ingest backlog grows means the native writer
                           degraded to the Python path,
         "arena_cas_success_per_s": in-place CAS swaps/s over the window
                           (the update plane writing at hardware speed),
         "arena_cas_retry_per_s": failed CAS compares/s — sustained
                           retries mean update workers are losing races
                           to the ingest writer and falling back to LWW
                           re-puts}

    Edge proxy tier (``serve/edge.py``; proxies register in
    the registry like workers, so ``scrape_fleet`` reaches them through
    the same METRICS verb):

        {"edge_open_connections": fleet-summed downstream connections
                           held open at AFTER (the tier's fan-in),
         "edge_coalesce_per_s": in-flight GET coalesce hits/s over the
                           window (requests answered WITHOUT an upstream
                           round trip),
         "edge_hedges_per_s": hedged requests fired/s,
         "edge_hedge_wins_per_s": hedges whose backup reply won/s —
                           fired without wins means the trigger is too
                           twitchy; wins without fires is impossible,
         "edge_shed_per_s": edge-side admission sheds/s (refused before
                           any upstream bytes),
         "edge_p99_s":     through-proxy p99 over the proxy's own query
                           verbs at AFTER (same log-bucket ladder as the
                           server's, so edge overhead is one
                           subtraction; None when no proxy served)}

    Push plane (``serve/push.py`` on the workers plus the
    edge hub's fan-out; subscription verbs are in ``_NON_QUERY_VERBS``,
    so a million idle subscribers never look like query load):

        {"push_subs_active": fleet-summed live subscriptions at AFTER
                           (worker-held and proxy-held both feed the
                           same gauge),
         "push_deltas_per_s": worker-emitted deltas/s over the window,
         "push_notifications_per_s": downstream notifications/s out of
                           the edge hubs — notifications/deltas is the
                           realized fan-out amplification,
         "push_fanout_ratio": WORST-case (max) downstream-subs per
                           upstream-sub across proxies at AFTER,
         "push_resumes_per_s": RESUME verbs served/s (replay and
                           snapshot-fallback both count; sustained rate
                           means clients are churning connections),
         "push_ring_evictions_per_s": replay-ring entries dropped/s —
                           nonzero means disconnected subscribers are
                           outliving their rings and will pay a full
                           snapshot on resume,
         "push_p99_s":     update→push p99 at AFTER over the window
                           (``tpums_push_latency_seconds`` — the ladder
                           the SLO_REPORT freshness gate reads)}

    Continuous-profiling plane (``obs/profiler.py``; the
    sampler's flush publishes these, so they ride the normal METRICS
    scrape even though the stacks themselves travel over PROFILE):

        {"prof_samples_per_s": profiler thread-samples/s across the fleet
                           over the window (~hz x threads x replicas when
                           healthy; 0 means the profiler is off or dead),
         "process_cpu_per_s": fleet CPU-seconds burned per wall second
                           over the window (getrusage user+sys deltas —
                           i.e. cores actually busy; the watch plane's
                           CPU-regression rule rates the same counter),
         "native_self_cpu_per_s": CPU-seconds/s spent inside native verb
                           handlers + the native arena write plane (the
                           C++ share of the same picture)}
    """
    if dt_s is None:
        dt_s = max(float(after.get("ts", 0)) - float(before.get("ts", 0)),
                   1e-9)
    b_h = {(h["name"], tuple(sorted(h.get("labels", {}).items()))): h
           for h in _query_hists(before)}
    b_all = {(h["name"], tuple(sorted(h.get("labels", {}).items()))): h
             for h in before.get("histograms", [])}
    requests = 0
    window = None  # delta histogram across all query verbs
    for h in _query_hists(after):
        k = (h["name"], tuple(sorted(h.get("labels", {}).items())))
        prev = b_h.get(k, {"counts": [0] * len(h["counts"]),
                           "count": 0, "sum": 0.0})
        dc = h["count"] - prev["count"]
        if dc <= 0:
            continue
        requests += dc
        dcounts = [a - b for a, b in zip(h["counts"], prev["counts"])]
        if window is None:
            window = {"name": "window", "le": list(h["le"]),
                      "counts": dcounts, "count": dc,
                      "sum": h["sum"] - prev["sum"]}
        elif window["le"] == list(h["le"]):
            window["counts"] = [a + b for a, b in
                                zip(window["counts"], dcounts)]
            window["count"] += dc
            window["sum"] += h["sum"] - prev["sum"]
    backlog = sum(
        g["value"] for g in after.get("gauges", [])
        if g["name"] == "tpums_journal_backlog_bytes"
    )

    def _shed_total(snap: dict) -> float:
        return sum(c["value"] for c in snap.get("counters", [])
                   if c["name"] == "tpums_admission_shed_total")

    shed = max(_shed_total(after) - _shed_total(before), 0.0)
    # the fleet merge SUMS same-labeled gauges across replicas, so a
    # tenant drained on several shards at once overshoots 1.0 — clamp:
    # the signal saturates at "some bucket is empty somewhere"
    pressure = min(max(
        (g["value"] for g in after.get("gauges", [])
         if g["name"] == "tpums_admission_pressure"), default=0.0), 1.0)

    def _counter_total(snap: dict, name: str) -> float:
        return sum(c["value"] for c in snap.get("counters", [])
                   if c["name"] == name)

    rebuilds = max(
        _counter_total(after, "tpums_topk_rebuilds_total")
        - _counter_total(before, "tpums_topk_rebuilds_total"), 0.0)
    dirty_depth = sum(
        g["value"] for g in after.get("gauges", [])
        if g["name"] == "tpums_topk_dirty_depth")
    staleness = max(
        (g["value"] for g in after.get("gauges", [])
         if g["name"] == "tpums_topk_index_staleness_seconds"), default=0.0)
    recall_series = [g["value"] for g in after.get("gauges", [])
                     if g["name"] == "tpums_ann_recall_probe"]
    # alert state (obs/watch.py): preferred source is the
    # watcher's own gauges when the watch loop runs inside a scraped
    # process; otherwise fall back to the registry's published alert
    # record, which is how an out-of-process watcher reaches autoscaler
    # callers of this function
    firing = [g["value"] for g in after.get("gauges", [])
              if g["name"] == "tpums_alerts_firing"]
    sev = [g["value"] for g in after.get("gauges", [])
           if g["name"] == "tpums_alerts_max_severity"]
    if firing:
        alerts_firing = sum(firing)
        alerts_sev_level = max(sev) if sev else 0
    else:
        rec = registry.resolve_alerts()
        alerts_firing = rec.get("firing", 0) if rec else 0
        alerts_sev_level = rec.get("max_severity_level", 0) if rec else 0
    from .rules import severity_name

    alerts_max_severity = (severity_name(alerts_sev_level)
                           if alerts_sev_level else None)
    # autopilot loop progress (serve/autopilot.py): counter
    # DELTAS over the window (the autoscaler and bench ask "did the
    # flywheel turn", not "how often has it ever turned") plus the latest
    # held-out score when an evaluation has run
    autopilot = {
        f"autopilot_{k}": max(
            _counter_total(after, f"tpums_autopilot_{k}_total")
            - _counter_total(before, f"tpums_autopilot_{k}_total"), 0.0)
        for k in ("retrains", "rollouts", "rollbacks")
    }
    heldout = [g["value"] for g in after.get("gauges", [])
               if g["name"] == "tpums_autopilot_heldout_mse"]
    autopilot["autopilot_heldout_mse"] = min(heldout) if heldout else None
    # tail-forensics plane : span volume (rate of span records
    # across the fleet), live exemplar retention, and how stale the last
    # forensics collection is (None = never collected anywhere)
    spans = max(
        _counter_total(after, "tpums_trace_spans_total")
        - _counter_total(before, "tpums_trace_spans_total"), 0.0)
    exemplar_count = sum(
        len(h.get("exemplars") or ())
        for h in after.get("histograms", []))
    last_collect = max(
        (g["value"] for g in after.get("gauges", [])
         if g["name"] == "tpums_forensics_last_collect_ts"), default=None)
    forensics_staleness = (
        max(time.time() - last_collect, 0.0)
        if last_collect else None)
    # geo-replication plane (serve/georepl.py): bytes lag SUMS
    # across topics/regions (total un-replicated backlog), seconds lag is
    # the WORST follower (a fleet sum of times means nothing)
    georepl_lag_bytes = sum(
        g["value"] for g in after.get("gauges", [])
        if g["name"] == "tpums_georepl_lag_bytes")
    georepl_lag_seconds = max(
        (g["value"] for g in after.get("gauges", [])
         if g["name"] == "tpums_georepl_lag_seconds"), default=0.0)
    # shared-memory arena plane (serve/arena.py): resident
    # bytes SUM across workers (fleet memory footprint), seqlock read
    # retries as a RATE (sustained retries = hot-row write contention on
    # the lock-free read path), index load factor and publish latency as
    # WORST-case maxes (the former predicts growth/rehash, the latter is
    # the O(state) publish promise being kept or broken)
    arena_resident = sum(
        g["value"] for g in after.get("gauges", [])
        if g["name"] == "tpums_arena_resident_bytes")
    arena_retries = max(
        _counter_total(after, "tpums_arena_read_retries_total")
        - _counter_total(before, "tpums_arena_read_retries_total"), 0.0)
    arena_load_factor = max(
        (g["value"] for g in after.get("gauges", [])
         if g["name"] == "tpums_arena_index_load_factor"), default=0.0)
    arena_publish_s = max(
        (g["value"] for g in after.get("gauges", [])
         if g["name"] == "tpums_arena_publish_seconds"), default=None)
    # native write plane : batch-writer and CAS counter DELTAS
    # as rates — write-path regressions (native writer degraded, update
    # plane losing CAS races) surface as rate shifts the watch plane can
    # alert on
    batch_rows = max(
        _counter_total(after, "tpums_arena_batch_rows_total")
        - _counter_total(before, "tpums_arena_batch_rows_total"), 0.0)
    cas_success = max(
        _counter_total(after, "tpums_arena_cas_success_total")
        - _counter_total(before, "tpums_arena_cas_success_total"), 0.0)
    cas_retry = max(
        _counter_total(after, "tpums_arena_cas_retry_total")
        - _counter_total(before, "tpums_arena_cas_retry_total"), 0.0)
    # edge proxy tier (serve/edge.py): open downstream
    # connections SUM across proxies (the tier's fan-in), coalesce hits /
    # hedges / edge sheds as RATES (tail management doing work vs. sitting
    # idle), and the through-proxy p99 from the proxy's own latency ladder
    # (same log buckets as the server's, so direct-vs-edge overhead is one
    # subtraction)
    edge_conns = sum(
        g["value"] for g in after.get("gauges", [])
        if g["name"] == "tpums_edge_open_connections")
    edge_coalesce = max(
        _counter_total(after, "tpums_edge_coalesce_hits_total")
        - _counter_total(before, "tpums_edge_coalesce_hits_total"), 0.0)
    edge_hedges = max(
        _counter_total(after, "tpums_edge_hedges_total")
        - _counter_total(before, "tpums_edge_hedges_total"), 0.0)
    edge_hedge_wins = max(
        sum(c["value"] for c in after.get("counters", [])
            if c["name"] == "tpums_edge_hedges_total"
            and c.get("labels", {}).get("result") == "won")
        - sum(c["value"] for c in before.get("counters", [])
              if c["name"] == "tpums_edge_hedges_total"
              and c.get("labels", {}).get("result") == "won"), 0.0)
    edge_shed = max(
        _counter_total(after, "tpums_edge_shed_total")
        - _counter_total(before, "tpums_edge_shed_total"), 0.0)
    # continuous-profiling plane (obs/profiler.py): sampler
    # liveness and process CPU as RATES; the native handler/write-plane
    # self-time counters give the C++ share of the same CPU picture
    prof_samples = max(
        _counter_total(after, "tpums_prof_samples_total")
        - _counter_total(before, "tpums_prof_samples_total"), 0.0)
    process_cpu = max(
        _counter_total(after, "tpums_process_cpu_seconds_total")
        - _counter_total(before, "tpums_process_cpu_seconds_total"), 0.0)
    native_self = max(
        (_counter_total(after, "tpums_native_self_seconds_total")
         + _counter_total(after, "tpums_arena_write_cpu_seconds_total"))
        - (_counter_total(before, "tpums_native_self_seconds_total")
           + _counter_total(before, "tpums_arena_write_cpu_seconds_total")),
        0.0)
    # push plane (serve/push.py + the edge hub): live subs
    # and fan-out as LEVELS, delta/notification/resume/eviction traffic
    # as RATES, and the update→push freshness ladder's window p99
    push_subs = sum(
        g["value"] for g in after.get("gauges", [])
        if g["name"] == "tpums_push_subs_active")
    push_deltas = max(
        _counter_total(after, "tpums_push_deltas_total")
        - _counter_total(before, "tpums_push_deltas_total"), 0.0)
    push_notifications = max(
        _counter_total(after, "tpums_push_notifications_total")
        - _counter_total(before, "tpums_push_notifications_total"), 0.0)
    push_fanout = max(
        (g["value"] for g in after.get("gauges", [])
         if g["name"] == "tpums_push_fanout_ratio"), default=0.0)
    push_resumes = max(
        _counter_total(after, "tpums_push_resume_total")
        - _counter_total(before, "tpums_push_resume_total"), 0.0)
    push_evictions = max(
        _counter_total(after, "tpums_push_ring_evictions_total")
        - _counter_total(before, "tpums_push_ring_evictions_total"), 0.0)
    push_window = None  # delta histogram of update→push latency
    for h in after.get("histograms", []):
        if h["name"] != "tpums_push_latency_seconds":
            continue
        k = (h["name"], tuple(sorted(h.get("labels", {}).items())))
        prev = b_all.get(k, {"counts": [0] * len(h["counts"]),
                             "count": 0, "sum": 0.0})
        dc = h["count"] - prev["count"]
        if dc <= 0:
            continue
        dcounts = [a - b for a, b in zip(h["counts"], prev["counts"])]
        if push_window is None:
            push_window = {"name": "push_window", "le": list(h["le"]),
                           "counts": dcounts, "count": dc,
                           "sum": h["sum"] - prev["sum"]}
        elif push_window["le"] == list(h["le"]):
            push_window["counts"] = [a + b for a, b in
                                     zip(push_window["counts"], dcounts)]
            push_window["count"] += dc
            push_window["sum"] += h["sum"] - prev["sum"]
    edge_window = None  # delta histogram across the proxy's query verbs
    for h in after.get("histograms", []):
        if h["name"] != "tpums_edge_latency_seconds":
            continue
        if h.get("labels", {}).get("verb") in _NON_QUERY_VERBS:
            continue
        k = (h["name"], tuple(sorted(h.get("labels", {}).items())))
        prev = b_all.get(k, {"counts": [0] * len(h["counts"]),
                             "count": 0, "sum": 0.0})
        dc = h["count"] - prev["count"]
        if dc <= 0:
            continue
        dcounts = [a - b for a, b in zip(h["counts"], prev["counts"])]
        if edge_window is None:
            edge_window = {"name": "edge_window", "le": list(h["le"]),
                           "counts": dcounts, "count": dc,
                           "sum": h["sum"] - prev["sum"]}
        elif edge_window["le"] == list(h["le"]):
            edge_window["counts"] = [a + b for a, b in
                                     zip(edge_window["counts"], dcounts)]
            edge_window["count"] += dc
            edge_window["sum"] += h["sum"] - prev["sum"]
    return {
        **autopilot,
        "qps": requests / dt_s,
        "p99_s": snapshot_quantile(window, 99) if window else None,
        "backlog_bytes": backlog,
        "shed_per_s": shed / dt_s,
        "admission_pressure": pressure,
        "topk_rebuilds_per_s": rebuilds / dt_s,
        "topk_dirty_depth": dirty_depth,
        "topk_staleness_s": staleness,
        "ann_recall": min(recall_series) if recall_series else None,
        "alerts_firing": alerts_firing,
        "alerts_max_severity": alerts_max_severity,
        "trace_spans_per_s": spans / dt_s,
        "exemplar_count": exemplar_count,
        "forensics_staleness_s": forensics_staleness,
        "georepl_lag_bytes": georepl_lag_bytes,
        "georepl_lag_seconds": georepl_lag_seconds,
        "arena_resident_bytes": arena_resident,
        "arena_read_retries_per_s": arena_retries / dt_s,
        "arena_load_factor": arena_load_factor,
        "arena_publish_seconds": arena_publish_s,
        "arena_batch_rows_per_s": batch_rows / dt_s,
        "arena_cas_success_per_s": cas_success / dt_s,
        "arena_cas_retry_per_s": cas_retry / dt_s,
        "edge_open_connections": edge_conns,
        "edge_coalesce_per_s": edge_coalesce / dt_s,
        "edge_hedges_per_s": edge_hedges / dt_s,
        "edge_hedge_wins_per_s": edge_hedge_wins / dt_s,
        "edge_shed_per_s": edge_shed / dt_s,
        "edge_p99_s": (snapshot_quantile(edge_window, 99)
                       if edge_window else None),
        "push_subs_active": push_subs,
        "push_deltas_per_s": push_deltas / dt_s,
        "push_notifications_per_s": push_notifications / dt_s,
        "push_fanout_ratio": push_fanout,
        "push_resumes_per_s": push_resumes / dt_s,
        "push_ring_evictions_per_s": push_evictions / dt_s,
        "push_p99_s": (snapshot_quantile(push_window, 99)
                       if push_window else None),
        "prof_samples_per_s": prof_samples / dt_s,
        "process_cpu_per_s": process_cpu / dt_s,
        "native_self_cpu_per_s": native_self / dt_s,
        "dt_s": dt_s,
        "requests": requests,
    }


def push_freshness(samples: Sequence[Tuple[float, dict]]) -> dict:
    """Reset-aware update->push freshness over a SERIES of fleet scrapes.

    ``fleet_signals`` differences two snapshots, which is blind to counter
    resets in between: a generation cutover replaces the processes whose
    counters held the window's history.  Here each CONSECUTIVE scrape pair
    contributes its increment, with the standard reset rule: when a
    fleet-merged total shrinks, the new snapshot's value IS the increment.
    While two generations are co-registered their merged total covers
    both, so a cutover costs at most one scrape interval of re-counted
    traffic: an overcount for a freshness gate, never an undercount.

    ``samples`` are ``(unix_ts, fleet_snapshot)`` pairs.  Returns::

        {"deltas": accumulated tpums_push_deltas_total increments,
         "p99_s": update->push p99 over the accumulated window ladder
                  (None when no observation landed),
         "dt_s": wall span of the series}
    """
    def _total(snap, name):
        return sum(c["value"] for c in snap.get("counters", [])
                   if c["name"] == name)

    def _hists(snap):
        return {tuple(sorted(h.get("labels", {}).items())): h
                for h in snap.get("histograms", [])
                if h["name"] == "tpums_push_latency_seconds"}

    deltas = 0.0
    window: Optional[dict] = None
    for (_, before), (_, after) in zip(samples, samples[1:]):
        inc = _total(after, "tpums_push_deltas_total") \
            - _total(before, "tpums_push_deltas_total")
        if inc < 0:  # reset: the survivors' total is the increment
            inc = _total(after, "tpums_push_deltas_total")
        deltas += inc
        prev = _hists(before)
        for key, h in _hists(after).items():
            p = prev.get(key)
            if p is None or h["count"] < p["count"] \
                    or list(p["le"]) != list(h["le"]):
                p = {"counts": [0] * len(h["counts"]), "count": 0,
                     "sum": 0.0}
            dc = h["count"] - p["count"]
            if dc <= 0:
                continue
            dcounts = [a - b for a, b in zip(h["counts"], p["counts"])]
            if any(d < 0 for d in dcounts):  # partial reset mid-merge
                dcounts, dc = list(h["counts"]), h["count"]
            dsum = max(h["sum"] - p["sum"], 0.0)
            if window is None:
                window = {"name": "push_window", "le": list(h["le"]),
                          "counts": dcounts, "count": dc, "sum": dsum}
            elif window["le"] == list(h["le"]):
                window["counts"] = [a + b for a, b in
                                    zip(window["counts"], dcounts)]
                window["count"] += dc
                window["sum"] += dsum
    return {
        "deltas": deltas,
        "p99_s": (snapshot_quantile(window, 99) if window else None),
        "dt_s": (samples[-1][0] - samples[0][0]) if len(samples) > 1
                else 0.0,
    }


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    prom = "--prom" in argv
    raw = "--raw" in argv
    result = scrape_fleet()
    if prom:
        sys.stdout.write(render_prometheus(result["fleet"]))
    elif raw:
        print(json.dumps(result, indent=2, default=str))
    else:
        print(json.dumps({
            "scraped": result["scraped"],
            "unreachable": result["unreachable"],
            "per_shard": result["per_shard"],
            "fleet": result["fleet"],
        }, indent=2, default=str))
    return 0 if result["scraped"] or not result["unreachable"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
