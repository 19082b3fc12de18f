"""Continuous fleet watch loop: scrape -> retain -> evaluate -> page.

Own copy of ``flink_ms_tpu/obs/watch.py``, whole: ``FleetWatcher`` and
its CLI around the canary, the rules engine, the watch store and the
registry's alert records, with forensics and the profiler attached to
firing latency and CPU alerts.

The missing live half of the observability stack.  ``FleetWatcher`` runs
a fixed-cadence loop (``TPUMS_WATCH_INTERVAL_S``, default 2 s):

1. **scrape** the whole fleet concurrently (``scrape.scrape_fleet`` —
   one wedged replica costs one timeout, not the cadence);
2. **retain** the merge plus derived watch series in a bounded ring
   store (``tsdb.SeriesStore`` — wall-clock + point-count eviction,
   optional JSONL spill for post-mortem);
3. **probe** live model quality on its own sub-cadence
   (``ModelQualityCanary`` — a held-out ratings slice scored against the
   LIVE fleet through the same grouping/skip semantics as ``eval/mse``,
   published as ``tpums_model_live_mse`` / ``tpums_model_staleness_seconds``
   / ``tpums_probe_coverage`` — the drift signal the autopilot
   consumes);
4. **evaluate** the declarative rules engine (``rules.RulesEngine`` —
   thresholds, absence, multi-window burn rate, ``for:`` hold-down,
   flap suppression) and emit every transition as a tracing event;
5. **publish** the alert summary outward: ``tpums_alerts_firing`` /
   ``tpums_alerts_max_severity`` gauges in the process metrics registry
   (so a co-located server exports them over METRICS) and a TTL'd
   registry alert record (so HEALTH hints and out-of-process
   ``fleet_signals`` callers see the same state).

Every firing is attributed to the nearest disruptive event (kill,
cutover, rollout, autoscale decision) with the SLO report's own
machinery; ``watch_summary()["unattributed_page"] == 0`` is the chaos
gate — nothing paged that the run cannot explain.  ``detection_latencies``
pairs kill events with their first subsequent page, which is the bound a
chaos run records.

CLI::

    python -m flink_ms_tpu_torch.obs.watch                  # watch until ^C
    python -m flink_ms_tpu_torch.obs.watch --once           # one tick -> JSON
    python -m flink_ms_tpu_torch.obs.watch --rules r.json --duration 60
    python -m flink_ms_tpu_torch.obs.watch --prom           # + text exposition
    python -m flink_ms_tpu_torch.obs.watch --spill w.jsonl  # post-mortem trail
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from ..serve import registry as job_registry
from . import forensics
from . import profdiff
from . import tracing
from .metrics import get_registry, render_prometheus
from .profiler import CPU_SECONDS_SERIES
from .rules import (RulesEngine, attribute_alerts, default_rules,
                    load_rules)
from .scrape import scrape_fleet, scrape_fleet_profiles
from .slo import DEFAULT_ATTRIBUTION_WINDOW_S, DISRUPTIVE_KINDS
from .tsdb import SeriesStore

__all__ = ["FleetWatcher", "ModelQualityCanary", "DEFAULT_INTERVAL_S",
           "KILL_KINDS", "main"]

DEFAULT_INTERVAL_S = 2.0
DEFAULT_SCOPE = "fleet"

# the kill-shaped subset of the disruptive kinds: what detection latency
# is measured against
KILL_KINDS = frozenset({"chaos_kill", "chaos_kill_warming",
                        "rehearsal_kill"})

# matches serve/consumer.py ALS_STATE: a string, not an import, so the obs
# layer stays importable without the serving stack
_DEFAULT_STATE = "ALS_MODEL"


def _env_float(name: str, default: float, lo: float) -> float:
    try:
        return max(float(os.environ.get(name, default)), lo)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# model-quality canary
# ---------------------------------------------------------------------------

class ModelQualityCanary:
    """Live held-out-quality prober.

    Holds a probe slice of ratings (an evenly-strided sample of what the
    caller provides, capped at ``max_probe`` so a probe is a handful of
    MGETs, not an eval job), scores it against the live fleet through
    ``eval.mse.compute_mse`` — the SAME grouping/skip semantics as the
    offline evaluator, so live and offline MSE on one slice are the
    identical statistic — and publishes three gauges:

    - ``tpums_model_live_mse``: the probe's MSE (absent until something
      scores);
    - ``tpums_probe_coverage``: scored fraction of the probe slice (a
      coverage collapse means keys vanished — a bad rollout looks like
      this before quality numbers move);
    - ``tpums_model_staleness_seconds``: seconds since the fetched
      factors last CHANGED (fingerprint of the raw payloads) — the
      online-update loop's liveness, measured from the serving side.

    ``client`` is anything with ``query_states(name, keys)`` (QueryClient,
    HAShardedClient, ElasticClient) or a zero-arg factory returning one
    (resolved lazily, so the canary can be built before the fleet is up).
    """

    def __init__(self, users, items, ratings,
                 client, state_name: str = _DEFAULT_STATE,
                 max_probe: int = 512):
        users = np.asarray(users)
        items = np.asarray(items)
        ratings = np.asarray(ratings, dtype=np.float64)
        if not (len(users) == len(items) == len(ratings)):
            raise ValueError("users/items/ratings length mismatch")
        if len(ratings) == 0:
            raise ValueError("empty probe slice")
        if len(ratings) > max_probe:
            idx = np.linspace(0, len(ratings) - 1, max_probe).astype(int)
            users, items, ratings = users[idx], items[idx], ratings[idx]
        self.users, self.items, self.ratings = users, items, ratings
        self.state_name = state_name
        self._client_or_factory = client
        self._client = None
        self._fingerprint: Optional[str] = None
        self._fingerprint_ts: Optional[float] = None
        self.probes = 0
        self.last: Optional[dict] = None

    def _resolve_client(self):
        if self._client is None:
            c = self._client_or_factory
            self._client = c if hasattr(c, "query_states") else c()
        return self._client

    @staticmethod
    def _parse(payload: Optional[str]):
        if payload is None:
            return None
        # serving values are the factor payload "f1;f2;..."
        return np.asarray([float(t) for t in payload.split(";") if t])

    def probe(self, now: Optional[float] = None) -> dict:
        """One probe round -> ``{"mse", "n_scored", "n_skipped",
        "coverage", "staleness_s", "ts"}``; also sets the three gauges."""
        from ..eval.mse import compute_mse

        now = time.time() if now is None else now
        client = self._resolve_client()
        fetched: List[str] = []

        def lookup_many(keys):
            payloads = client.query_states(self.state_name, list(keys))
            fetched.extend(p for p in payloads if p is not None)
            return [self._parse(p) for p in payloads]

        def lookup(key):
            return lookup_many([key])[0]

        mse, n_scored, n_skipped = compute_mse(
            self.users, self.items, self.ratings, lookup,
            lookup_many=lookup_many)
        coverage = n_scored / len(self.ratings)
        fp = hashlib.sha1(
            "\n".join(sorted(fetched)).encode()).hexdigest() \
            if fetched else None
        if fp != self._fingerprint:
            self._fingerprint = fp
            self._fingerprint_ts = now
        staleness = (now - self._fingerprint_ts
                     if self._fingerprint_ts is not None else 0.0)
        reg = get_registry()
        if mse is not None:
            reg.gauge("tpums_model_live_mse").set(mse)
        reg.gauge("tpums_probe_coverage").set(coverage)
        reg.gauge("tpums_model_staleness_seconds").set(staleness)
        self.probes += 1
        self.last = {"mse": mse, "n_scored": n_scored,
                     "n_skipped": n_skipped, "coverage": coverage,
                     "staleness_s": staleness, "ts": now}
        return self.last

    @classmethod
    def from_ratings_file(cls, path: str, client,
                          state_name: str = _DEFAULT_STATE,
                          max_probe: int = 512,
                          field_delimiter: str = "tab"
                          ) -> "ModelQualityCanary":
        """Build the probe slice from a ratings file (the same reader the
        trainers/evaluators use)."""
        from ..core import formats as F
        users, items, ratings = F.read_ratings(
            path, field_delimiter=field_delimiter, ignore_first_line=True)
        return cls(users, items, ratings, client, state_name=state_name,
                   max_probe=max_probe)


# ---------------------------------------------------------------------------
# the watch loop
# ---------------------------------------------------------------------------

def _exemplar_tids(scrape: dict, series: str,
                   limit: int = 8) -> List[str]:
    """Trace ids retained by the fleet's exemplar-linked histogram
    buckets for ``series``, slowest bucket first — the concrete requests
    behind a breached latency quantile."""
    recs = []  # (bucket_index, value, tid)
    fleet = scrape.get("fleet") or {}
    for h in fleet.get("histograms", []):
        if h.get("name") != series:
            continue
        for idx, rec in (h.get("exemplars") or {}).items():
            try:
                recs.append((int(idx), float(rec[1]), str(rec[0])))
            except (TypeError, ValueError, IndexError):
                continue
    recs.sort(key=lambda r: (-r[0], -r[1]))
    out: List[str] = []
    for _, _, tid in recs:
        if tid not in out:
            out.append(tid)
        if len(out) >= limit:
            break
    return out


class FleetWatcher:
    """Scrape/retain/evaluate/publish on a fixed cadence (see module
    docstring).  Use as a context manager or ``start()``/``stop()``;
    ``tick()`` is public so tests and ``--once`` drive it synchronously."""

    def __init__(self,
                 interval_s: Optional[float] = None,
                 rules=None,
                 store: Optional[SeriesStore] = None,
                 canary: Optional[ModelQualityCanary] = None,
                 canary_every: int = 1,
                 scope: str = DEFAULT_SCOPE,
                 spill_path: Optional[str] = None,
                 scrape_timeout_s: Optional[float] = None,
                 publish: bool = True,
                 attribution_window_s: float =
                 DEFAULT_ATTRIBUTION_WINDOW_S,
                 profile_attach: bool = True):
        self.interval_s = (
            _env_float("TPUMS_WATCH_INTERVAL_S", DEFAULT_INTERVAL_S, 0.05)
            if interval_s is None else max(float(interval_s), 0.05))
        if rules is None:
            rules_path = os.environ.get("TPUMS_WATCH_RULES", "").strip()
            rules = load_rules(rules_path) if rules_path \
                else default_rules()
        spill_path = spill_path or \
            os.environ.get("TPUMS_WATCH_SPILL", "").strip() or None
        self.store = store if store is not None else \
            SeriesStore(spill_path=spill_path)
        if spill_path and self.store.spill_path is None:
            self.store.spill_path = spill_path
        self.engine = RulesEngine(rules)
        self.canary = canary
        self.canary_every = max(int(canary_every), 1)
        self.scope = scope
        self.scrape_timeout_s = (
            _env_float("TPUMS_WATCH_SCRAPE_TIMEOUT_S", 1.0, 0.05)
            if scrape_timeout_s is None else float(scrape_timeout_s))
        self.publish = publish
        self.attribution_window_s = attribution_window_s
        # continuous-profiling attachment: each tick keeps the fleet
        # profile so a CPU/quantile firing can be diffed prev-vs-now and
        # page WITH the top-delta frames (profdiff), not just the number
        self.profile_attach = profile_attach
        self._prof_prev: Optional[dict] = None
        self.ticks = 0
        self.last_scrape: Optional[dict] = None
        self.last_error: Optional[str] = None
        self.tick_seconds: deque = deque(maxlen=512)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one tick ---------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One scrape/probe/evaluate/publish round -> this tick's alert
        transitions."""
        now = time.time() if now is None else now
        t0 = time.perf_counter()
        scrape = scrape_fleet(timeout_s=self.scrape_timeout_s)
        self.last_scrape = scrape
        self.store.ingest_fleet(scrape, ts=now)
        if self.canary is not None and self.ticks % self.canary_every == 0:
            try:
                p = self.canary.probe(now=now)
            except (OSError, RuntimeError, ValueError) as e:
                # a probe outage is a signal (absence rules see the gap),
                # never a watch-loop crash
                self.last_error = f"canary: {e}"
            else:
                if p["mse"] is not None:
                    self.store.observe("tpums_model_live_mse", p["mse"],
                                       ts=now)
                self.store.observe("tpums_probe_coverage", p["coverage"],
                                   ts=now)
                self.store.observe("tpums_model_staleness_seconds",
                                   p["staleness_s"], ts=now)
        transitions = self.engine.evaluate(self.store, now=now)
        prof_cur = None
        if self.profile_attach:
            try:
                prof_cur = scrape_fleet_profiles(
                    timeout_s=self.scrape_timeout_s)["fleet"]
            except Exception as e:  # noqa: BLE001 - never kill the tick
                self.last_error = f"profile scrape: {e}"
        if transitions:
            self._attach_forensics(transitions, scrape)
            self._attach_profile(transitions, prof_cur)
        if prof_cur is not None:
            self._prof_prev = prof_cur
        if self.publish:
            summary = self.engine.summary()
            reg = get_registry()
            reg.gauge("tpums_alerts_firing").set(summary["firing"])
            reg.gauge("tpums_alerts_max_severity").set(
                summary["max_severity_level"])
            reg.gauge("tpums_watch_scrape_duration_seconds").set(
                scrape.get("scrape_duration_s") or 0.0)
            job_registry.publish_alerts(
                self.scope, summary,
                ttl_s=max(5.0 * self.interval_s, 15.0))
        self.ticks += 1
        self.tick_seconds.append(time.perf_counter() - t0)
        return transitions

    def _attach_forensics(self, transitions: List[dict],
                          scrape: dict) -> None:
        """Enrich latency-quantile firings with forensics: the exemplar
        tids the breached histogram retained, plus each trace's critical
        path.  The incident record then NAMES the stage that made p99
        slow instead of just quoting the breached number.  Transitions
        are the same dict objects ``engine.history`` keeps, so the
        enrichment lands in the incident timeline."""
        rules = {r.name: r for r in self.engine.rules}
        for tr in transitions:
            rule = rules.get(tr.get("rule"))
            if (tr.get("kind") != "alert_firing" or rule is None
                    or rule.kind != "threshold"
                    or rule.mode != "quantile"):
                continue
            tids = _exemplar_tids(scrape, rule.series)
            if not tids:
                continue
            spill = tracing.trace_file_path()
            try:
                ctx = forensics.incident_context(
                    tids, paths=[spill] if spill else None)
            except (OSError, ValueError) as e:
                self.last_error = f"forensics: {e}"
                continue
            tr.update(ctx)

    def _attach_profile(self, transitions: List[dict],
                        prof_cur: Optional[dict]) -> None:
        """Enrich CPU-regression and latency-quantile firings with the
        profiling plane: diff the PREVIOUS tick's fleet profile against
        this tick's and attach the top-delta frames, so the page names
        the code that got hot (``profile_top_frames``), completing the
        alert -> stage (forensics) -> frames (profdiff) chain.  First
        tick has no baseline; the firing still pages, just unframed."""
        if prof_cur is None or self._prof_prev is None:
            return
        rules = {r.name: r for r in self.engine.rules}
        frames: Optional[List[dict]] = None
        for tr in transitions:
            rule = rules.get(tr.get("rule"))
            if (tr.get("kind") != "alert_firing" or rule is None
                    or rule.kind != "threshold"
                    or (rule.mode != "quantile"
                        and rule.series != CPU_SECONDS_SERIES)):
                continue
            if frames is None:
                try:
                    frames = profdiff.top_frames(self._prof_prev, prof_cur)
                except (ValueError, TypeError) as e:
                    self.last_error = f"profdiff: {e}"
                    return
            if frames:
                tr["profile_top_frames"] = frames

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.time()
            try:
                self.tick(now=t0)
            except Exception as e:  # noqa: BLE001 - loop must survive
                self.last_error = f"{type(e).__name__}: {e}"
            self._stop.wait(max(self.interval_s - (time.time() - t0),
                                0.01))

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "FleetWatcher":
        if self._thread is not None:
            raise RuntimeError("watcher already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpums-watch")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(10.0, 3 * self.interval_s))
            self._thread = None
        if self.publish:
            job_registry.drop_alerts(self.scope)

    def __enter__(self) -> "FleetWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- incident timeline ------------------------------------------------

    def _disruptive_events(self) -> List[dict]:
        # only events from THIS watcher's lifetime: the tracing ring is
        # process-global and may hold kills from earlier runs (tests,
        # repeated bench sections) that this watcher never saw
        t0 = self.engine.started_at
        return [e for e in tracing.recent_events()
                if e.get("kind") in DISRUPTIVE_KINDS
                and e.get("ts", 0.0) >= t0]

    def incident_timeline(self) -> List[dict]:
        """Disruptive events and alert transitions merged, time-ordered —
        the live counterpart of the SLO report's timeline."""
        merged = self._disruptive_events() + list(self.engine.history)
        return sorted(merged, key=lambda e: e.get("ts", 0.0))

    def attribution(self) -> dict:
        """Attribute every firing so far to the nearest disruptive event
        (``{"alerts", "unattributed", "unattributed_page", "window_s"}``)."""
        return attribute_alerts(self.engine.history,
                                self._disruptive_events(),
                                window_s=self.attribution_window_s)

    def detection_latencies(self,
                            kill_kinds: Sequence[str] = tuple(KILL_KINDS)
                            ) -> dict:
        """kill -> first subsequent page-severity firing inside the
        attribution window, each page consumed by AT MOST one kill (so a
        single page cannot "detect" several kills, and a page long after
        a kill does not count as detecting it)::

            {"kills": N, "detected": M, "latencies_s": [...],
             "max_s": worst | None}
        """
        kinds = frozenset(kill_kinds)
        t0 = self.engine.started_at
        kills = sorted(e["ts"] for e in tracing.recent_events()
                       if e.get("kind") in kinds
                       and e.get("ts", 0.0) >= t0)
        pages = sorted(tr["ts"] for tr in self.engine.history
                       if tr["kind"] == "alert_firing"
                       and tr.get("severity") == "page")
        latencies: List[float] = []
        detected = 0
        pi = 0
        for k_ts in kills:
            while pi < len(pages) and pages[pi] < k_ts:
                pi += 1
            if pi < len(pages) and \
                    pages[pi] - k_ts <= self.attribution_window_s:
                detected += 1
                latencies.append(round(pages[pi] - k_ts, 3))
                pi += 1
        return {"kills": len(kills), "detected": detected,
                "latencies_s": latencies,
                "max_s": max(latencies) if latencies else None}

    def watch_summary(self) -> dict:
        """The artifact section chaos/bench runs record."""
        s = self.engine.summary()
        att = self.attribution()
        det = self.detection_latencies()
        fired = sum(1 for t in self.engine.history
                    if t["kind"] == "alert_firing")
        resolved = sum(1 for t in self.engine.history
                       if t["kind"] == "alert_resolved")
        return {
            "ticks": self.ticks,
            "interval_s": self.interval_s,
            "firing": s["firing"],
            "max_severity": s["max_severity"],
            "fired_total": fired,
            "resolved_total": resolved,
            "unattributed": att["unattributed"],
            "unattributed_page": att["unattributed_page"],
            "detection": det,
            "canary": self.canary.last if self.canary else None,
            "avg_tick_s": round(
                sum(self.tick_seconds) / len(self.tick_seconds), 6)
            if self.tick_seconds else None,
            "store": self.store.stats(),
            "last_error": self.last_error,
        }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flink_ms_tpu_torch.obs.watch",
        description="continuous fleet watch loop")
    ap.add_argument("--rules", help="JSON rules file (default: built-in "
                                    "fleet baseline or TPUMS_WATCH_RULES)")
    ap.add_argument("--interval", type=float, default=None,
                    help="scrape cadence seconds "
                         "(TPUMS_WATCH_INTERVAL_S, default 2)")
    ap.add_argument("--duration", type=float, default=None,
                    help="watch for N seconds then summarize "
                         "(default: until interrupted)")
    ap.add_argument("--once", action="store_true",
                    help="single tick, print the summary, exit")
    ap.add_argument("--prom", action="store_true",
                    help="also print text exposition of the last fleet "
                         "merge + watch gauges")
    ap.add_argument("--spill", help="JSONL spill path (TPUMS_WATCH_SPILL)")
    ap.add_argument("--scope", default=DEFAULT_SCOPE,
                    help="registry alert-record scope (default: fleet)")
    args = ap.parse_args(argv)

    rules = load_rules(args.rules) if args.rules else None
    w = FleetWatcher(interval_s=args.interval, rules=rules,
                     spill_path=args.spill, scope=args.scope)
    transitions: List[dict] = []
    if args.once:
        transitions = w.tick()
    else:
        w.start()
        try:
            if args.duration is not None:
                time.sleep(args.duration)
            else:
                while True:
                    time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            w.stop()
    summary = w.watch_summary()
    summary["transitions"] = transitions if args.once \
        else w.engine.history
    print(json.dumps(summary, indent=2, default=str))
    if args.prom:
        if w.last_scrape is not None:
            sys.stdout.write(render_prometheus(w.last_scrape["fleet"]))
        sys.stdout.write(render_prometheus(get_registry().snapshot()))
    job_registry.drop_alerts(args.scope)
    return 0 if summary["unattributed_page"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
