"""Bounded in-process ring time-series store for the fleet watch loop.

Own copy of ``flink_ms_tpu/obs/tsdb.py``, whole: the same series keys,
eviction, queries and spill lines, so the same snapshot timeline answers
every query with the same numbers in either package.

The post-hoc observability stack (scrape -> ``fleet_signals`` ->
``slo.build_report``) needs the caller to hold two snapshots and only
answers questions about one window after the fact.  Continuous watching
needs *retention*: a rolling history of every scraped series so rules can
ask "what was the GET error rate over the last 60 s" or "has this gauge
gone quiet" at any moment, without a sidecar TSDB process.

``SeriesStore`` is that retention, deliberately small:

- one deque per (name, labels) series, bounded BOTH by wall-clock
  retention (``TPUMS_WATCH_RETENTION_S``, default 900 s) and point count
  (``TPUMS_WATCH_MAX_POINTS``, default 4096) — eviction happens on
  ingest, so an idle store never grows;
- scalar series hold ``(ts, value)`` points (counters stay cumulative —
  reset detection lives in the query, exactly like PromQL ``increase``);
- histogram series hold cumulative snapshot entries on the shared
  ``LATENCY_BUCKETS_S`` ladder, so a trailing-window quantile is a
  bucket-wise delta of the newest and oldest in-window samples — the
  same statistic ``metrics.bucketed_quantiles`` computes for the bench;
- queries: ``latest`` / ``points`` / ``staleness_s`` / ``increase`` /
  ``rate`` (counter-reset aware) / ``derivative`` (gauge slope) /
  ``quantile`` (windowed histogram interpolation);
- optional JSONL spill (``spill_path``) appends one compact line per
  ingest for post-mortem correlation with the ``TPUMS_TRACE`` event log.

``ingest_fleet`` adapts a ``scrape.scrape_fleet()`` result: the fleet
merge's counters/gauges/histograms plus derived watch series
(``tpums_watch_replicas_total`` / ``_replicas_ready`` /
``_unreachable_replicas`` / ``_scrape_duration_seconds``) that the
default alert rules key on.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .metrics import snapshot_quantile

__all__ = ["SeriesStore", "series_key", "DEFAULT_RETENTION_S",
           "DEFAULT_MAX_POINTS"]

DEFAULT_RETENTION_S = 900.0
DEFAULT_MAX_POINTS = 4096


def _env_float(name: str, default: float, lo: float) -> float:
    try:
        return max(float(os.environ.get(name, default)), lo)
    except ValueError:
        return default


def series_key(name: str, labels: Optional[dict] = None
               ) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    """Canonical series identity: name + sorted label pairs (stringified,
    matching the snapshot JSON round-trip)."""
    items = tuple(sorted((str(k), str(v))
                         for k, v in (labels or {}).items()))
    return (name, items)


class SeriesStore:
    """Ring-buffered multi-series store.  Thread-safe: the watch loop
    ingests from its own thread while rules/tests query concurrently."""

    def __init__(self, retention_s: Optional[float] = None,
                 max_points: Optional[int] = None,
                 spill_path: Optional[str] = None):
        self.retention_s = (
            _env_float("TPUMS_WATCH_RETENTION_S", DEFAULT_RETENTION_S, 1.0)
            if retention_s is None else max(float(retention_s), 1.0))
        self.max_points = int(
            _env_float("TPUMS_WATCH_MAX_POINTS", DEFAULT_MAX_POINTS, 2)
            if max_points is None else max(int(max_points), 2))
        self.spill_path = spill_path
        self._lock = threading.Lock()
        self._scalar: Dict[tuple, Deque[Tuple[float, float]]] = {}
        self._hist: Dict[tuple, Deque[Tuple[float, dict]]] = {}
        self._ingests = 0

    # -- ingest -----------------------------------------------------------

    def _evict(self, dq: Deque, now: float) -> None:
        cutoff = now - self.retention_s
        while dq and dq[0][0] < cutoff:
            dq.popleft()

    def observe(self, name: str, value: float, ts: Optional[float] = None,
                **labels) -> None:
        """Append one scalar point (counter level or gauge value)."""
        now = time.time() if ts is None else float(ts)
        key = series_key(name, labels)
        with self._lock:
            dq = self._scalar.get(key)
            if dq is None:
                dq = self._scalar[key] = deque(maxlen=self.max_points)
            dq.append((now, float(value)))
            self._evict(dq, now)

    def observe_hist(self, name: str, hist_entry: dict,
                     ts: Optional[float] = None, **labels) -> None:
        """Append one CUMULATIVE histogram sample (a snapshot ``histograms``
        entry: ``le``/``counts``/``count``/``sum``)."""
        now = time.time() if ts is None else float(ts)
        key = series_key(name, labels)
        sample = {"le": list(hist_entry["le"]),
                  "counts": list(hist_entry["counts"]),
                  "count": int(hist_entry["count"]),
                  "sum": float(hist_entry["sum"])}
        with self._lock:
            dq = self._hist.get(key)
            if dq is None:
                dq = self._hist[key] = deque(maxlen=self.max_points)
            dq.append((now, sample))
            self._evict(dq, now)

    def ingest_snapshot(self, snap: dict, ts: Optional[float] = None,
                        extra_labels: Optional[dict] = None) -> None:
        """Ingest one metrics snapshot dict (``registry.snapshot()`` shape
        or a ``merge_snapshots`` output): counters and gauges become scalar
        points, histograms cumulative samples."""
        now = time.time() if ts is None else float(ts)
        extra = extra_labels or {}
        for c in snap.get("counters", []):
            self.observe(c["name"], c["value"], ts=now,
                         **{**c.get("labels", {}), **extra})
        for g in snap.get("gauges", []):
            self.observe(g["name"], g["value"], ts=now,
                         **{**g.get("labels", {}), **extra})
        for h in snap.get("histograms", []):
            self.observe_hist(h["name"], h, ts=now,
                              **{**h.get("labels", {}), **extra})

    def ingest_fleet(self, scrape_result: dict,
                     ts: Optional[float] = None) -> None:
        """Ingest a ``scrape_fleet()`` result: the fleet merge plus the
        derived per-tick watch series the default rules alert on."""
        now = time.time() if ts is None else float(ts)
        self.ingest_snapshot(scrape_result.get("fleet", {}), ts=now)
        replicas = scrape_result.get("replicas", [])
        ready = sum(1 for r in replicas
                    if r.get("ready") and r.get("snapshot") is not None)
        self.observe("tpums_watch_replicas_total", len(replicas), ts=now)
        self.observe("tpums_watch_replicas_ready", ready, ts=now)
        self.observe("tpums_watch_unreachable_replicas",
                     scrape_result.get("unreachable", 0), ts=now)
        if scrape_result.get("scrape_duration_s") is not None:
            self.observe("tpums_watch_scrape_duration_seconds",
                         scrape_result["scrape_duration_s"], ts=now)
        self._ingests += 1
        if self.spill_path:
            self._spill(now, scrape_result)

    def _spill(self, now: float, scrape_result: dict) -> None:
        line = {"ts": now, "kind": "watch_ingest",
                "replicas": len(scrape_result.get("replicas", [])),
                "unreachable": scrape_result.get("unreachable", 0),
                "scrape_duration_s": scrape_result.get("scrape_duration_s"),
                "gauges": {
                    g["name"]: g["value"]
                    for g in scrape_result.get("fleet", {}).get("gauges", [])
                },
                "counters": {
                    c["name"]: c["value"]
                    for c in scrape_result.get("fleet", {}).get(
                        "counters", [])
                }}
        try:
            with open(self.spill_path, "a") as f:
                f.write(json.dumps(line, separators=(",", ":"),
                                   default=str) + "\n")
        except OSError:
            pass

    # -- scalar queries ---------------------------------------------------
    #
    # Label semantics follow PromQL selectors: the given labels are a
    # SUBSET match, so a query for ``tpums_server_requests_total`` with no
    # labels aggregates across every verb the scrape saw.  No exact-key
    # short-circuit: an unlabeled series coexisting with labeled series of
    # the same name must still aggregate with them, not shadow them.

    def _matching(self, table: Dict[tuple, Deque], name: str,
                  labels: dict) -> List[Deque]:
        want = dict(series_key(name, labels)[1])
        with self._lock:
            out = []
            for (n, items), dq in table.items():
                if n != name:
                    continue
                have = dict(items)
                if all(have.get(k) == v for k, v in want.items()):
                    out.append(dq)
            return out

    def _points(self, name: str, labels: dict) -> List[Tuple[float, float]]:
        with self._lock:
            dq = self._scalar.get(series_key(name, labels))
            return list(dq) if dq else []

    def _points_multi(self, name: str, labels: dict
                      ) -> List[List[Tuple[float, float]]]:
        dqs = self._matching(self._scalar, name, labels)
        with self._lock:
            return [list(dq) for dq in dqs]

    def points(self, name: str, window_s: Optional[float] = None,
               now: Optional[float] = None, **labels
               ) -> List[Tuple[float, float]]:
        """``(ts, value)`` points, optionally only the trailing window."""
        pts = self._points(name, labels)
        if window_s is None:
            return pts
        now = time.time() if now is None else now
        cutoff = now - window_s
        return [(t, v) for t, v in pts if t >= cutoff]

    def latest(self, name: str, **labels) -> Optional[float]:
        """Latest value; with a subset match over several label sets the
        latests SUM (the fleet-merge convention for same-named gauges)."""
        series = self._points_multi(name, labels)
        vals = [pts[-1][1] for pts in series if pts]
        return sum(vals) if vals else None

    def staleness_s(self, name: str, now: Optional[float] = None,
                    **labels) -> Optional[float]:
        """Seconds since ANY matching series last received a point; None
        when never seen (absence rules treat that separately)."""
        series = self._points_multi(name, labels)
        last = max((pts[-1][0] for pts in series if pts), default=None)
        if last is None:
            return None
        now = time.time() if now is None else now
        return max(now - last, 0.0)

    @staticmethod
    def _increase_one(pts: List[Tuple[float, float]], cutoff: float
                      ) -> float:
        # anchor: latest point at-or-before the cutoff, then in-window
        anchor = None
        series: List[Tuple[float, float]] = []
        for t, v in pts:
            if t < cutoff:
                anchor = (t, v)
            else:
                series.append((t, v))
        if anchor is not None:
            series.insert(0, anchor)
        if len(series) < 2:
            return 0.0
        total = 0.0
        prev = series[0][1]
        for _, cur in series[1:]:
            total += cur if cur < prev else cur - prev
            prev = cur
        return total

    def increase(self, name: str, window_s: float,
                 now: Optional[float] = None, **labels) -> float:
        """Counter increase over the trailing window, reset-aware: a sample
        below its predecessor means the process restarted, so the sample's
        own level is the post-reset contribution (PromQL semantics).  The
        last pre-window point anchors the window so slow scrape cadences
        don't under-count.  Subset label matches sum their increases."""
        now = time.time() if now is None else now
        cutoff = now - window_s
        return sum(self._increase_one(pts, cutoff)
                   for pts in self._points_multi(name, labels))

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None, **labels) -> float:
        """Per-second counter rate over the trailing window."""
        return self.increase(name, window_s, now=now, **labels) \
            / max(window_s, 1e-9)

    def derivative(self, name: str, window_s: float,
                   now: Optional[float] = None, **labels
                   ) -> Optional[float]:
        """Gauge slope over the trailing window: (last-first)/dt.  None
        with fewer than two in-window points."""
        pts = self.points(name, window_s=window_s, now=now, **labels)
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)

    def window_max(self, name: str, window_s: float,
                   now: Optional[float] = None, **labels
                   ) -> Optional[float]:
        """Max value inside the trailing window; subset matches take the
        max of per-series window maxima."""
        now = time.time() if now is None else now
        cutoff = now - window_s
        best: Optional[float] = None
        for pts in self._points_multi(name, labels):
            for t, v in pts:
                if t >= cutoff and (best is None or v > best):
                    best = v
        return best

    # -- histogram queries ------------------------------------------------

    @staticmethod
    def _window_delta_one(samples: List[Tuple[float, dict]],
                          cutoff: float) -> Optional[dict]:
        anchor = None
        inwin = []
        for t, h in samples:
            if t < cutoff:
                anchor = h
            else:
                inwin.append(h)
        if not inwin:
            return None
        newest = inwin[-1]
        base = anchor if anchor is not None else (
            inwin[0] if len(inwin) > 1 else None)
        if base is None or base["le"] != newest["le"]:
            base = {"le": newest["le"],
                    "counts": [0] * len(newest["counts"]),
                    "count": 0, "sum": 0.0}
        counts = [a - b for a, b in zip(newest["counts"], base["counts"])]
        if any(c < 0 for c in counts):  # exporter reset mid-window
            counts = list(newest["counts"])
            base = {"counts": [0] * len(counts), "count": 0, "sum": 0.0}
        return {"le": list(newest["le"]), "counts": counts,
                "count": newest["count"] - base["count"],
                "sum": newest["sum"] - base["sum"]}

    def window_hist(self, name: str, window_s: float,
                    now: Optional[float] = None, **labels
                    ) -> Optional[dict]:
        """Delta histogram over the trailing window: per matching series,
        newest in-window cumulative sample minus the window's anchor
        sample (last at-or-before the cutoff, else the oldest in-window);
        subset matches then add bucket-wise (same ladder required — the
        scrape already enforces it fleet-wide).  Any bucket that DECREASED
        means the exporter restarted mid-window — that series' newest
        cumulative sample alone is then the best available estimate."""
        now = time.time() if now is None else now
        dqs = self._matching(self._hist, name, labels)
        with self._lock:
            all_samples = [list(dq) for dq in dqs]
        cutoff = now - window_s
        merged: Optional[dict] = None
        for samples in all_samples:
            d = self._window_delta_one(samples, cutoff)
            if d is None:
                continue
            if merged is None:
                merged = {"name": name, **d}
            elif merged["le"] == d["le"]:
                merged["counts"] = [a + b for a, b in
                                    zip(merged["counts"], d["counts"])]
                merged["count"] += d["count"]
                merged["sum"] += d["sum"]
        return merged

    def quantile(self, name: str, q: float, window_s: float,
                 now: Optional[float] = None, **labels) -> Optional[float]:
        """Interpolated quantile of the trailing window's delta histogram
        (the same bucket-interpolation statistic as the bench/scrape
        path); None with no in-window observations."""
        h = self.window_hist(name, window_s, now=now, **labels)
        if h is None or h["count"] <= 0:
            return None
        return snapshot_quantile(h, q)

    # -- introspection ----------------------------------------------------

    def series(self) -> List[tuple]:
        with self._lock:
            return sorted(list(self._scalar) + list(self._hist))

    def stats(self) -> dict:
        with self._lock:
            return {
                "scalar_series": len(self._scalar),
                "hist_series": len(self._hist),
                "points": sum(len(d) for d in self._scalar.values())
                + sum(len(d) for d in self._hist.values()),
                "ingests": self._ingests,
                "retention_s": self.retention_s,
                "max_points": self.max_points,
            }
