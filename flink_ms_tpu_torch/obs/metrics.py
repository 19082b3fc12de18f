"""Process-wide metrics registry of the port's serving path.

Own copy of the subset of ``flink_ms_tpu/obs/metrics.py`` that the top-k
index, the batcher, the lookup server, admission, the serving job's ingest
and snapshot planes (``tpums_snapshot_*``, ``tpums_bootstrap_total``) and
the push engine (``tpums_push_*``, with the reference's names and labels)
record: monotonic counters, labelled gauges and fixed-bucket
log-spaced histograms in one get-or-create registry, with the
``TPUMS_METRICS=0`` switch that makes every observation a no-op, optional
exemplars (``TPUMS_EXEMPLARS=1``: each histogram bucket keeps the last
traced observation), and the snapshot the ``METRICS`` verb renders as one
JSON line, in the reference's schema.  The port's registry is its own; the
JAX package's is not shared.  The fleet merge (``merge_snapshots``) and
``snapshot_quantile`` serve the fleet scrape (``obs/scrape.py``);
``render_prometheus`` is the reference's text exposition, byte for byte;
``bucketed_quantiles`` and ``diff_snapshots`` are the bench's percentile
and delta helpers; ``set_enabled``/``set_exemplars`` flip the two switches
live.

Every instrument takes its own lock per observation: ``+=`` on an
attribute is a read-modify-write that can lose updates across threads.
"""

from __future__ import annotations

import json
import os
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# enable switch
# ---------------------------------------------------------------------------

_ENABLED = os.environ.get("TPUMS_METRICS", "1") != "0"


def metrics_enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Flip metric collection live (bench A/B, tests) -> previous value.
    Instruments keep existing either way; observations become no-ops."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    return prev


# Exemplars: when on, each histogram bucket remembers the last
# ``(tid, value, ts)`` observed under an active trace, so any p99 number
# resolves to a concrete trace id.  Off by default — the hot path then
# pays exactly one module-global check per observation.
_EXEMPLARS = os.environ.get("TPUMS_EXEMPLARS", "0") != "0"

# The trace id rides INTO ``observe(v, tid=...)`` explicitly, so an
# untraced observation pays nothing for the feature.


def exemplars_enabled() -> bool:
    return _EXEMPLARS


def set_exemplars(on: bool) -> bool:
    """Flip exemplar retention live (bench A/B, tests) -> previous value."""
    global _EXEMPLARS
    prev, _EXEMPLARS = _EXEMPLARS, bool(on)
    return prev


# ---------------------------------------------------------------------------
# shared bucket ladder
# ---------------------------------------------------------------------------

def log_buckets(lo: float, hi: float, per_decade: int = 16) -> Tuple[float, ...]:
    """Log-spaced upper bounds from ``lo`` to >= ``hi`` (``per_decade``
    buckets per factor of 10).  Bounds are generated once and shared; the
    per-observation cost is a bisect, independent of bucket count."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError("need 0 < lo < hi and per_decade >= 1")
    ratio = 10.0 ** (1.0 / per_decade)
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * ratio)
    return tuple(out)


# 1 us .. 100 s at 16 buckets a decade, and the batch-size ladder, 1 .. 64k
# at 8 a decade (the reference's bounds)
LATENCY_BUCKETS_S: Tuple[float, ...] = log_buckets(1e-6, 100.0, 16)
SIZE_BUCKETS: Tuple[float, ...] = log_buckets(1.0, 65536.0, 8)

# Metric-name hygiene contract (the reference's): every series name matches
# NAME_PATTERN, counters end in ``_total``, and label KEYS come from this
# closed vocabulary (label VALUES stay free-form).
NAME_PATTERN = r"^tpums_[a-z0-9_]+$"
LABEL_VOCABULARY = frozenset({
    "verb",     # wire verb (GET/MGET/TOPK/...)
    "state",    # model state / table name
    "tenant",   # admission-control tenant id
    "kind",     # generic discriminator (event kind, rollout kind, ...)
    "result",   # outcome discriminator (won/lost/fired/...)
    "pid",      # per-process series that must NOT sum across a fleet
    "topic",    # journal/georepl topic
    "region",   # geo region id
})

# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter.  ``inc`` never goes backwards; negative
    increments are rejected (that's what gauges are for)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not _ENABLED:
            return
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (backlog bytes, rows/s)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with log-spaced upper bounds.

    ``observe(v)`` counts ``v`` into the first bucket whose upper bound is
    >= v (Prometheus ``le`` semantics; values above the last bound land in
    the implicit +Inf bucket) — one bisect into a precomputed tuple plus
    two adds, zero allocation.  ``quantile(q)`` returns the interpolated
    value the way ``histogram_quantile`` does: uniform within the winning
    bucket, lower edge 0 for the first.  ``fill`` bulk-loads values that
    already exist (bench percentiles, ``StepTimer.to_histogram``)."""

    __slots__ = ("name", "labels", "bounds", "_lock", "_counts",
                 "_sum", "_count", "_exemplars")

    def __init__(self, name: str,
                 labels: Tuple[Tuple[str, str], ...] = (),
                 bounds: Sequence[float] = LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("bucket bounds must be strictly increasing")
        self.name = name
        self.labels = labels
        self.bounds = bounds
        self._lock = threading.Lock()
        # one slot per bound + the +Inf overflow slot
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0
        # bucket index -> (tid, value, ts): last traced observation per
        # bucket, populated only while exemplars are on AND a trace is
        # active — bounded at one entry per bucket by construction
        self._exemplars: Dict[int, tuple] = {}

    def observe(self, v: float, tid: Optional[str] = None) -> None:
        if not _ENABLED:
            return
        i = bisect_left(self.bounds, v)
        if tid is not None and _EXEMPLARS:
            with self._lock:
                self._counts[i] += 1
                self._sum += v
                self._count += 1
                self._exemplars[i] = (tid, v, time.time())
            return
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def exemplars(self) -> Dict[int, tuple]:
        """Snapshot of the per-bucket (tid, value, ts) exemplars."""
        with self._lock:
            return dict(self._exemplars)

    def fill(self, values: Sequence[float]) -> "Histogram":
        """Bulk-load observations IGNORING the enable switch: offline
        re-bucketing of values that already exist, where the math must
        work even under TPUMS_METRICS=0."""
        with self._lock:
            for v in values:
                self._counts[bisect_left(self.bounds, v)] += 1
                self._sum += v
                self._count += 1
        return self

    def quantile(self, q: float) -> float:
        """Interpolated quantile in [0, 100]; nan when empty."""
        with self._lock:
            entry = {"le": self.bounds, "counts": list(self._counts),
                     "count": self._count}
        return snapshot_quantile(entry, q)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create instrument store.  One process-wide instance
    (``get_registry``) backs every subsystem; private instances exist only
    for tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[tuple, Counter] = {}
        self._gauges: Dict[tuple, Gauge] = {}
        self._histograms: Dict[tuple, Histogram] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(name, key[1]))
        return c

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(name, key[1]))
        return g

    def histogram(self, name: str, bounds: Sequence[float] = LATENCY_BUCKETS_S,
                  **labels: str) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    key, Histogram(name, key[1], bounds))
        return h

    def snapshot(self, meta: Optional[dict] = None) -> dict:
        """JSON-able point-in-time dump of every instrument (the METRICS
        verb's payload and the scraper's merge unit)."""
        out = {
            "ts": time.time(),
            "enabled": _ENABLED,
            "counters": [], "gauges": [], "histograms": [],
        }
        if meta:
            out["meta"] = dict(meta)
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        for c in counters:
            out["counters"].append(
                {"name": c.name, "labels": dict(c.labels), "value": c.value})
        for g in gauges:
            out["gauges"].append(
                {"name": g.name, "labels": dict(g.labels), "value": g.value})
        for h in hists:
            with h._lock:
                counts = list(h._counts)
                s, n = h._sum, h._count
                ex = {str(i): list(rec) for i, rec in h._exemplars.items()}
            entry = {
                "name": h.name, "labels": dict(h.labels),
                "le": list(h.bounds), "counts": counts,
                "sum": s, "count": n,
            }
            if ex:
                entry["exemplars"] = ex
            out["histograms"].append(entry)
        return out

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


# ---------------------------------------------------------------------------
# the METRICS verb's payload
# ---------------------------------------------------------------------------

def _series_key(entry: dict) -> tuple:
    return (entry["name"], tuple(sorted(entry.get("labels", {}).items())))


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Aggregate N snapshots into one: counters and gauges sum, histograms
    add bucket-wise (identical bounds required; a mismatched series is
    carried under ``skipped``), exemplars keep the freshest per bucket.
    Associative and commutative, so per-shard merges compose into fleet
    totals in any order."""
    out: dict = {"ts": time.time(), "merged_from": len(snaps),
                 "counters": [], "gauges": [], "histograms": []}
    acc_c: Dict[tuple, dict] = {}
    acc_g: Dict[tuple, dict] = {}
    acc_h: Dict[tuple, dict] = {}
    skipped: List[str] = []
    for snap in snaps:
        for kind, acc in (("counters", acc_c), ("gauges", acc_g)):
            for e in snap.get(kind, []):
                k = _series_key(e)
                cur = acc.get(k)
                if cur is None:
                    acc[k] = {"name": e["name"],
                              "labels": dict(e.get("labels", {})),
                              "value": e["value"]}
                else:
                    cur["value"] += e["value"]
        for e in snap.get("histograms", []):
            k = _series_key(e)
            cur = acc_h.get(k)
            if cur is None:
                acc_h[k] = {"name": e["name"],
                            "labels": dict(e.get("labels", {})),
                            "le": list(e["le"]),
                            "counts": list(e["counts"]),
                            "sum": e["sum"], "count": e["count"]}
                if e.get("exemplars"):
                    acc_h[k]["exemplars"] = {
                        b: list(rec) for b, rec in e["exemplars"].items()}
            elif cur["le"] != list(e["le"]):
                skipped.append(e["name"])
            else:
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], e["counts"])]
                cur["sum"] += e["sum"]
                cur["count"] += e["count"]
                for b, rec in (e.get("exemplars") or {}).items():
                    old = cur.get("exemplars", {}).get(b)
                    if old is None or rec[2] >= old[2]:
                        cur.setdefault("exemplars", {})[b] = list(rec)
    out["counters"] = [acc_c[k] for k in sorted(acc_c)]
    out["gauges"] = [acc_g[k] for k in sorted(acc_g)]
    out["histograms"] = [acc_h[k] for k in sorted(acc_h)]
    if skipped:
        out["skipped"] = sorted(set(skipped))
    return out


def snapshot_quantile(hist_entry: dict, q: float) -> float:
    """Interpolated quantile in [0, 100] straight off a snapshot's
    histogram entry, as ``histogram_quantile`` reads it: uniform within
    the winning bucket, lower edge 0 for the first, the +Inf bucket
    clamped to the last finite bound; nan when empty."""
    if not (0 <= q <= 100):
        raise ValueError("q must be in [0, 100]")
    bounds = [float(b) for b in hist_entry["le"]]
    counts = list(hist_entry["counts"])
    total = hist_entry["count"]
    if total == 0:
        return float("nan")
    rank = q / 100.0 * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):  # +Inf bucket
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - prev_cum) / c if c else 0.0
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return bounds[-1]


def synthesize_requests(snapshot: dict,
                        hist_name: str = "tpums_server_latency_seconds",
                        counter_name: str = "tpums_server_requests_total",
                        ) -> dict:
    """Derive the per-verb ``tpums_server_requests_total`` counter series
    from the latency histogram's count, in place -> the snapshot.

    Every request observes its latency exactly once, so the histogram
    count IS the request count; materializing the counter here (snapshot
    time, scrape rate) instead of inc'ing a second instrument on every
    request halves the hot path's locked operations.  Merge stays
    consistent: counters sum and the underlying histogram counts sum."""
    have = {_series_key(e) for e in snapshot.get("counters", [])}
    for h in snapshot.get("histograms", []):
        if h["name"] != hist_name:
            continue
        entry = {"name": counter_name,
                 "labels": dict(h.get("labels", {})),
                 "value": h["count"]}
        if _series_key(entry) not in have:
            snapshot["counters"].append(entry)
    return snapshot


def snapshot_to_json_line(snapshot: dict) -> str:
    """Single-line JSON (the METRICS verb's wire payload — the protocol is
    line-framed, so the snapshot must never contain a raw newline)."""
    return json.dumps(snapshot, separators=(",", ":"))


# ---------------------------------------------------------------------------
# bench percentiles and deltas
# ---------------------------------------------------------------------------

def bucketed_quantiles(values: Sequence[float], qs: Sequence[float],
                       bounds: Sequence[float] = LATENCY_BUCKETS_S
                       ) -> List[float]:
    """Interpolated quantiles of ``values`` computed THROUGH the shared
    bucket ladder: the same estimate a scraped serving histogram yields for
    the same data.  Pure computation: unaffected by the enable switch."""
    h = Histogram("_bucketed", bounds=bounds).fill(values)
    return [h.quantile(q) for q in qs]


def diff_snapshots(before: dict, after: dict) -> dict:
    """Compact before/after delta for bench detail records: counters that
    moved, histogram count/sum deltas, and gauges at their AFTER value
    (gauges are levels, not flows)."""
    def index(snap, kind):
        return {_series_key(e): e for e in snap.get(kind, [])}

    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    b_c = index(before, "counters")
    for k, e in index(after, "counters").items():
        d = e["value"] - b_c.get(k, {}).get("value", 0)
        if d:
            out["counters"][_fmt_series(e)] = d
    for k, e in index(after, "gauges").items():
        if e["value"]:
            out["gauges"][_fmt_series(e)] = round(e["value"], 6)
    b_h = index(before, "histograms")
    for k, e in index(after, "histograms").items():
        prev = b_h.get(k, {"count": 0, "sum": 0.0})
        dc = e["count"] - prev["count"]
        if dc:
            out["histograms"][_fmt_series(e)] = {
                "count": dc, "sum": round(e["sum"] - prev["sum"], 6)}
    return out


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _fmt_series(entry: dict, name: Optional[str] = None,
                extra: Optional[dict] = None) -> str:
    labels = dict(entry.get("labels", {}))
    if extra:
        labels.update(extra)
    base = name or entry["name"]
    if not labels:
        return base
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
    return f"{base}{{{inner}}}"


def _escape_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt_float(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(float(v))


def render_prometheus(snapshot: dict) -> str:
    """Snapshot -> Prometheus text exposition format 0.0.4 (counters as
    ``counter``, gauges as ``gauge``, histograms as cumulative ``_bucket``
    series plus ``_sum``/``_count``)."""
    lines: List[str] = []
    seen_type: set = set()

    def typ(name: str, kind: str) -> None:
        if name not in seen_type:
            seen_type.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for e in snapshot.get("counters", []):
        typ(e["name"], "counter")
        lines.append(f"{_fmt_series(e)} {e['value']}")
    for e in snapshot.get("gauges", []):
        typ(e["name"], "gauge")
        lines.append(f"{_fmt_series(e)} {_fmt_float(e['value'])}")
    for e in snapshot.get("histograms", []):
        name = e["name"]
        typ(name, "histogram")
        cum = 0
        for bound, c in zip(e["le"], e["counts"]):
            cum += c
            lines.append(
                f"{_fmt_series(e, name + '_bucket', {'le': _fmt_float(bound)})}"
                f" {cum}")
        if len(e["counts"]) > len(e["le"]):
            cum += e["counts"][len(e["le"])]
        lines.append(
            f"{_fmt_series(e, name + '_bucket', {'le': '+Inf'})} {cum}")
        lines.append(f"{_fmt_series(e, name + '_sum')} {_fmt_float(e['sum'])}")
        lines.append(f"{_fmt_series(e, name + '_count')} {e['count']}")
    return "\n".join(lines) + ("\n" if lines else "")
