"""Process-wide metrics registry of the port's serving path.

Own copy of the subset of ``flink_ms_tpu/obs/metrics.py`` that the top-k
index and the batcher record: monotonic counters, labelled gauges and
fixed-bucket log-spaced histograms in one get-or-create registry, with the
``TPUMS_METRICS=0`` switch that makes every observation a no-op.  The
port's registry is its own; the JAX package's is not shared.

Every instrument takes its own lock per observation: ``+=`` on an
attribute is a read-modify-write that can lose updates across threads.
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Dict, Sequence, Tuple

_ENABLED = os.environ.get("TPUMS_METRICS", "1") != "0"


def metrics_enabled() -> bool:
    return _ENABLED


def log_buckets(lo: float, hi: float, per_decade: int = 16) -> Tuple[float, ...]:
    """Log-spaced upper bounds from ``lo`` to >= ``hi`` (``per_decade``
    buckets per factor of 10)."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError("need 0 < lo < hi and per_decade >= 1")
    ratio = 10.0 ** (1.0 / per_decade)
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * ratio)
    return tuple(out)


# the latency ladder, 1 us .. 100 s at 16 buckets a decade, and the
# batch-size ladder, 1 .. 64k at 8 a decade (the reference's bounds)
LATENCY_BUCKETS_S: Tuple[float, ...] = log_buckets(1e-6, 100.0, 16)
SIZE_BUCKETS: Tuple[float, ...] = log_buckets(1.0, 65536.0, 8)


class Counter:
    """Monotonic counter; negative increments are refused."""

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
    """Last-write-wins instantaneous value."""

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

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram: ``observe(v)`` counts ``v`` into the first
    bucket whose upper bound is >= v (values above the last bound land in
    the overflow slot)."""

    __slots__ = ("name", "labels", "bounds", "_lock", "_counts", "_sum",
                 "_count")

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
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create instrument store: the same ``(name, labels)`` returns
    the same instrument, so call sites look it up once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[tuple, Counter] = {}
        self._gauges: Dict[tuple, Gauge] = {}
        self._histograms: Dict[tuple, Histogram] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            return self._counters.setdefault(key, Counter(name, key[1]))

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            return self._gauges.setdefault(key, Gauge(name, key[1]))

    def histogram(self, name: str, bounds: Sequence[float] = LATENCY_BUCKETS_S,
                  **labels: str) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(name, key[1], bounds)
            return h


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
