"""Tracing, device sync and per-step timing.

Counterpart of ``flink_ms_tpu/utils/profiling.py``: ``hard_sync`` waits
for the card with ``torch.cuda.synchronize``, ``trace`` records a
``torch.profiler`` trace (host and CUDA activity) in place of the XLA
profiler, and ``StepTimer`` is the reference's, copied.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Dict, List, Optional

import torch


def hard_sync(x) -> float:
    """Wait for the work that produces `x` (a tensor, or a sequence whose
    first element is one) and return one element as a Python float.

    CUDA calls return before the card finishes, so a timed region ends
    here: ``torch.cuda.synchronize`` on the tensor's device, then a value
    fetch."""
    t = x[0] if isinstance(x, (list, tuple)) else x
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0])


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """``torch.profiler`` trace of the enclosed block, written as
    ``<trace_dir>/trace.json`` (Chrome/Perfetto format; no-op when None).
    Records host activity, and CUDA activity when CUDA is available."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))



class StepTimer:
    """Wall-clock timer for repeated steps with percentile reporting.

    Usage::

        timer = StepTimer("als_iter")
        for _ in range(iters):
            with timer:
                step()
        print(timer.summary())

    The timer reads the host clock and does not wait for the card.  A
    step must end in a device-to-host copy for its time to cover the
    device work: a staged ALS iteration (``ops/als.py``) does, since it
    copies the factors to the host for its snapshot."""

    def __init__(self, name: str):
        self.name = name
        self.durations_s: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        assert self._t0 is not None
        self.durations_s.append(time.perf_counter() - self._t0)
        self._t0 = None

    def merge(self, other: "StepTimer") -> "StepTimer":
        """Absorb another timer's observations (per-worker timers into one
        distribution: percentiles over the merged sample are exact, unlike
        averaged per-worker percentiles).  Returns self."""
        self.durations_s.extend(other.durations_s)
        return self

    def to_histogram(self):
        """This timer's observations on the serving plane's shared latency
        ladder (``obs.metrics.LATENCY_BUCKETS_S``), so a bench percentile
        and a scraped serving percentile use the same buckets."""
        from ..obs.metrics import Histogram

        return Histogram(self.name).fill(self.durations_s)

    def percentile(self, q: float) -> float:
        if not self.durations_s:
            return float("nan")
        xs = sorted(self.durations_s)
        # nearest-rank: smallest value with cumulative share >= q
        idx = max(math.ceil(q / 100.0 * len(xs)) - 1, 0)
        return xs[min(idx, len(xs) - 1)]

    def stats(self) -> Dict[str, float]:
        n = len(self.durations_s)
        total = sum(self.durations_s)
        return {
            "name": self.name,
            "steps": n,
            "total_s": total,
            "mean_s": total / n if n else float("nan"),
            "p50_s": self.percentile(50),
            "p90_s": self.percentile(90),
            "p99_s": self.percentile(99),
            "p999_s": self.percentile(99.9),
        }

    def summary(self) -> str:
        s = self.stats()
        return (
            f"[{self.name}] {s['steps']} steps, {s['total_s']:.3f}s total, "
            f"mean {s['mean_s'] * 1e3:.2f}ms, p50 {s['p50_s'] * 1e3:.2f}ms, "
            f"p99 {s['p99_s'] * 1e3:.2f}ms"
        )

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.stats(), f)
            f.write("\n")
