"""Tracing and device sync.

Counterpart of ``flink_ms_tpu/utils/profiling.py``: ``hard_sync`` waits
for the card with ``torch.cuda.synchronize``, and ``trace`` records a
``torch.profiler`` trace (host and CUDA activity) in place of the XLA
profiler.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

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

