"""The port's small helpers: ``utils/profiling.py`` (sync, traces) and
``parallel/mesh.py`` (``num_blocks``)."""

import json
import os

import torch

from flink_ms_tpu_torch.parallel import mesh
from flink_ms_tpu_torch.utils import profiling


def test_one_block_on_one_card():
    assert mesh.num_blocks() == 1


def test_hard_sync_returns_first_element():
    t = torch.tensor([[2.5, 1.0], [3.0, 4.0]])
    assert profiling.hard_sync(t) == 2.5
    assert profiling.hard_sync((t[1], t)) == 3.0


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(None):
        pass  # no-op
    out = tmp_path / "prof"
    with profiling.trace(str(out)):
        torch.ones(4).sum()
    with open(os.path.join(out, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
