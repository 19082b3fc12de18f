"""A serving member's exit with its index's background threads busy.

A daemon thread still inside a torch call when the interpreter ends aborts
the process (SIGABRT, "terminate called without an active exception") as
the call returns.  On the card, a fleet member respawned shortly before its
stop did so from its CUDA warm-up thread (``topk-cuda-warm``), which was
still in its first top-k.  ``ServingJob.stop`` closes the top-k handler,
whose index then starts no rebuild and waits for a running one and for the
warm-up.  Each case runs a CPU member in a process of its own, with a
warm-up (its torch calls stood in for by a CPU loop) or an index rebuild,
or both, in flight when it stops."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MEMBER = r"""
import sys, threading, time
sys.path.insert(0, {root!r})
import torch
from flink_ms_tpu_torch.serve import consumer as PC
from flink_ms_tpu_torch.serve import journal as PJ
from flink_ms_tpu_torch.serve import topk

BUSY_S = 1.5


def busy(*_):
    # torch calls that let the interpreter go, as the card's kernels do
    a = torch.randn(300, 300)
    t0 = time.monotonic()
    while time.monotonic() - t0 < BUSY_S:
        a @ a


journal = PJ.Journal({journal!r}, "t")
rows = ["%d,%s,%s" % (i, side, ";".join("%.3f" % ((i * 7 + j) % 11 / 10)
                                        for j in range(4)))
        for side in "UI" for i in range(40)]
journal.append(rows)
job = PC.ServingJob(journal, "ALS_MODEL", PC.parse_als_record,
                    PC.MemoryStateBackend(), host="127.0.0.1", port=0,
                    device="cpu").start()
assert job.wait_ready(30)
handler = job.server.topk_handlers["ALS_MODEL"]
assert handler("3", 5)            # the index is built
busy_in = {busy_in!r}
if "warm-up" in busy_in:
    # the card's warm-up, in flight: its torch calls stood in for on the CPU
    topk._warm_ops = busy
    torch.cuda.init = lambda: None
    topk._warm_async(torch.device("cuda", 0))
if "rebuild" in busy_in:
    index = handler.index
    real = index._assemble

    def slow(*a):
        busy()
        return real(*a)

    index._assemble = slow
    with index._lock:
        index._start_rebuild_locked()
time.sleep(0.2)
assert {{t.name for t in threading.enumerate()}} >= set(
    {{"warm-up": "topk-cuda-warm", "rebuild": "topk-rebuild"}}[b]
    for b in busy_in)
job.stop()
print("alive after stop:", sorted(t.name for t in threading.enumerate()
                                  if t.name.startswith("topk-")))
"""


@pytest.mark.parametrize("busy_in", [("warm-up",), ("rebuild",),
                                     ("warm-up", "rebuild")],
                         ids=["warm-up", "rebuild", "both"])
def test_a_member_stopped_with_its_index_busy_exits_cleanly(tmp_path,
                                                            busy_in):
    code = MEMBER.format(root=ROOT, journal=str(tmp_path / "j"),
                         busy_in=busy_in)
    env = dict(os.environ, TPUMS_REGISTRY_DIR=str(tmp_path / "reg"),
               TPUMS_TOPK_SHARDED="0", TPUMS_TOPK_TIER="exact",
               TPUMS_SNAPSHOTS="0", TPUMS_PROF="0")
    got = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]
    assert "alive after stop: []" in got.stdout
    assert "terminate called" not in got.stderr


def test_a_closed_index_rebuilds_in_the_callers_thread():
    """After its close the index still answers, and a query that needs a
    rebuild (a new item) gets one at once, in its own thread."""
    import threading

    import numpy as np

    from flink_ms_tpu_torch.serve.table import ModelTable
    from flink_ms_tpu_torch.serve.topk import DeviceFactorIndex

    table = ModelTable(4)
    for i in range(5):
        table.put(f"{i}-I", f"{i}.0;0.0")
    index = DeviceFactorIndex(table, device="cpu")
    query = np.array([1.0, 0.0], dtype=np.float32)
    assert [i for i, _ in index.topk(query, 2)] == ["4", "3"]
    index.close()
    table.put("9-I", "9.0;0.0")
    assert [i for i, _ in index.topk(query, 2)] == ["9", "4"]
    assert not [t for t in threading.enumerate()
                if t.name == "topk-rebuild"]
