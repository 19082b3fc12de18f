"""Teardown leaves no process running: a stopped ``ReplicaSupervisor``
launches and respawns nothing, ``ScaleController.stop`` aborts a cutover
that another thread is running and stops its warming generation, and
``chip_smoke.py``'s sweep finds and stops every process a run started,
one whose parent died before it included, and no other."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

import chip_smoke
from flink_ms_tpu_torch.serve.elastic import ScaleController, ScaleError
from flink_ms_tpu_torch.serve.ha import ReplicaSupervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _DeadProc:
    pid = 0

    def poll(self):
        return -9

    def kill(self):
        pass


def _supervisor(tmp_path):
    return ReplicaSupervisor(1, 1, str(tmp_path / "bus"), "models",
                             str(tmp_path / "ports"), device="cpu",
                             respawn_delay_s=0.0)


def test_a_stopped_supervisor_launches_nothing(tmp_path, monkeypatch):
    def popen(*a, **kw):
        raise AssertionError("a stopped supervisor started a process")

    monkeypatch.setattr(subprocess, "Popen", popen)
    sup = _supervisor(tmp_path)
    sup.stop()
    with pytest.raises(RuntimeError, match="is stopped"):
        sup._launch(0, 0)
    assert sup.procs == {}


@pytest.mark.parametrize("stopped", [False, True])
def test_the_monitor_respawns_only_while_running(tmp_path, stopped):
    """A dead member past its respawn delay is respawned by a running
    supervisor, and not once ``stop`` has begun (whose join of the monitor
    can time out while the monitor goes on checking)."""
    sup = _supervisor(tmp_path)
    spawned = []
    sup._spawn = lambda shard, replica: spawned.append((shard, replica))
    sup.procs[(0, 0)] = _DeadProc()
    if stopped:
        sup._stop.set()
    sup._check_once()
    assert spawned == ([] if stopped else [(0, 0)])
    assert sup.respawns == (0 if stopped else 1)


class _WarmingSup:
    """A generation that never becomes ready until it is stopped."""

    def __init__(self):
        self.started = self.stopped = False

    def start(self):
        self.started = True
        return self

    def wait_all_ready(self, timeout_s=1.0):
        time.sleep(min(timeout_s, 0.02))
        return False

    def stop(self):
        self.stopped = True


@pytest.mark.parametrize("when", ["while_warming", "before_the_spawn"])
def test_stop_aborts_a_cutover_and_stops_its_warming_generation(tmp_path,
                                                                when):
    """``stop`` on one thread while ``scale_to`` runs on another (the
    autoscaler's): the cutover raises ``ScaleError`` within a second,
    publishes nothing, and its warming generation is stopped, whether
    ``stop`` came while the generation warmed or before it was spawned."""
    ctl = ScaleController("tear", str(tmp_path / "bus"), "models",
                          port_dir=str(tmp_path / "ports"), device="cpu",
                          ready_timeout_s=60)
    sup = _WarmingSup()

    def spawn_generation(gen, shards, replicas):
        if when == "before_the_spawn":
            ctl.stop()
        return sup

    ctl._spawn_generation = spawn_generation
    errors = []

    def cut():
        try:
            ctl.scale_to(2, replicas=1)
        except Exception as e:   # noqa: BLE001 - the thread's outcome
            errors.append(e)

    t = threading.Thread(target=cut)
    t0 = time.time()
    t.start()
    if when == "while_warming":
        while ctl.warming is None and time.time() - t0 < 10:
            time.sleep(0.01)
        assert ctl.warming is sup and sup.started
        ctl.stop()
    t.join(timeout=10)
    assert not t.is_alive() and time.time() - t0 < 5
    assert len(errors) == 1 and isinstance(errors[0], ScaleError)
    assert sup.stopped and ctl.supervisors == {} and ctl.warming is None
    assert ctl.current() is None


_SWEEP = r"""
import json, os, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke

os.environ[chip_smoke.RUN_MARK] = "sweep-" + str(os.getpid())
sleep = [sys.executable, "-c", "import time; time.sleep(60)"]
# an orphan that carries the mark: its parent exits at once
spawner = subprocess.run(
    [sys.executable, "-c",
     "import subprocess, sys; print(subprocess.Popen(sys.argv[1:], "
     "start_new_session=True, stdout=subprocess.DEVNULL, "
     "stderr=subprocess.DEVNULL).pid)", *sleep],
    capture_output=True, text=True, check=True)
orphan = int(spawner.stdout)
# a child without the mark, found as a descendant
child = subprocess.Popen(sleep, env={"PATH": os.environ.get("PATH", "")})
# an orphan without the mark: not this run's to stop
stranger = int(subprocess.run(
    [sys.executable, "-c",
     "import subprocess, sys; print(subprocess.Popen(sys.argv[1:], "
     "start_new_session=True, stdout=subprocess.DEVNULL, "
     "stderr=subprocess.DEVNULL, env={}).pid)",
     *sleep],
    capture_output=True, text=True, check=True).stdout)
time.sleep(0.2)
found = chip_smoke.own_processes()
said = []
stopped = chip_smoke.stop_leftovers("the test", say=said.append)
child.wait(timeout=10)
after = chip_smoke.own_processes()
alive = os.path.exists(f"/proc/{stranger}")
os.kill(stranger, 9)
print(json.dumps(dict(orphan=orphan, child=child.pid, stranger=stranger,
                      found=sorted(found), stopped=sorted(stopped),
                      after=sorted(after), said=said,
                      orphan_gone=not os.path.exists(f"/proc/{orphan}")
                      or open(f"/proc/{orphan}/stat").read().split(
                          ")")[1].split()[0] == "Z",
                      stranger_alive=alive)))
"""


def test_the_sweep_stops_what_the_run_started_and_nothing_else():
    """In a process of its own (the sweep stops its caller's descendants,
    and a test worker's may be other tests' servers)."""
    out = subprocess.run([sys.executable, "-c", _SWEEP, REPO],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["orphan"] in r["found"] and r["child"] in r["found"]
    assert r["stranger"] not in r["found"]
    assert r["stopped"] == r["found"] and r["after"] == []
    assert r["orphan_gone"] and r["stranger_alive"]
    assert r["said"][0].startswith("processes left running after the test")
    assert r["said"][-1] == f"stopped {len(r['found'])} of them"
