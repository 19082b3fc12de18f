"""Phase 22's stall watchdog in a serving member that is SIGSTOPped and
SIGCONTed, as phase 22 (b) stops a replica for ``GEO_STOP_S`` inside its
TTL.

A stop longer than ``STALL_S`` is a stall the watchdog dumps.  It dumped
through a faulthandler timer, whose thread walks every thread's frames
without the GIL: armed before the stop, it fired as the member went on,
while the member's threads ran, started and ended (one a connection), and
killed the member by SIGSEGV.  That thread blocks every signal, so
faulthandler's own handler never ran and the member's stall file ended
in the middle of a dump, with no crash written.  The supervisor then
found the member gone and respawned it, and the geo rehearsal failed on
the respawn.  The watchdog now dumps from its own thread as it takes the
GIL back, under the GIL.  Each case runs a CPU member in a process of its
own, with the watchdog armed as phase 22 arms it (``StallWatch``'s
``sitecustomize``), under a churn of short client connections."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CYCLES = 40            # stops a member must outlive
CHURN = 32             # client threads, a connection each GET


def _member(tmp_path):
    """A 1-shard member over a small journal, watched as phase 22 watches
    its processes -> (its process, its port, the watch)."""
    from flink_ms_tpu_torch.core import formats as F
    from flink_ms_tpu_torch.serve.journal import Journal
    from flink_ms_tpu_torch.serve.sharded import spawn_worker_procs

    rng = np.random.default_rng(0)
    jd = tmp_path / "journal"
    Journal(str(jd), "t").append(
        [F.format_als_row(i, "U", rng.normal(size=8)) for i in range(300)]
        + [F.format_als_row(i, "I", rng.normal(size=8)) for i in range(200)])
    watch = chip_smoke.StallWatch(str(tmp_path))
    os.makedirs(watch.site)
    os.makedirs(watch.dir)
    with open(os.path.join(watch.site, "sitecustomize.py"), "w") as f:
        f.write(chip_smoke.STALL_WATCHDOG)
    env = dict(os.environ, PYTHONPATH=watch.site, TPUMS_STALL_DIR=watch.dir,
               TPUMS_REGISTRY_DIR=str(tmp_path / "registry"),
               TPUMS_HEARTBEAT_S="0.25")
    (tmp_path / "ports").mkdir()
    procs, ports = spawn_worker_procs(
        1, str(jd), "t", str(tmp_path / "ports"),
        extra_args=["--replicaIndex", "0", "--jobGroup", "g"], env=env,
        device="cpu")
    return procs[0], ports[0], watch


def test_a_sigstopped_member_outlives_its_stall_dumps(tmp_path):
    """``CYCLES`` stops of ``GEO_STOP_S`` under a churn of connections: the
    member lives through every one, each stop is a stall of the member's
    stall file with every thread's stack, and the member still answers."""
    from flink_ms_tpu_torch.serve.client import QueryClient

    proc, port, watch = _member(tmp_path)
    stop, gets, errors = threading.Event(), [0], []

    def churn(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                with QueryClient("127.0.0.1", port, timeout_s=10) as c:
                    c.query_state("ALS_MODEL", f"{rng.integers(300)}-U")
                gets[0] += 1
            except Exception as e:     # only after the member is gone
                errors.append(repr(e))
                time.sleep(0.05)

    threads = [threading.Thread(target=churn, args=(k,), daemon=True)
               for k in range(CHURN)]
    for t in threads:
        t.start()
    died = None
    try:
        for k in range(CYCLES):
            proc.send_signal(signal.SIGSTOP)
            time.sleep(chip_smoke.GEO_STOP_S)
            proc.send_signal(signal.SIGCONT)
            time.sleep(0.25)
            if proc.poll() is not None:
                died = k + 1
                break
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15)
        rc = proc.poll()
        if rc is None:
            with QueryClient("127.0.0.1", port, timeout_s=10) as c:
                answered = c.query_state("ALS_MODEL", "7-U") is not None
            proc.terminate()
            proc.wait(timeout=30)
    with open(os.path.join(watch.dir, f"stall-{proc.pid}.txt"),
              errors="replace") as f:
        tail = f.read()[-400:]
    assert died is None and rc is None, (
        f"the member exited rc {rc} after {died} of {CYCLES} stops; its "
        f"stall file ended {tail!r}")
    assert answered and gets[0] > 0
    _, events = watch.read()
    stalls = [e for e in events if e[2] == proc.pid and e[3] == "stall"]
    # each stop is a stall of about its length, each with the threads'
    # stacks
    stops = [s for s in stalls if s[1] >= chip_smoke.GEO_STOP_S * 0.9]
    assert len(stops) >= CYCLES * 3 // 4, (len(stops), tail)
    assert all(s[4] != "no dump" for s in stalls), stalls[:3]


def test_a_stall_is_dumped_under_the_gil_with_no_timer(tmp_path):
    """A process whose main thread holds the GIL 0.6 s in a C call: the
    stall is dumped once the watchdog's thread has the GIL back, with the
    holder's frame still on top, and the watchdog never arms a
    faulthandler timer (its thread would walk the frames without the
    GIL)."""
    code = f"""
import ctypes, faulthandler, sys, time
sys.path.insert(0, {ROOT!r})
armed = []
faulthandler.dump_traceback_later = lambda *a, **k: armed.append(a)
import chip_smoke
ns = {{}}
exec(chip_smoke.STALL_WATCHDOG, ns)
stop = ns["watch_stalls"]({str(tmp_path / "stalls")!r}, 0.3)

def held_gil():
    ctypes.PyDLL(None).usleep(600000)

time.sleep(0.2)
held_gil()
time.sleep(0.2)
stop()
assert not armed, armed
"""
    (tmp_path / "stalls").mkdir()
    env = dict(os.environ)
    env.pop("TPUMS_STALL_DIR", None)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=60)
    _, events = chip_smoke.StallWatch(str(tmp_path)).read()
    ((_, sec, _, kind, frames),) = events
    assert kind == "stall" and sec >= 0.5
    assert frames.startswith("<string>") and "held_gil" in frames


def test_a_stopped_watch_leaves_its_process_as_it_found_it(tmp_path,
                                                           monkeypatch):
    """``StallWatch`` in this process, as phase 22 runs it: one watchdog
    while it watches, none once stopped, and ``registry.register`` its own
    again, so a later heartbeat of this process (a later test's) writes to
    no file of the stopped watch, whose fd number another file may have
    taken."""
    from flink_ms_tpu_torch.serve import registry

    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "registry"))
    monkeypatch.delenv("TPUMS_STALL_DIR", raising=False)
    real = registry.register

    def dogs():
        return [t for t in threading.enumerate()
                if t.name == "stall-watchdog" and t.is_alive()]

    watch = chip_smoke.StallWatch(str(tmp_path)).start()
    try:
        assert len(dogs()) == 1
        deadline = time.time() + 10
        while registry.register is real and time.time() < deadline:
            time.sleep(0.02)
        assert registry.register is not real
    finally:
        watch.stop()
    assert registry.register is real and not dogs()
    assert "TPUMS_STALL_DIR" not in os.environ
    registry.register("g@g1:s0r0", "127.0.0.1", 1, "S", replica_of="g",
                      replica=0, ready=True, ttl_s=1.5)
    with open(os.path.join(watch.dir, f"stall-{os.getpid()}.txt")) as f:
        assert "--- member" not in f.read()
