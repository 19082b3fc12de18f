"""Rehearsal of ``chip_smoke.py``'s phase 22 (geo-replication and the edge
proxy) on the CPU at a small size, through ``--geo-only``: every member a
``--device cpu`` process, the proxies processes of their own, the
rehearsal's group a 2 x 2 of CPU members behind two proxies; (a)'s byte
check failing on a changed follower; and the script's argument parsing.
(Phase 22 has a file of its own so that the suite's file-by-file
scheduling runs it beside the rehearsals of the other phases.)"""

import re

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture
def small_geo(monkeypatch):
    """Phase 22 at a small size: seeded rank-8 rows of 1,200 users and
    1,100 items, the streams shrunk, and a liveness a busy test host
    keeps (its promotion bound widened to match: the follower promotes
    once the home region's leases lapse)."""
    # arenas start small and grow with their rows, so their files stay
    # dense (deleting a sparse file can cost one discard per extent)
    monkeypatch.setenv("TPUMS_ARENA_CAPACITY", "256")
    for name, value in (("N_USERS", 1200), ("N_ITEMS", 1100), ("RANK", 8),
                        ("JOB_TOPK_USERS", 16), ("FLEET_WAIT_S", 120.0),
                        ("GEO_TOPK_USERS", 16), ("GEO_KEYS", 32),
                        ("GEO_SGD_S", 1.0), ("GEO_PUSH_SUBS", 3),
                        ("GEO_LOAD_S", 1.0), ("GEO_PROMOTE_S", 20.0),
                        ("GEO_REHEARSAL_USERS", 300),
                        ("card_line", lambda: "a CPU, no power limit")):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "GEO_ENV", dict(
        chip_smoke.GEO_ENV, TPUMS_REPLICA_TTL_S="6"))
    monkeypatch.setattr(chip_smoke, "OBS_REHEARSAL_ENV", dict(
        chip_smoke.OBS_REHEARSAL_ENV, TPUMS_REPLICA_TTL_S="10"))
    # the autoscaler decides but does not act ("dry"), as phase 21's
    # rehearsal on the CPU
    monkeypatch.setattr(chip_smoke, "OBS_REHEARSAL", dict(
        chip_smoke.OBS_REHEARSAL, users=300, dim=8, base_qps=30.0,
        peak_qps=60.0, burst_qps=120.0, duration_s=6.0, subscribers=4,
        autoscale="dry"))


def _record_order(monkeypatch):
    """Record when (d)'s process starts, is released and is joined, and
    when (a), its lag read and (c) begin and end."""
    order = []

    class Recorded(chip_smoke.Rehearsal):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            order.append("(d) started")

        def release(self):
            order.append("(d) released")
            return super().release()

        def finish(self):
            order.append("(d) joined")
            return super().finish()

    monkeypatch.setattr(chip_smoke, "Rehearsal", Recorded)
    for name, mark in (("geo_regions", "(a)"),
                       ("geo_replication", "(a)'s lag"),
                       ("geo_failover", "(c)")):
        real = getattr(chip_smoke, name)

        def wrapped(g, card, real=real, mark=mark):
            order.append(f"{mark} began")
            try:
                return real(g, card)
            finally:
                order.append(f"{mark} ended")

        monkeypatch.setattr(chip_smoke, name, wrapped)
    return order


def test_geo_only_rehearsal(small_geo, capsys, monkeypatch):
    """``--geo-only`` on the CPU: phase 22's (a)-(d) pass their checks and
    print their lines, (d)'s process starts before (a), its rehearsal
    once (a) has read the lag, and is joined after (c), every member's
    largest heartbeat gap and every stall are
    printed, and the script leaves no process of its own."""
    order = _record_order(monkeypatch)
    assert chip_smoke.geo_only(torch, torch.device("cpu")) == 0
    out = capsys.readouterr().out
    for line in ("geo (a) replication (a CPU, no power limit)",
                 "geo (a) lag under forwarded SGD",
                 "geo (a) st= on an eu member across a partition",
                 "geo (b) edge (a CPU, no power limit)",
                 "geo (b) coalescing", "geo (b) proxy SIGKILL",
                 "geo (b) eu proxy", "geo (b) latency",
                 "geo (c) failover", "geo (d) rehearsal",
                 "geo (d) the proxy tier's fleet signals",
                 "geo (a)-(c) respawns by supervisor",
                 "geo heartbeats: 15 members", "geo the largest gap",
                 "geo stalls of 0.3 s or more", "geo phase:"):
        assert line in out, line
    # (a)'s lag window taken apart, on a line of its own before the lag's
    (apart,) = [ln for ln in out.splitlines() if "window taken apart" in ln]
    assert out.index(apart) < out.index("geo (a) lag under forwarded SGD")
    for field in (r"[0-9]+ replicator steps in [0-9.]+ s \([0-9]+ read data\)",
                  r"[0-9]+ caught-up instants",
                  r"the longest run without one: [0-9]+ steps, [0-9.]+ ms "
                  r"\(read [0-9.]+, write [0-9.]+, fsync [0-9.]+, status "
                  r"[0-9.]+, rest [0-9.]+, between steps",
                  r"read [0-9.]+/[0-9.]+/[0-9.]+; write [0-9.]+/[0-9.]+/",
                  r"fsync [0-9.]+/[0-9.]+/[0-9.]+; status [0-9.]+/",
                  r"status record written [0-9]+ times",
                  r"appends to home's topic [0-9.]+/s by the update planes "
                  r"\(us@@geo@g1:s",
                  r"fsyncs: the forwarder's [0-9]+ \(",
                  r"the replicator's [0-9]+ [0-9.]+/[0-9.]+/[0-9.]+ ms",
                  r"the 5 ms sampler late by [0-9.]+/[0-9.]+/[0-9.]+ ms",
                  r"this process's stalls of 0.3 s in the window: ",
                  r"its threads: MainThread, .*tpums-georepl-eu-",
                  r"CPU s in the window: us members [0-9.]+, eu members "
                  r"[0-9.]+, proxies [0-9.]+, \(d\) [0-9.]+, this process "
                  r"[0-9.]+, its replicator thread [0-9.]+",
                  r"journals on \S+ at /"):
        assert re.search(field, apart), field
    assert order == ["(d) started", "(a) began", "(a) ended",
                     "(a)'s lag began", "(a)'s lag ended", "(d) released",
                     "(c) began", "(c) ended", "(d) joined"]
    # every member of both regions, the proxies, and (d)'s members
    for job in ("us@@geo@g1:s0r0", "us@@geo@g1:s1r1", "eu@@geo@g1:s1r0",
                "rehearsal@g1:s0r0", "edge/us@@geo/proxy-1"):
        assert f" {job} " in out, job
    assert "(SIGSTOPped 0.8 s in (b))" in out
    assert "byte for byte" in out
    assert "missed 0, duplicates 0" in out
    assert out.strip().splitlines()[-1] == "a CPU, no power limit"
    assert chip_smoke.own_processes(helpers=False) == {}


def test_an_extra_respawn_fails_phase_22(small_geo, capsys, monkeypatch):
    """A us member SIGKILLed after (b)'s surface check and respawned by
    its supervisor: every other check of (a)-(c) passes, and the phase
    fails on the respawn; (d) still ends by itself and its members with
    it, and the heartbeat report still prints."""
    import signal
    import time

    real = chip_smoke.geo_edge_surface

    def kill_one(g, card):
        got = real(g, card)
        sup = g.region[chip_smoke.GEO_HOME].active_supervisor
        sup.procs[(1, 1)].send_signal(signal.SIGKILL)
        deadline = time.time() + 60
        while sup.respawns == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert sup.respawns == 1
        assert sup.wait_all_ready(timeout_s=60)
        return got

    monkeypatch.setattr(chip_smoke, "geo_edge_surface", kill_one)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match=r"\(a\)-\(c\) respawned members: .*'us@@geo "
                             r"gen 1': 1"):
        chip_smoke.geo_only(torch, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "geo (c) failover" in out and "geo heartbeats:" in out
    assert re.search(r" us@@geo@g1:s1r1 [0-9.]+, 1 respawn(;|\n)", out)
    assert chip_smoke.own_processes(helpers=False) == {}


def test_a_respawned_member_is_named_with_its_exit(small_geo, capsys,
                                                  monkeypatch):
    """The us replica (b) SIGSTOPs, SIGKILLed once (b) has continued it:
    phase 22's failure names the member, its pid, its exit (-9, SIGKILL)
    and the last lines of the stall file its watchdog kept, and the log
    says the same."""
    import signal
    import time

    real = chip_smoke.geo_edge
    killed = []

    def kill_in_b(g, card):
        sup = g.region[chip_smoke.GEO_HOME].active_supervisor

        def kill():
            victim = sup.procs[(0, 0)]
            killed.append(victim.pid)
            victim.send_signal(signal.SIGKILL)
            deadline = time.time() + 60
            while sup.respawns == 0 and time.time() < deadline:
                time.sleep(0.05)
            assert sup.wait_all_ready(timeout_s=60)

        # (b) reads 4 counters before it stops the replica and 2 after
        monkeypatch.setattr(chip_smoke, "edge_counter",
                            _after_first(chip_smoke.edge_counter, 4, kill))
        return real(g, card)

    monkeypatch.setattr(chip_smoke, "geo_edge", kill_in_b)
    with pytest.raises(chip_smoke.SmokeFailure) as err:
        chip_smoke.geo_only(torch, torch.device("cpu"))
    (pid,) = killed
    said = (rf"us@@geo@g1:s0r0 pid {pid} exited rc -9 \(SIGKILL\); "
            rf"stall-{pid}\.txt ended: ")
    assert re.search(r"\(a\)-\(c\) respawned members: .*'us@@geo gen 1': "
                     r"1.*; " + said, str(err.value)), str(err.value)
    out = capsys.readouterr().out
    assert re.search(r"geo \(a\)-\(c\) members that exited and were "
                     r"respawned: " + said, out)
    assert chip_smoke.own_processes(helpers=False) == {}


def _after_first(fn, calls, then):
    """``fn``, which runs ``then`` once, after its first ``calls`` calls."""
    n = [0]

    def wrapped(*a, **k):
        n[0] += 1
        if n[0] == calls + 1:
            then()
        return fn(*a, **k)

    return wrapped


def test_geo_byte_check_fails_on_a_changed_follower(small_geo, tmp_path):
    """(a)'s byte check passes on a caught-up follower, and fails once one
    byte of the follower journal differs from home's; the run stops its
    replicator."""
    import os

    rows = chip_smoke.seeded_published()
    base = chip_smoke.fleet_baseline(rows, torch.device("cpu"), 16)
    g = chip_smoke.GeoRun(str(tmp_path), base, torch.device("cpu"))
    try:
        assert "byte for byte" in chip_smoke.geo_byte_equal(g, "(a) test")
        seg = os.path.join(g.eu_dir, f"{chip_smoke.JOB_TOPIC}.log")
        with open(seg, "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 1]))
        with pytest.raises(chip_smoke.SmokeFailure,
                           match="follower files differ from home's"):
            chip_smoke.geo_byte_equal(g, "(a) test")
    finally:
        g.close()


@pytest.mark.parametrize("argv,called", [
    (["--geo-only"], ("geo_only",)),
    (["--obs-only"], ("obs_only", [])),
    (["--obs-only", "40000", "138493"], ("obs_only", [40000, 138493])),
    (["--multi-gpu"], ("multi_gpu_only",)),
])
def test_arguments_choose_the_mode(monkeypatch, argv, called):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "geo_only",
                        lambda torch, dev: calls.append(("geo_only",)) or 0)
    monkeypatch.setattr(chip_smoke, "obs_only",
                        lambda torch, dev, users:
                        calls.append(("obs_only", users)) or 0)
    monkeypatch.setattr(chip_smoke, "multi_gpu_only",
                        lambda torch, dev:
                        calls.append(("multi_gpu_only",)) or 0)
    assert chip_smoke.main(argv) == 0
    assert calls == [called]


@pytest.mark.parametrize("argv", [["--geo-only", "1"], ["--geo"],
                                  ["--obs-only", "x"], ["--bogus"]])
def test_unknown_arguments_are_refused(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert chip_smoke.main(argv) == 2
    captured = capsys.readouterr()
    assert "unknown arguments" in captured.err and captured.out == ""


def test_geo_only_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(["--geo-only"]) != 0
    assert capsys.readouterr().out == ""


def test_seeded_rows_are_the_served_shape(monkeypatch):
    monkeypatch.setattr(chip_smoke, "N_USERS", 30)
    monkeypatch.setattr(chip_smoke, "N_ITEMS", 20)
    rows = chip_smoke.seeded_published()
    assert len(rows) == 30 + 20 + 2
    assert rows[0].startswith("0,U,") and rows[30].startswith("0,I,")
    assert len(rows[0].split(",")[2].split(";")) == chip_smoke.RANK
    assert rows == chip_smoke.seeded_published()
    np.testing.assert_equal(len({r.split(",")[0] for r in rows[:30]}), 30)


def test_a_failure_before_the_lag_read_stops_the_held_rehearsal(
        small_geo, capsys, monkeypatch):
    """(a) failing before it has read the lag: (d)'s process, still held,
    is stopped before it starts a member, and nothing of the phase is
    left."""

    def fail(g, card):
        raise chip_smoke.SmokeFailure("(b) a surface check failed here")

    monkeypatch.setattr(chip_smoke, "geo_edge_surface", fail)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="a surface check failed here"):
        chip_smoke.geo_only(torch, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "geo (d) rehearsal" not in out and "rehearsal@g1" not in out
    assert "geo heartbeats:" in out
    assert chip_smoke.own_processes(helpers=False) == {}


def test_stall_watch_reads_gaps_stalls_and_late_heartbeats(tmp_path):
    """The watchdog, in a process of its own that heartbeats a registry
    entry: a pause of 1 s between heartbeats is the member's largest gap
    and a late heartbeat, dumped; a C call that keeps the GIL 0.6 s is a
    stall, dumped with its thread's frames; ``StallWatch`` reads them, and
    the watchdog stops."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"""
import ctypes, sys, time
sys.path.insert(0, {root!r})
import chip_smoke
ns = {{}}
exec(chip_smoke.STALL_WATCHDOG, ns)
stop = ns["watch_stalls"]({str(tmp_path / "stalls")!r}, 0.3)
from flink_ms_tpu_torch.serve import registry

def beat():
    registry.register("g@g1:s0r0", "127.0.0.1", 1, "S", replica_of="g",
                      replica=0, ready=True, ttl_s=1.5)

def held_gil():
    ctypes.PyDLL(None).usleep(600000)

for _ in range(8):
    beat()
    time.sleep(0.25)
time.sleep(1.0)
for _ in range(4):
    beat()
    time.sleep(0.25)
held_gil()
time.sleep(0.2)
stop()
"""
    (tmp_path / "stalls").mkdir()
    env = dict(os.environ, TPUMS_REGISTRY_DIR=str(tmp_path / "reg"),
               TPUMS_HEARTBEAT_S="0.25")
    env.pop("TPUMS_STALL_DIR", None)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=60)
    members, events = chip_smoke.StallWatch(str(tmp_path)).read()
    assert list(members) == ["g@g1:s0r0"]
    ((pid, gap, _),) = members["g@g1:s0r0"]
    assert 1.2 <= gap <= 1.6
    kinds = {kind: (s, frames) for _, s, p, kind, frames in events
             if p == pid}
    assert set(kinds) == {"stall", "heartbeat late"}, events
    assert kinds["stall"][0] >= 0.5 and "held_gil" in kinds["stall"][1]
    assert 0.8 <= kinds["heartbeat late"][0] <= 1.4
    assert "<string>" in kinds["heartbeat late"][1]


@pytest.mark.parametrize("when,kind", [
    ("live", "crash (Fatal Python error: Aborted)"),
    ("exit", "crash at its exit (Fatal Python error: Aborted)"),
])
def test_stall_watch_tells_a_live_crash_from_one_at_exit(tmp_path, when,
                                                         kind):
    """A process that aborts while it runs is a crash the phase fails on;
    one that aborts once its interpreter is ending is printed as a crash
    at its exit."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "stalls").mkdir()
    code = f"""
import atexit, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
if {when!r} == "exit":
    atexit.register(os.abort)      # runs after the watchdog's own
ns = {{}}
exec(chip_smoke.STALL_WATCHDOG, ns)
ns["watch_stalls"]({str(tmp_path / "stalls")!r}, 0.3)
if {when!r} == "live":
    os.abort()
"""
    got = subprocess.run([sys.executable, "-c", code], timeout=60,
                         capture_output=True)
    assert got.returncode != 0
    _, events = chip_smoke.StallWatch(str(tmp_path)).read()
    assert [e[3] for e in events] == [kind]


def test_a_crash_at_exit_fails_phase_22_and_names_its_threads(tmp_path):
    """A process whose daemon thread is inside a torch call as its
    interpreter ends aborts; the watchdog names the threads alive at its
    exit, with their frames, and keeps what the C++ runtime wrote to a
    stderr thrown away; the report counts the crash, so phase 22 fails
    on it."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "stalls").mkdir()
    code = f"""
import sys, threading, time
sys.path.insert(0, {root!r})
import chip_smoke, torch
ns = {{}}
exec(chip_smoke.STALL_WATCHDOG, ns)
ns["watch_stalls"]({str(tmp_path / "stalls")!r}, 0.3)

def first_topk():
    a = torch.randn(300, 300)
    while True:
        a @ a

threading.Thread(target=first_topk, name="topk-cuda-warm",
                 daemon=True).start()
time.sleep(0.3)
"""
    got = subprocess.run([sys.executable, "-c", code], timeout=60,
                         stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    assert got.returncode != 0
    watch = chip_smoke.StallWatch(str(tmp_path))
    _, events = watch.read()
    ((_, _, _, kind, where),) = events
    assert kind == "crash at its exit (Fatal Python error: Aborted)"
    assert "threads alive at its exit: topk-cuda-warm (daemon) at " \
        "<string>" in where and "first_topk" in where
    assert "terminate called without an active exception" in where
    assert len(watch.report("geo", "1.5")["crashes"]) == 1
