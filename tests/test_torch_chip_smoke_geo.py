"""Rehearsal of ``chip_smoke.py``'s phase 22 (geo-replication and the edge
proxy) on the CPU at a small size, through ``--geo-only``: every member a
``--device cpu`` process, the proxies processes of their own, the
rehearsal's group a 2 x 2 of CPU members behind two proxies; (a)'s byte
check failing on a changed follower; and the script's argument parsing.
(Phase 22 has a file of its own so that the suite's file-by-file
scheduling runs it beside the rehearsals of the other phases.)"""

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


def test_geo_only_rehearsal(small_geo, capsys):
    """``--geo-only`` on the CPU: phase 22's (a)-(d) pass their checks and
    print their lines, and the script leaves no process of its own."""
    assert chip_smoke.geo_only(torch, torch.device("cpu")) == 0
    out = capsys.readouterr().out
    for line in ("geo (a) replication (a CPU, no power limit)",
                 "geo (a) lag under forwarded SGD",
                 "geo (a) st= on an eu member across a partition",
                 "geo (b) edge (a CPU, no power limit)",
                 "geo (b) coalescing", "geo (b) proxy SIGKILL",
                 "geo (b) eu proxy", "geo (b) latency",
                 "geo (c) failover", "geo (d) rehearsal",
                 "geo (d) the proxy tier's fleet signals", "geo phase:"):
        assert line in out, line
    assert "byte for byte" in out
    assert "missed 0, duplicates 0" in out
    assert out.strip().splitlines()[-1] == "a CPU, no power limit"
    assert chip_smoke.own_processes(helpers=False) == {}


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
