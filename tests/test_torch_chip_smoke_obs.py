"""Rehearsal of ``chip_smoke.py``'s phase 21 (observability) on the CPU at
a small size: every member a ``--device cpu`` process, the CLIs processes
of their own, the rehearsal's group a 2 x 2 of CPU members under a kill
and the autoscaler's decisions; and one case where the phase must fail.
(Phase 21 has a file of its own so that the suite's file-by-file
scheduling runs it beside the rehearsals of the other phases.)"""

import os

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture
def small_obs(monkeypatch):
    """Phase 17's published topic at a small size (random rank-8 rows of
    1,200 users and 1,100 items, the MEAN rows, the one job's replies from
    ``fleet_baseline``) and phase 21's streams and rehearsal shrunk."""
    from flink_ms_tpu_torch.core import formats as F

    # arenas start small and grow with their rows, so their files stay
    # dense (deleting a sparse file can cost one discard per extent)
    monkeypatch.setenv("TPUMS_ARENA_CAPACITY", "256")
    # 400 TOPK: the profiler counts a thread only when its CPU clock (10 ms
    # ticks) moved, so the request path needs a few ticks of work to be
    # sampled at all
    for name, value in (("FLEET_WAIT_S", 90.0), ("OBS_TOPK_CALLS", 400),
                        ("OBS_AB_CALLS", 20), ("OBS_PUSH_SUBS", 8),
                        ("OBS_SGD_RATINGS", 1_000)):
        monkeypatch.setattr(chip_smoke, name, value)
    # the autoscaler decides but does not act ("dry"): its live cutover
    # would spawn 8 more members, a load that starves the heartbeats of
    # the other files' members while the suite runs files side by side
    # the fleet tests' 10 s replica TTL beside the wall-clock profile: the
    # suite runs files side by side, and a member of a busy test host may
    # miss the rehearsal's own 1.5 s (the card runs at 1.5 s; the case
    # below pins that)
    monkeypatch.setattr(chip_smoke, "OBS_REHEARSAL_ENV", dict(
        chip_smoke.OBS_REHEARSAL_ENV, TPUMS_REPLICA_TTL_S="10"))
    monkeypatch.setattr(chip_smoke, "OBS_REHEARSAL", dict(
        chip_smoke.OBS_REHEARSAL, users=300, dim=8, base_qps=30.0,
        peak_qps=60.0, burst_qps=120.0, duration_s=6.0, subscribers=4,
        autoscale="dry"))
    rng = np.random.default_rng(0)
    uf, itf = rng.normal(size=(1200, 8)), rng.normal(size=(1100, 8))
    published = [F.format_als_row(u, "U", uf[u]) for u in range(1200)]
    published += [F.format_als_row(i, "I", itf[i]) for i in range(1100)]
    published += [F.format_als_row("MEAN", side, m.mean(axis=0))
                  for side, m in (("U", uf), ("I", itf))]
    return chip_smoke.fleet_baseline(published, torch.device("cpu"), 16)


def test_obs_phase_rehearsal(small_obs, capsys):
    """Phase 21 on the CPU: (a)-(d) pass their checks."""
    out = chip_smoke.obs_phase(torch, small_obs, torch.device("cpu"),
                               "a CPU, no power limit")
    logs = capsys.readouterr().out
    assert "obs (a) profiler (a CPU, no power limit)" in logs
    assert "obs (a) #1 " in logs and "mean p50 off" in logs
    assert "(400 with a client span and both shards' server_reply)" in logs
    assert "forensics --json equals the in-process report" in logs
    assert "obs (c) rehearsal" in logs and "obs (c) per verb" in logs
    assert out["obs_samples"] > 0 and out["obs_parts"]["server"] > 0
    assert out["obs_fleet_samples"] > 0
    assert out["obs_detection_s"] is not None
    assert [b[0] for b in out["obs_ab"]] == ["off", "on", "off", "on"]


def test_obs_phase_fails_with_the_profiler_killed(small_obs, monkeypatch):
    """``TPUMS_PROF=0`` in every member: PROFILE still parses, but answers
    a profiler that is off, and the phase fails at (a)."""
    monkeypatch.setenv("TPUMS_PROF", "0")
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="PROFILE answered 'P\\\\t"):
        chip_smoke.obs_phase(torch, small_obs, torch.device("cpu"),
                             "a CPU, no power limit")


class _Entered(Exception):
    pass


def test_obs_rehearsal_runs_at_the_rehearsals_own_ttl(monkeypatch):
    """(c) hands the rehearsal's process no replica TTL or heartbeat of its
    own (the fleet phases' 5 s stand-in is gone), so the rehearsal sets
    its CLI's 1.5 s for its members; the members and the rehearsal's
    process profile by the wall clock; phase 22 (d) runs the same
    rehearsal with two proxies, no profiler and a 4 s schedule; this
    process's environment is left as it was."""
    seen = []
    for name in ("TPUMS_REPLICA_TTL_S", "TPUMS_PROF_IDLE", "TPUMS_PROF"):
        monkeypatch.setenv(name, "7")

    def entered(kw, env, timeout_s):
        seen.append((kw, env))
        raise _Entered()

    monkeypatch.setattr(chip_smoke, "Isolated", entered)
    with pytest.raises(_Entered):
        chip_smoke.obs_rehearsal(torch, torch.device("cpu"), "a CPU")
    kw, env = seen[-1]
    assert "TPUMS_REPLICA_TTL_S" not in env
    assert "TPUMS_HEARTBEAT_S" not in env
    assert env["TPUMS_PROF_IDLE"] == "1" and "TPUMS_PROF" not in env
    assert env["TPUMS_REGISTRY_DIR"]
    assert "edge" not in kw and kw["kill"] is True
    assert kw["users"] == 20_000 and kw["device"] == "cpu"
    for name in ("TPUMS_REPLICA_TTL_S", "TPUMS_PROF_IDLE", "TPUMS_PROF"):
        assert os.environ[name] == "7"
    with pytest.raises(_Entered):
        chip_smoke.obs_rehearsal(torch, torch.device("cpu"), "a CPU",
                                 edge=2, duration_s=4.0)
    kw, env = seen[-1]
    assert kw["edge"] == 2 and "TPUMS_REPLICA_TTL_S" not in env
    assert env["TPUMS_PROF"] == "0" and "TPUMS_PROF_IDLE" not in env
    assert kw["warm_s"] + kw["ramp_s"] + kw["burst_s"] + kw["cool_s"] == 4.0


def test_wait_parts_split_threads_by_role_and_part():
    stacks = {
        "-;threading.run;flink_ms_tpu_torch.serve.server.handle": 4.0,
        "-;flink_ms_tpu_torch.serve.server.handle;"
        "flink_ms_tpu_torch.serve.microbatch.wait": 2.0,
        "-;flink_ms_tpu_torch.serve.microbatch._run;"
        "flink_ms_tpu_torch.serve.topk.topk;"
        "flink_ms_tpu_torch.serve.topk._sync": 3.0,
        "-;flink_ms_tpu_torch.serve.microbatch._run;threading.wait": 1.0,
        "-;flink_ms_tpu_torch.obs.workload.worker": 5.0,
        "-;flink_ms_tpu_torch.obs.workload.worker;"
        "flink_ms_tpu_torch.serve.client.query_state;socket.readinto": 6.0,
        "-;chip_smoke.fleet_profile_poller;threading.wait": 9.0,
    }
    parts = chip_smoke.wait_parts(stacks)
    t, ps = parts["member request threads"]
    assert t == 6.0 and ps["reading the next request"] == 4.0 \
        and ps["the batcher"] == 2.0
    t, ps = parts["member batch dispatch"]
    assert t == 4.0 and ps["the card's syncs"] == 3.0 \
        and ps["waiting for queries"] == 1.0
    t, ps = parts["rehearsal op threads"]
    assert t == 11.0 and ps["pacing, ahead of schedule"] == 5.0 \
        and ps["the fleet's replies"] == 6.0
    assert parts["rehearsal fan-out pool"][0] == 0.0
    text = chip_smoke.fmt_wait_parts(parts)
    assert text.startswith("member request threads 6.00 s (")
    assert "rehearsal fan-out pool" not in text
