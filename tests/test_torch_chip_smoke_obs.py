"""Rehearsal of ``chip_smoke.py``'s phase 21 (observability) on the CPU at
a small size: every member a ``--device cpu`` process, the CLIs processes
of their own, the rehearsal's group a 2 x 2 of CPU members under a kill
and the autoscaler's decisions; and one case where the phase must fail.
(Phase 21 has a file of its own so that the suite's file-by-file
scheduling runs it beside the rehearsals of the other phases.)"""

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
