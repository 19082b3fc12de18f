"""``scripts/rehearsal_ab.py``'s ``split<N>`` arm: the open loop of the
rehearsal split over N workload CLIs in attach mode against one shared
2 x 2 group, on the CPU at a small size."""

import importlib.util
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "rehearsal_ab", os.path.join(ROOT, "scripts", "rehearsal_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flag(cmd, name):
    return cmd[cmd.index(name) + 1]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_the_n_client_rates_sum_to_the_schedules_rate(n, tmp_path):
    """Each of the N CLIs runs attach mode against the group at 1/N of
    each phase's rate; their rates sum to the schedule's, scaled to the
    query verbs' share of the default mix, which they run without
    UPDATE; each has its own seed and report."""
    import chip_smoke
    from flink_ms_tpu_torch.obs.workload import DEFAULT_VERB_WEIGHTS, VerbMix

    ab = _script()
    kw = dict(chip_smoke.OBS_REHEARSAL)
    cmds = ab.split_commands(n, kw, "cpu", str(tmp_path))
    assert len(cmds) == n
    share = 82.0 / 100.0
    assert sum(ab.SPLIT_MIX.values()) / sum(
        DEFAULT_VERB_WEIGHTS.values()) == pytest.approx(share)
    for flag, key in (("--baseQps", "base_qps"), ("--peakQps", "peak_qps"),
                      ("--burstQps", "burst_qps")):
        rates = [float(_flag(c, flag)) for c in cmds]
        assert sum(rates) == pytest.approx(kw[key] * share, rel=1e-12)
        assert max(rates) == pytest.approx(min(rates))
    for c in cmds:
        assert c[1:3] == ["-m", "flink_ms_tpu_torch.obs.workload"]
        assert _flag(c, "--group") == ab.SPLIT_GROUP
        assert "--rehearsal" not in c and _flag(c, "--device") == "cpu"
        assert _flag(c, "--durationS") == "12"
        assert int(_flag(c, "--threads")) == kw["threads"]
        mix = VerbMix.from_string(_flag(c, "--mix")).to_dict()
        assert mix == {v: w for v, w in DEFAULT_VERB_WEIGHTS.items()
                       if v != "UPDATE"}
    assert len({_flag(c, "--seed") for c in cmds}) == n
    assert len({_flag(c, "--out") for c in cmds}) == n


def test_merge_reports_sums_rates_and_keeps_the_worst():
    ab = _script()

    def rep(t0, t1, done, qps, lag, p99, ok=False):
        return {"workload": {"t_start": t0, "t_end": t1, "completed": done,
                             "scheduled": done, "achieved_qps": qps,
                             "max_sched_lag_s": lag},
                "verbs": {"GET": {"p99_ms": p99, "service_p99_ms": p99 / 2},
                          "TOPK": {"p99_ms": 3 * p99,
                                   "service_p99_ms": None}},
                "errors": {"total": 1}, "ok": ok}

    got = ab.merge_reports([rep(100.0, 112.0, 1200, 100.0, 0.5, 10.0),
                            rep(101.0, 114.0, 1300, 100.0, 2.0, 4.0)])
    assert got["achieved_qps"] == 200.0
    assert got["span_qps"] == round(2500 / 14.0, 1)
    assert got["max_sched_lag_s"] == 2.0 and got["duration_s"] == 14.0
    assert got["completed"] == got["scheduled"] == 2500
    assert got["client_qps"] == [100.0, 100.0] and got["errors"] == 2
    assert got["verbs"] == {"GET": {"p99_ms": 10.0, "service_p99_ms": 5.0},
                            "TOPK": {"p99_ms": 30.0}}
    assert got["ok"] is False


@pytest.mark.parametrize("name,ok", [("plain", True), ("profiled", True),
                                     ("split1", True), ("split12", True),
                                     ("split0", False), ("split", False),
                                     ("bogus", False)])
def test_variant_names(name, ok):
    import argparse

    ab = _script()
    if ok:
        assert ab.variant(name) == name
    else:
        with pytest.raises(argparse.ArgumentTypeError):
            ab.variant(name)


def test_a_split_run_on_the_cpu(tmp_path, monkeypatch):
    """``--runs split2@cpu`` on a small group: one JSON line, both clients'
    ops all run, no respawn, the group and its registry gone after."""
    import subprocess

    env = dict(os.environ, TMPDIR=str(tmp_path),
               TPUMS_ARENA_CAPACITY="256")
    for k in ("TPUMS_REGISTRY_DIR", "TPUMS_HEARTBEAT_S",
              "TPUMS_REPLICA_TTL_S"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "rehearsal_ab.py"),
         "--runs", "split2@cpu", "--users", "300"],
        env=env, cwd=ROOT, check=True, capture_output=True, text=True,
        timeout=240).stdout
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    got = lines[0]
    assert (got["variant"], got["device"], got["clients"]) == \
        ("split2", "cpu", 2)
    assert got["completed"] == got["scheduled"] > 0
    assert len(got["client_qps"]) == 2 and got["respawns"] == 0
    assert got["errors"] == 0
    assert set(got["verbs"]) == {"GET", "MGET", "TOPK", "TOPKV"}
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith("tpums_rehearsal_ab_")]
