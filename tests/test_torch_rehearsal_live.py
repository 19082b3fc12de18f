"""The rehearsal with its autoscaler acting (``autoscale="live"``) in both
packages on the CPU, and the same rehearsal at full width as a witness.

- Tier-1: a 1-shard, 1-replica group whose autoscaler trips as soon as the
  open loop runs (its qps mark lowered to 20 q/s a shard) and cuts over to
  2 shards inside the run, once through the JAX package's
  ``run_rehearsal`` and once through the port's (``device="cpu"``), on the
  same seed.  Each report must validate, carry exactly one
  ``elastic_cutover`` with its decision and start, and attribute every
  error and every breach; both must have run the same plan.  Breaches
  themselves depend on the host's timing, so what is held across the
  packages is that each one is attributed, to a kind the SLO layer
  accepts, not their values.
- Slow (``-m slow``): the reference CLI's defaults at the served model's
  width (rank 50, 40,000 users unless ``TPUMS_WITNESS_USERS`` says
  otherwise, 2 shards x 2 replicas, a kill, the watch loop, 8 push
  subscribers) through both packages on the CPU, one after the other.  It
  prints each run's achieved rate, schedule lag and verdict, holds the
  port's achieved rate to at least half the reference's (a witness that
  the open loop's lag at this size is the design's on one host, not the
  port's) and the port's respawns to exactly one, the kill's, at the
  CLI's 1.5 s TTL.
"""

import functools
import os
import time

import pytest

from flink_ms_tpu.obs import slo as RS
from flink_ms_tpu.obs import workload as RW
from flink_ms_tpu.serve import elastic as RE
from flink_ms_tpu_torch.obs import slo as PS
from flink_ms_tpu_torch.obs import workload as PW
from flink_ms_tpu_torch.serve import elastic as PE

PACKAGES = {
    "reference": (RW.run_rehearsal, RS, RE),
    "port": (functools.partial(PW.run_rehearsal, device="cpu"), PS, PE),
}
# the scaler's own chain of events around one cutover
SCALE_KINDS = ("autoscale_decision", "elastic_scale_start",
               "elastic_cutover")


@pytest.fixture
def rehearsal_env(monkeypatch):
    # arenas start small and grow with their rows (dense files delete
    # fast); a generous TTL, as the rehearsal keeps an operator's value,
    # so a member whose heartbeat a busy host holds back is not respawned;
    # the reference's members run on the CPU, unsharded
    monkeypatch.setenv("TPUMS_ARENA_CAPACITY", "256")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "10")
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")


def _forced_policy(monkeypatch, elastic, qps_per_shard):
    """The rehearsal's policy with its scale-out mark at ``qps_per_shard``
    (``run_rehearsal`` builds it from the module at call time)."""
    real = elastic.AutoscalerPolicy

    def policy(**kw):
        return real(**dict(kw, qps_high_per_shard=qps_per_shard))

    monkeypatch.setattr(elastic, "AutoscalerPolicy", policy)


def _kinds(report):
    out = {}
    for e in report["timeline"]:
        out[e["kind"]] = out.get(e["kind"], 0) + 1
    return out


def test_live_autoscaler_cuts_over_in_both_packages(rehearsal_env,
                                                   monkeypatch, tmp_path):
    reports = {}
    for name, (run, slo, elastic) in PACKAGES.items():
        _forced_policy(monkeypatch, elastic, 20.0)
        reports[name] = run(
            out_path=str(tmp_path / f"{name}.json"), shards=1,
            replication=1, users=100, dim=4, base_qps=50.0, peak_qps=80.0,
            burst_qps=120.0, warm_s=1.0, ramp_s=2.0, burst_s=3.0,
            cool_s=2.0, threads=3, autoscale="live", kill=False, seed=0)
    allowed = set(RS.DISRUPTIVE_KINDS) | {"workload_phase"}
    for name, rep in reports.items():
        slo = PACKAGES[name][1]
        assert slo.validate_report(rep) == [], name
        kinds = _kinds(rep)
        for kind in SCALE_KINDS:
            assert kind in kinds, (name, kinds)
        # 1 -> 2 shards, and 2 is the rehearsal's ceiling: one cutover
        assert kinds["elastic_cutover"] == 1, (name, kinds)
        wl = rep["workload"]
        assert wl["completed"] == wl["scheduled"], name
        assert rep["errors"]["unattributed"] == 0, name
        for b in rep["breaches"]:
            cause = b["attributed_to"]
            assert cause is not None and cause["kind"] in allowed, (name, b)
        for s in rep["errors"]["samples"]:
            assert s["attributed_to"] is not None, (name, s)
    ref, port = reports["reference"], reports["port"]
    assert port["meta"] == ref["meta"]
    assert port["workload"]["scheduled_by_verb"] == \
        ref["workload"]["scheduled_by_verb"]
    assert sorted(port["verbs"]) == sorted(ref["verbs"])
    assert [o for o in port["spec"]["objectives"]] == \
        [o for o in ref["spec"]["objectives"]]


@pytest.mark.slow
def test_full_width_rehearsal_lags_alike_in_both_packages(rehearsal_env,
                                                         monkeypatch):
    # the CLI's own liveness (1.5 s), as the witness is of the CLI's run
    monkeypatch.delenv("TPUMS_REPLICA_TTL_S")
    users = int(os.environ.get("TPUMS_WITNESS_USERS", "40000"))
    runs = {}
    for name, (run, _, _) in PACKAGES.items():
        t0 = time.perf_counter()
        rep = run(shards=2, replication=2, users=users, dim=50,
                  base_qps=120.0, peak_qps=240.0, burst_qps=480.0,
                  warm_s=2.0, ramp_s=3.0, burst_s=4.0, cool_s=3.0,
                  threads=4, seed=0, autoscale="live", kill=True,
                  watch=True, subscribers=8)
        wl = rep["workload"]
        kinds = _kinds(rep)
        loose = [f"{b['verb']}.{b['objective']}" for b in rep["breaches"]
                 if not b["attributed_to"]]
        print(f"witness {name}: {users} users x rank 50, "
              f"{time.perf_counter() - t0:.1f}s in all; ok {rep['ok']}; "
              f"{wl['completed']} of {wl['scheduled']} ops in "
              f"{wl['duration_s']}s for a {wl['planned_duration_s']}s "
              f"schedule, achieved {wl['achieved_qps']} q/s, max lag "
              f"{wl['max_sched_lag_s']}s; respawns "
              f"{kinds.get('replica_respawn', 0)}, cutovers "
              f"{kinds.get('elastic_cutover', 0)}; breaches "
              f"{len(rep['breaches'])}, unattributed {loose}; per verb "
              "p99/service p99 ms " + "; ".join(
                  f"{v} {s.get('p99_ms')}/{s.get('service_p99_ms')}"
                  for v, s in sorted(rep["verbs"].items())), flush=True)
        assert wl["completed"] == wl["scheduled"], name
        if name == "port":
            # the kill's respawn and no other: a replaying member's
            # heartbeat keeps within the 1.5 s TTL
            # (tests/test_torch_heartbeat.py pins why)
            assert kinds.get("replica_respawn", 0) == 1, kinds
        runs[name] = wl["achieved_qps"]
    assert runs["port"] >= 0.5 * runs["reference"], runs
