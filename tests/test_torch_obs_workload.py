"""The port's rehearsal workload engine (``flink_ms_tpu_torch/obs/workload.py``)
against the JAX package's on the CPU.

- Every case of ``tests/test_obs_workload.py`` and the rehearsal of
  ``tests/test_slo_smoke.py`` run again with the reference's names bound to
  the port's objects (``run_rehearsal`` with ``device="cpu"``: a 2-shard,
  2-replica group of port members on the CPU).
- Cross-package cases, exact: ``ZipfKeys`` permutations and draws,
  ``PhaseSchedule.intended_offsets`` and ``VerbMix`` choices are equal for
  equal seeds; ``_seed_journal`` writes the same bytes; the engine's plan is
  the same list; the edge arm's rehearsal (two proxies of the run's own
  package) gives valid reports with the same edge fields in both.
"""

import functools
import importlib
import os
import random

import pytest

import test_obs_workload as ref_cases
import test_slo_smoke as ref_smoke
from test_torch_profiler import _on_port
import flink_ms_tpu.obs as ref_obs_pkg
from flink_ms_tpu.obs import workload as RW
from flink_ms_tpu_torch.obs import slo as PS
from flink_ms_tpu_torch.obs import tracing as PT
from flink_ms_tpu_torch.obs import workload as PW


PORT = _on_port(ref_cases, {n: getattr(PW, n) for n in (
    "OpenLoopPacer", "Phase", "PhaseSchedule", "VerbMix", "WorkloadEngine",
    "WorkloadRecorder", "ZipfKeys")})
SMOKE = _on_port(ref_smoke, {
    "validate_report": PS.validate_report,
    "run_rehearsal": functools.partial(PW.run_rehearsal, device="cpu")})
CASES = sorted(n for n, f in vars(ref_cases).items()
               if n.startswith("test_") and callable(f))


def test_the_mirrored_cases_are_all_twelve():
    assert len(CASES) == 12


@pytest.mark.parametrize("name", CASES)
def test_reference_workload_case_on_the_port(name, monkeypatch):
    # `from flink_ms_tpu.obs import recent_events` inside a case reads the
    # port's event ring
    monkeypatch.setattr(ref_obs_pkg, "recent_events", PT.recent_events)
    PORT[name]()


def test_reference_slo_smoke_rehearsal_on_the_port(tmp_path, monkeypatch):
    # the members' arenas start small and grow with their rows, so their
    # files stay dense: deleting a sparse file can cost one discard per
    # extent on a filesystem mounted with discard; and a generous TTL (the
    # rehearsal keeps an operator's value), so that a member whose
    # heartbeat a busy host holds back is not taken for dead and respawned
    # with its counters lost to the fleet scrape
    monkeypatch.setenv("TPUMS_ARENA_CAPACITY", "256")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "10")
    SMOKE["test_slo_smoke_rehearsal"](tmp_path)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 17])
def test_draws_equal_the_reference(seed):
    for n, s in ((1, 1.1), (500, 1.1), (138_493 // 97, 0.8)):
        rk, pk = RW.ZipfKeys(n, s, seed), PW.ZipfKeys(n, s, seed)
        assert pk.ids == rk.ids
        assert pk.hot_share(0.01) == rk.hot_share(0.01)
        ra, rb = random.Random(seed + 1), random.Random(seed + 1)
        assert [pk.sample(rb) for _ in range(500)] == \
            [rk.sample(ra) for _ in range(500)]
    spec = "GET=55,MGET=15,TOPK=8,TOPKV=4,UPDATE=18,GET~abuse=3.5"
    rm, pm = RW.VerbMix.from_string(spec), PW.VerbMix.from_string(spec)
    assert pm.to_dict() == rm.to_dict()
    ra, rb = random.Random(seed), random.Random(seed)
    assert [pm.choose(rb) for _ in range(2000)] == \
        [rm.choose(ra) for _ in range(2000)]
    args = (120.0 + seed, 240.0, 480.0, 2.0, 3.0, 4.0, 3.0)
    r = RW.PhaseSchedule.ramp_burst(*args)
    p = PW.PhaseSchedule.ramp_burst(*args)
    assert p.intended_offsets() == r.intended_offsets()
    assert [(a, b, ph.name, ph.rate_qps) for a, b, ph in p.windows()] \
        == [(a, b, ph.name, ph.rate_qps) for a, b, ph in r.windows()]
    r = RW.PhaseSchedule.diurnal(10.0, 100.0 + seed, 8.0, steps=8)
    p = PW.PhaseSchedule.diurnal(10.0, 100.0 + seed, 8.0, steps=8)
    assert p.intended_offsets() == r.intended_offsets()
    sched = PW.PhaseSchedule.ramp_burst(50, 80, 120, 1, 1, 1.5, 1)
    rsched = RW.PhaseSchedule.ramp_burst(50, 80, 120, 1, 1, 1.5, 1)
    assert PW.WorkloadEngine(None, sched, pm, seed=seed)._build_plan() == \
        RW.WorkloadEngine(None, rsched, rm, seed=seed)._build_plan()


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("users,dim,seed", [(50, 4, 0), (400, 50, 7)])
def test_seed_journal_writes_the_reference_bytes(tmp_path, users, dim, seed):
    RW._seed_journal(str(tmp_path / "ref"), "models", users, dim, seed)
    PW._seed_journal(str(tmp_path / "port"), "models", users, dim, seed)
    want = _tree_bytes(tmp_path / "ref")
    assert want and _tree_bytes(tmp_path / "port") == want
    assert sum(b.count(b"\n") for b in want.values()) >= 2 * users


def _edge_rehearsal(mod, tmp_path, monkeypatch, **kw):
    """A small edge-arm rehearsal (two proxies, every client an
    ``EdgeClient``) -> (report, the edge fields of its fleet signals over
    the run, the proxies' requests counted by the last scrape)."""
    pkg = mod.__name__.rsplit(".", 2)[0]
    scrape = importlib.import_module(f"{pkg}.obs.scrape")
    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "registry"))
    real, seen = scrape.scrape_fleet, []

    def recording(*a, **k):
        out = real(*a, **k)
        seen.append(out["fleet"])
        return out

    monkeypatch.setattr(scrape, "scrape_fleet", recording)
    try:
        report = mod.run_rehearsal(
            out_path=str(tmp_path / "SLO_REPORT.json"), shards=2,
            replication=2, users=100, base_qps=50.0, peak_qps=80.0,
            burst_qps=120.0, warm_s=1.0, ramp_s=1.0, burst_s=1.5,
            cool_s=1.0, threads=3, autoscale="off", kill=False, seed=0,
            edge=2, **kw)
    finally:
        monkeypatch.setattr(scrape, "scrape_fleet", real)
    sig = scrape.fleet_signals(seen[0], seen[-1])
    edge = {k: v for k, v in sig.items() if k.startswith("edge_")}
    requests = sum(c["value"] for c in seen[-1].get("counters", [])
                   if c["name"] == "tpums_edge_requests_total")
    return report, edge, requests


def test_edge_arm_rehearsal_in_both_packages(tmp_path, monkeypatch):
    """The rehearsal's edge arm: two proxies of the run's own package in
    front of a 2 x 2 group, every client through them.  Both packages'
    reports are valid, with no error, every op run, and the same edge
    fields in their fleet signals; the proxies served the traffic."""
    monkeypatch.setenv("TPUMS_ARENA_CAPACITY", "256")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "10")
    ref, ref_edge, ref_n = _edge_rehearsal(RW, tmp_path / "ref",
                                           monkeypatch)
    port, port_edge, port_n = _edge_rehearsal(
        PW, tmp_path / "port", monkeypatch, device="cpu")
    for report, n in ((ref, ref_n), (port, port_n)):
        assert PS.validate_report(report) == []
        assert report["meta"]["edge"] == 2
        assert report["errors"]["total"] == 0
        assert report["errors"]["unattributed"] == 0
        wl = report["workload"]
        assert wl["completed"] == wl["scheduled"] > 0
        # every read went through the proxies (UPDATE goes to the
        # update plane's journal)
        reads = sum(report["verbs"][v]["requests"]
                    for v in ("GET", "MGET", "TOPK", "TOPKV"))
        assert 0 < reads <= n
    assert sorted(port_edge) == sorted(ref_edge)
    assert {"edge_open_connections", "edge_coalesce_per_s",
            "edge_hedges_per_s", "edge_p99_s"} <= set(port_edge)
    assert sorted(port["verbs"]) == sorted(ref["verbs"])
    assert sorted(port["meta"]) == sorted(ref["meta"])


def test_cli_without_a_mode_prints_its_usage():
    assert PW.main([]) == 2
