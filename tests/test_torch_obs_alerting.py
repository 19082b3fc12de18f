"""The port's alert plane (``flink_ms_tpu_torch/obs/tsdb.py``, ``slo.py``,
``rules.py``) against the JAX package's on the CPU.

Two kinds of check:
- every case of ``tests/test_tsdb.py``, ``test_slo.py`` and
  ``test_rules.py`` runs again with the reference's names bound to the
  port's objects (the reference's own assertions, on the port); the live
  cases of ``test_rules.py`` run against a port serving job, with the
  modules they import inside their bodies swapped for the port's;
- one seeded snapshot timeline goes through both packages and must give
  equal ``SeriesStore`` queries, equal ``build_report`` JSON, an equal
  ``human_summary`` text, equal ``validate_report`` lists, equal
  ``RulesEngine`` transitions and equal ``attribute_alerts`` (exact
  equality: the same float operations in the same order).
"""

import dataclasses
import inspect
import json
import types

import numpy as np
import pytest

import test_rules as ref_rules_cases
import test_slo as ref_slo_cases
import test_tsdb as ref_tsdb_cases
from test_torch_profiler import _port_imports
from flink_ms_tpu.obs import rules as RR
from flink_ms_tpu.obs import slo as RS
from flink_ms_tpu.obs import tsdb as RT
from flink_ms_tpu_torch.eval import mse as PMse
from flink_ms_tpu_torch.obs import metrics as PM
from flink_ms_tpu_torch.obs import rules as PR
from flink_ms_tpu_torch.obs import scrape as PSc
from flink_ms_tpu_torch.obs import slo as PS
from flink_ms_tpu_torch.obs import tracing as PTr
from flink_ms_tpu_torch.obs import tsdb as PT
from flink_ms_tpu_torch.obs import watch as PW
from flink_ms_tpu_torch.core import formats as PF
from flink_ms_tpu_torch.serve import client as PClient
from flink_ms_tpu_torch.serve import registry as PReg


def _on_port(module, overrides):
    """The module's functions with every global in ``overrides`` swapped for
    the port's object (helpers rebound too, so they build port objects)."""
    g = dict(module.__dict__)
    g.update(overrides)
    for name, obj in list(g.items()):
        if isinstance(obj, types.FunctionType) and \
                obj.__module__ == module.__name__:
            g[name] = types.FunctionType(obj.__code__, g, obj.__name__,
                                         obj.__defaults__, obj.__closure__)
    return g


def _cases(module):
    return sorted(n for n, f in vars(module).items()
                  if n.startswith("test_") and callable(f))


def _run(g, name, tmp_path):
    fn = g[name]
    args = {"tmp_path": tmp_path} if "tmp_path" in \
        inspect.signature(fn).parameters else {}
    fn(**args)


TSDB_PORT = _on_port(ref_tsdb_cases, {
    "SeriesStore": PT.SeriesStore, "series_key": PT.series_key,
    "MetricsRegistry": PM.MetricsRegistry,
    "bucketed_quantiles": PM.bucketed_quantiles,
    "LATENCY_BUCKETS_S": PM.LATENCY_BUCKETS_S})

SLO_PORT = _on_port(ref_slo_cases, {
    "obs_metrics": PM, "obs_slo": PS,
    **{n: getattr(PS, n) for n in (
        "SLOObjective", "SLOSpec", "bucket_index", "build_report",
        "burn_rate", "human_summary", "validate_report", "verb_windows")}})

# the pure cases, and the live ones: a serving job, the watch loop
# (FleetWatcher), the canary, the fleet scrape and HEALTH's alert hint
RULES_PURE = [n for n in _cases(ref_rules_cases)
              if "live_job" not in inspect.signature(
                  getattr(ref_rules_cases, n)).parameters
              and "detection_latency" not in n]
# in the reference module's order, as its suite runs them (a case leaves
# kill events in the process's event ring that a later case's watcher
# must not see inside its window)
RULES_LIVE = [n for n, f in vars(ref_rules_cases).items()
              if n.startswith("test_") and callable(f)
              and n not in RULES_PURE]
RULES_PORT = _on_port(ref_rules_cases, {
    "F": PF, "SeriesStore": PT.SeriesStore,
    **{n: getattr(PR, n) for n in (
        "Rule", "RulesEngine", "attribute_alerts", "default_rules",
        "load_rules")}})


@pytest.mark.parametrize("name", _cases(ref_tsdb_cases))
def test_reference_tsdb_case_on_the_port(name, tmp_path):
    _run(TSDB_PORT, name, tmp_path)


@pytest.mark.parametrize("name", _cases(ref_slo_cases))
def test_reference_slo_case_on_the_port(name, tmp_path):
    _run(SLO_PORT, name, tmp_path)


@pytest.mark.parametrize("name", RULES_PURE)
def test_reference_rules_case_on_the_port(name, tmp_path):
    _run(RULES_PORT, name, tmp_path)


def test_the_mirrored_rules_cases_are_the_pure_ones():
    assert len(RULES_PURE) == 11
    assert "test_flap_suppression_latches_and_unlatches" in RULES_PURE


@pytest.fixture
def port_live_job(tmp_path):
    """The reference's ``live_job`` fixture with the port's serving job."""
    import numpy as np

    from flink_ms_tpu_torch.serve.consumer import (ALS_STATE, ServingJob,
                                                   make_backend,
                                                   parse_als_record)
    from flink_ms_tpu_torch.serve.journal import Journal

    rng = np.random.default_rng(0)
    n, dim = 40, 4
    uf = rng.normal(size=(n, dim))
    itf = rng.normal(size=(n, dim))
    journal = Journal(str(tmp_path / "bus"), "models")
    journal.append(
        [PF.format_als_row(u, "U", uf[u]) for u in range(n)]
        + [PF.format_als_row(i, "I", itf[i]) for i in range(n)])
    job = ServingJob(journal, ALS_STATE, parse_als_record,
                     make_backend("memory", None),
                     host="127.0.0.1", port=0,
                     poll_interval_s=0.01, device="cpu").start()
    assert job.wait_ready(60)
    yield job, journal, uf, itf
    job.stop()


def test_the_live_rules_cases_are_the_other_eight():
    assert len(RULES_LIVE) == 8
    assert "test_watcher_detection_latency_pairs_kill_with_page" in \
        RULES_LIVE


@pytest.mark.parametrize("name", RULES_LIVE)
def test_reference_live_rules_case_on_the_port(name, tmp_path, monkeypatch,
                                                request):
    _port_imports(monkeypatch, {"flink_ms_tpu.eval.mse": PMse,
                                "flink_ms_tpu.obs.watch": PW,
                                "flink_ms_tpu.obs.scrape": PSc,
                                "flink_ms_tpu.obs.tracing": PTr,
                                "flink_ms_tpu.serve.client": PClient,
                                "flink_ms_tpu.serve.registry": PReg})
    fn = RULES_PORT[name]
    have = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    args = {p: (request.getfixturevalue("port_live_job") if p == "live_job"
                else have[p]) for p in inspect.signature(fn).parameters}
    fn(**args)


# ---------------------------------------------------------------------------
# one timeline through both packages
# ---------------------------------------------------------------------------

VERBS = ("GET", "MGET", "TOPKV")


def _timeline(seed=0, n=12, restart_at=7):
    """(ts, snapshot) pairs of a seeded fleet: per-verb latency histograms,
    request and error counters, a ready gauge; the exporter restarts at
    tick `restart_at` (counters and histograms reset)."""
    rng = np.random.default_rng(seed)
    out = []
    reg = PM.MetricsRegistry()
    for t in range(n):
        if t == restart_at:
            reg = PM.MetricsRegistry()
        for verb in VERBS:
            h = reg.histogram("tpums_server_latency_seconds", verb=verb)
            for v in np.abs(rng.normal(0.004, 0.003, rng.integers(5, 40))):
                h.observe(float(v) + 1e-5)
            reg.counter("tpums_server_errors_total", verb=verb).inc(
                int(rng.integers(0, 3)))
        reg.gauge("tpums_watch_replicas_total").set(
            float(3 - (t in (5, 6))))
        reg.gauge("tpums_model_live_mse").set(
            float(1.0 + (2.5 if 8 <= t <= 9 else 0.0)
                  + rng.uniform(0, 0.1)))
        snap = PM.synthesize_requests(reg.snapshot())
        out.append((1000.0 + 10.0 * t, snap))
    return out


def _store(mod, timeline):
    s = mod.SeriesStore(retention_s=1e6, max_points=64)
    for ts, snap in timeline:
        s.ingest_snapshot(json.loads(json.dumps(snap)), ts=ts)
    return s


def _queries(s, now):
    out = []
    for window in (15.0, 35.0, 200.0):
        for verb in (None,) + VERBS:
            lbl = {} if verb is None else {"verb": verb}
            out.append(s.increase("tpums_server_requests_total", window,
                                  now=now, **lbl))
            out.append(s.rate("tpums_server_errors_total", window, now=now,
                              **lbl))
            for q in (50, 99):
                out.append(s.quantile("tpums_server_latency_seconds", q,
                                      window, now=now, **lbl))
            out.append(s.window_hist("tpums_server_latency_seconds", window,
                                     now=now, **lbl))
        out.append(s.derivative("tpums_model_live_mse", window, now=now))
        out.append(s.window_max("tpums_watch_replicas_total", window,
                                now=now))
    out.append(s.latest("tpums_server_requests_total"))
    out.append(s.staleness_s("tpums_model_live_mse", now=now + 3.0))
    out.append(s.points("tpums_watch_replicas_total", window_s=40.0,
                        now=now))
    out.append(s.series())
    out.append(s.stats())
    return out


def test_series_store_queries_equal_the_reference():
    tl = _timeline()
    ref, port = _store(RT, tl), _store(PT, tl)
    for now in (1030.0, 1065.0, 1110.0):
        assert _queries(port, now) == _queries(ref, now)
    assert PT.series_key("n", {"b": 2, "a": 1}) == \
        RT.series_key("n", {"b": 2, "a": 1})


def test_fleet_ingest_and_spill_equal_the_reference(tmp_path):
    scrape = ref_tsdb_cases._fake_scrape()
    for mod, name in ((RT, "ref"), (PT, "port")):
        s = mod.SeriesStore(retention_s=1e6,
                            spill_path=str(tmp_path / f"{name}.jsonl"))
        s.ingest_fleet(scrape, ts=1.0)
        s.ingest_fleet(ref_tsdb_cases._fake_scrape(requests=150.0), ts=2.0)
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()


def _report_inputs(t0, errors_at, timeline, samples=True):
    rec = ref_slo_cases._recorder_with_traffic(t0, errors_at=errors_at)
    before = ref_slo_cases._fleet_snap({"GET": (0, 0.0, 0),
                                        "TOPKV": (3, 0.3, 0)})
    after = ref_slo_cases._fleet_snap({"GET": (200, 0.4, 2),
                                       "TOPKV": (40, 2.0, 1)})
    return dict(workload=ref_slo_cases._workload_summary(t0), recorder=rec,
                fleet_before=before, fleet_after=after,
                fleet_samples=[(t0, before), (t0 + 10, after)]
                if samples else (), timeline=timeline,
                meta={"mode": "fleet", "shards": 2, "kill": True})


REPORT_CASES = {
    "kill": (1000.0, (1003.0, 1003.2),
             [{"ts": 1002.5, "kind": "rehearsal_kill", "shard": 0}]),
    "unattributed": (2000.0, (2002.0,), []),
    "burst": (3000.0, (3007.0,), [{"ts": 3001.0, "kind": "rollout_cutover"}]),
    "clean": (4000.0, (), []),
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_build_report_summary_and_validation_equal_the_reference(case):
    t0, errors_at, timeline = REPORT_CASES[case]
    inputs = _report_inputs(t0, errors_at, timeline)
    specs = [(RS.SLOSpec.default(["GET", "TOPK"]),
              PS.SLOSpec.default(["GET", "TOPK"])),
             (RS.SLOSpec([RS.SLOObjective("GET", p99_ms=1.0,
                                          goodput_min=0.999)]),
              PS.SLOSpec([PS.SLOObjective("GET", p99_ms=1.0,
                                          goodput_min=0.999)]))]
    for ref_spec, port_spec in specs:
        want = RS.build_report(ref_spec, **inputs)
        got = PS.build_report(port_spec, **inputs)
        assert abs(got.pop("ts") - want.pop("ts")) < 60
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)
        assert PS.human_summary(got) == RS.human_summary(want)
        assert PS.validate_report(got) == RS.validate_report(want)
        for key in ("verbs", "errors", "spec"):
            broken = json.loads(json.dumps(got))
            broken.pop(key)
            broken["breaches"] = [{"verb": "GET"}]
            assert PS.validate_report(broken) == RS.validate_report(broken)
    assert PS.validate_report("x") == RS.validate_report("x")


def test_verb_windows_and_burn_rate_equal_the_reference():
    tl = _timeline(seed=3)
    for (_, a), (_, b) in zip(tl, tl[1:]):
        assert PS.verb_windows(a, b) == RS.verb_windows(a, b)
    for req, err, target in ((100, 3, 0.999), (0, 0, 0.99), (10, 1, None),
                             (50, 2, 1.0)):
        assert PS.burn_rate(req, err, target) == \
            RS.burn_rate(req, err, target)
    for v in (None, float("nan"), 1e-7, 0.0042, 250.0):
        assert PS.bucket_index(v) == RS.bucket_index(v)
    assert PS.DISRUPTIVE_KINDS == RS.DISRUPTIVE_KINDS
    assert PS.SLOSpec.default(list(RS.CLIENT_TO_SERVER_VERB)).to_dict() == \
        RS.SLOSpec.default(list(RS.CLIENT_TO_SERVER_VERB)).to_dict()


def _extra_rules(mod):
    return [
        mod.Rule(name="get_p99", series="tpums_server_latency_seconds",
                 labels={"verb": "GET"}, mode="quantile", q=99,
                 window_s=30.0, op=">", value=0.008, for_s=10.0,
                 severity="page"),
        mod.Rule(name="errors", series="tpums_server_errors_total",
                 mode="rate", window_s=30.0, op=">=", value=0.05,
                 flap_max=2, flap_window_s=60.0),
        mod.Rule(name="mse_slope", series="tpums_model_live_mse",
                 mode="derivative", window_s=25.0, op=">", value=0.05,
                 severity="info"),
        mod.Rule(name="quiet", kind="absence", series="tpums_nothing",
                 value=35.0),
        mod.Rule(name="burn", kind="burn_rate",
                 requests_series="tpums_server_requests_total",
                 errors_series="tpums_server_errors_total",
                 availability_target=0.99, fast_window_s=20.0,
                 slow_window_s=60.0, burn_multiple=2.0),
    ]


def _engine_run(mod, store_mod, tl):
    eng = mod.RulesEngine(mod.default_rules() + _extra_rules(mod),
                          now=tl[0][0])
    store = store_mod.SeriesStore(retention_s=1e6)
    ticks = []
    for ts, snap in tl:
        store.ingest_snapshot(json.loads(json.dumps(snap)), ts=ts)
        ticks.append(eng.evaluate(store, now=ts + 0.5))
    return eng, ticks


def test_rules_engine_transitions_and_attribution_equal_the_reference():
    tl = _timeline(seed=1, n=16)
    ref_eng, ref_ticks = _engine_run(RR, RT, tl)
    port_eng, port_ticks = _engine_run(PR, PT, tl)
    assert port_ticks == ref_ticks
    fired = [t for tick in ref_ticks for t in tick
             if t["kind"] == "alert_firing"]
    assert {t["rule"] for t in fired} >= {"replica_drop", "model_drift"}
    assert port_eng.history == ref_eng.history
    assert port_eng.active() == ref_eng.active()
    assert port_eng.summary() == ref_eng.summary()
    timeline = [{"ts": 1049.0, "kind": "chaos_kill"},
                {"ts": 1081.0, "kind": "rollout_cutover"},
                {"ts": 1090.0, "kind": "not_disruptive"}]
    for window in (2.0, 5.0, 30.0):
        assert PR.attribute_alerts(port_eng.history, timeline, window) == \
            RR.attribute_alerts(ref_eng.history, timeline, window)
    assert [PR.severity_name(x) for x in (0, 1, 2, 3, 4)] == \
        [RR.severity_name(x) for x in (0, 1, 2, 3, 4)]


def test_default_and_loaded_rules_equal_the_reference(tmp_path):
    want = [dataclasses.asdict(r) for r in RR.default_rules()]
    assert [dataclasses.asdict(r) for r in PR.default_rules()] == want
    assert "model_drift" in [r["name"] for r in want]
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": want + [
        {"name": "extra", "kind": "absence", "series": "beat",
         "value": 10}]}))
    assert [dataclasses.asdict(r) for r in PR.load_rules(str(path))] == \
        [dataclasses.asdict(r) for r in RR.load_rules(str(path))]
    assert [r.to_dict() for r in PR.load_rules(str(path))] == \
        [r.to_dict() for r in RR.load_rules(str(path))]
