"""The port's observability leftovers against the JAX package's on the CPU:
``obs/metrics.py`` (the Prometheus exposition, bench deltas and
percentiles, the two live switches), ``obs/tracing.py`` (the stage stack,
size-capped rotation of the event file, ``load_events``, ``clear_events``),
``obs/scrape.py`` (``push_freshness``, the CLI, the profile merge) and
``utils/profiling.StepTimer`` (``merge``, ``to_histogram``, ``write_json``).

The reference's cases of ``tests/test_obs_metrics.py`` and
``tests/test_obs_tracing.py`` that need neither a server nor
``Histogram.merge`` run again with the reference's module bound to the
port's; the rest hold both packages to equal bytes on the same inputs.
"""

import inspect
import io
import json
import os
import time
import types
from contextlib import redirect_stdout

import numpy as np
import pytest

import test_obs_metrics as ref_metrics_cases
import test_obs_tracing as ref_tracing_cases
from flink_ms_tpu.obs import metrics as RM
from flink_ms_tpu.obs import scrape as RSc
from flink_ms_tpu.obs import tracing as RT
from flink_ms_tpu.utils.profiling import StepTimer as RefTimer
from flink_ms_tpu_torch.obs import metrics as PM
from flink_ms_tpu_torch.obs import scrape as PSc
from flink_ms_tpu_torch.obs import tracing as PT
from flink_ms_tpu_torch.utils.profiling import StepTimer as PortTimer


def _on_port(module, overrides):
    g = dict(module.__dict__)
    g.update(overrides)
    for name, obj in list(g.items()):
        if isinstance(obj, types.FunctionType) and \
                obj.__module__ == module.__name__:
            g[name] = types.FunctionType(obj.__code__, g, obj.__name__,
                                         obj.__defaults__, obj.__closure__)
    return g


METRICS_CASES = [
    "test_log_buckets_boundaries", "test_histogram_le_bucket_placement",
    "test_histogram_quantile_interpolates_within_bucket_width",
    "test_counter_and_histogram_exact_under_threads",
    "test_enable_switch_gates_observation_but_not_math",
    "test_snapshot_quantile_and_diff",
    "test_render_prometheus_cumulative_buckets",
    "test_bucketed_quantiles_empty_is_nan",
    "test_bucketed_quantiles_all_mass_in_overflow_bucket",
    "test_bucketed_quantiles_single_observation",
]
TRACING_CASES = [
    "test_stamp_pop_unstamp_helpers",
    "test_call_with_trace_crosses_pool_threads",
    "test_span_stack_parents_nested_spans",
    "test_wire_tid_helpers_roundtrip_composite_form",
    "test_sample_trace_follows_knob",
]
METRICS_PORT = _on_port(ref_metrics_cases, {"M": PM})
TRACING_PORT = _on_port(ref_tracing_cases, {"T": PT})


@pytest.mark.parametrize("name", METRICS_CASES)
def test_reference_metrics_case_on_the_port(name):
    METRICS_PORT[name]()


@pytest.mark.parametrize("name", TRACING_CASES)
def test_reference_tracing_case_on_the_port(name, monkeypatch):
    fn = TRACING_PORT[name]
    if "monkeypatch" in inspect.signature(fn).parameters:
        fn(monkeypatch)
    else:
        fn()


# ---------------------------------------------------------------------------
# metrics: one snapshot, both renderings
# ---------------------------------------------------------------------------

def _snapshot(mod, seed=0):
    rng = np.random.default_rng(seed)
    r = mod.MetricsRegistry()
    r.counter("tpums_server_requests_total", verb="GET").inc(7)
    r.counter("tpums_events_total", kind='we"ird\\one\nx').inc(2)
    r.counter("tpums_plain_total").inc(3)
    r.gauge("tpums_backlog").set(2.5)
    r.gauge("tpums_inf").set(float("inf"))
    r.gauge("tpums_zero", state="ALS_MODEL").set(0.0)
    h = r.histogram("tpums_server_latency_seconds", verb="TOPK")
    for v in np.abs(rng.normal(0.002, 0.001, 300)):
        h.observe(float(v))
    h.observe(1e6)  # the +Inf slot
    r.histogram("tpums_sizes", bounds=mod.SIZE_BUCKETS).observe(9.0)
    return r.snapshot()


def test_render_prometheus_is_byte_equal_to_the_reference():
    for seed in (0, 1):
        ref = _snapshot(RM, seed)
        port = _snapshot(PM, seed)
        # the registries are separate; their snapshots hold equal series
        for kind in ("counters", "gauges", "histograms"):
            assert port[kind] == ref[kind]
        assert PM.render_prometheus(ref) == RM.render_prometheus(ref)
        assert PM.render_prometheus(port) == RM.render_prometheus(port)
    assert PM.render_prometheus({}) == RM.render_prometheus({}) == ""
    for v in ("a", 'q"', "b\\s", "n\nl", 3):
        assert PM._escape_label(v) == RM._escape_label(v)
    for v in (0.0, 1.5, float("inf"), 1e-7):
        assert PM._fmt_float(v) == RM._fmt_float(v)


def test_diff_snapshots_and_bucketed_quantiles_equal_the_reference():
    before, after = _snapshot(PM, 0), _snapshot(PM, 0)
    after["counters"][0]["value"] += 5
    after["histograms"][0]["count"] += 2
    after["histograms"][0]["sum"] += 0.25
    for a, b in ((before, after), (after, before), ({}, after)):
        assert PM.diff_snapshots(a, b) == RM.diff_snapshots(a, b)
    rng = np.random.default_rng(4)
    for values in ([], [0.00123], list(np.abs(rng.normal(0.01, 0.02, 999))),
                   [1e9, 2e9]):
        for bounds in (PM.LATENCY_BUCKETS_S, (0.001, 0.01, 0.1)):
            got = PM.bucketed_quantiles(values, (1, 50, 99, 100), bounds)
            want = RM.bucketed_quantiles(values, (1, 50, 99, 100), bounds)
            np.testing.assert_array_equal(got, want)


def test_exemplar_switch_equals_the_reference():
    for mod in (PM, RM):
        prev = mod.set_exemplars(True)
        try:
            assert mod.exemplars_enabled() is True
            h = mod.Histogram("h", bounds=(1.0, 2.0))
            h.observe(1.5, tid="abc")
            assert [t for t, _, _ in h._exemplars.values()] == ["abc"]
        finally:
            mod.set_exemplars(prev)
        assert mod.exemplars_enabled() is prev


# ---------------------------------------------------------------------------
# tracing: rotation, load_events, the stage stack
# ---------------------------------------------------------------------------

def _emit(mod, n):
    for i in range(n):
        mod.event("rotate_probe", tid=f"t{i % 3}", i=i, pad="x" * (i % 7))


def test_rotated_trace_files_equal_the_reference(tmp_path, monkeypatch):
    """The same events under the same cap and keep count give the same
    file names with the same bytes, and each package loads the other's."""
    monkeypatch.setenv("TPUMS_TRACE_MAX_BYTES", "400")
    monkeypatch.setenv("TPUMS_TRACE_KEEP", "2")
    got = {}
    for name, mod in (("ref", RT), ("port", PT)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv("TPUMS_TRACE", str(d / "events.jsonl"))
        clock = iter(1.7e9 + 0.25 * k for k in range(10_000))
        monkeypatch.setattr(time, "time", lambda c=clock: next(c))
        _emit(mod, 40)
        assert mod.trace_file_path() == str(d / "events.jsonl")
        got[name] = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
    monkeypatch.setenv("TPUMS_TRACE", "0")
    assert sorted(got["port"]) == ["events.jsonl", "events.jsonl.1",
                                   "events.jsonl.2"]
    assert got["port"] == got["ref"]
    for name in got["ref"]:
        for pkg in ("ref", "port"):
            path = str(tmp_path / pkg / name)
            assert PT.load_events(path) == RT.load_events(path)
            assert PT.load_events(path)
    assert PT.load_events(str(tmp_path / "missing")) == []


def test_rotation_keep_zero_and_trace_file_path(tmp_path, monkeypatch):
    path = tmp_path / "e.jsonl"
    monkeypatch.setenv("TPUMS_TRACE_MAX_BYTES", "100")
    monkeypatch.setenv("TPUMS_TRACE_KEEP", "0")
    monkeypatch.setenv("TPUMS_TRACE", str(path))
    _emit(PT, 10)
    assert sorted(os.listdir(tmp_path)) == ["e.jsonl"]
    assert path.stat().st_size < 200
    monkeypatch.setenv("TPUMS_TRACE", "-")
    assert PT.trace_file_path() is None == RT.trace_file_path()
    monkeypatch.setenv("TPUMS_TRACE", "0")
    assert PT.trace_file_path() is None


def test_load_events_skips_malformed_lines_like_the_reference(tmp_path):
    path = tmp_path / "mixed.jsonl"
    path.write_text('{"kind": "a"}\n\n{torn\n{"kind": "b", "n": 2}\n[1]\n')
    assert PT.load_events(str(path)) == RT.load_events(str(path))
    assert [e for e in PT.load_events(str(path)) if isinstance(e, dict)] \
        == [{"kind": "a"}, {"kind": "b", "n": 2}]


def test_stage_stack_behaves_like_the_reference():
    import threading

    def drive(mod):
        seen = []
        mod.push_stage("outer")
        seen.append(dict(mod.thread_stages()))
        mod.push_stage("inner")
        seen.append(sorted(mod.thread_stages().values()))
        mod.pop_stage()
        seen.append(sorted(mod.thread_stages().values()))
        mod.pop_stage()
        mod.pop_stage()  # popping an empty stack is a no-op
        seen.append(dict(mod.thread_stages()))
        with mod.trace_span():
            with mod.span("traced_stage"):
                seen.append(sorted(mod.thread_stages().values()))
        with mod.span("untraced"):
            seen.append(dict(mod.thread_stages()))
        other = []
        t = threading.Thread(target=lambda: (
            mod.push_stage("worker"),
            other.append(threading.get_ident()),
            other.append(mod.thread_stages()),
            mod.pop_stage()))
        t.start()
        t.join()
        seen.append(other[1] == {other[0]: "worker"})
        return [s if not isinstance(s, dict) else
                {("me" if k == threading.get_ident() else k): v
                 for k, v in s.items()} for s in seen]

    assert drive(PT) == drive(RT)
    assert drive(PT)[0] == {"me": "outer"}


def test_clear_events_empties_the_ring():
    PT.event("before_clear", tid="c1")
    assert PT.recent_events(tid="c1")
    PT.clear_events()
    assert PT.recent_events() == []


# ---------------------------------------------------------------------------
# StepTimer
# ---------------------------------------------------------------------------

def test_step_timer_merge_histogram_and_json_equal_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    a_vals = list(np.abs(rng.normal(0.01, 0.004, 50)))
    b_vals = list(np.abs(rng.normal(0.2, 0.05, 30)))
    out = {}
    for name, cls in (("ref", RefTimer), ("port", PortTimer)):
        a, b = cls("step"), cls("other")
        a.durations_s.extend(a_vals)
        b.durations_s.extend(b_vals)
        assert a.merge(b) is a and b.durations_s == b_vals
        h = a.to_histogram()
        path = tmp_path / f"{name}.json"
        a.write_json(str(path))
        out[name] = (h.name, h.counts(), h.count, h.sum,
                     [h.quantile(q) for q in (50, 90, 99)],
                     path.read_bytes())
    assert out["port"] == out["ref"]
    assert json.loads(out["port"][-1])["steps"] == 80


# ---------------------------------------------------------------------------
# scrape
# ---------------------------------------------------------------------------

def _push_samples(seed=0):
    """(ts, fleet snapshot) pairs with push counters and latency, a reset
    (a generation cutover) in the middle and a ladder change at the end."""
    rng = np.random.default_rng(seed)
    out, reg = [], PM.MetricsRegistry()
    for t in range(9):
        if t in (4, 8):
            reg = PM.MetricsRegistry()
        reg.counter("tpums_push_deltas_total").inc(int(rng.integers(0, 50)))
        h = reg.histogram("tpums_push_latency_seconds",
                          bounds=(PM.LATENCY_BUCKETS_S if t < 8
                                  else (0.01, 0.1)))
        for v in np.abs(rng.normal(0.02, 0.01, int(rng.integers(0, 20)))):
            h.observe(float(v))
        out.append((100.0 + t, reg.snapshot()))
    return out


def test_push_freshness_equals_the_reference():
    for seed in (0, 1, 2):
        s = _push_samples(seed)
        for part in (s, s[:1], s[:5], []):
            assert PSc.push_freshness(part) == RSc.push_freshness(part)
    assert PSc.push_freshness(_push_samples())["deltas"] > 0


def test_scrape_cli_prints_like_the_reference(monkeypatch):
    snap = _snapshot(PM)
    fake = {"fleet": snap, "scraped": 1, "unreachable": 0,
            "per_shard": {"g/shard-0": snap}, "replicas": []}
    for argv in (["--prom"], ["--raw"], []):
        outs = []
        for mod in (RSc, PSc):
            monkeypatch.setattr(mod, "scrape_fleet", lambda: fake)
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = mod.main(argv)
            outs.append((rc, buf.getvalue()))
        assert outs[1] == outs[0]
    # no replica scraped and none unreachable is success; a dead one fails
    monkeypatch.setattr(PSc, "scrape_fleet", lambda: dict(
        fake, scraped=0, unreachable=1))
    with redirect_stdout(io.StringIO()):
        assert PSc.main([]) == 1


def test_scrape_fleet_profiles_refuses_by_item(tmp_path):
    """Once the port's refusal, now the fleet merge: both packages'
    ``scrape_fleet_profiles`` over one port server merge its PROFILE reply
    into the same stage set and seconds (exact: one reply, one sum), and
    an empty registry merges to an empty profile in both."""
    from flink_ms_tpu_torch.obs import profiler as PP
    from flink_ms_tpu_torch.serve import registry as PReg
    from flink_ms_tpu_torch.serve.server import LookupServer
    from flink_ms_tpu_torch.serve.table import ModelTable

    empty = [mod.scrape_fleet_profiles() for mod in (RSc, PSc)]
    assert [e["scraped"] for e in empty] == [0, 0]
    assert empty[1]["fleet"]["stacks"] == empty[0]["fleet"]["stacks"] == {}
    prof = PP.SamplingProfiler(hz=50.0)
    with prof._lock:
        prof._stacks.update({"-;m.f": 3, "push;m.g": 2})
        prof.samples = 5
    saved, PP._global = PP._global, prof
    srv = LookupServer({"ALS_MODEL": ModelTable(2)}, host="127.0.0.1",
                       port=0, job_id="prof-left").start()
    try:
        PReg.register("prof-left", "127.0.0.1", srv.port, "ALS_MODEL",
                      ready=True, ttl_s=300.0)
        got = [mod.scrape_fleet_profiles() for mod in (RSc, PSc)]
    finally:
        srv.stop()
        PP._global = saved
    for g in got:
        assert g["scraped"] == 1 and g["unreachable"] == 0
        assert g["fleet"]["stacks"] == {"-;m.f": 0.06, "push;m.g": 0.04}
        assert g["fleet"]["samples"] == 5
        assert g["fleet"]["meta"]["planes"] == ["python"]
        assert g["replicas"][0]["job_id"] == "prof-left"
