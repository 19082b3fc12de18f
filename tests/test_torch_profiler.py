"""The port's continuous profiler (``flink_ms_tpu_torch/obs/profiler.py``,
``profdiff.py``), its PROFILE verb and fleet merge against the JAX
package's on the CPU.

- Every case of ``tests/test_profiler.py`` runs again with the reference's
  names bound to the port's objects (its module-level names through
  ``_on_port``, the modules its cases import inside their bodies through
  ``_port_imports``; the other port files rerun reference cases through
  the same two helpers): the reference's own assertions, on the port.
- Cross-package cases: each package's PROFILE reply parses with the
  other's ``parse_profile_reply``; ``scrape_fleet_profiles`` of either
  package over one reference job, one port job and one native server gives
  the same stage set and the same total seconds (rel 1e-9: both folds sum
  the same numbers); the folded text and ``profdiff`` give equal results
  for equal inputs (exact).
Frame keys are ``module.function``, so the port's frames read
``flink_ms_tpu_torch.…``: no case compares frame names across packages.
"""

import importlib
import inspect
import json
import math
import sys
import threading
import types

import pytest

import test_profiler as ref_cases
from flink_ms_tpu.obs import profdiff as RD
from flink_ms_tpu.obs import profiler as RP
from flink_ms_tpu.obs import scrape as RSc
from flink_ms_tpu.serve.server import LookupServer as RefServer
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu_torch.obs import metrics as PM
from flink_ms_tpu_torch.obs import profdiff as PD
from flink_ms_tpu_torch.obs import profiler as PP
from flink_ms_tpu_torch.obs import scrape as PSc
from flink_ms_tpu_torch.obs import tracing as PT
from flink_ms_tpu_torch.serve import native_store as PN
from flink_ms_tpu_torch.serve import registry as PReg
from flink_ms_tpu_torch.serve.consumer import ALS_STATE
from flink_ms_tpu_torch.serve.server import LookupServer as PortServer
from flink_ms_tpu_torch.serve.table import ModelTable as PortTable


def _on_port(module, overrides):
    """The module's functions and classes with every global in
    ``overrides`` swapped for the port's object (helpers and helper classes
    rebound too, so they build and drive port objects)."""
    g = dict(module.__dict__)
    g.update(overrides)

    def rebind(fn):
        out = types.FunctionType(fn.__code__, g, fn.__name__,
                                 fn.__defaults__, fn.__closure__)
        out.__kwdefaults__ = fn.__kwdefaults__
        return out

    for name, obj in list(g.items()):
        if getattr(obj, "__module__", None) != module.__name__:
            continue
        if isinstance(obj, types.FunctionType):
            g[name] = rebind(obj)
        elif isinstance(obj, type):
            slots = vars(obj).get("__slots__", ())
            ns = {k: rebind(v) if isinstance(v, types.FunctionType) else v
                  for k, v in vars(obj).items()
                  if k not in ("__dict__", "__weakref__") and k not in slots}
            g[name] = type(obj.__name__, obj.__bases__, ns)
    return g


def _port_imports(monkeypatch, modules):
    """For the length of a case, an ``import`` of a reference module inside
    a case's body gets the port's module (``sys.modules`` and the parent
    package's attribute both point at it)."""
    for name, mod in modules.items():
        parent, _, leaf = name.rpartition(".")
        monkeypatch.setitem(sys.modules, name, mod)
        monkeypatch.setattr(importlib.import_module(parent), leaf, mod,
                            raising=False)


def _run(g, name, tmp_path, monkeypatch):
    fn = g[name]
    have = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: have[p] for p in inspect.signature(fn).parameters})


@pytest.fixture(autouse=True)
def _fresh_profilers():
    RP.stop_profiler()
    PP.stop_profiler()
    yield
    RP.stop_profiler()
    PP.stop_profiler()


PORT = _on_port(ref_cases, {
    "P": PP, "profdiff": PD, "T": PT, "registry": PReg,
    "ALS_STATE": ALS_STATE, "LookupServer": PortServer,
    "ModelTable": PortTable})
CASES = sorted(n for n, f in vars(ref_cases).items()
               if n.startswith("test_") and callable(f))


def test_the_mirrored_cases_are_all_fourteen():
    assert len(CASES) == 14


@pytest.mark.parametrize("name", CASES)
def test_reference_profiler_case_on_the_port(name, tmp_path, monkeypatch):
    _port_imports(monkeypatch, {
        "flink_ms_tpu.obs.metrics": PM,
        "flink_ms_tpu.obs.scrape": PSc,
        "flink_ms_tpu.serve.native_store": PN})
    _run(PORT, name, tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _raw_line(port, line):
    return ref_cases._raw_line(port, line)


class _Busy:
    """A thread burning CPU inside a stage until stopped."""

    def __init__(self, prof_mod, stage):
        self.stop_ev = threading.Event()
        self.inside = threading.Event()

        def run():
            with prof_mod.prof_stage(stage):
                self.inside.set()
                x = 0.0
                while not self.stop_ev.is_set():
                    x += math.sqrt(x + 1.0)

        self.t = threading.Thread(target=run, daemon=True)
        self.t.start()
        assert self.inside.wait(5)

    def stop(self):
        self.stop_ev.set()
        self.t.join(timeout=5)


def _pinned_profiler(mod, stage, passes=5):
    """The package's process profiler, sampled by hand in wall mode (no
    timer thread), so its snapshot holds still between two scrapes."""
    prof = mod.SamplingProfiler(hz=50.0)
    prof.include_idle = True
    busy = _Busy(mod, stage)
    try:
        for _ in range(passes):
            prof.sample_once()
    finally:
        busy.stop()
    mod._global = prof
    return prof


def _servers():
    rt, pt = RefTable(2), PortTable(2)
    rt.put("1-U", "0.5;1.5")
    pt.put("1-U", "0.5;1.5")
    ref = RefServer({ALS_STATE: rt}, host="127.0.0.1", port=0,
                    job_id="prof-ref").start()
    port = PortServer({ALS_STATE: pt}, host="127.0.0.1", port=0,
                      job_id="prof-port").start()
    return ref, port


def test_profile_replies_parse_across_the_packages(monkeypatch):
    monkeypatch.setenv("TPUMS_PROF", "1")
    RP.ensure_started()
    PP.ensure_started()
    ref, port = _servers()
    try:
        r_line = _raw_line(ref.port, "PROFILE")
        p_line = _raw_line(port.port, "PROFILE")
        for line in (r_line, p_line):
            a, b = RP.parse_profile_reply(line), PP.parse_profile_reply(line)
            assert a is not None and a == b
        r_doc, p_doc = PP.parse_profile_reply(r_line), \
            RP.parse_profile_reply(p_line)
        assert sorted(r_doc) == sorted(p_doc)
        assert sorted(r_doc["meta"]) == sorted(p_doc["meta"])
        assert p_doc["meta"]["job_id"] == "prof-port"
        assert p_doc["meta"]["plane"] == r_doc["meta"]["plane"] == "python"
        assert p_doc["enabled"] is r_doc["enabled"] is True
        assert p_doc["hz"] == r_doc["hz"]
        # the port's reply line is the reference's function of the same
        # snapshot: equal bytes for an equal profile
        snap = {"ts": 1.0, "hz": 47.0, "enabled": True, "samples": 3,
                "wall_s": 2.0, "unit": "seconds",
                "stacks": {"server_reply;m.f": 0.06}, "meta": {"a": 1}}
        for mod in (RP, PP):
            monkeypatch.setattr(mod._global, "snapshot",
                                lambda meta=None, s=snap: dict(s))
        assert PP.profile_reply_line() == RP.profile_reply_line()
    finally:
        ref.stop()
        port.stop()


def _total(profile, skip=("native;PROFILE",)):
    return sum(v for k, v in profile["stacks"].items() if k not in skip)


def test_fleet_merge_equal_through_either_package(tmp_path):
    """One reference job, one port job, one native server: both packages'
    ``scrape_fleet_profiles`` give one stage set and one total.  The native
    server counts each PROFILE request's own self-time under
    ``native;PROFILE``, which grows from one scrape to the next, so the
    totals leave that stack out."""
    _pinned_profiler(RP, "ref_burn")
    _pinned_profiler(PP, "port_burn")
    ref, port = _servers()
    store = PN.NativeStore(str(tmp_path / "store"))
    store.put("1-U", "0.5;1.5")
    nsrv = PN.NativeLookupServer(store, ALS_STATE, job_id="prof-nat",
                                 port=0).__enter__()
    try:
        for job_id, p in (("prof-ref", ref.port), ("prof-port", port.port),
                          ("prof-nat", nsrv.port)):
            PReg.register(job_id, "127.0.0.1", p, ALS_STATE, ready=True,
                          ttl_s=300.0)
        for _ in range(50):
            assert _raw_line(nsrv.port, f"GET\t{ALS_STATE}\t1-U") \
                == "V\t0.5;1.5"
        got = [RSc.scrape_fleet_profiles(), PSc.scrape_fleet_profiles(),
               RSc.scrape_fleet_profiles()]
        assert [g["scraped"] for g in got] == [3, 3, 3]
        fleets = [g["fleet"] for g in got]
        stages = [sorted({k.split(";")[0] for k in f["stacks"]})
                  for f in fleets]
        assert stages[0] == stages[1] == stages[2]
        assert {"ref_burn", "port_burn", "native"} <= set(stages[0])
        totals = [_total(f) for f in fleets]
        assert totals[0] > 0
        assert totals[1] == pytest.approx(totals[0], rel=1e-9)
        assert totals[2] == pytest.approx(totals[0], rel=1e-9)
        for f in fleets:
            assert f["meta"]["planes"] == ["native", "python"]
            assert f["samples"] == fleets[0]["samples"] > 0
        # each stage's seconds are equal too, and equal the merge of the
        # replies scraped one by one
        per_stage = []
        for f in fleets[:2]:
            acc = {}
            for k, v in f["stacks"].items():
                if k != "native;PROFILE":
                    st = k.split(";")[0]
                    acc[st] = acc.get(st, 0.0) + v
            per_stage.append(acc)
        assert per_stage[0].keys() == per_stage[1].keys()
        for st, v in per_stage[0].items():
            assert per_stage[1][st] == pytest.approx(v, rel=1e-9)
    finally:
        nsrv.__exit__(None, None, None)
        store.close()
        ref.stop()
        port.stop()


def test_folded_text_and_profdiff_equal_the_reference(tmp_path):
    base = {"ts": 1.0, "hz": 47.0, "samples": 9, "wall_s": 1.0,
            "unit": "seconds", "meta": {"plane": "python"},
            "stacks": {"-;m.f;m.g": 1.234567, "server_reply;m.h": 0.021277,
                       "native;GET": 0.5, "s;m.k": 1e-7}}
    cur = dict(base, stacks={"-;m.f;m.g": 1.5, "push;m.x": 0.75,
                             "native;GET": 0.25, "server_reply;m.h": 0.1})
    for prof in (base, cur):
        text = PP.profile_to_folded(prof)
        assert text == RP.profile_to_folded(prof)
        assert PP.folded_to_profile(text) == RP.folded_to_profile(text)
        p = tmp_path / "p.folded"
        p.write_text(text)
        assert PP.load_profile(str(p)) == RP.load_profile(str(p))
    assert PP.merge_profiles([base, cur]) == RP.merge_profiles([base, cur])
    assert PD.self_times(cur) == RD.self_times(cur)
    for lo in (0.0, 0.2):
        assert PD.diff_profiles(base, cur, min_delta_s=lo) == \
            RD.diff_profiles(base, cur, min_delta_s=lo)
    assert PD.top_frames(base, cur, n=3) == RD.top_frames(base, cur, n=3)
    rep = PD.diff_profiles(base, cur)
    assert PD.format_diff(rep) == RD.format_diff(rep)


def test_profiler_cli_prints_like_the_reference(tmp_path, capsys):
    a = {"ts": 1.0, "hz": 47.0, "samples": 9, "wall_s": 1.0,
         "unit": "seconds", "meta": {},
         "stacks": {"-;m.f": 1.0, "server_reply;m.h": 0.5}}
    b = dict(a, stacks={"-;m.f": 1.25, "server_reply;m.h": 0.25,
                        "push;m.x": 0.5})
    pa, pb = tmp_path / "a.json", tmp_path / "b.folded"
    pa.write_text(json.dumps(a))
    pb.write_text(RP.profile_to_folded(b))
    for argv in (["--diff", str(pa), str(pb)],
                 ["--diff", str(pa), str(pb), "--json"],
                 ["--flamegraph", str(pa)], ["--flamegraph", str(pb),
                                             "--json"]):
        outs = []
        for mod in (RP, PP):
            assert mod.main(argv) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0], argv


def test_serving_job_starts_the_profiler_unless_killed(tmp_path, monkeypatch):
    """``ServingJob.start`` starts the process profiler after its server,
    as the reference's does; ``TPUMS_PROF=0`` leaves it off."""
    from flink_ms_tpu_torch.core import formats as F
    from flink_ms_tpu_torch.serve.consumer import (ServingJob, make_backend,
                                                   parse_als_record)
    from flink_ms_tpu_torch.serve.journal import Journal

    journal = Journal(str(tmp_path / "bus"), "models")
    journal.append([F.format_als_row(u, "U", [0.5, 1.0]) for u in range(4)])
    for flag, active in (("0", False), ("1", True)):
        PP.stop_profiler()
        monkeypatch.setenv("TPUMS_PROF", flag)
        job = ServingJob(journal, ALS_STATE, parse_als_record,
                         make_backend("memory", None), host="127.0.0.1",
                         port=0, poll_interval_s=0.01, device="cpu",
                         topk_index=False, snapshots=False).start()
        try:
            assert job.wait_ready(60)
            assert PP.profiler_active() is active
            doc = PP.parse_profile_reply(_raw_line(job.port, "PROFILE"))
            assert doc is not None and doc["enabled"] is active
            assert doc["meta"]["job_id"] == job.job_id
        finally:
            job.stop()
