"""The port's tail-latency forensics (``flink_ms_tpu_torch/obs/forensics.py``)
against the JAX package's on the CPU.

- Every case of ``tests/test_forensics.py`` runs again with the
  reference's names bound to the port's objects (module-level names
  through ``_on_port``, the modules its cases import inside their bodies
  through ``_port_imports``): the reference's own assertions on the port.
- Cross-package cases, all exact (the same float operations on the same
  parsed events): one spill written by both packages' clients and servers
  gives equal ``report`` dicts, equal ``render_human`` text and equal CLI
  output through either package; seeded synthetic spans give equal trees,
  critical paths, slow/fast diffs and incident contexts; the port's
  ``collect`` feeds the port's ``fleet_signals`` its staleness.
"""

import inspect
import io
import json
import random
import time
import types
from contextlib import redirect_stdout

import pytest

import test_forensics as ref_cases
from test_torch_profiler import _on_port, _port_imports
import tests.test_update_plane as ref_up_cases
from flink_ms_tpu.obs import forensics as RFX
from flink_ms_tpu.obs import scrape as RSc
from flink_ms_tpu.obs import tracing as RT
from flink_ms_tpu.serve.client import QueryClient as RefClient
from flink_ms_tpu.serve.server import LookupServer as RefServer
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu_torch.obs import forensics as PFX
from flink_ms_tpu_torch.obs import metrics as PM
from flink_ms_tpu_torch.obs import rules as PRu
from flink_ms_tpu_torch.obs import scrape as PSc
from flink_ms_tpu_torch.obs import tracing as PT
from flink_ms_tpu_torch.obs import watch as PW
from flink_ms_tpu_torch.serve import update_plane as PUP
from flink_ms_tpu_torch.serve.client import QueryClient as PortClient
from flink_ms_tpu_torch.serve.consumer import ALS_STATE
from flink_ms_tpu_torch.serve.server import LookupServer as PortServer
from flink_ms_tpu_torch.serve.table import ModelTable as PortTable


PORT = _on_port(ref_cases, {
    "FX": PFX, "M": PM, "T": PT, "Rule": PRu.Rule,
    "fleet_signals": PSc.fleet_signals})
# the reference update plane's test helpers, building port tables
UP_HELPERS = types.ModuleType("tests.test_update_plane")
UP_HELPERS.__dict__.update({
    k: v for k, v in _on_port(ref_up_cases, {"ModelTable": PortTable}).items()
    if k in ("TableClient", "seed_table")})
CASES = sorted(n for n, f in vars(ref_cases).items()
               if n.startswith("test_") and callable(f))


def test_the_mirrored_cases_are_all_sixteen():
    assert len(CASES) == 16


@pytest.mark.parametrize("name", CASES)
def test_reference_forensics_case_on_the_port(name, tmp_path, monkeypatch):
    _port_imports(monkeypatch, {
        "flink_ms_tpu.obs.watch": PW,
        "flink_ms_tpu.obs.tracing": PT,
        "flink_ms_tpu.serve.update_plane": PUP,
        "tests.test_update_plane": UP_HELPERS})
    fn = PORT[name]
    have = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: have[p] for p in inspect.signature(fn).parameters})


# ---------------------------------------------------------------------------
# one spill, both packages
# ---------------------------------------------------------------------------

def _tables():
    rt, pt = RefTable(2), PortTable(2)
    for u in range(8):
        row = ";".join(f"{0.25 * (u + j):.2f}" for j in range(3))
        rt.put(f"{u}-U", row)
        pt.put(f"{u}-U", row)
    return rt, pt


def test_report_equals_the_reference_on_a_mixed_spill(tmp_path,
                                                      monkeypatch):
    """Both packages' clients trace GETs and MGETs into both packages'
    servers, every process appending to one ``TPUMS_TRACE`` file; each
    package's report over that file is the same dict, and every trace is a
    client span with the server's reply under it."""
    spill = tmp_path / "spill.jsonl"
    monkeypatch.setenv("TPUMS_TRACE", str(spill))
    rt, pt = _tables()
    ref = RefServer({ALS_STATE: rt}, host="127.0.0.1", port=0,
                    job_id="fx-ref").start()
    port = PortServer({ALS_STATE: pt}, host="127.0.0.1", port=0,
                      job_id="fx-port").start()
    tids = []
    try:
        for client_cls, tr in ((RefClient, RT), (PortClient, PT)):
            for srv in (ref, port):
                with client_cls("127.0.0.1", srv.port, timeout_s=30) as c:
                    for u in range(8):
                        tid = tr.new_trace_id()
                        tids.append(tid)
                        with tr.trace_span(tid):
                            if u % 2:
                                c.query_states(ALS_STATE,
                                               [f"{u}-U", f"{u - 1}-U"])
                            else:
                                c.query_state(ALS_STATE, f"{u}-U")
    finally:
        ref.stop()
        port.stop()
    monkeypatch.setenv("TPUMS_TRACE", "0")
    r_rep, p_rep = RFX.report([str(spill)]), PFX.report([str(spill)])
    assert p_rep == r_rep
    assert p_rep["traces"] == len(tids) == 32
    assert PFX.render_human(p_rep) == RFX.render_human(r_rep)
    trees = PFX.assemble(PFX.collect([str(spill)]))
    for tid in tids:
        tree = trees[tid]
        kinds = {PFX.stage_name(ev) for ev in tree.spans.values()}
        assert any(k.startswith("server_reply:") for k in kinds), kinds
        assert any(k.startswith(("client_rpc", "client_pipeline"))
                   for k in kinds), kinds
        assert len(tree.roots) == 1          # the server parents under it
    for argv in ([str(spill)], [str(spill), "--json"],
                 [str(spill), "--tree", tids[0]]):
        outs = []
        for mod in (RFX, PFX):
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert mod.main(argv) == 0
            outs.append(buf.getvalue())
        assert outs[1] == outs[0], argv


def _synthetic_events(seed, n=40):
    """Seeded spans: a client root per trace, a server reply under it, a
    device stage under that on some, an orphan on a few, annotations."""
    rng = random.Random(seed)
    evs = []
    for i in range(n):
        tid = f"{seed:04x}{i:012x}"
        t0 = rng.uniform(0, 100)
        dur = rng.uniform(0.001, 0.004)
        evs.append({"ts": t0 + dur, "tid": tid, "kind": "client_rpc",
                    "sid": "r", "t0": t0, "dur_s": dur})
        sd = dur * rng.uniform(0.3, 0.9)
        evs.append({"ts": t0 + sd, "tid": tid, "kind": "server_reply",
                    "verb": rng.choice(["GET", "TOPK", "MGET"]), "sid": "s",
                    "psid": "r", "t0": t0 + 0.0001, "dur_s": sd})
        if rng.random() < 0.3:
            dd = sd * rng.uniform(0.2, 1.2)
            evs.append({"ts": t0 + dd, "tid": tid, "kind": "mb_device",
                        "sid": "d", "psid": "s", "t0": t0 + 0.0002,
                        "dur_s": dd})
        if rng.random() < 0.1:
            evs.append({"ts": t0, "tid": tid, "kind": "fanout", "sid": "o",
                        "psid": "gone", "dur_s": dur / 2})
        if rng.random() < 0.2:
            evs.append({"ts": t0, "tid": tid, "kind": "ha_failover"})
    rng.shuffle(evs)
    return evs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trees_paths_and_diffs_equal_the_reference(seed):
    evs = _synthetic_events(seed)
    r_trees, p_trees = RFX.assemble(evs), PFX.assemble(evs)
    assert sorted(p_trees) == sorted(r_trees)
    for tid, rt in r_trees.items():
        pt = p_trees[tid]
        assert (pt.spans, pt.children, pt.roots, pt.annotations) == \
            (rt.spans, rt.children, rt.roots, rt.annotations)
        assert pt.total_s() == rt.total_s()
        assert pt.self_times() == rt.self_times()
        assert pt.render() == rt.render()
        assert PFX.critical_path(pt, top=3) == RFX.critical_path(rt, top=3)
    for q in (0.5, 0.9):
        assert PFX.diff_slow_fast(p_trees, slow_q=q) == \
            RFX.diff_slow_fast(r_trees, slow_q=q)
    tids = sorted(r_trees)[:5] + ["missing", ""]
    assert PFX.incident_context(tids, trees=p_trees) == \
        RFX.incident_context(tids, trees=r_trees)


def test_collect_feeds_the_ports_fleet_signals(tmp_path):
    """The gauges ``collect`` sets are the ones ``fleet_signals`` reads:
    the port's forensics staleness is a number once the port has
    collected, and reads as the reference reads the same snapshot."""
    spill = tmp_path / "s.jsonl"
    spill.write_text(json.dumps({"ts": 1.0, "tid": "a", "kind": "x",
                                 "sid": "1", "dur_s": 0.001}) + "\n")
    PFX.collect([str(spill)])
    snap = PM.get_registry().snapshot()
    before = dict(snap, ts=snap["ts"] - 1.0)
    sig = PSc.fleet_signals(before, snap)
    assert sig["forensics_staleness_s"] is not None
    assert 0.0 <= sig["forensics_staleness_s"] < 60.0
    # both read the wall clock at their call: equal within a second
    assert sig["forensics_staleness_s"] == pytest.approx(
        RSc.fleet_signals(before, snap)["forensics_staleness_s"], abs=1.0)
    assert time.time() - snap["ts"] < 60.0
