"""The port's blue/green rollout (``flink_ms_tpu_torch/serve/rollout.py``)
against the JAX package's on the CPU.

Every case of ``tests/test_rollout.py`` runs again with the reference's
names bound to the port's (its controller spawns ``--device cpu``
workers): the verification gate's units, rollback without history, and
the blue/green scenario (cutover under a query stream with zero
client-visible errors, a refused model, one-command rollback).  Then the
two packages roll one group across each other: the reference's controller
rolls back a generation the port's controller published, and the port's
rolls back the reference's, each restoring the previous model's answers,
and both report the same status.
"""

import functools
import inspect
import threading
import time
import types

import numpy as np
import pytest

import test_rollout as ref_cases
from flink_ms_tpu.serve import rollout as RRO
from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.serve import registry
from flink_ms_tpu_torch.serve import rollout as PRO
from flink_ms_tpu_torch.serve.client import RetryPolicy
from flink_ms_tpu_torch.serve.consumer import ALS_STATE
from flink_ms_tpu_torch.serve.elastic import ElasticClient
from flink_ms_tpu_torch.serve.journal import Journal


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    for name in ("TPUMS_SNAPSHOTS", "TPUMS_COMPACT", "TPUMS_TABLE",
                 "TPUMS_TENANT"):
        monkeypatch.delenv(name, raising=False)


def _on_port(module, overrides):
    g = dict(module.__dict__)
    g.update(overrides)
    for name, obj in list(g.items()):
        if isinstance(obj, types.FunctionType) and \
                obj.__module__ == module.__name__:
            g[name] = types.FunctionType(obj.__code__, g, obj.__name__,
                                         obj.__defaults__, obj.__closure__)
    return g


PORT_CASES = _on_port(ref_cases, {
    "F": F, "registry": registry, "rollout_mod": PRO, "Journal": Journal,
    "ElasticClient": ElasticClient, "ALS_STATE": ALS_STATE,
    "RolloutController": functools.partial(PRO.RolloutController,
                                           device="cpu"),
    "RolloutError": PRO.RolloutError,
    "VerificationError": PRO.VerificationError})

CASES = [
    "test_parse_factors",
    "test_mse_probe_gate_pass_fail_and_empty",
    "test_rollback_without_topology_or_history_raises",
    "test_rollout_blue_green_abort_and_rollback_zero_errors",
]


@pytest.mark.parametrize("name", CASES)
def test_reference_rollout_case_on_the_port(name, tmp_path, monkeypatch):
    fn = PORT_CASES[name]
    params = inspect.signature(fn).parameters
    fn(**{k: v for k, v in (("tmp_path", tmp_path),
                            ("monkeypatch", monkeypatch)) if k in params})


def test_every_reference_rollout_case_is_covered():
    """The registry cases of ``tests/test_rollout.py`` run on the port in
    ``test_torch_registry_alerts.py``; the rest run here."""
    registry_cases = {
        "test_qualify_group_explicit_idempotent_and_validated",
        "test_qualify_group_ambient_tenant_env", "test_split_tenant_roundtrip",
        "test_topology_records_are_tenant_isolated",
        "test_tenant_listing_and_gc_isolation",
        "test_publish_topology_extra_binds_model_and_survives_history"}
    names = {n for n in vars(ref_cases) if n.startswith("test_")}
    assert names == registry_cases | set(CASES)


def test_probe_gate_and_status_equal_the_reference(tmp_path):
    """The same fake warming client: the same verdicts and messages, the
    same ``verified`` events, the same status of one registry record."""
    table = {"0-U": "1;0", "1-U": "0;1", "0-I": "1;0", "1-I": "0;1"}
    client = ref_cases._FakeModelClient(table)
    probes = [ref_cases._probe([0, 1], [0, 1], [1.0, 1.0], 0.01),
              ref_cases._probe([0, 1], [0, 1], [5.0, 5.0], 0.01),
              ref_cases._probe([7, 8], [7, 8], [1.0, 1.0], 1e9)]
    outcomes = {}
    for name, mod, kw in (("ref", RRO, {}), ("port", PRO, {"device": "cpu"})):
        ctl = mod.RolloutController("g", journal_dir=str(tmp_path),
                                    topic="models", **kw)
        got = []
        for probe in probes:
            try:
                ctl._run_probe(client, 3, probe)
                got.append("ok")
            except mod.VerificationError as e:
                got.append(str(e))
        got.append([{k: v for k, v in e.items() if k != "t"}
                    for e in ctl.events])
        outcomes[name] = got
    assert outcomes["port"] == outcomes["ref"]
    registry.publish_topology("g", 1, extra={"model": {
        "journal_dir": "/d/v1", "topic": "models", "model_id": "v1"}})
    registry.publish_topology("g", 1, extra={"model": {
        "journal_dir": "/d/v2", "topic": "models", "model_id": "v2"}})
    port_status = PRO.RolloutController("g", device="cpu").status()
    assert port_status == RRO.RolloutController("g").status()
    assert port_status["rollback_to"]["model_id"] == "v1"


# ---------------------------------------------------------------------------
# one group, two packages' controllers
# ---------------------------------------------------------------------------

def _seed_model(tmp_path, name, n=16, k=3, seed=0):
    journal = Journal(str(tmp_path / f"bus-{name}"), "models")
    rng = np.random.default_rng(seed)
    journal.append(
        [F.format_als_row(u, "U", rng.normal(size=k)) for u in range(n)]
        + [F.format_als_row(i, "I", rng.normal(size=k)) for i in range(n)])
    return journal


class _Stream:
    """GETs of every key in a loop through one port ElasticClient; a raise
    or a missing row is a client-visible error."""

    def __init__(self, group, keys):
        self.group, self.keys = group, keys
        self.errors, self.served = [], 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        c = ElasticClient(self.group, timeout_s=10, retry=RetryPolicy(
            attempts=6, backoff_s=0.02, max_backoff_s=0.5))
        with c:
            while not self._stop.is_set():
                for key in self.keys:
                    try:
                        if c.query_state(ALS_STATE, key) is None:
                            self.errors.append((key, "missing"))
                    except Exception as e:
                        self.errors.append((key, repr(e)))
                    self.served += 1

    def advance(self, n=30):
        mark, deadline = self.served, time.time() + 10
        while self.served < mark + n and time.time() < deadline:
            time.sleep(0.02)

    def stop(self):
        self._stop.set()
        self._t.join(timeout=30)


def test_controllers_roll_back_across_the_packages(tmp_path, monkeypatch):
    """The port's controller serves v1 then v2; the reference's rolls back
    to v1 (its own workers); the port's rolls back to v2 (its workers).
    Every generation answers its model's payloads, with zero errors."""
    monkeypatch.setenv("TPUMS_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "30")
    n = 16
    j1 = _seed_model(tmp_path, "v1", n=n, seed=1)
    j2 = _seed_model(tmp_path, "v2", n=n, seed=2)
    keys = [f"{u}-U" for u in range(n)]
    port_ctl = PRO.RolloutController(
        "x", port_dir=str(tmp_path / "ports-port"), journal_dir=j1.dir,
        topic="models", ready_timeout_s=90, device="cpu")
    ref_ctl = stream = probe = None
    try:
        port_ctl.rollout(j1.dir, "models", model_id="v1", shards=1)
        probe = ElasticClient("x", timeout_s=10)
        v1 = probe.query_states(ALS_STATE, keys)
        assert all(v is not None for v in v1)
        stream = _Stream("x", keys)
        stream.advance()
        rec = port_ctl.rollout(j2.dir, "models", model_id="v2",
                               verify_min_rows=2 * n)
        assert rec["gen"] == 2
        stream.advance()
        v2 = probe.query_states(ALS_STATE, keys)
        assert v2 != v1 and all(v is not None for v in v2)

        # a fresh reference controller attaches to the port's group: its
        # journal binding comes from the record the port published
        ref_ctl = RRO.RolloutController(
            "x", port_dir=str(tmp_path / "ports-ref"), ready_timeout_s=120)
        assert (ref_ctl.journal_dir, ref_ctl.topic) == (j2.dir, "models")
        assert ref_ctl.status() == port_ctl.status()
        rec = ref_ctl.rollback(verify_min_rows=2 * n)
        assert rec["gen"] == 3 and rec["model"]["model_id"] == "v1"
        stream.advance()
        assert probe.query_states(ALS_STATE, keys) == v1

        rec = port_ctl.rollback()
        assert rec["gen"] == 4 and rec["model"]["model_id"] == "v2"
        stream.advance()
        assert probe.query_states(ALS_STATE, keys) == v2
        stream.stop()
        assert stream.errors == [], stream.errors[:5]
        st = port_ctl.status()
        assert st == ref_ctl.status()
        assert st["model"]["model_id"] == "v2"
        assert st["rollback_to"]["model_id"] == "v1"
        assert [e["kind"] for e in ref_ctl.events].count("cutover") == 1
    finally:
        if stream is not None:
            stream.stop()
        if probe is not None:
            probe.close()
        if ref_ctl is not None:
            ref_ctl.stop()
        port_ctl.stop(drop_topology=True)


def test_cli_status_and_refusals(tmp_path, capsys):
    assert PRO.main([]) == 2
    registry.publish_topology("cli", 1, extra={"model": {
        "journal_dir": "/d/v1", "topic": "models", "model_id": "v1"}})
    assert PRO.main(["--group", "cli", "--status", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"model_id": "v1"' in out
    assert PRO.main(["--group", "cli", "--rollback", "--device",
                     "cpu"]) == 1
    assert "no previous model" in capsys.readouterr().err
