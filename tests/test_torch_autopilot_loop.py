"""The port's autopilot controller (``flink_ms_tpu_torch/serve/autopilot.py``
``AutopilotController``) against the JAX package's on the CPU.

Every case of ``tests/test_autopilot.py`` runs again with the reference's
names bound to the port's (``device="cpu"``; the flywheel's workers are
``--device cpu`` processes): windowing with last-write-wins and offsets
across a restart, standby without the lease, both drift sources with the
re-arm latch, validation, the atomic state record, and the unattended
flywheel (rollout, then drift rollback).  Then both packages tail the same
input journals into separate work dirs and write equal window files and
state records, each resumes the other's state record, and their
candidates agree at the parity contract's rtol 1e-3 / atol 1e-5 with the
reference's init draws injected.
"""

import functools
import inspect
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

import test_autopilot as ref_cases
from flink_ms_tpu.ops import als as JA
from flink_ms_tpu.serve import autopilot as RAP
from flink_ms_tpu.serve.update_plane import UpdatePlaneClient as RefUPC
from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.obs.metrics import get_registry
from flink_ms_tpu_torch.ops import als as TA
from flink_ms_tpu_torch.serve import autopilot as PAP
from flink_ms_tpu_torch.serve import registry
from flink_ms_tpu_torch.serve.consumer import ALS_STATE
from flink_ms_tpu_torch.serve.elastic import ElasticClient
from flink_ms_tpu_torch.serve.journal import Journal
from flink_ms_tpu_torch.serve.rollout import RolloutController
from flink_ms_tpu_torch.serve.update_plane import UpdatePlaneClient


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
    "F": F, "get_registry": get_registry, "registry": registry,
    "AutopilotController": functools.partial(PAP.AutopilotController,
                                             device="cpu"),
    "PHASES": PAP.PHASES, "autopilot_scope": PAP.autopilot_scope,
    "ALS_STATE": ALS_STATE, "ElasticClient": ElasticClient,
    "Journal": Journal,
    "RolloutController": functools.partial(RolloutController, device="cpu"),
    "UpdatePlaneClient": UpdatePlaneClient})

CASES = sorted(n for n in vars(ref_cases) if n.startswith("test_"))


@pytest.mark.parametrize("name", CASES)
def test_reference_autopilot_case_on_the_port(name, tmp_path, monkeypatch):
    fn = PORT_CASES[name]
    params = inspect.signature(fn).parameters
    fn(**{k: v for k, v in (("tmp_path", tmp_path),
                            ("monkeypatch", monkeypatch)) if k in params})


def test_the_controller_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        PAP.AutopilotController("g", str(tmp_path / "bus"),
                                str(tmp_path / "work"),
                                rollout=ref_cases._StubRollout())


# ---------------------------------------------------------------------------
# both packages over the same input journals
# ---------------------------------------------------------------------------

def _pilots(tmp_path, name, mod, **kw):
    kw = dict(dict(rollout=ref_cases._StubRollout(), partitions=3,
                   min_window=4, num_factors=3, iterations=2), **kw)
    if mod is PAP:
        kw["device"] = "cpu"
    return mod.AutopilotController("stub", str(tmp_path / "bus"),
                                   str(tmp_path / name), **kw)


def _submit(tmp_path, seed, n, client=RefUPC):
    rng = np.random.default_rng(seed)
    up = client(str(tmp_path / "bus"), "models", partitions=3)
    up.submit_many([(int(u), int(i), float(np.round(r, 3))) for u, i, r in
                    zip(rng.integers(0, 12, n), rng.integers(0, 9, n),
                        rng.uniform(1, 5, n))], flush=True)
    up.sync()


def _record(pilot):
    with open(pilot.state_path) as f:
        rec = json.load(f)
    rec.pop("updated_at")
    return rec


def _windows(pilot):
    d = os.path.join(pilot.work_dir, "windows")
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_windows_and_state_records_equal_the_reference(tmp_path):
    _submit(tmp_path, 0, 60)
    ref, port = _pilots(tmp_path, "ref", RAP), _pilots(tmp_path, "port", PAP)
    for step in range(3):
        got = [(p._tail_ratings(), p._seal_window()[0]) for p in (ref, port)]
        assert got[0] == got[1]
        for p in (ref, port):
            p._set_phase("training")
        assert _record(port) == _record(ref)
        assert _windows(port) == _windows(ref)
        assert port._acc == ref._acc
        _submit(tmp_path, step + 1, 25, client=UpdatePlaneClient)
    # a foreign line in one input journal: skipped by both
    Journal(str(tmp_path / "bus"), "models.upd1").append(
        ["not\ta rating", "9\t1\t2\t3.5"])
    assert [p._tail_ratings() for p in (ref, port)] == [26, 26]
    assert [p._seal_window()[0] for p in (ref, port)] == [4, 4]
    assert _record(port) == _record(ref)
    assert _windows(port) == _windows(ref)
    assert list(_windows(port)) == ["window-v000004.tsv"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_resumes_the_others_state_record(tmp_path, writer):
    first_mod, second_mod = (RAP, PAP) if writer == "ref" else (PAP, RAP)
    _submit(tmp_path, 0, 40)
    first = _pilots(tmp_path, "work", first_mod)
    first._tail_ratings()
    first._seal_window()
    first.state["model_seq"] = 4
    first._save_state()
    _submit(tmp_path, 1, 15)
    # the other package's controller on the same work dir: the same LWW
    # set from the sealed window, the same offsets, only the new ratings
    second = _pilots(tmp_path, "work", second_mod)
    assert second._acc == first._acc
    assert second.state["offsets"] == first.state["offsets"]
    assert second.state["model_seq"] == 4
    assert second._tail_ratings() == 15
    assert second._seal_window()[0] == 2
    # and a third controller of the first package resumes from there
    third = _pilots(tmp_path, "work", first_mod)
    assert third._acc == second._acc and third._tail_ratings() == 0
    assert third.state["window_version"] == 2


@pytest.mark.parametrize("holder", ["ref", "port"])
def test_the_autopilot_lease_holds_across_the_packages(tmp_path, holder):
    """One package's controller holds ``<group>#autopilot``: the other's
    tick is standby until the lease is released."""
    mods = (RAP, PAP) if holder == "ref" else (PAP, RAP)
    first, second = (_pilots(tmp_path, f"w{i}", m)
                     for i, m in enumerate(mods))
    assert first._ensure_lease()
    assert second.tick()["state"] == "standby"
    assert second.state["phase"] == "idle"
    first.release_lease()
    assert second.tick().get("state") != "standby"
    second.release_lease()


def _reference_draws(monkeypatch, seed):
    """The port's ``warm_start_factors`` draws the reference's threefry init
    for unseen ids (the split of PRNGKey(seed), users first)."""
    keys = list(jax.random.split(jax.random.PRNGKey(seed)))

    def draw(n, k, generator, dtype=torch.float32):
        return torch.from_numpy(np.array(
            JA.init_factors(n, k, keys.pop(0), np.float32)))

    monkeypatch.setattr(TA, "init_factors", draw)


def test_candidates_agree_with_the_reference(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    n_u, n_i, k = 30, 20, 3
    U, V = rng.normal(size=(n_u, k)), rng.normal(size=(n_i, k))
    uu, ii = np.nonzero(rng.uniform(size=(n_u, n_i)) < 0.6)
    rr = np.sum(U[uu] * V[ii], axis=1) + 0.05 * rng.normal(size=uu.shape)
    up = RefUPC(str(tmp_path / "bus"), "models", partitions=3)
    up.submit_many([(int(u), int(i), float(r))
                    for u, i, r in zip(uu, ii, rr)], flush=True)
    up.sync()
    # an incumbent that lacks some ids: the warm start draws for them
    inc_u = {u: U[u] + 0.3 for u in range(n_u) if u not in (2, 11)}
    inc_i = {i: V[i] - 0.2 for i in range(n_i) if i != 5}
    kw = dict(num_factors=k, iterations=3, holdout_fraction=0.25)
    out = {}
    for name, mod in (("ref", RAP), ("port", PAP)):
        pilot = _pilots(tmp_path, name, mod, **kw)
        monkeypatch.setattr(pilot, "_incumbent_tables",
                            lambda: (inc_u, inc_i))
        pilot._tail_ratings()
        version, users, items, ratings = pilot._seal_window()
        if mod is PAP:
            _reference_draws(monkeypatch, pilot.seed)
        cand = pilot._train(version, users, items, ratings)
        out[name] = (pilot, cand, pilot._evaluate(cand))
    (ref, want, ref_eval), (port, got, port_eval) = out["ref"], out["port"]
    assert got["model_id"] == want["model_id"] == "auto-v000001"
    assert got["warm"] is want["warm"] is True
    assert got["rows"] == want["rows"]
    for a, b in zip(got["heldout"], want["heldout"]):
        np.testing.assert_array_equal(a, b)
    assert sorted(got["tables"]) == sorted(want["tables"])
    for key, vec in want["tables"].items():
        np.testing.assert_allclose(got["tables"][key], vec, rtol=1e-3,
                                   atol=1e-5, err_msg=key)
    assert os.path.basename(got["journal_dir"]) == \
        os.path.basename(want["journal_dir"])
    assert _record(port)["model_seq"] == _record(ref)["model_seq"] == 1
    assert port_eval["win"] == ref_eval["win"]
    assert port_eval["candidate_scored"] == ref_eval["candidate_scored"]
    np.testing.assert_allclose(port_eval["candidate_mse"],
                               ref_eval["candidate_mse"], rtol=1e-3)
    np.testing.assert_allclose(port_eval["incumbent_mse"],
                               ref_eval["incumbent_mse"], rtol=1e-12)
    # each package reads the other's candidate journal as its tables
    pu, pi = PAP.read_model_tables(want["journal_dir"], "models")
    assert sorted(f"{x}-U" for x in pu) + sorted(f"{x}-I" for x in pi) == \
        sorted(k for k in want["tables"] if k.endswith("-U")) + \
        sorted(k for k in want["tables"] if k.endswith("-I"))
    ru = RAP._read_journal_lines(got["journal_dir"], "models")
    assert len(ru) == got["rows"]
