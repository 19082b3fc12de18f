"""The gram engine's opt-in modes in the port (``FLINK_MS_SVM_STEP=onehot``,
``FLINK_MS_SVM_DW=sorted|presorted``) against the port's defaults and the
JAX package's same modes on the CPU.  The port runs the one-hot step as
the dynamic step and both sorted modes over the presorted layout; the
one-hot step is held bit for bit to the dynamic step, the sorted modes to
direct Δw, to each other and to the reference's modes at the repo's
cross-engine tolerance, rtol 2e-4 / atol 1e-6 (``tests/test_svm.py:275``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ms_tpu.ops import svm as JS
from flink_ms_tpu.parallel.mesh import make_mesh
from flink_ms_tpu_torch.ops import svm as TS
from flink_ms_tpu_torch.ops import svm_kernels as SK

from test_torch_svm import _close, _configs, _data, jax_steps

MODES = [("add", dict(mode="add", sigma_prime=4.0)),
         ("add-safe", dict(mode="add")),
         ("avg", dict(mode="avg"))]


def _fit(monkeypatch, td, problem, cfg, env, steps=None):
    with monkeypatch.context() as m:
        for key, value in env.items():
            m.setenv(key, value)
        fit, args = TS.compile_svm_fit(problem, cfg, device="cpu")
        return fit(cfg.iterations, *args, steps=steps)


@pytest.mark.parametrize("name,kw", MODES, ids=[m[0] for m in MODES])
def test_onehot_equals_dynamic_bit_for_bit(rng, monkeypatch, name, kw):
    _, td = _data(rng, n=250)
    p = TS.prepare_svm_blocked(td, 8, seed=0)
    cfg = TS.SVMConfig(iterations=5, local_iterations=p.rows_per_block,
                       regularization=1e-2, inner="gram", seed=3, **kw)
    w_d, a_d = _fit(monkeypatch, td, p, cfg, {"FLINK_MS_SVM_STEP": "dynamic"})
    w_o, a_o = _fit(monkeypatch, td, p, cfg, {"FLINK_MS_SVM_STEP": "onehot"})
    assert torch.equal(w_o, w_d) and torch.equal(a_o, a_d)
    assert w_d.abs().max() > 0.1  # the fit moved


@pytest.mark.parametrize("name,kw", MODES, ids=[m[0] for m in MODES])
def test_sorted_modes_match_direct_and_each_other(rng, monkeypatch, name, kw):
    _, td = _data(rng, n=300, d=90)
    p = TS.prepare_svm_blocked(td, 8, seed=0)
    cfg = TS.SVMConfig(iterations=6, local_iterations=p.rows_per_block,
                       regularization=1e-2, inner="gram", **kw)
    out = {dw: _fit(monkeypatch, td, p, cfg, {"FLINK_MS_SVM_DW": dw})
           for dw in ("direct", "sorted", "presorted")}
    for dw in ("sorted", "presorted"):
        _close(out[dw][0].numpy(), out["direct"][0].numpy())
        _close(out[dw][1].numpy(), out["direct"][1].numpy())
    _close(out["sorted"][0].numpy(), out["presorted"][0].numpy())


REF_CASES = [("step-onehot", {"FLINK_MS_SVM_STEP": "onehot"}),
             ("dw-sorted", {"FLINK_MS_SVM_DW": "sorted"}),
             ("dw-presorted", {"FLINK_MS_SVM_DW": "presorted"}),
             ("onehot-presorted", {"FLINK_MS_SVM_STEP": "onehot",
                                   "FLINK_MS_SVM_DW": "presorted"})]


@pytest.mark.parametrize("case,env", REF_CASES, ids=[c[0] for c in REF_CASES])
@pytest.mark.parametrize("name,kw", MODES[:2], ids=[m[0] for m in MODES[:2]])
def test_mode_matches_reference_mode(rng, monkeypatch, case, env, name, kw):
    jd, td = _data(rng)
    K, rounds = 8, 4
    pj = JS.prepare_svm_blocked(jd, K, seed=0)
    pt = TS.prepare_svm_blocked(td, K, seed=0)
    H = pj.rows_per_block
    jc, tc = _configs(H, rounds, regularization=1e-2, inner="gram", **kw)
    with monkeypatch.context() as m:
        for key, value in env.items():
            m.setenv(key, value)
        fit, dev_args = JS.compile_svm_fit(pj, jc, make_mesh(1))
        want_w, want_a = fit(jnp.asarray(rounds, jnp.int32), *dev_args)
    steps = jax_steps(0, 0, rounds, K, H, H)
    w, a = _fit(monkeypatch, td, pt, tc, env, steps=steps)
    _close(w.numpy(), np.asarray(want_w))
    _close(a.numpy(), np.asarray(want_a))
    assert np.abs(np.asarray(want_w)).max() > 0.1


@pytest.mark.parametrize("mode", ["sorted", "presorted"])
def test_sorted_layout_equals_reference(rng, monkeypatch, mode):
    """Both sorted modes compile the port's one layout, the reference's
    presorted one: from the reference's "sorted" (perm, ids) it is the
    values gathered through perm and the row of each, perm // L."""
    jd, td = _data(rng, n=230)
    pj = JS.prepare_svm_blocked(jd, 8, seed=0)
    pt = TS.prepare_svm_blocked(td, 8, seed=0)
    jc, tc = _configs(pj.rows_per_block, 1, inner="gram")
    monkeypatch.setenv("FLINK_MS_SVM_DW", mode)
    _, dev_args = JS.compile_svm_fit(pj, jc, make_mesh(1))
    want = [np.asarray(a)[0] for a in dev_args[8:]]
    ids = want[1]
    if mode == "sorted":
        perm = want[0]
        want = [pt.val.reshape(-1)[perm], ids, perm // pt.idx.shape[-1]]
    got = [t.numpy() for t in TS.compile_svm_fit(pt, tc, device="cpu")[1][8:]]
    assert np.array_equal(got[0], want[0]) and got[0].dtype == np.float32
    assert np.array_equal(got[1], want[2])
    lengths = got[-1]
    assert lengths.shape == (pt.n_features,)
    assert np.array_equal(np.repeat(np.arange(pt.n_features), lengths), ids)


@pytest.mark.parametrize("env,scatter", [
    ({}, 3), ({"FLINK_MS_SVM_STEP": "onehot"}, 3),
    ({"FLINK_MS_SVM_DW": "sorted"}, 0), ({"FLINK_MS_SVM_DW": "presorted"}, 0),
    ({"FLINK_MS_SVM_DW": "pallas"}, 3)])
def test_kernel_wrapper_calls_per_mode(rng, monkeypatch, env, scatter):
    """Every mode reads w through ``margin_gather`` once a round; the
    sorted modes write Δw by a segment sum and never call
    ``scatter_add_dw``."""
    calls = {"margin": 0, "scatter": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TS, "margin_gather", count("margin", SK.margin_gather))
    monkeypatch.setattr(TS, "scatter_add_dw",
                        count("scatter", SK.scatter_add_dw))
    _, td = _data(rng, n=100)
    p = TS.prepare_svm_blocked(td, 4, seed=0)
    cfg = TS.SVMConfig(iterations=3, local_iterations=5, inner="gram")
    _fit(monkeypatch, td, p, cfg, env)
    assert calls == {"margin": 3, "scatter": scatter}


@pytest.mark.parametrize("env", [{"FLINK_MS_SVM_STEP": "onehot"},
                                 {"FLINK_MS_SVM_DW": "sorted"},
                                 {"FLINK_MS_SVM_DW": "presorted"}])
def test_scatter_engine_ignores_the_modes(rng, monkeypatch, env):
    _, td = _data(rng, n=120)
    p = TS.prepare_svm_blocked(td, 4, seed=0)
    cfg = TS.SVMConfig(iterations=3, local_iterations=8, inner="scatter")
    base = _fit(monkeypatch, td, p, cfg, {})
    got = _fit(monkeypatch, td, p, cfg, env)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


@pytest.mark.parametrize("var,value", [
    ("FLINK_MS_SVM_STEP", "one-hot"), ("FLINK_MS_SVM_STEP", "ONEHOT"),
    ("FLINK_MS_SVM_DW", "sort"), ("FLINK_MS_SVM_DW", "pre-sorted")])
def test_typo_raises(rng, monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    _, td = _data(rng, n=50)
    with pytest.raises(ValueError, match="must be"):
        TS.svm_fit(td, TS.SVMConfig(iterations=1), device="cpu")
