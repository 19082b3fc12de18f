"""Phase 23 of ``chip_smoke.py`` (implicit ALS, bf16 exchange, the SVM's
avg mode) and its ``--scale-only`` mode, on the CPU at small sizes, with the
facts they rest on held against the JAX package:

- the Hu-Koren-Volinsky objective (``implicit_objective``) against a dense
  brute force, and not rising over the port's implicit iterations;
- one avg round from w = 0 times K equal to one add round with σ′ = 1, bit
  for bit, on both engines of the port and of the JAX package;
- the anchor constants equal to what the JAX package computes now
  (``scripts/jax_reference_constants.py``), and the port's CPU fits within
  their limits of them (the CPU parity check of the arms' configurations);
- the full-width constants phases 4 and 23 hold the card to are the ones
  PERF.md quotes, and the script's ``--ml20m`` takes no other argument;
- the phase's rehearsal with the fits' wrappers counting launches as on
  the card (``count_plain_versions``), the JAX package's values recomputed
  at the rehearsal's size in place of the full-width ones, and cases that
  must fail;
- ``--scale-only``'s arguments and a run at about 2,000 x 300 with 20,000
  ratings, rank 8, its chunks cut so that every bucket takes several."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
from flink_ms_tpu.core.formats import SparseData as RefSparseData
from flink_ms_tpu.ops import svm as JS
from flink_ms_tpu.parallel.mesh import make_mesh
from flink_ms_tpu_torch.ops import als as TA
from flink_ms_tpu_torch.ops import svm as TS

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _constants_script():
    spec = importlib.util.spec_from_file_location(
        "jax_reference_constants",
        os.path.join(ROOT, "scripts", "jax_reference_constants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the implicit objective ---------------------------------------------------


def _dense_problem(seed=0, n_users=40, n_items=30, k=5, density=0.3):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(n_users, n_items)) < density
    mask[np.arange(n_users), rng.integers(0, n_items, n_users)] = True
    mask[rng.integers(0, n_users, n_items), np.arange(n_items)] = True
    u, i = np.nonzero(mask)
    r = rng.uniform(1.0, 5.0, len(u))
    return (u, i, r, rng.normal(size=(n_users, k)),
            rng.normal(size=(n_items, k)))


def test_implicit_objective_equals_a_dense_brute_force():
    u, i, r, X, Y = _dense_problem()
    alpha, lam = 40.0, 0.1
    P = X @ Y.T
    C = np.ones_like(P)
    Pref = np.zeros_like(P)
    C[u, i] = 1.0 + alpha * r
    Pref[u, i] = 1.0
    want = float((C * (Pref - P) ** 2).sum()
                 + lam * ((X ** 2).sum() + (Y ** 2).sum()))
    rows = (torch.from_numpy(u), torch.from_numpy(i), torch.from_numpy(r))
    got = chip_smoke.implicit_objective(torch, torch.from_numpy(X),
                                        torch.from_numpy(Y), rows, alpha,
                                        lam, chunk=7)
    assert got == pytest.approx(want, rel=1e-12)


def test_implicit_objective_does_not_rise_over_the_ports_iterations():
    u, i, r, _, _ = _dense_problem(seed=1)
    problem = TA.prepare_blocked(u, i, r, 1)
    gen = torch.Generator().manual_seed(42)
    init = (TA.init_factors(problem.n_users, 5, gen).numpy(),
            TA.init_factors(problem.n_items, 5, gen).numpy())
    objs = []
    for it in (0, 1, 2, 3):
        cfg = TA.ALSConfig(num_factors=5, iterations=it, lambda_=0.1,
                           implicit=True, alpha=40.0)
        m = TA.als_fit(u, i, r, cfg, "cpu", problem=problem, init=init)
        objs.append(chip_smoke.implicit_objective(
            torch, m.user_factors, m.item_factors,
            chip_smoke.rating_rows(torch, m, u, i, r, CPU)))
    assert all(b <= a * (1 + 1e-9) for a, b in zip(objs, objs[1:])), objs
    assert objs[3] < 0.5 * objs[0]


def test_train_rmse_is_the_ports_rmse():
    u, i, r, _, _ = _dense_problem(seed=2)
    m = TA.als_fit(u, i, r, TA.ALSConfig(num_factors=5, iterations=2,
                                         lambda_=0.1), "cpu")
    rows = chip_smoke.rating_rows(torch, m, u, i, r, CPU)
    got = chip_smoke.train_rmse(torch, m.user_factors, m.item_factors, rows,
                                chunk=17)
    assert got == pytest.approx(TA.rmse(m, u, i, r, "cpu"), rel=1e-12)


# -- avg x K = add with sigma' 1 ----------------------------------------------


N, D, K = 20_000, 2_000, 64


@pytest.fixture(scope="module")
def rcv1_small():
    return chip_smoke.synth_rcv1(N, D, 30, seed=0)


@pytest.mark.parametrize("inner", ["gram", "scatter"])
def test_one_avg_round_times_k_is_add_with_sigma_one_on_the_port(
        rcv1_small, inner):
    problem = TS.prepare_svm_blocked(rcv1_small, K)
    cfg = TS.SVMConfig(iterations=1, local_iterations=problem.rows_per_block,
                       regularization=1e-4, mode="avg", inner=inner)
    w = {}
    for mode, kw in (("avg", {}), ("add", {"sigma_prime": 1.0})):
        fit, args = TS.compile_svm_fit(
            problem, dataclasses.replace(cfg, mode=mode, **kw), "cpu")
        w[mode] = fit(1, *args)[0]
    assert bool((w["add"] != 0).any())
    assert torch.equal(w["avg"] * K, w["add"])


@pytest.mark.parametrize("inner", ["gram", "scatter"])
def test_one_avg_round_times_k_is_add_with_sigma_one_in_jax(rcv1_small,
                                                             inner):
    d = rcv1_small
    data = RefSparseData(d.labels, d.indptr, d.indices, d.values,
                         d.n_features)
    problem = JS.prepare_svm_blocked(data, K)
    cfg = JS.SVMConfig(iterations=1, local_iterations=problem.rows_per_block,
                       regularization=1e-4, mode="avg", inner=inner)
    w = {mode: JS.svm_fit(data, dataclasses.replace(cfg, mode=mode, **kw),
                          make_mesh(1), problem=problem).weights
         for mode, kw in (("avg", {}), ("add", {"sigma_prime": 1.0}))}
    assert np.any(w["add"] != 0)
    assert np.array_equal(np.asarray(w["avg"]) * K, np.asarray(w["add"]))


# -- the anchor constants -----------------------------------------------------


def test_anchor_constants_are_the_jax_packages_and_the_port_agrees():
    """What ``scripts/jax_reference_constants.py`` computes now equals the
    constants phase 23 holds the card to, and the port's own fits of the
    anchor problem on the CPU lie within the card's limit (rtol 1e-3)."""
    jax_now = _constants_script().als_values()
    # another CPU may order XLA's sums otherwise: 1e-5 still tells a
    # stale constant (another problem or config moves it past 1e-3)
    assert jax_now["ANCHOR_IMPLICIT_OBJECTIVE"] == pytest.approx(
        chip_smoke.ANCHOR_IMPLICIT_OBJECTIVE, rel=1e-5)
    assert jax_now["ANCHOR_BF16_RMSE"] == pytest.approx(
        chip_smoke.ANCHOR_BF16_RMSE, rel=1e-5)
    port = chip_smoke.anchor_values(torch, TA, CPU)
    assert port["implicit_objective"] == pytest.approx(
        chip_smoke.ANCHOR_IMPLICIT_OBJECTIVE,
        rel=chip_smoke.IMPLICIT_ANCHOR_RTOL)
    assert port["bf16_rmse"] == pytest.approx(
        chip_smoke.ANCHOR_BF16_RMSE, rel=chip_smoke.BF16_ANCHOR_RTOL)


@pytest.mark.parametrize("argv", [
    ["--ml20m", "--svm-avg"], ["--svm-avg", "--ml20m"], ["--ml20m", "x"],
    ["--ml20m", "--ml20m=1"]])
def test_ml20m_refuses_any_other_argument(argv, monkeypatch):
    """``--ml20m`` is one documented computation: it is refused beside any
    other argument, before any fit."""
    mod = _constants_script()
    monkeypatch.setattr(mod, "ml20m_values", lambda: pytest.fail("ran"))
    monkeypatch.setattr(mod, "svm_avg_values", lambda: pytest.fail("ran"))
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code == 2


def test_full_width_constants_are_the_ones_perf_md_quotes():
    """The JAX package's full-width values phases 4 and 23 hold the card
    to, each as PERF.md quotes it (with the command that made them)."""
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    assert "jax_reference_constants.py --ml20m" in perf
    values = (*chip_smoke.ML20M_EXPLICIT_RMSE,
              chip_smoke.ML20M_IMPLICIT_OBJECTIVE, chip_smoke.ML20M_BF16_RMSE)
    assert len(values) == 5
    for v in values:
        assert repr(v) in perf, v
    for name in ("EXPLICIT_JAX_RTOL", "IMPLICIT_JAX_RTOL", "BF16_JAX_RTOL"):
        assert 0 < getattr(chip_smoke, name) <= 1e-3


# -- phase 23, rehearsed ------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    from flink_ms_tpu_torch.ops import cholesky as CH
    from flink_ms_tpu_torch.ops import gather_assembly as GA
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    chip_smoke.count_plain_versions(TA, CH, GA, TS, SK, monkeypatch.setattr)
    monkeypatch.setattr(chip_smoke, "RANK", 8)
    return TA, CH, GA, TS, SK


@pytest.fixture
def arms_inputs(counted, monkeypatch):
    """Phase 4's and phase 7's inputs at a small size, and the JAX
    package's fits of that ALS problem at rank 8 in place of its
    full-width ones, held to the anchor's limits (a problem this small
    reads gaps of 1.3e-7 and 3.4e-6, far above the card's)."""
    for name, value in (("SVM_N", 3000), ("SVM_D", 400), ("SVM_NNZ", 9),
                        ("SVM_K", 32),
                        ("IMPLICIT_JAX_RTOL", chip_smoke.IMPLICIT_ANCHOR_RTOL),
                        ("BF16_JAX_RTOL", chip_smoke.BF16_ANCHOR_RTOL)):
        monkeypatch.setattr(chip_smoke, name, value)
    (users, items, ratings), problem, init = chip_smoke.seeded_problem(
        TA, 400, 250, 30_000)
    jax_now = _constants_script()._fit_values(
        (users, items, ratings), init, (
            ("ML20M_IMPLICIT_OBJECTIVE", 3,
             dict(implicit=True, alpha=chip_smoke.ALS_ALPHA)),
            ("ML20M_BF16_RMSE", 3, dict(exchange_dtype="bfloat16"))))
    for name, value in jax_now.items():
        monkeypatch.setattr(chip_smoke, name, value)
    f32 = TA.als_fit(users, items, ratings, TA.ALSConfig(
        num_factors=8, iterations=3, lambda_=chip_smoke.LAMBDA), "cpu",
        problem=problem, init=init)
    runs = {"default": {"sec_per_iter": 0.001, "rmse": [
        None, None, TA.rmse(f32, users, items, ratings, "cpu")]}}
    data, svm_problem = chip_smoke.svm_inputs(TS)[:2]
    cfg = chip_smoke.svm_config(TS, svm_problem)
    _, args = TS.compile_svm_fit(svm_problem, cfg, "cpu")
    svm_run = {"sec_per_round": 0.01, "data": data, "problem": svm_problem,
               "dev_args": args}
    return problem, (users, items, ratings), init, runs, svm_run


def _arms(counted, arms_inputs):
    TA_, CH, GA, TS_, SK = counted
    problem, ratings_t, init, runs, svm_run = arms_inputs
    return chip_smoke.arms_phase(torch, TA_, CH, GA, TS_, SK, problem,
                                 ratings_t, init, runs, svm_run, CPU)


def test_arms_phase_rehearsal(counted, arms_inputs, capsys):
    problem = arms_inputs[0]
    out = _arms(counted, arms_inputs)
    n_buckets = len(problem.u.widths) + len(problem.i.widths)
    logs = capsys.readouterr().out
    for label in ("als_implicit", "als_bf16"):
        ran = out[label]["cholesky"] // 2
        assert ran > 6 and out[label] == {
            "cholesky": 2 * ran, "assembly": n_buckets * ran,
            "cholesky_batch_major": 0}
        bf16 = n_buckets * ran if label == "als_bf16" else 0
        assert (f"assembly {n_buckets * ran} (of them on a bfloat16 table "
                f"{bf16})") in logs
    # time_rounds: a warm-up and 3 samples of 1 and 10 rounds; then 1 and 10
    ran = 4 * (1 + chip_smoke.SVM_ROUNDS) + 1 + chip_smoke.SVM_ROUNDS
    assert out["svm_avg"] == {"margin_gather": ran, "scatter_add_dw": 0,
                              "scatter_add_dw[row_scale]": ran}
    for line in ("als_implicit: Hu-Koren-Volinsky objective at the init",
                 "accuracy user implicit half-sweep vs float64",
                 "accuracy item implicit half-sweep vs float64",
                 "als_implicit: objective after 3 iterations against the "
                 "JAX package's fit of this problem",
                 "als_bf16: the plain versions' bf16 fit",
                 "the JAX package's docstring claims +1.4e-05 on a TPU",
                 "presorted dw, bit for bit: True"):
        assert line in logs


def test_arms_phase_fails_when_the_implicit_objective_rises(
        counted, arms_inputs, monkeypatch):
    real = chip_smoke.implicit_objective
    calls = []

    def rising(*a, **kw):
        calls.append(1)
        return real(*a, **kw) + 1e3 * len(calls)

    monkeypatch.setattr(chip_smoke, "implicit_objective", rising)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="als_implicit: the objective rose"):
        _arms(counted, arms_inputs)


def test_arms_phase_fails_off_the_jax_anchor(counted, arms_inputs,
                                             monkeypatch):
    """The JAX package's fit of the arms' problem moved by 1%: the bf16
    arm is off it."""
    monkeypatch.setattr(chip_smoke, "ML20M_BF16_RMSE",
                        chip_smoke.ML20M_BF16_RMSE * 1.01)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="als_bf16: off the JAX package's fit"):
        _arms(counted, arms_inputs)


@pytest.mark.parametrize("name, limit, label", [
    ("ML20M_IMPLICIT_OBJECTIVE", "IMPLICIT_JAX_RTOL", "als_implicit"),
    ("ML20M_BF16_RMSE", "BF16_JAX_RTOL", "als_bf16")])
def test_arms_phase_fails_at_twice_its_anchor_limit(counted, arms_inputs,
                                                    monkeypatch, name,
                                                    limit, label):
    """The JAX package's value moved by twice the arm's limit."""
    rtol = getattr(chip_smoke, limit)
    monkeypatch.setattr(chip_smoke, name,
                        getattr(chip_smoke, name) * (1 + 2 * rtol))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match=f"{label}: off the JAX package's fit"):
        _arms(counted, arms_inputs)


def test_arms_phase_fails_when_the_exchange_stays_f32(counted, arms_inputs,
                                                      monkeypatch):
    """A port that ignores ``exchange_dtype`` and exchanges in f32: no
    assembly reads a bfloat16 table."""
    monkeypatch.setattr(TA, "resolve_exchange", lambda exchange_dtype: None)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="als_bf16: 0 of .* on a bfloat16 table"):
        _arms(counted, arms_inputs)


def test_arms_phase_fails_when_avg_is_not_scaled_add(counted, arms_inputs,
                                                     monkeypatch):
    """An avg mode whose local steps are smoothed by σ′ = K (add's safe
    default) instead of 1: its objective still falls, but K times its
    round is not add's round with σ′ = 1."""
    real = TS._make_fit

    def smoothed(problem, config, dev):
        if config.mode == "avg":
            K = problem.n_blocks
            config = dataclasses.replace(config, mode="add",
                                         sigma_prime=float(K),
                                         stepsize=1.0 / K)
        return real(problem, config, dev)

    monkeypatch.setattr(TS, "_make_fit", smoothed)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="svm_avg: one round x K off add's"):
        _arms(counted, arms_inputs)


# -- --scale-only -------------------------------------------------------------


def test_scale_only_is_chosen_by_its_argument(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "scale_only",
                        lambda torch, dev: calls.append(dev) or 0)
    assert chip_smoke.main(["--scale-only"]) == 0
    assert calls == [torch.device("cuda", 0)]


@pytest.mark.parametrize("argv", [["--scale-only", "10000000"],
                                  ["--scale"], ["--scale-only", "--geo-only"]])
def test_scale_only_refuses_other_arguments(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert chip_smoke.main(argv) == 2
    captured = capsys.readouterr()
    assert "unknown arguments" in captured.err and captured.out == ""


def test_scale_only_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(["--scale-only"]) != 0
    assert capsys.readouterr().out == ""


def test_scale_only_rehearsal(counted, monkeypatch, capsys):
    """The envelope at about 2,000 x 300 with 20,000 ratings, rank 8, on
    the CPU through the fused path, its chunk limit cutting every bucket
    into 3 chunks or more."""
    from flink_ms_tpu_torch.ops import _build

    TA_, CH, GA = counted[:3]
    monkeypatch.setattr(chip_smoke, "SCALE_ENV_SIZES", ((2000, 300, 20_000),))
    monkeypatch.setattr(chip_smoke, "SCALE_ENV_RANK", 8)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "a CPU")
    monkeypatch.setattr(_build, "build_all", lambda names=(): {})
    users, items, ratings = chip_smoke.synth_ratings(2000, 300, 20_000)
    problem = TA_.prepare_blocked(users, items, ratings, 1)
    k = 8
    # the CPU's fused chunk holds a row's gathered factors and its system
    row = max(w * k * 4 + 3 * k * k * 4
              for s in (problem.u, problem.i) for w in s.widths)
    fewest = min(r for s in (problem.u, problem.i) for r in s.rows)
    limit = row * (fewest // 3)
    monkeypatch.setenv("FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES", str(limit))
    assert chip_smoke.scale_only(torch, CPU) == 0
    logs = capsys.readouterr().out
    line = next(x for x in logs.splitlines()
                if "sec/iter (median of 3, 1 vs 3 iterations)" in x)
    n_buckets = len(problem.u.widths) + len(problem.i.widths)
    ran = 1 + 3 * 4 + 1 + 2
    asm = int(line.split("assembly ")[1].split(";")[0])
    assert asm >= 3 * n_buckets * ran
    assert f"FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES {limit}" in logs
    assert "accuracy user half-sweep vs float64" in logs
    assert "accuracy item half-sweep vs float64" in logs
    assert logs.splitlines()[-1] == "a CPU"
    assert logs.splitlines()[-2] == '{"kernels": []}'
    assert "FLINK_MS_ALS_FUSED" not in os.environ


def test_scale_envelope_fails_when_the_fused_path_does_not_chunk(
        counted, monkeypatch):
    TA_, CH, GA = counted[:3]
    monkeypatch.setattr(chip_smoke, "SCALE_ENV_RANK", 8)
    monkeypatch.setenv("FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES", str(1 << 40))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="the fused path's chunks did not run"):
        chip_smoke.scale_envelope(torch, TA_, CH, GA, 500, 100, 4000, CPU)
