"""The port's multi-rank paths (``flink_ms_tpu_torch/parallel/``) on the CPU,
over gloo, against the JAX package's device mesh: the process-group
bootstrap, the routed exchange's host layout and plan array for array,
ALS over 2 ranks (gathered, routed and fused sweeps), CoCoA SVM over 2
ranks with the reference's draws injected, staged ALS resumed across the
packages at D = 2, and both CLIs on 2 ranks.

Every job of ranks runs in spawned processes that import the port only;
each job has a time limit of its own, so a hung collective fails its test
rather than the suite.  One module-scoped job makes every 2-rank fit the
tests compare (``two_ranks``)."""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flink_ms_tpu.ops import als as JA
from flink_ms_tpu.ops import svm as JS
from flink_ms_tpu.parallel.mesh import make_mesh
from flink_ms_tpu_torch.core import formats as TF
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.ops import als as TA
from flink_ms_tpu_torch.ops import svm as TS
from flink_ms_tpu_torch.parallel import distributed as pdist
from flink_ms_tpu_torch.parallel import mesh as TM
from flink_ms_tpu_torch.train import als_train, svm_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_S = 120  # the time limit of each job of ranks
# the two commands of a job started elsewhere, each a fresh interpreter:
# alone about 8 s, and 55-61 s with six busy processes on 8 cores
CLI_JOB_S = 300
RANK_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _launch(calls, world=2):
    """One job of ``world`` CPU ranks making ``calls`` (see
    ``run_calls``) -> each rank's values."""
    return pdist.launch_local(pdist.run_calls, world, (calls,),
                              device="cpu", timeout=JOB_S)


def jax_steps(seed, start, rounds, C, H, rows):
    """The reference's step indices for rounds [start, start + rounds) of
    global chains [0, C): randint(fold_in(fold_in(fold_in(PRNGKey(seed),
    chain), round), step), (), 0, rows) (``flink_ms_tpu/ops/svm.py:
    425-435``; the copy in ``tests/test_torch_svm.py``) -> (rounds, C, H)."""
    base = jax.random.PRNGKey(np.uint32(seed))

    def one(r, c, h):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.fold_in(base, c), r), h)
        return jax.random.randint(key, (), 0, rows)

    grid = jax.vmap(jax.vmap(jax.vmap(one, (None, None, 0)), (None, 0, None)),
                    (0, None, None))
    return np.asarray(grid(jnp.arange(start, start + rounds, dtype=jnp.int32),
                           jnp.arange(C, dtype=jnp.int32),
                           jnp.arange(H, dtype=jnp.int32)))


def _close(got, want, rtol=1e-3, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# -- the process-group bootstrap --------------------------------------------


@pytest.fixture
def no_rank_env(monkeypatch):
    for key in RANK_ENV:
        monkeypatch.delenv(key, raising=False)


def test_maybe_init_distributed_is_a_noop_without_flags(no_rank_env):
    assert pdist.maybe_init_distributed() is False
    assert pdist.maybe_init_distributed(Params.from_args(
        ["--devices", "2", "--device", "cpu"])) is False
    assert not pdist.in_group()
    assert (pdist.world_size(), pdist.rank(), pdist.is_primary()) == \
        (1, 0, True)
    assert TM.num_blocks() == 1


@pytest.mark.parametrize("args,env", [
    (["--coordinatorAddress", "localhost:1"], {}),
    (["--coordinatorAddress", "localhost:1", "--numProcesses", "2"], {}),
    (["--coordinatorAddress", "localhost:1", "--processId", "0"], {}),
    ([], {"JAX_COORDINATOR_ADDRESS": "localhost:1", "JAX_PROCESS_ID": "0"}),
    ([], {"MASTER_ADDR": "localhost", "MASTER_PORT": "1"}),
])
def test_maybe_init_distributed_raises_without_rank_info(no_rank_env,
                                                         monkeypatch, args,
                                                         env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="requires --numProcesses and "
                                         "--processId"):
        pdist.maybe_init_distributed(Params.from_args(args + ["--device",
                                                              "cpu"]))
    assert not pdist.in_group()


def test_unknown_backend_raises_before_joining(no_rank_env):
    with pytest.raises(ValueError, match="must be nccl|gloo"):
        pdist.maybe_init_distributed(Params.from_args([
            "--coordinatorAddress", "localhost:1", "--numProcesses", "2",
            "--processId", "0", "--device", "cpu", "--backend", "mpi"]))
    assert not pdist.in_group()


def test_ranks_for_blocks_follows_mesh_for_blocks(capsys):
    assert TM.ranks_for_blocks(None, device="cpu") == 1
    assert TM.ranks_for_blocks(4, 3, device="cpu") == 3  # --devices wins
    assert TM.ranks_for_blocks(1, device="cpu") == 1
    assert capsys.readouterr().out == ""
    assert TM.ranks_for_blocks(6, device="cpu") == 1
    assert "[mesh] --blocks 6 exceeds the 1 visible device(s)" in \
        capsys.readouterr().out
    with pytest.raises(ValueError, match="must be >= 1"):
        TM.ranks_for_blocks(None, 0, device="cpu")


def test_collective_helpers_on_two_ranks(two_ranks):
    # each rank evaluated the helpers on values of its own rank
    for r, who in enumerate(two_ranks["who"]):
        assert who == (2, r, r == 0, True)
    for gathered in two_ranks["gathered"]:
        assert np.array_equal(gathered, np.repeat([[0.0], [1.0]], 3, axis=1)
                              .repeat(2, axis=0))
    for bcast in two_ranks["broadcast"]:
        assert np.array_equal(bcast, np.arange(4.0))
    assert two_ranks["summed"] == [[3.0, 3.0, 3.0]] * 2
    # outside a group each is the identity
    assert np.array_equal(pdist.broadcast_one_to_all(np.arange(3)),
                          np.arange(3))
    import torch

    t = torch.arange(6.0).reshape(2, 3)
    assert pdist.gather_blocks(t) is t
    assert pdist.all_reduce_sum(t) is t


def test_launch_local_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 0 of 1 failed"):
        _launch([(TA.compile_fit, (None, None, "cpu"), {}, None)], world=1)


# -- the routed exchange's host layout ----------------------------------------



def _sparse(rng, n_users=3_000, n_items=2_500, nnz=2_000):
    return (rng.integers(0, n_users, nnz), rng.integers(0, n_items, nnz),
            rng.uniform(1, 5, nnz))


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("density", ["sparse", "dense"])
def test_build_routing_equals_reference(rng, D, density):
    u, i, r = _sparse(rng) if density == "sparse" else \
        _sparse(rng, 80, 60, 5_000)
    pj, pt = JA.prepare_blocked(u, i, r, D), TA.prepare_blocked(u, i, r, D)
    for side, opp in (("u", "i"), ("i", "u")):
        want = JA.build_routing(getattr(pj, side), getattr(pj, opp), D)
        got = TA.build_routing(getattr(pt, side), getattr(pt, opp), D)
        assert (got.r_max, got.recv_rows, got.net_rows) == \
            (want.r_max, want.recv_rows, want.net_rows)
        for a, b in zip([got.send_idx] + got.idx,
                        [want.send_idx] + want.idx):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(got.idx) == len(want.idx)


@pytest.mark.parametrize("mode", ["auto", "gather", "routed"])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_exchange_plan_equals_reference(rng, monkeypatch, mode, D):
    monkeypatch.setenv("FLINK_MS_ALS_EXCHANGE_MODE", mode)
    for u, i, r in (_sparse(rng), _sparse(rng, 40, 30, 6_000),
                    _sparse(rng, 2_000, 40, 3_000)):
        pj = JA.prepare_blocked(u, i, r, D)
        pt = TA.prepare_blocked(u, i, r, D)
        want, got = JA._exchange_plan(pj, D), TA._exchange_plan(pt, D)
        for side in ("u", "i"):
            assert (got[side] is None) == (want[side] is None), side
            if got[side] is not None:
                assert np.array_equal(got[side].send_idx,
                                      want[side].send_idx)
        assert TA._exchange_plan(pt, D) is got  # cached on the problem
    if D == 1:
        assert got == {"u": None, "i": None}


def test_exchange_mode_typo_raises(monkeypatch):
    monkeypatch.setenv("FLINK_MS_ALS_EXCHANGE_MODE", "banana")
    with pytest.raises(ValueError, match="banana"):
        TA._exchange_mode_choice()


# -- ALS over 2 ranks ---------------------------------------------------------


def _als_inputs():
    rng = np.random.default_rng(11)
    u = rng.integers(0, 90, 1_500) + 5
    i = rng.integers(0, 70, 1_500) + 300
    r = rng.uniform(1.0, 5.0, 1_500)
    n_u, n_i = len(np.unique(u)), len(np.unique(i))
    k = 5
    init = (rng.uniform(size=(n_u, k)).astype(np.float32) / 3,
            rng.uniform(size=(n_i, k)).astype(np.float32) / 3)
    return (u, i, r), init, k


ALS_MODES = {"explicit": {}, "implicit": dict(implicit=True, alpha=2.0)}
ALS_RUNS = [(mode, env_name, env)
            for mode in ALS_MODES
            for env_name, env in (
                ("auto", {}),
                ("gather", {"FLINK_MS_ALS_EXCHANGE_MODE": "gather"}),
                ("routed", {"FLINK_MS_ALS_EXCHANGE_MODE": "routed"}),
                ("fused", {"FLINK_MS_ALS_FUSED": "1",
                           "FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES": "3000"}))]


@pytest.mark.parametrize("mode", list(ALS_MODES))
def test_two_rank_als_equals_jax_two_device_mesh(two_ranks, mode):
    ratings, init, k = _als_inputs()
    cfg = dict(num_factors=k, iterations=3, lambda_=0.1, **ALS_MODES[mode])
    want = JA.als_fit(*ratings, JA.ALSConfig(**cfg), make_mesh(2),
                      problem=JA.prepare_blocked(*ratings, 2), init=init)
    one = TA.als_fit_host(*ratings, TA.ALSConfig(**cfg), device="cpu",
                          init=init)
    r0, r1 = two_ranks[("als", mode, "auto")]
    for got in (r0, r1):  # every rank returns the whole model
        assert np.array_equal(got[0], want.user_ids)
        assert np.array_equal(got[1], want.item_ids)
        _close(got[2], want.user_factors)
        _close(got[3], want.item_factors)
        # D changes only the order of float sums: the reference's own
        # multiblock tolerance against the one-rank fit
        _close(got[2], one[2], rtol=5e-2, atol=5e-3)
        _close(got[3], one[3], rtol=5e-2, atol=5e-3)
    assert np.array_equal(r0[2], r1[2]) and np.array_equal(r0[3], r1[3])


@pytest.mark.parametrize("mode", list(ALS_MODES))
def test_routed_sweep_equals_gathered_bit_for_bit(two_ranks, mode):
    gathered = two_ranks[("als", mode, "gather")][0]
    routed = two_ranks[("als", mode, "routed")][0]
    for a, b in zip(routed[2:], gathered[2:]):
        assert np.array_equal(a, b)
    assert np.array_equal(two_ranks[("als", mode, "auto")][0][2],
                          gathered[2])


@pytest.mark.parametrize("mode", list(ALS_MODES))
def test_two_rank_fused_sweep_equals_default(two_ranks, mode):
    fused = two_ranks[("als", mode, "fused")][0]
    default = two_ranks[("als", mode, "auto")][0]
    _close(fused[2], default[2])
    _close(fused[3], default[3])


# -- CoCoA SVM over 2 ranks ---------------------------------------------------

SVM_CASES = [("gram-add", dict(inner="gram", mode="add", sigma_prime=4.0)),
             ("gram-avg", dict(inner="gram", mode="avg")),
             ("scatter-add", dict(inner="scatter", mode="add")),
             ("gram-add-sorted", dict(inner="gram", mode="add"))]
SVM_ENV = {"gram-add-sorted": {"FLINK_MS_SVM_DW": "presorted"}}


def _svm_data(n=400, d=90, nnz=7):
    """Ragged sparse rows with duplicate ids and a flipped sparse teacher
    -> (JAX SparseData, port SparseData)."""
    from flink_ms_tpu.core import formats as JF

    rng = np.random.default_rng(5)
    lens = rng.integers(0, nnz + 1, n)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    idx = rng.integers(0, d, indptr[-1])
    val = rng.normal(size=indptr[-1]) / np.sqrt(nnz)
    margin = np.add.reduceat(val * rng.normal(size=d)[idx],
                             np.minimum(indptr[:-1], len(idx) - 1))
    y = np.where(lens > 0, np.sign(margin), 1.0)
    y = np.where(rng.uniform(size=n) < 0.1, -y, y)
    fields = dict(labels=y, indptr=indptr, indices=idx, values=val,
                  n_features=d)
    return JF.SparseData(**fields), TF.SparseData(**fields)


def _svm_inputs():
    jd, td = _svm_data()
    K, rounds = 16, 4
    pj = JS.prepare_svm_blocked(jd, K, seed=0)
    return jd, td, pj, K, rounds, pj.rows_per_block


def _svm_padding_inputs():
    """K = 5 chains, which 2 ranks split as 3 + 3 with one empty pad."""
    _, td, _, _, rounds, _ = _svm_inputs()
    problem = TS.prepare_svm_blocked(td, 5, seed=0)
    H = problem.rows_per_block
    cfg = TS.SVMConfig(iterations=rounds, local_iterations=H,
                       regularization=1e-2, mode="add")
    return td, problem, cfg, jax_steps(0, 0, rounds, 5, H, H)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every 2-rank run of the tests below, made by ONE job of 2 CPU
    ranks (a rank costs seconds to start) -> {name: [rank 0's value,
    rank 1's value]}: the ALS fits of ``ALS_RUNS``, the SVM fits of
    ``SVM_CASES`` with the reference's draws and the padded K = 5 fit,
    staged ALS (resuming a snapshot the reference wrote for 2 blocks,
    writing its own, and the straight fit), and the collective helpers
    evaluated on each rank's own values."""
    calls = {}
    ratings, init, k = _als_inputs()
    for mode, name, env in ALS_RUNS:
        calls[("als", mode, name)] = (
            TA.als_fit_host, ratings,
            dict(config=TA.ALSConfig(num_factors=k, iterations=3,
                                     lambda_=0.1, **ALS_MODES[mode]),
                 device="cpu", init=init), env)
    jd, td, pj, K, rounds, H = _svm_inputs()
    steps = jax_steps(0, 0, rounds, K, H, H)
    problem = TS.prepare_svm_blocked(td, K, seed=0)
    for name, cfg in SVM_CASES:
        calls[("svm", name)] = (
            TS.svm_fit, (td, TS.SVMConfig(iterations=rounds,
                                          local_iterations=H,
                                          regularization=1e-2, **cfg)),
            dict(device="cpu", problem=problem, steps=steps),
            SVM_ENV.get(name))
    ptd, pproblem, pcfg, psteps = _svm_padding_inputs()
    calls["svm-pad"] = (TS.svm_fit, (ptd, pcfg), dict(
        device="cpu", problem=pproblem, steps=psteps), None)
    stage = tmp_path_factory.mktemp("stage")
    from_jax, from_port = str(stage / "jax"), str(stage / "port")
    JA.als_fit(*ratings, JA.ALSConfig(num_factors=k, iterations=1,
                                      lambda_=0.1), make_mesh(2),
               problem=JA.prepare_blocked(*ratings, 2), init=init,
               temporary_path=from_jax)
    for name, path, n in (("staged-resumed", from_jax, 3),
                          ("staged-written", from_port, 2),
                          ("staged-straight", None, 3)):
        calls[name] = (TA.als_fit_host, ratings, dict(
            config=TA.ALSConfig(num_factors=k, iterations=n, lambda_=0.1),
            device="cpu", init=init, temporary_path=path), None)
    pd = "__import__('flink_ms_tpu_torch.parallel.distributed').parallel." \
         "distributed"
    rank = f"float({pd}.rank())"
    for name, expr in (
            ("gathered", f"{pd}.gather_blocks(__import__('torch').full("
                         f"(2, 3), {rank})).numpy()"),
            ("broadcast", f"{pd}.broadcast_one_to_all(__import__('numpy')"
                          f".arange(4) + {rank})"),
            ("summed", f"{pd}.all_reduce_sum(__import__('torch').ones(3) "
                       f"* ({rank} + 1)).tolist()"),
            ("who", f"({pd}.world_size(), {pd}.rank(), {pd}.is_primary(), "
                    f"{pd}.in_group())")):
        calls[name] = (eval, (expr,), {}, None)
    names = list(calls)
    ranks = _launch([calls[name] for name in names])
    out = {name: [values[j] for values in ranks]
           for j, name in enumerate(names)}
    out["stage_dirs"] = (from_jax, from_port)
    return out


@pytest.mark.parametrize("name,cfg", SVM_CASES, ids=[c[0] for c in SVM_CASES])
@pytest.mark.parametrize("D", [2, 8])
def test_two_rank_svm_equals_jax_mesh(two_ranks, monkeypatch, name, cfg, D):
    jd, td, pj, K, rounds, H = _svm_inputs()
    for key, value in SVM_ENV.get(name, {}).items():
        monkeypatch.setenv(key, value)
    want = JS.svm_fit(jd, JS.SVMConfig(iterations=rounds, local_iterations=H,
                                       regularization=1e-2, **cfg),
                      make_mesh(D), problem=pj).weights
    w0, w1 = (model.weights for model in two_ranks[("svm", name)])
    assert np.array_equal(w0, w1)  # w is the same on every rank
    np.testing.assert_allclose(w0, want, rtol=2e-4, atol=1e-6)
    assert np.abs(want).max() > 0.05  # the fit moved


def test_svm_pads_chains_to_a_multiple_of_the_ranks(two_ranks):
    # K = 5 over 2 ranks: padded to 6 chains, 3 a rank, the last one
    # empty; the combination uses the real K, so the fit equals the
    # one-rank fit
    td, problem, cfg, steps = _svm_padding_inputs()
    one = TS.svm_fit(td, cfg, device="cpu", problem=problem,
                     steps=steps).weights
    for model in two_ranks["svm-pad"]:
        np.testing.assert_allclose(model.weights, one, rtol=2e-4, atol=1e-6)


# -- staged ALS over 2 ranks, across the packages ------------------------------


def test_two_rank_staging_resumes_across_packages(two_ranks, capfd):
    ratings, init, k = _als_inputs()
    jc3 = JA.ALSConfig(num_factors=k, iterations=3, lambda_=0.1)
    from_jax, from_port = two_ranks["stage_dirs"]
    resumed, _ = two_ranks["staged-resumed"]
    straight, _ = two_ranks["staged-straight"]
    # the job resumed the reference's D = 2 snapshot of iteration 1 and
    # ran 2 more; it also wrote the port's own 2 iterations
    assert sorted(os.listdir(from_jax)) == ["iter_00002.npz",
                                            "iter_00003.npz"]
    assert sorted(os.listdir(from_port)) == ["iter_00001.npz",
                                             "iter_00002.npz"]
    mesh2 = make_mesh(2)
    problem_j = JA.prepare_blocked(*ratings, 2)
    want = JA.als_fit(*ratings, jc3, mesh2, problem=problem_j, init=init)
    _close(resumed[2], want.user_factors)
    _close(resumed[3], want.item_factors)
    # the port's D = 2 snapshot resumes in the reference on 2 devices
    capfd.readouterr()
    got = JA.als_fit(*ratings, jc3, mesh2, problem=problem_j, init=init,
                     temporary_path=from_port)
    assert f"[ALS] staging: resuming from iteration 2 ({from_port})" in \
        capfd.readouterr().out
    _close(got.user_factors, straight[2])
    _close(got.item_factors, straight[3])
    # the meta names 2 blocks, key for key the reference's
    want_meta = JA._staging_meta(problem_j, jc3, init, "cpu")
    got_meta = TA._staging_meta(TA.prepare_blocked(*ratings, 2),
                                TA.ALSConfig(num_factors=k, iterations=3,
                                             lambda_=0.1), init)
    assert got_meta == want_meta and got_meta["n_blocks"] == 2
    assert len(got_meta) == 15


# -- the CLIs on 2 ranks ------------------------------------------------------


def _ratings_file(tmp_path):
    ratings, _, _ = _als_inputs()
    path = str(tmp_path / "ratings.csv")
    TF.write_ratings(path, *ratings)
    return path


def _als_flags(path, out):
    return ["--input", path, "--ignoreFirstLine", "false", "--iterations",
            "4", "--numFactors", "4", "--lambda", "0.1", "--device", "cpu",
            "--userFactors", os.path.join(out, "uf"),
            "--itemFactors", os.path.join(out, "itf")]


def test_als_cli_on_two_ranks_writes_once(tmp_path, capfd):
    path = _ratings_file(tmp_path)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    for d in (one, two):
        os.makedirs(d)
    als_train.run(Params.from_args(_als_flags(path, one)))
    capfd.readouterr()
    model = als_train.run(Params.from_args(_als_flags(path, two)
                                           + ["--devices", "2"]))
    out = capfd.readouterr().out
    # one summary line, from rank 0, naming both devices
    lines = [ln for ln in out.splitlines()
             if ln.startswith("[ALS] model-training")]
    assert len(lines) == 1 and "2 device(s)" in lines[0], out
    for name, table in (("uf", model.user_factors),
                        ("itf", model.item_factors)):
        ids_1, _, m_1 = TF.read_als_model(os.path.join(one, name))
        ids_2, _, m_2 = TF.read_als_model(os.path.join(two, name))
        assert ids_1 == ids_2
        np.testing.assert_allclose(m_2, m_1, rtol=5e-2, atol=5e-3)
        np.testing.assert_allclose(m_2, table.numpy(), rtol=1e-6)
    assert sorted(os.listdir(two)) == ["itf", "uf"]


def _libsvm_file(tmp_path):
    _, td, *_ = _svm_inputs()
    path = str(tmp_path / "train.libsvm")
    lines = []
    for j in range(td.n_examples):
        lo, hi = td.indptr[j], td.indptr[j + 1]
        feats = " ".join(f"{i + 1}:{float(v)!r}" for i, v in
                         zip(td.indices[lo:hi], td.values[lo:hi]))
        lines.append(f"{int(td.labels[j]):+d} {feats}".rstrip())
    TF.write_lines(path, lines)
    return path


SVM_FLAGS = ["--blocks", "6", "--iteration", "5", "--regularization", "0.02",
             "--mode", "add", "--sigmaPrime", "2", "--device", "cpu"]


def test_svm_cli_on_two_ranks_writes_once(tmp_path, capfd):
    path = _libsvm_file(tmp_path)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    want = svm_train.run(Params.from_args(["--training", path, "--output",
                                           one] + SVM_FLAGS))
    capfd.readouterr()
    got = svm_train.run(Params.from_args(["--training", path, "--output",
                                          two, "--devices", "2"]
                                         + SVM_FLAGS))
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines()
             if ln.startswith("[SVM] model-fitting")]
    assert len(lines) == 1 and "2 device(s)" in lines[0], out
    # the draws do not depend on the ranks: the same fit up to the order
    # of the Δw sums
    np.testing.assert_allclose(got.weights, want.weights, rtol=2e-4,
                               atol=1e-6)
    with open(two) as f:
        assert f.read().splitlines() == list(
            TF.format_svm_flat_rows(got.weights))


def _cli_ranks(tmp_path, module, flags):
    """Two commands of ``module``, one per rank, joined through
    ``--coordinatorAddress/--numProcesses/--processId`` at a rendezvous
    file -> (return codes, [(stdout, stderr)] per rank)."""
    rendezvous = "file://" + str(tmp_path / "rendezvous")
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    env["PYTHONPATH"] = ROOT
    # each rank writes to files of its own: with pipes read one rank at a
    # time, a rank blocked on a full pipe would stall the other one inside
    # a collective until the limit
    logs = [(tmp_path / f"rank{r}.out", tmp_path / f"rank{r}.err")
            for r in range(2)]
    procs = []
    for r, (o, e) in enumerate(logs):
        with open(o, "w") as fo, open(e, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *flags,
                 "--coordinatorAddress", rendezvous, "--numProcesses", "2",
                 "--processId", str(r)],
                cwd=ROOT, env=env, stdout=fo, stderr=fe))
    deadline = time.monotonic() + CLI_JOB_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return ([p.returncode for p in procs],
            [(o.read_text(), e.read_text()) for o, e in logs])


def test_svm_cli_joins_a_job_started_elsewhere(tmp_path):
    """``--coordinatorAddress/--numProcesses/--processId``: two commands,
    one per rank, meet at a rendezvous file and write the model once; both
    leave the group at their end (barrier, then
    ``destroy_process_group``) and exit 0."""
    path = _libsvm_file(tmp_path)
    out = str(tmp_path / "model")
    rcs, outs = _cli_ranks(tmp_path, "flink_ms_tpu_torch.train.svm_train",
                           ["--training", path, "--output", out]
                           + SVM_FLAGS)
    assert rcs == [0, 0], outs
    assert "2 device(s)" in outs[0][0] and "[SVM]" not in outs[1][0]
    want = svm_train.run(Params.from_args(["--training", path]
                                          + SVM_FLAGS))
    with open(out) as f:
        rows = f.read().splitlines()
    assert len(rows) == len(want.weights)
    w = np.array([float(row.split(",")[1]) for row in rows])
    np.testing.assert_allclose(w, want.weights, rtol=2e-4, atol=1e-6)


def test_als_cli_joins_a_job_started_elsewhere(tmp_path):
    """The ALS CLI the same way: rank 0 alone writes the model, which
    equals the ``--devices 2`` job's (same blocks, same collectives), and
    both ranks exit 0."""
    path = _ratings_file(tmp_path)
    joined, spawned = str(tmp_path / "joined"), str(tmp_path / "spawned")
    for d in (joined, spawned):
        os.makedirs(d)
    rcs, outs = _cli_ranks(tmp_path, "flink_ms_tpu_torch.train.als_train",
                           _als_flags(path, joined))
    assert rcs == [0, 0], outs
    assert "2 device(s)" in outs[0][0] and "[ALS]" not in outs[1][0]
    assert sorted(os.listdir(joined)) == ["itf", "uf"]
    als_train.run(Params.from_args(_als_flags(path, spawned)
                                   + ["--devices", "2"]))
    for name in ("uf", "itf"):
        ids_j, _, m_j = TF.read_als_model(os.path.join(joined, name))
        ids_s, _, m_s = TF.read_als_model(os.path.join(spawned, name))
        assert ids_j == ids_s
        # tolerance: the same float32 collectives on both jobs
        np.testing.assert_allclose(m_j, m_s, rtol=1e-6, atol=1e-7)
