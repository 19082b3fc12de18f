"""Staged ALS training in the port (``als_fit(temporary_path=...)``, the
CLI's ``--temporaryPath``) against the JAX package's on the CPU: the
snapshot's meta key for key, a staging directory written by either
package resumed by the other, retraining on a changed meta, pruning, and
``StepTimer``.  Factors are held at the parity contract's rtol 1e-3 /
atol 1e-5."""

import os

import numpy as np
import pytest

from flink_ms_tpu.ops import als as JA
from flink_ms_tpu.parallel.mesh import make_mesh
from flink_ms_tpu.utils.profiling import StepTimer as JStepTimer
from flink_ms_tpu_torch.core import formats as TF
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.ops import als as TA
from flink_ms_tpu_torch.train import als_train as port_cli
from flink_ms_tpu_torch.utils.profiling import StepTimer

RESUME = "[ALS] staging: resuming from iteration"


def _ratings(rng, n_users=60, n_items=35, nnz=700):
    u = rng.integers(0, n_users, nnz) + 10
    i = rng.integers(0, n_items, nnz) + 500
    r = rng.uniform(1.0, 5.0, nnz)
    return u, i, r


def _init(rng, u, i, k):
    n_u, n_i = len(np.unique(u)), len(np.unique(i))
    return (rng.uniform(size=(n_u, k)).astype(np.float32),
            rng.uniform(size=(n_i, k)).astype(np.float32))


def _configs(**kw):
    kw.setdefault("num_factors", 4)
    kw.setdefault("lambda_", 0.1)
    return JA.ALSConfig(**kw), TA.ALSConfig(**kw)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-3, atol=1e-5)


def _snapshots(path):
    return sorted(n for n in os.listdir(path) if n.endswith(".npz"))


@pytest.mark.parametrize("start", ["seed", "init"])
@pytest.mark.parametrize("kw", [{}, dict(implicit=True, alpha=2.0),
                                dict(weighted_reg=False, seed=7),
                                dict(exchange_dtype="bfloat16"),
                                dict(exchange_dtype=None)])
def test_meta_equals_reference(rng, start, kw):
    u, i, r = _ratings(rng)
    jc, tc = _configs(**kw)
    init = None if start == "seed" else _init(rng, u, i, 4)
    pj = JA.prepare_blocked(u, i, r, 1)
    pt = TA.prepare_blocked(u, i, r, 1)
    got = TA._staging_meta(pt, tc, init)
    want = JA._staging_meta(pj, jc, init, "cpu")
    assert got == want
    assert [type(got[k]) for k in want] == [type(want[k]) for k in want]
    assert got["dtype"] == "float32" and got["assembly_precision"] == "highest"


@pytest.mark.parametrize("start", ["seed", "init"])
def test_reference_staging_resumes_in_port(rng, tmp_path, capsys, start):
    u, i, r = _ratings(rng)
    init = None if start == "seed" else _init(rng, u, i, 4)
    stage = str(tmp_path / "stage")
    j2, _ = _configs(iterations=2)
    j3, t3 = _configs(iterations=3)
    JA.als_fit(u, i, r, j2, make_mesh(1), init=init, temporary_path=stage)
    assert _snapshots(stage) == ["iter_00001.npz", "iter_00002.npz"]
    capsys.readouterr()
    timer = StepTimer("als-iteration")
    got = TA.als_fit(u, i, r, t3, device="cpu", init=init,
                     temporary_path=stage, step_timer=timer)
    assert f"{RESUME} 2 ({stage})" in capsys.readouterr().out
    assert len(timer.durations_s) == 1
    # the seeded starts differ between the packages; the snapshot carries
    # the state, so the resumed fit continues the reference's own run
    want = JA.als_fit(u, i, r, j3, make_mesh(1), init=init)
    _close(got.user_factors, want.user_factors)
    _close(got.item_factors, want.item_factors)
    assert _snapshots(stage) == ["iter_00002.npz", "iter_00003.npz"]


@pytest.mark.parametrize("start", ["seed", "init"])
def test_port_staging_resumes_in_reference(rng, tmp_path, capsys, start):
    u, i, r = _ratings(rng)
    init = None if start == "seed" else _init(rng, u, i, 4)
    stage = str(tmp_path / "stage")
    _, t2 = _configs(iterations=2)
    j3, t3 = _configs(iterations=3)
    TA.als_fit(u, i, r, t2, device="cpu", init=init, temporary_path=stage)
    capsys.readouterr()
    got = JA.als_fit(u, i, r, j3, make_mesh(1), init=init,
                     temporary_path=stage)
    assert f"{RESUME} 2 ({stage})" in capsys.readouterr().out
    want = TA.als_fit(u, i, r, t3, device="cpu", init=init)
    _close(got.user_factors, want.user_factors.numpy())
    _close(got.item_factors, want.item_factors.numpy())


def test_staged_fit_equals_straight_fit(rng, tmp_path, capsys):
    u, i, r = _ratings(rng)
    init = _init(rng, u, i, 4)
    _, t3 = _configs(iterations=3)
    stage = str(tmp_path / "stage")
    staged = TA.als_fit(u, i, r, t3, device="cpu", init=init,
                        temporary_path=stage)
    assert RESUME not in capsys.readouterr().out
    straight = TA.als_fit(u, i, r, t3, device="cpu", init=init)
    _close(staged.user_factors, straight.user_factors)
    _close(staged.item_factors, straight.item_factors)
    # a full resume runs no iteration and returns the last snapshot
    again = TA.als_fit(u, i, r, t3, device="cpu", init=init,
                       temporary_path=stage)
    assert f"{RESUME} 3" in capsys.readouterr().out
    assert np.array_equal(again.user_factors.numpy(),
                          staged.user_factors.numpy())
    with np.load(os.path.join(stage, "iter_00003.npz")) as z:
        assert z["user_factors"].dtype == np.float32
        assert np.array_equal(z["item_factors"], staged.item_factors.numpy())


@pytest.mark.parametrize("change", ["lambda", "data", "init"])
def test_changed_meta_retrains(rng, tmp_path, capsys, change):
    u, i, r = _ratings(rng)
    init = _init(rng, u, i, 3)
    stage = str(tmp_path / "stage")
    _, first = _configs(num_factors=3, iterations=2, lambda_=0.5)
    TA.als_fit(u, i, r, first, device="cpu", init=init, temporary_path=stage)
    capsys.readouterr()
    cfg = first
    if change == "lambda":
        _, cfg = _configs(num_factors=3, iterations=2, lambda_=0.01)
    elif change == "data":
        r = r.copy()
        r[0] += 1.0  # same shape, same ids, one rating changed
    else:
        init = (init[0] + 0.25, init[1])
    fresh = TA.als_fit(u, i, r, cfg, device="cpu", init=init,
                       temporary_path=stage)
    assert RESUME not in capsys.readouterr().out
    plain = TA.als_fit(u, i, r, cfg, device="cpu", init=init)
    _close(fresh.user_factors, plain.user_factors)


def test_orphans_pruned_and_keep_window(rng, tmp_path):
    u, i, r = _ratings(rng)
    stage = tmp_path / "stage"
    stage.mkdir()
    (stage / "iter_00009.npz.tmp").write_bytes(b"partial")
    (stage / "iter_00007.npz").write_bytes(b"stale, longer run")
    (stage / "notes.txt").write_text("kept: not a snapshot")
    _, cfg = _configs(num_factors=3, iterations=4)
    timer = StepTimer("als-iteration")
    TA.als_fit(u, i, r, cfg, device="cpu", temporary_path=str(stage),
               step_timer=timer)
    assert sorted(os.listdir(stage)) == ["iter_00003.npz", "iter_00004.npz",
                                         "notes.txt"]
    assert len(timer.durations_s) == 4


def test_fewer_iterations_not_overtrained(rng, tmp_path, capsys):
    u, i, r = _ratings(rng)
    init = _init(rng, u, i, 3)
    stage = str(tmp_path / "stage")
    _, t5 = _configs(num_factors=3, iterations=5)
    _, t2 = _configs(num_factors=3, iterations=2)
    TA.als_fit(u, i, r, t5, device="cpu", init=init, temporary_path=stage)
    capsys.readouterr()
    short = TA.als_fit(u, i, r, t2, device="cpu", init=init,
                       temporary_path=stage)
    # iterations 4 and 5 are kept, and beyond the asked 2: a cold rerun
    assert RESUME not in capsys.readouterr().out
    plain = TA.als_fit(u, i, r, t2, device="cpu", init=init)
    _close(short.user_factors, plain.user_factors)


def test_load_staged_skips_corrupt_snapshots(rng, tmp_path):
    u, i, r = _ratings(rng)
    stage = str(tmp_path / "stage")
    _, cfg = _configs(num_factors=3, iterations=2)
    TA.als_fit(u, i, r, cfg, device="cpu", temporary_path=stage)
    with open(os.path.join(stage, "iter_00002.npz"), "wb") as f:
        f.write(b"torn")
    problem = TA.prepare_blocked(u, i, r, 1)
    meta = TA._staging_meta(problem, cfg, None)
    it, uf, itf = TA.load_staged(stage, meta)
    assert it == 1 and uf.shape == (problem.n_users, 3)
    assert TA.load_staged(str(tmp_path / "missing"), meta) is None


def test_step_timer_summary_bytes_equal_reference():
    got, want = StepTimer("als-iteration"), JStepTimer("als-iteration")
    for t in (0.012, 0.0305, 0.0101, 0.2):
        got.durations_s.append(t)
        want.durations_s.append(t)
    assert got.summary() == want.summary()
    assert got.stats() == want.stats()
    for q in (0, 50, 90, 99.9, 100):
        assert got.percentile(q) == want.percentile(q)
    assert StepTimer("x").summary() == JStepTimer("x").summary()


def test_cli_temporary_path(tmp_path, rng, capsys):
    u, i, r = _ratings(rng)
    path = str(tmp_path / "ratings.csv")
    TF.write_ratings(path, u, i, r)
    stage = str(tmp_path / "stage")
    flags = ["--input", path, "--ignoreFirstLine", "false", "--device",
             "cpu", "--iterations", "3", "--numFactors", "3",
             "--temporaryPath", stage + "/",
             "--userFactors", str(tmp_path / "uf"),
             "--itemFactors", str(tmp_path / "itf")]
    port_cli.run(Params.from_args(flags))
    lines = capsys.readouterr().out.splitlines()
    at = [n for n, ln in enumerate(lines) if ln.startswith("[als-iteration] 3 "
                                                          "steps")]
    assert at and lines[at[0] + 1].startswith("[ALS] model-training")
    assert _snapshots(stage) == ["iter_00002.npz", "iter_00003.npz"]
    # the final factors' copy under the staging dir equals the output
    for name, out in (("userFactors", "uf"), ("itemFactors", "itf")):
        with open(os.path.join(stage, name)) as a, \
                open(str(tmp_path / out)) as b:
            assert a.read() == b.read()
    port_cli.run(Params.from_args(flags))
    assert f"{RESUME} 3 ({stage})" in capsys.readouterr().out


@pytest.mark.parametrize("value", ["/", "///"])
def test_cli_rejects_a_bare_slash(tmp_path, rng, value):
    u, i, r = _ratings(rng)
    path = str(tmp_path / "ratings.csv")
    TF.write_ratings(path, u, i, r)
    with pytest.raises(ValueError, match="bare '/'"):
        port_cli.run(Params.from_args(["--input", path, "--device", "cpu",
                                       "--temporaryPath", value]))
