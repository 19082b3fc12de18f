"""The port's MSE evaluator (``flink_ms_tpu_torch/eval/mse.py``) against
the JAX package's ``eval/mse.py`` on the same files."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flink_ms_tpu.core import formats as RF
from flink_ms_tpu.core.params import Params as RefParams
from flink_ms_tpu.eval import mse as ref_mse
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.eval import mse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_case(d, rng, n_users=40, n_items=30, k=5, n=600):
    """Model files (with a MEAN row) and a tab ratings file whose users and
    items include ids the model lacks."""
    uf, itf = str(d / "uf"), str(d / "itf")
    RF.write_als_model(uf, np.arange(n_users), "U",
                       rng.normal(size=(n_users, k)) * 0.5)
    RF.write_als_model(itf, np.arange(n_items), "I",
                       rng.normal(size=(n_items, k)) * 0.5)
    with open(itf, "a") as f:
        f.write(RF.format_mean_row("I", np.zeros(k)) + "\n")
    users = rng.integers(0, n_users + 5, n)
    items = rng.integers(0, n_items + 3, n)
    ratings = rng.uniform(1, 5, n)
    path = str(d / "ratings.tsv")
    with open(path, "w") as f:
        f.write("user\titem\trating\n")
        for u, i, r in zip(users, items, ratings):
            f.write(f"{u}\t{i}\t{float(r)!r}\n")
    return path, f"{uf},{itf}", (users, items, ratings)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_offline_run_equals_reference(tmp_path, seed):
    rng = np.random.default_rng(seed)
    ratings, model, (u, i, r) = _write_case(tmp_path, rng)
    args = ["--input", ratings, "--model", model]
    want = ref_mse.run(RefParams.from_args(args))
    got = mse.run(Params.from_args(args + ["--device", "cpu"]))
    assert got == pytest.approx(want, rel=1e-6)
    # and the scored / skipped counts of the batched pass
    w = ref_mse._compute_mse_offline_batched(
        u, i, r, ref_mse._load_model_tables(model))
    g = mse._compute_mse_offline_batched(
        u, i, r, mse._load_model_tables(model), device="cpu")
    assert g[1:] == w[1:] and g[1] > 0 and g[2] > 0
    assert g[0] == pytest.approx(w[0], rel=1e-6)


def test_offline_matches_the_per_rating_semantics(tmp_path):
    """The batched pass scores exactly what compute_mse's group and skip
    rules score (a missing item drops its rating only; a missing user its
    whole group)."""
    rng = np.random.default_rng(3)
    _, model, (u, i, r) = _write_case(tmp_path, rng)
    table = mse._load_model_tables(model)
    want = mse.compute_mse(u, i, r, table.get)
    got = mse._compute_mse_offline_batched(u, i, r, table, device="cpu")
    assert got[1:] == want[1:]
    assert got[0] == pytest.approx(want[0], rel=1e-5)  # float32 predictions
    assert want == ref_mse.compute_mse(u, i, r, table.get)


def test_output_file_and_injected_lookup(tmp_path):
    rng = np.random.default_rng(4)
    ratings, model, _ = _write_case(tmp_path, rng)
    out = str(tmp_path / "mse.txt")
    got = mse.run(Params.from_args(["--input", ratings, "--model", model,
                                    "--device", "cpu", "--output", out]))
    assert open(out).read() == repr(float(got)) + "\n"
    table = mse._load_model_tables(model)
    assert mse.run(Params.from_args(["--input", ratings]),
                   lookup=table.get) == ref_mse.run(
        RefParams.from_args(["--input", ratings]), lookup=table.get)


def test_live_mode_is_refused(tmp_path):
    with pytest.raises(ValueError, match="Serving job"):
        mse.run(Params.from_args(["--input", str(tmp_path / "r.tsv"),
                                  "--jobId", "j1"]))


def test_cuda_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ratings, model, _ = _write_case(tmp_path, np.random.default_rng(5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mse.run(Params.from_args(["--input", ratings, "--model", model]))


def test_rolling_holdout_split_equals_reference():
    rng = np.random.default_rng(6)
    u = rng.integers(0, 30, 500)
    i = rng.integers(0, 50, 500)
    r = rng.uniform(1, 5, 500)
    for seed, frac in ((0, 0.2), (3, 0.5)):
        got = mse.rolling_holdout_split(u, i, r, fraction=frac, seed=seed)
        want = ref_mse.rolling_holdout_split(u, i, r, fraction=frac,
                                             seed=seed)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        mse.rolling_holdout_split(u, i, r, fraction=1.0)


def test_module_cli_prints_the_mse(tmp_path):
    ratings, model, _ = _write_case(tmp_path, np.random.default_rng(7))
    out = subprocess.run(
        [sys.executable, "-m", "flink_ms_tpu_torch.eval.mse", "--device",
         "cpu", "--input", ratings, "--model", model],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    want = ref_mse.run(RefParams.from_args(["--input", ratings,
                                            "--model", model]))
    assert float(out.stdout.strip().splitlines()[-1]) == \
        pytest.approx(want, rel=1e-6)
    assert "skipped" in out.stderr
