"""The port's ALS training CLI (``flink_ms_tpu_torch/train/als_train.py``)
against the JAX package's on the same input, on the CPU."""

import os
import re

import numpy as np
import pytest

from flink_ms_tpu.core import formats as JF
from flink_ms_tpu.core.params import Params as JParams
from flink_ms_tpu.train import als_train as jax_cli
from flink_ms_tpu_torch.core import formats as TF
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.train import als_train as port_cli


@pytest.fixture
def ratings_file(tmp_path, rng):
    n_users, n_items, k_true = 40, 25, 3
    uf = rng.normal(size=(n_users, k_true))
    itf = rng.normal(size=(n_items, k_true))
    mask = rng.uniform(size=(n_users, n_items)) < 0.5
    u, i = np.nonzero(mask)
    # a noise floor makes the two fits' RMSEs comparable although their
    # inits differ
    r = (uf @ itf.T)[u, i] + 0.3 * rng.standard_normal(len(u))
    p = str(tmp_path / "ratings.csv")
    TF.write_ratings(p, u + 100, i + 2000, r)
    return p, (u + 100, i + 2000, r)


def _flags(path, out_dir):
    return [
        "--input", path, "--ignoreFirstLine", "false", "--iterations", "10",
        "--numFactors", "3", "--lambda", "0.1",
        "--userFactors", os.path.join(out_dir, "userFactors"),
        "--itemFactors", os.path.join(out_dir, "itemFactors"),
    ]


def _train_rmse(out: str) -> float:
    line = [ln for ln in out.splitlines() if ln.startswith("[ALS] model-training")]
    assert len(line) == 1, out
    return float(re.search(r"train RMSE=([0-9.]+)", line[0]).group(1))


def test_port_cli_files_parse_and_match_jax_cli(tmp_path, ratings_file,
                                                capsys):
    path, (u, i, r) = ratings_file
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    port_cli.run(Params.from_args(_flags(path, port_dir) + ["--device", "cpu"]))
    port_out = capsys.readouterr().out
    jax_cli.run(JParams.from_args(_flags(path, jax_dir) + ["--devices", "1"]))
    jax_out = capsys.readouterr().out
    for name, typ in (("userFactors", "U"), ("itemFactors", "I")):
        ids_p, types_p, mat_p = JF.read_als_model(os.path.join(port_dir, name))
        ids_j, types_j, mat_j = JF.read_als_model(os.path.join(jax_dir, name))
        assert ids_p == ids_j  # same ids, same (sorted) order
        assert set(types_p) == set(types_j) == {typ}
        assert mat_p.shape == mat_j.shape and np.isfinite(mat_p).all()
    # the inits differ (torch generator vs threefry): compare the fits,
    # not the factors
    rmse_p, rmse_j = _train_rmse(port_out), _train_rmse(jax_out)
    assert abs(rmse_p - rmse_j) <= 0.05 * rmse_j + 1e-3, (rmse_p, rmse_j)
    assert "1 device(s)" in port_out and "k=3, 10 iters" in port_out


def test_format_als_row_byte_identical(rng):
    for n in (1, 3, 50):
        row = rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n)
        row32 = row.astype(np.float32)
        for vec in (row, row32, list(row)):
            assert TF.format_als_row(17, "U", vec) == \
                JF.format_als_row(17, "U", vec)
        line = TF.format_als_row("MEAN", "I", row)
        assert TF.parse_als_row(line)[0] == "MEAN"
        assert np.array_equal(TF.parse_als_row(line)[2],
                              JF.parse_als_row(line)[2])


def test_stdout_mode_and_profile_trace(tmp_path, ratings_file, capsys):
    path, _ = ratings_file
    trace_dir = str(tmp_path / "trace")
    port_cli.run(Params.from_args([
        "--input", path, "--ignoreFirstLine", "false", "--iterations", "2",
        "--numFactors", "3", "--device", "cpu", "--profileDir", trace_dir,
        "--blocks", "4",
    ]))
    out = capsys.readouterr().out
    assert "==== USER FACTORS ====" in out and "==== ITEM FACTORS ====" in out
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0


def test_no_input_prints_usage(capsys):
    assert port_cli.run(Params.from_args([])) is None
    assert "--input" in capsys.readouterr().out


@pytest.mark.parametrize("flag,value,match", [
    ("--temporaryPath", "stage", "Staging"),
    ("--devices", "2", "Multi-GPU"),
])
def test_unported_flags_are_refused(ratings_file, flag, value, match):
    path, _ = ratings_file
    with pytest.raises(ValueError, match=match):
        port_cli.run(Params.from_args(
            ["--input", path, "--device", "cpu", flag, value]))
