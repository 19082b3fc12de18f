"""The port's SVM training CLI (``flink_ms_tpu_torch/train/svm_train.py``)
and its LibSVM and SVM-model formats against the JAX package's, on the
CPU."""

import os
import re

import numpy as np
import pytest

from flink_ms_tpu.core import formats as JF
from flink_ms_tpu.core.params import Params as JParams
from flink_ms_tpu.train import svm_train as jax_cli
from flink_ms_tpu_torch.core import formats as TF
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.train import svm_train as port_cli


@pytest.fixture
def libsvm_file(tmp_path, rng):
    """Sparse two-class rows with a noise floor, 1-based ids, a comment and
    a blank line."""
    n, d = 120, 15
    w_true = rng.normal(size=d)
    lines = ["# training rows"]
    for j in range(n):
        ids = np.sort(rng.choice(d, rng.integers(1, 6), replace=False))
        vals = rng.normal(size=len(ids))
        y = 1 if vals @ w_true[ids] + 0.2 * rng.normal() > 0 else -1
        feats = " ".join(f"{i + 1}:{v}" for i, v in zip(ids, vals))
        lines.append(f"{y:+d} {feats}")
        if j == 10:
            lines.append("")
    path = str(tmp_path / "train.libsvm")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _objective(out: str) -> float:
    line = [ln for ln in out.splitlines()
            if ln.startswith("[SVM] model-fitting")]
    assert len(line) == 1, out
    return float(re.search(r"objective=([0-9.]+)", line[0]).group(1))


FLAGS = ["--blocks", "4", "--iteration", "8", "--regularization", "0.02",
         "--mode", "add", "--sigmaPrime", "2"]


@pytest.mark.parametrize("partition", [False, True])
def test_port_cli_output_matches_jax_formatters(tmp_path, libsvm_file, capsys,
                                                partition):
    extra = ["--partition", "true", "--range", "4"] if partition else []
    port_out = str(tmp_path / "port")
    model = port_cli.run(Params.from_args(
        ["--training", libsvm_file, "--output", port_out, "--device", "cpu"]
        + FLAGS + extra))
    out = capsys.readouterr().out
    assert "120 examples x 15 features, 8 rounds x 30 local steps, " \
        "1 device(s)" in out
    # the same weights through the JAX package's formatters: the same bytes
    want = (JF.format_svm_range_rows(model.weights, 4) if partition
            else JF.format_svm_flat_rows(model.weights))
    with open(port_out) as f:
        assert f.read() == "".join(row + "\n" for row in want)
    # and the rows parse back to the weights, by either package's parser
    w = TF.read_svm_model(port_out, n_features=15, partitioned=partition)
    np.testing.assert_array_equal(w, model.weights)
    np.testing.assert_array_equal(
        w, JF.read_svm_model(port_out, n_features=15, partitioned=partition))
    got = np.zeros(15)
    for line in TF.iter_lines(port_out):
        if partition:
            bucket, entries = TF.parse_svm_range_row(line)
            assert (bucket, entries) == JF.parse_svm_range_row(line)
            assert all(i // 4 == bucket for i, _ in entries)
        else:
            entries = [TF.parse_svm_flat_row(line)]
            assert entries[0] == JF.parse_svm_flat_row(line)
        for i, v in entries:
            got[i - 1] = v
    np.testing.assert_array_equal(got, model.weights)
    # the step draws differ (torch generator vs threefry): compare the fits
    jax_cli.run(JParams.from_args(
        ["--training", libsvm_file, "--output", str(tmp_path / "jax"),
         "--devices", "1"] + FLAGS))
    jax_out = capsys.readouterr().out
    obj_p, obj_j = _objective(out), _objective(jax_out)
    assert obj_p < 1.0 and abs(obj_p - obj_j) <= 0.05 * obj_j, (obj_p, obj_j)


def test_read_libsvm_equals_reference(tmp_path, libsvm_file):
    parts = tmp_path / "parts"
    parts.mkdir()
    with open(libsvm_file) as f:
        rows = f.read().splitlines()
    for k, chunk in enumerate((rows[:40], rows[40:])):
        (parts / f"part-{k}").write_text("\n".join(chunk) + "\n")
    (parts / "_SUCCESS").write_text("")
    for path, n_features in ((libsvm_file, 0), (str(parts), 40)):
        got = TF.read_libsvm(path, n_features)
        want = JF.read_libsvm(path, n_features)
        assert got.n_features == want.n_features == max(15, n_features)
        assert got.n_examples == want.n_examples == 120
        for name in ("labels", "indptr", "indices", "values"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert [x.tolist() for x in got.row(7)] == \
            [x.tolist() for x in want.row(7)]
    bad = tmp_path / "bad.libsvm"
    bad.write_text("+1 0:1.0\n")
    with pytest.raises(ValueError, match=">= 1"):
        TF.read_libsvm(str(bad))


def test_svm_row_formats_byte_identical(rng):
    w = rng.normal(size=23) * 10.0 ** rng.integers(-8, 8, 23)
    for vec in (w, w.astype(np.float32)):
        assert list(TF.format_svm_flat_rows(vec)) == \
            list(JF.format_svm_flat_rows(vec))
        for r in (1, 5, 1000):
            assert list(TF.format_svm_range_rows(vec, r)) == \
                list(JF.format_svm_range_rows(vec, r))
    assert TF.parse_svm_range_row("0,1:2.5;3:-1.0;") == \
        JF.parse_svm_range_row("0,1:2.5;3:-1.0;")
    with pytest.raises(ValueError):
        TF.parse_svm_range_row("0,1;2")


def test_stdout_mode_and_profile_trace(tmp_path, libsvm_file, capsys):
    trace_dir = str(tmp_path / "trace")
    port_cli.run(Params.from_args(
        ["--training", libsvm_file, "--iterations", "2", "--device", "cpu",
         "--profileDir", trace_dir, "--localIterations", "5"]))
    out = capsys.readouterr().out
    assert "2 rounds x 5 local steps" in out
    assert "Printing result to stdout" in out
    assert sum(1 for ln in out.splitlines() if re.match(r"^\d+,", ln)) == 15
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0


def test_multi_gpu_is_refused(libsvm_file, monkeypatch):
    # more ranks than visible GPUs: refused before anything runs
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1"):
        port_cli.run(Params.from_args(
            ["--training", libsvm_file, "--device", "cuda", "--devices",
             "2"]))
