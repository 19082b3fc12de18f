"""The port's model generators (``flink_ms_tpu_torch/gen``) against the JAX
package's on the CPU: the parallel path's part files byte for byte, the
single-process path's rows through both packages' parsers with their
distribution beside the reference's at equal size, and the SVM rows'
format."""

import os
import re

import numpy as np
import pytest
import torch

from flink_ms_tpu.core import formats as JF
from flink_ms_tpu.core.params import Params as JParams
from flink_ms_tpu.gen import als_model_generator as JG
from flink_ms_tpu.gen import svm_model_generator as JSG
from flink_ms_tpu_torch.core import formats as TF
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.gen import als_model_generator as TG
from flink_ms_tpu_torch.gen import svm_model_generator as TSG


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("distribution", ["ratio", "bounded"])
@pytest.mark.parametrize("p", [2, 3])
def test_part_worker_equals_reference_byte_for_byte(tmp_path, distribution,
                                                    p):
    got, want = tmp_path / "port", tmp_path / "ref"
    got.mkdir()
    want.mkdir()
    for part in range(p):
        args = (part, p, 70, 31, 6, 9, distribution)
        assert TG._part_worker((str(got),) + args) == \
            JG._part_worker((str(want),) + args)
        name = str(part + 1)
        assert _bytes(got / name) == _bytes(want / name)
        assert len(_bytes(got / name)) > 0


def test_cli_parallel_parts_equal_the_reference_workers(tmp_path):
    out = tmp_path / "model"
    TG.run(Params.from_args([
        "--device", "cpu", "--numUsers", "50", "--numItems", "20",
        "--latentFactors", "3", "--parallelism", "2", "--seed", "4",
        "--output", str(out)]))
    assert sorted(os.listdir(out)) == ["1", "2"]
    want = tmp_path / "ref"
    want.mkdir()
    for part in range(2):
        JG._part_worker((str(want), part, 2, 50, 20, 3, 4, "ratio"))
        assert _bytes(out / str(part + 1)) == _bytes(want / str(part + 1))
    ids, types, mat = JF.read_als_model(str(out))
    assert types.count("U") == 50 and types.count("I") == 20
    assert mat.shape == (70, 3)


def test_cli_pool_failure_falls_back_loudly(tmp_path, monkeypatch, capsys):
    import multiprocessing as mp

    class Broken:
        def Pool(self, n):
            raise OSError("no processes")

    monkeypatch.setattr(mp, "get_context", lambda kind: Broken())
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    out = tmp_path / "model"
    TG.run(Params.from_args([
        "--device", "cpu", "--numUsers", "7", "--numItems", "5",
        "--latentFactors", "2", "--parallelism", "3", "--output", str(out)]))
    assert "regenerating single-process" in capsys.readouterr().err
    assert sorted(os.listdir(out)) == ["1", "2", "3"]
    ids, types, _ = TF.read_als_model(str(out))
    assert sorted(types) == ["I"] * 5 + ["U"] * 7


@pytest.mark.parametrize("distribution", ["ratio", "bounded"])
def test_single_process_rows_parse_and_match_reference_distribution(
        tmp_path, distribution):
    n_users, n_items, latent = 3000, 1000, 8
    flags = ["--numUsers", str(n_users), "--numItems", str(n_items),
             "--latentFactors", str(latent), "--parallelism", "1",
             "--distribution", distribution]
    got, want = str(tmp_path / "port"), str(tmp_path / "ref")
    TG.run(Params.from_args(flags + ["--device", "cpu", "--output", got]))
    JG.run(JParams.from_args(flags + ["--output", want]))
    lines = list(TF.iter_lines(got))
    parsed = [TF.parse_als_row(ln) for ln in lines]
    assert [JF.parse_als_row(ln)[2].tolist() for ln in lines] == \
        [v.tolist() for _, _, v in parsed]
    ids = [int(i) for i, _, _ in parsed]
    types = [t for _, t, _ in parsed]
    assert ids == list(range(1, n_users + 1)) + list(range(1, n_items + 1))
    assert types == ["U"] * n_users + ["I"] * n_items
    mat = np.stack([v for _, _, v in parsed])
    ref = JF.read_als_model(want)[2]
    assert mat.shape == ref.shape == (n_users + n_items, latent)
    assert np.isfinite(mat).all() and (mat >= 0).all()
    if distribution == "bounded":
        # uniform on [0, c): mean c/2, variance c^2/12; 32,000 draws each
        c = np.sqrt(5.0 / latent)
        for m in (mat, ref):
            assert (m < c).all()
            assert abs(m.mean() - c / 2) < 0.01 * c
            assert abs(m.var() - c * c / 12) < 0.02 * c * c / 12 * 3
    else:
        # the ratio of uniforms has no mean: compare its quartiles; U/U has
        # P(U/U <= z) = z/2 below 1 and 1 - 1/(2z) above, so its quartiles
        # are 1/2, 1 and 2 (times latent here)
        for q, want_q in ((25, 0.5), (50, 1.0), (75, 2.0)):
            a, b = np.percentile(mat, q), np.percentile(ref, q)
            assert abs(a - b) < 0.05 * latent * want_q, (q, a, b)
            assert abs(a - latent * want_q) < 0.05 * latent * want_q


def test_single_process_sides_are_seeded_s_and_s_plus_1(tmp_path):
    out = str(tmp_path / "model")
    TG.run(Params.from_args([
        "--device", "cpu", "--numUsers", "4", "--numItems", "3",
        "--latentFactors", "5", "--parallelism", "1", "--seed", "11",
        "--output", out]))
    lines = list(TF.iter_lines(out))
    assert lines[:4] == list(TG.generate_rows(4, "U", 5, 11, device="cpu"))
    assert lines[4:] == list(TG.generate_rows(3, "I", 5, 12, device="cpu"))
    # the draws are f32 values, written as the shortest repr of each
    vals = TF.parse_als_row(lines[0])[2]
    assert np.array_equal(vals.astype(np.float32).astype(np.float64), vals)


def test_generate_rows_batches_continue_one_stream(monkeypatch):
    monkeypatch.setattr(TG, "_BATCH", 3)
    small = list(TG.generate_rows(7, "U", 2, 5, device="cpu"))
    gen = torch.Generator().manual_seed(5)
    want = []
    for m in (3, 3, 1):
        num = torch.rand((m, 2), generator=gen)
        den = torch.rand((m, 2), generator=gen)
        want.append((num / torch.clamp_min(den, 1e-12) * 2).double())
    want = torch.cat(want).numpy()
    got = np.stack([TF.parse_als_row(r)[2] for r in small])
    assert np.array_equal(got, want)


def test_svm_rows_format_and_distribution(tmp_path):
    num_features, range_ = 4000, 300
    out = str(tmp_path / "svm")
    TSG.run(Params.from_args([
        "--device", "cpu", "--numFeatures", str(num_features), "--range",
        str(range_), "--parallelism", "1", "--seed", "2", "--output", out]))
    ref = str(tmp_path / "ref")
    JSG.run(JParams.from_args([
        "--numFeatures", str(num_features), "--range", str(range_),
        "--parallelism", "1", "--seed", "2", "--output", ref]))
    lines, ref_lines = list(TF.iter_lines(out)), list(JF.iter_lines(ref))
    assert len(lines) == len(ref_lines) == num_features // range_ + 1
    token = re.compile(r"^\d+:(0|-?\d+\.\d+(e-?\d+)?)$")
    weights = []
    for b, (line, ref_line) in enumerate(zip(lines, ref_lines)):
        head, payload = line.split(",", 1)
        assert head == str(b)
        assert all(token.match(t) for t in payload.split(";")), line[:80]
        got_b, got = TF.parse_svm_range_row(line)
        assert JF.parse_svm_range_row(line) == (got_b, got)
        want_b, want = JF.parse_svm_range_row(ref_line)
        assert got_b == want_b == b
        assert [i for i, _ in got] == [i for i, _ in want] == \
            list(range(b * range_, (b + 1) * range_))
        weights += [w for _, w in got]
    w = np.asarray(weights)
    n = len(w)
    assert abs((w == 0).mean() - 0.5) < 4 * 0.5 / np.sqrt(n)
    nz = w[w != 0]
    assert (np.abs(nz) < 10).all()
    assert abs(nz.mean()) < 4 * 10 / np.sqrt(3 * len(nz))
    assert abs(nz.var() - 100 / 3) < 0.05 * 100 / 3
    # a nonzero weight is an f32 draw, printed as the repr of its double
    assert np.array_equal(nz.astype(np.float32).astype(np.float64), nz)


def test_svm_parallel_parts_round_robin(tmp_path):
    out = tmp_path / "svm"
    TSG.run(Params.from_args([
        "--device", "cpu", "--numFeatures", "50", "--range", "10",
        "--parallelism", "2", "--output", str(out)]))
    assert sorted(os.listdir(out)) == ["1", "2"]
    buckets = sorted(TF.parse_svm_range_row(ln)[0]
                     for ln in TF.iter_lines(str(out)))
    assert buckets == list(range(6))
    assert [TF.parse_svm_range_row(ln)[0]
            for ln in TF.iter_lines(str(out / "2"))] == [1, 3, 5]


def test_stdout_mode(capsys):
    TSG.run(Params.from_args(["--device", "cpu", "--numFeatures", "3",
                              "--range", "2"]))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Printing results to stdout")
    assert [ln.split(",")[0] for ln in out[1:]] == ["0", "1"]
    TG.run(Params.from_args(["--device", "cpu", "--numUsers", "2",
                             "--numItems", "1", "--latentFactors", "2"]))
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[:2] for ln in out[1:]] == [["1", "U"], ["2", "U"],
                                                     ["1", "I"]]


def test_bad_distribution_raises():
    with pytest.raises(ValueError, match="ratio|bounded"):
        TG.run(Params.from_args(["--device", "cpu", "--numUsers", "2",
                                 "--numItems", "2", "--latentFactors", "2",
                                 "--distribution", "weird"]))
