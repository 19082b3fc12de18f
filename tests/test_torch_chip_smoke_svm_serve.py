"""Rehearsals of ``chip_smoke.py``'s phase 24 (the SVM's train -> publish ->
serve -> predict loop) on the CPU at a small size: 400 features, range
100, 50 rows and queries, a model trained by the port's ``svm_fit`` on the
CPU, every job and CLI a process of its own, ``margin_gather`` counting
its launches through the fakes of ``count_plain_versions`` and running
its plain version; and the cases where the phase must fail."""

import _ctypes
import re
import shutil

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture
def small_serve(monkeypatch):
    """Phase 24's sizes shrunk, the kernel wrappers counting, and phase
    7's sample taken from a small CPU fit."""
    from flink_ms_tpu_torch.ops import als as TA
    from flink_ms_tpu_torch.ops import cholesky as CH
    from flink_ms_tpu_torch.ops import gather_assembly as GA
    from flink_ms_tpu_torch.ops import svm as TS
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    for name, value in (("SVMSERVE_RANGE", 100), ("SVMSERVE_ROWS", 50),
                        ("SVMSERVE_SUBSET_ROWS", 20), ("SVMSERVE_QUERIES", 50),
                        ("SVMSERVE_NNZ", 20), ("SVMSERVE_LOOP_QUERIES", 20),
                        ("SVMSERVE_CLI_QUERIES", 10),
                        ("SVMSERVE_CLI_FEATURES", 20)):
        monkeypatch.setattr(chip_smoke, name, value)
    chip_smoke.count_plain_versions(TA, CH, GA, TS, SK, monkeypatch.setattr)
    data = chip_smoke.synth_rcv1(2000, 400, 9, seed=0)
    problem = TS.prepare_svm_blocked(data, 32)
    cfg = TS.SVMConfig(iterations=5, local_iterations=problem.rows_per_block,
                       regularization=1e-4, mode="add", sigma_prime=8.0)
    w = TS.svm_fit(data, cfg, "cpu", problem=problem).weights
    w = torch.as_tensor(np.asarray(w), dtype=torch.float32)
    return chip_smoke.svm_serve_sample({"w": w, "data": data}), SK


def _phase(small_serve):
    sample, SK = small_serve
    return chip_smoke.svm_serve_phase(torch, sample, SK, torch.device("cpu"))


def test_svm_serve_sample_is_phase_7s_rows_padded(monkeypatch):
    """``SVMSERVE_ROWS`` rows drawn by ``default_rng(11)``, each row's
    indices and values as the data holds them, padded with index 0 and
    value 0 to the longest row."""
    from flink_ms_tpu_torch.core.formats import SparseData

    monkeypatch.setattr(chip_smoke, "SVMSERVE_ROWS", 40)
    rng = np.random.default_rng(1)
    lengths = rng.integers(1, 6, 300)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    data = SparseData(labels=rng.choice([-1.0, 1.0], 300), indptr=indptr,
                      indices=rng.integers(0, 50, indptr[-1]),
                      values=rng.normal(size=indptr[-1]), n_features=50)
    s = chip_smoke.svm_serve_sample({"w": torch.zeros(50), "data": data})
    assert np.array_equal(s["rows"], np.sort(
        np.random.default_rng(11).choice(300, 40, replace=False)))
    assert s["idx"].shape == (40, int(lengths[s["rows"]].max()))
    for j, r in enumerate(s["rows"]):
        a, b = indptr[r], indptr[r + 1]
        n = b - a
        assert s["nnz"][j] == n
        assert np.array_equal(s["idx"][j, :n], data.indices[a:b])
        assert np.array_equal(s["val"][j, :n], data.values[a:b])
        assert not s["idx"][j, n:].any() and not s["val"][j, n:].any()
        assert s["labels"][j] == data.labels[r]


def test_svm_serve_phase_rehearsal(small_serve, capsys):
    out = _phase(small_serve)
    logs = capsys.readouterr().out
    assert "400 flat rows" in logs and "5 range rows at range 100" in logs
    assert "parsed back to w bit for bit: flat True, range True" in logs
    assert "ready with 400 features in" in logs
    assert "libcuda mapped by the jobs: {'flat': [], 'range': []}" in logs
    assert "flat GET 0.000e+00 (20 rows)" in logs
    for way, rows in (("flat MGET", 50), ("range GET", 20),
                      ("range MGET", 20)):
        assert re.search(rf"{way} [0-9.e+-]+ \({rows} rows\)", logs), way
    assert "margin_gather (1 launch, 9 wide)" in logs
    assert "signs equal the card's on" in logs
    assert ("CLIs, run beside (c): svm_predict_random 10 rows, "
            "range_partition_svm_predict 10 rows of "
            "qId,nFeatures,prediction,ms") in logs
    assert "processes of the phase alive: []" in logs
    assert out["launches"] == 1 and 0.5 < out["accuracy"] <= 1.0
    for key in ("svmserve_flat", "svmserve_flat_mget", "svmserve_range",
                "svmserve_range_mget"):
        assert 0 < out[f"{key}_p50_ms"] <= out[f"{key}_p99_ms"]
    assert set(out["ready_s"]) == {"flat", "range"}
    assert out["cli_rows"] == {"svm_predict_random": 10,
                               "range_partition_svm_predict": 10}


def test_svm_serve_phase_fails_when_a_served_weight_moves_one_ulp(
        small_serve, monkeypatch):
    """The flat model file, after (a) read it back, with the first sampled
    feature's weight one float32 ulp up: the plane serves it and (c)'s
    float64 check fails."""
    from flink_ms_tpu_torch.core import formats as F

    sample = small_serve[0]
    fid = int(sample["idx"][0, 0])
    real = chip_smoke.svm_serve_files

    def moved(work, w64):
        paths = real(work, w64)
        w = w64.copy()
        w[fid] = float(np.nextafter(np.float32(w[fid]), np.float32(np.inf)))
        F.write_lines(paths["flat"], F.format_svm_flat_rows(w))
        return paths

    monkeypatch.setattr(chip_smoke, "svm_serve_files", moved)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="svm_serve: the flat GET values are off the "
                             "host's float64"):
        _phase(small_serve)


def test_svm_serve_phase_fails_when_a_job_maps_libcuda(
        small_serve, monkeypatch, tmp_path):
    """Every process the phase starts loads a library named
    ``libcuda.so.1`` at start-up (a copy of a small shared object): (b)
    reads it in the jobs' mappings and fails."""
    lib = tmp_path / "libcuda.so.1"
    shutil.copy(_ctypes.__file__, lib)
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        f"import ctypes\nctypes.CDLL({str(lib)!r})\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="svm_serve: an SVM job maps the CUDA driver"):
        _phase(small_serve)
