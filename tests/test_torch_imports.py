"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points refuse to run without CUDA unless the caller asks for the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.ops import als as TA
from flink_ms_tpu_torch.ops import svm as TS
from flink_ms_tpu_torch.parallel.mesh import resolve_device
from flink_ms_tpu_torch.train import als_train, svm_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_load_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import flink_ms_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            flink_ms_tpu_torch.__path__, "flink_ms_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "flink_ms_tpu" or m.startswith("flink_ms_tpu."))
        print(len(names), bad)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 17  # every module of the port was imported
    assert bad == "[]"


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_has_no_fallback(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path, rng):
    u = rng.integers(0, 10, 50)
    i = rng.integers(0, 8, 50)
    r = rng.uniform(1, 5, 50)
    cfg = TA.ALSConfig(num_factors=3, iterations=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.als_fit(u, i, r, cfg)
    model = TA.als_fit(u, i, r, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.predict(model, u, i)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.rmse(model, u, i, r)
    assert np.isfinite(TA.rmse(model, u, i, r, device="cpu"))
    path = str(tmp_path / "ratings.csv")
    F.write_ratings(path, u, i, r)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        als_train.run(Params.from_args(["--input", path]))


def test_svm_entry_points_raise_without_cuda(no_cuda, tmp_path):
    path = str(tmp_path / "train.libsvm")
    F.write_lines(path, ["+1 1:1.0 3:0.5", "-1 2:1.0 4:0.5"] * 5)
    data = F.read_libsvm(path)
    cfg = TS.SVMConfig(iterations=1, local_iterations=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.svm_fit(data, cfg)
    problem = TS.prepare_svm_blocked(data, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.compile_svm_fit(problem, cfg)
    assert TS.svm_fit(data, cfg, device="cpu").weights.shape == (4,)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        svm_train.run(Params.from_args(["--training", path]))


def test_svm_wrapper_times_refuses_without_cuda(no_cuda, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "svm_wrapper_times", os.path.join(ROOT, "scripts",
                                          "svm_wrapper_times.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main([]) == 2
    assert capsys.readouterr().out == ""
