"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points refuse to run without CUDA unless the caller asks for the CPU."""

import json
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
        assert {"flink_ms_tpu_torch.obs.metrics",
                "flink_ms_tpu_torch.serve.table",
                "flink_ms_tpu_torch.serve.topk",
                "flink_ms_tpu_torch.serve.ann",
                "flink_ms_tpu_torch.serve.microbatch",
                "flink_ms_tpu_torch.eval.mse",
                "flink_ms_tpu_torch.gen.als_model_generator",
                "flink_ms_tpu_torch.gen.svm_model_generator",
                "flink_ms_tpu_torch.serve.journal",
                "flink_ms_tpu_torch.serve.autopilot",
                "flink_ms_tpu_torch.parallel.distributed",
                "flink_ms_tpu_torch.serve.proto",
                "flink_ms_tpu_torch.serve.admission",
                "flink_ms_tpu_torch.serve.server",
                "flink_ms_tpu_torch.serve.consumer",
                "flink_ms_tpu_torch.serve.als_consumer",
                "flink_ms_tpu_torch.serve.svm_consumer",
                "flink_ms_tpu_torch.serve.registry",
                "flink_ms_tpu_torch.serve.client",
                "flink_ms_tpu_torch.serve.producer",
                "flink_ms_tpu_torch.serve.als_producer",
                "flink_ms_tpu_torch.serve.svm_producer",
                "flink_ms_tpu_torch.obs.tracing",
                "flink_ms_tpu_torch.eval.mean_vector",
                "flink_ms_tpu_torch.online.sgd",
                "flink_ms_tpu_torch.client.common",
                "flink_ms_tpu_torch.client.als_predict",
                "flink_ms_tpu_torch.client.als_predict_random",
                "flink_ms_tpu_torch.client.als_topk",
                "flink_ms_tpu_torch.serve.push",
                "flink_ms_tpu_torch.serve.snapshot",
                "flink_ms_tpu_torch.serve.compact",
                "flink_ms_tpu_torch.client.svm_predict",
                "flink_ms_tpu_torch.client.svm_predict_random",
                "flink_ms_tpu_torch.client.range_partition_svm_predict",
                "flink_ms_tpu_torch.serve.sharded",
                "flink_ms_tpu_torch.serve.ha",
                "flink_ms_tpu_torch.serve.elastic",
                "flink_ms_tpu_torch.serve.update_plane",
                "flink_ms_tpu_torch.obs.scrape",
                "flink_ms_tpu_torch.serve.native_store",
                "flink_ms_tpu_torch.serve.arena",
                "flink_ms_tpu_torch.native._build",
                "flink_ms_tpu_torch.obs.tsdb",
                "flink_ms_tpu_torch.obs.slo",
                "flink_ms_tpu_torch.obs.rules",
                "flink_ms_tpu_torch.obs.watch",
                "flink_ms_tpu_torch.serve.rollout",
                "flink_ms_tpu_torch.obs.profdiff",
                "flink_ms_tpu_torch.obs.forensics",
                "flink_ms_tpu_torch.obs.profiler",
                "flink_ms_tpu_torch.obs.workload",
                "flink_ms_tpu_torch.serve.georepl",
                "flink_ms_tpu_torch.serve.edge"
                } <= set(names)
        from flink_ms_tpu_torch.serve import autopilot
        assert {"AutopilotController", "main", "retrain_candidate"} <= \
            set(vars(autopilot))
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
    assert int(n) >= 73  # every module of the port was imported
    assert bad == "[]"


def test_serving_clis_load_no_jax(tmp_path):
    """The serving job's CLI (and the other CLIs of the serving loop and
    of the fleet), run as ``python -m`` would run them: on this host
    without CUDA the job stops at its device, before any socket, and the
    fleet's launchers raise with their worker's exit code, having loaded
    no JAX."""
    code = textwrap.dedent(f"""
        import runpy, sys
        fleet = ["--journalDir", {str(tmp_path)!r}, "--topic", "t",
                 "--portDir", {str(tmp_path / "ports")!r}]
        runs = [("flink_ms_tpu_torch.serve.als_consumer",
                 ["--journalDir", {str(tmp_path)!r}, "--topic", "t",
                  "--port", "0", "--device", "cuda"]),
                ("flink_ms_tpu_torch.serve.als_producer", []),
                ("flink_ms_tpu_torch.eval.mean_vector", []),
                ("flink_ms_tpu_torch.online.sgd", []),
                ("flink_ms_tpu_torch.client.als_predict_random", []),
                ("flink_ms_tpu_torch.serve.compact", []),
                ("flink_ms_tpu_torch.client.svm_predict_random", []),
                ("flink_ms_tpu_torch.client.range_partition_svm_predict",
                 []),
                ("flink_ms_tpu_torch.serve.sharded", fleet + [
                    "--workerIndex", "0", "--numWorkers", "2"]),
                ("flink_ms_tpu_torch.serve.ha", fleet + [
                    "--numWorkers", "1", "--replication", "1"]),
                ("flink_ms_tpu_torch.serve.elastic", fleet + [
                    "--shards", "1"])]
        errors = []
        for mod, argv in runs:
            sys.argv = [mod] + argv
            try:
                runpy.run_module(mod, run_name="__main__")
            except Exception as e:
                errors.append(type(e).__name__ + ": " + str(e)[:60])
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "flink_ms_tpu" or m.startswith("flink_ms_tpu."))
        print(errors[0])
        print(" | ".join(errors[-3:]))
        print(len(errors), bad)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, fleet, last = out.stdout.strip().splitlines()[-3:]
    assert first.startswith("RuntimeError: device 'cuda' was asked for")
    # the fleet's worker stops at its device; both launchers raise with
    # the exit code of the worker they spawned (it stopped at its device)
    sharded, ha, elastic = fleet.split(" | ")
    assert sharded.startswith("RuntimeError: device 'cuda' was asked for")
    assert ha.startswith("RuntimeError: replica s0r0 died at spawn rc=1")
    assert elastic.startswith("RuntimeError: replica s0r0 died at spawn")
    assert last == "11 []"


def test_module_list_equals_the_reference():
    """Every module of the JAX package has its counterpart in the port,
    under the same path, but the Pallas solve, which the port has as
    ``ops/cholesky.py`` (with its CUDA source)."""
    def modules(pkg):
        root = os.path.join(ROOT, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith(".py") and "__pycache__" not in d}

    ref, port = modules("flink_ms_tpu"), modules("flink_ms_tpu_torch")
    assert ref - port == {"ops/cholesky_pallas.py"}
    assert "ops/cholesky.py" in port
    assert {"serve/georepl.py", "serve/edge.py"} <= port


def test_edge_cli_serves_and_drains_without_jax(tmp_path):
    """``python -m flink_ms_tpu_torch.serve.edge`` writes its port file,
    answers PING, registers under the group's edge namespace and exits 0
    on SIGTERM, having loaded neither JAX nor torch (it owns no
    device)."""
    import signal
    import socket
    import time

    reg = str(tmp_path / "registry")
    pf = str(tmp_path / "edge.port")
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               TPUMS_REGISTRY_DIR=reg)
    code = textwrap.dedent("""
        import runpy, sys, atexit
        def report():
            bad = sorted(m for m in sys.modules
                         if m == "jax" or m.startswith(("jax.", "jaxlib"))
                         or m == "flink_ms_tpu"
                         or m.startswith("flink_ms_tpu."))
            print("loaded", bad, "torch" in sys.modules, flush=True)
        atexit.register(report)
        sys.argv = ["edge", "--group", "g", "--portFile", sys.argv[1]]
        runpy.run_module("flink_ms_tpu_torch.serve.edge",
                         run_name="__main__")
    """)
    proc = subprocess.Popen([sys.executable, "-c", code, pf], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        while not os.path.exists(pf):
            assert proc.poll() is None and time.time() < deadline
            time.sleep(0.05)
        with open(pf) as f:
            port = int(f.read())
        with socket.create_connection(("127.0.0.1", port), 10) as sock:
            sock.sendall(b"PING\n")
            assert sock.recv(4096).startswith(b"PONG")
        entries = [json.load(open(os.path.join(reg, n)))
                   for n in os.listdir(reg) if n.endswith(".json")]
        assert [e.get("replica_of") for e in entries] == ["edge/g"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    # nor torch: a proxy is host code, and starts without the import
    assert out.strip().splitlines()[-1] == "loaded [] False"


def test_loop_clis_load_no_jax(tmp_path):
    """The closed loop's CLIs, run as ``python -m`` would run them, load no
    JAX: without CUDA the autopilot stops at its device before any file,
    the rollout's worker stops at its device (its supervisor raises, as
    the reference's does), and the status and scrape CLIs answer."""
    code = textwrap.dedent(f"""
        import runpy, sys
        runs = [("flink_ms_tpu_torch.serve.autopilot",
                 ["--group", "g", "--ratingsDir", {str(tmp_path / "bus")!r},
                  "--workDir", {str(tmp_path / "work")!r}, "--once"]),
                ("flink_ms_tpu_torch.serve.rollout",
                 ["--group", "g", "--journalDir", {str(tmp_path)!r},
                  "--portDir", {str(tmp_path / "ports")!r},
                  "--readyTimeoutS", "60"]),
                ("flink_ms_tpu_torch.serve.rollout", ["--group", "g",
                                                      "--status"]),
                ("flink_ms_tpu_torch.obs.scrape", ["--prom"])]
        out = []
        for mod, argv in runs:
            sys.argv = [mod] + argv
            try:
                runpy.run_module(mod, run_name="__main__")
            except SystemExit as e:
                out.append(f"exit {{e.code}}")
            except Exception as e:
                out.append(type(e).__name__ + ": " + str(e)[:60])
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "flink_ms_tpu" or m.startswith("flink_ms_tpu."))
        print(" | ".join(out))
        print(bad)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               TPUMS_REGISTRY_DIR=str(tmp_path / "registry"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    runs, bad = out.stdout.strip().splitlines()[-2:]
    pilot, rollout, status, scrape = runs.split(" | ")
    assert pilot.startswith("RuntimeError: device 'cuda' was asked for")
    assert not os.path.exists(tmp_path / "work")
    assert rollout.startswith("RuntimeError: replica s0r0 died at spawn")
    assert (status, scrape) == ("exit 0", "exit 0")
    assert bad == "[]"


def test_native_library_is_the_ports_own_build():
    """The port's native library is its own build of its own sources,
    under ``build/native/``, never the JAX package's ``native/``; no
    module of the port (nor ``chip_smoke.py``) names the JAX package's
    ``native/libtpums.so`` or its Makefile."""
    from flink_ms_tpu_torch.native import _build
    from flink_ms_tpu_torch.serve import native_store

    build_dir = os.path.join(ROOT, "build", "native")
    for variant in _build.VARIANTS:
        path = str(_build.library_path(variant))
        assert os.path.dirname(path) == build_dir
        assert os.path.basename(path).startswith("libtpums")
    assert set(_build.SOURCES) | set(_build.HEADERS) == {
        "store.cpp", "lookup_server.cpp", "arena.cpp", "tpums.h",
        "tpums_internal.h"}
    assert all((_build.SRC_DIR / n).is_file()
               for n in _build.SOURCES + _build.HEADERS)
    assert _build.CXXFLAGS == ("-O2", "-std=c++17", "-fPIC", "-Wall",
                               "-Wextra")
    assert _build.LDFLAGS == ("-shared", "-pthread")
    lib = native_store.library_path()
    assert os.path.dirname(lib) == build_dir
    assert os.path.realpath(lib) != os.path.realpath(
        os.path.join(ROOT, "native", "libtpums.so"))
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT,
                                                  "flink_ms_tpu_torch")):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith((".py", ".cpp", ".h"))]
    for path in sources:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert "native/libtpums.so" not in text, path
        assert "make -C native" not in text, path


def test_spawned_ranks_load_no_jax():
    """A rank that ``launch_local`` spawns imports the port's worker entry
    points (the CLIs' and phase 16's) and nothing of JAX: the test process
    has JAX loaded, and a spawned child starts from a fresh interpreter."""
    from flink_ms_tpu_torch.parallel import distributed as pdist

    loaded = ("(__import__('flink_ms_tpu_torch.train.als_train'), "
              "__import__('flink_ms_tpu_torch.train.svm_train'), "
              "__import__('chip_smoke'), "
              "sorted(__import__('sys').modules))[-1]")
    for names in pdist.launch_local(pdist.run_calls, 2, (
            [(eval, (loaded,), {}, None)],), device="cpu", timeout=120):
        names = names[0]
        assert "flink_ms_tpu_torch.parallel.distributed" in names
        assert "chip_smoke" in names
        bad = [m for m in names
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "flink_ms_tpu" or m.startswith("flink_ms_tpu.")]
        assert bad == []


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


def test_serving_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from flink_ms_tpu_torch.eval import mse
    from flink_ms_tpu_torch.serve.ann import IVFIndex
    from flink_ms_tpu_torch.serve.table import ModelTable
    from flink_ms_tpu_torch.serve.topk import (DeviceFactorIndex,
                                               make_als_topk_handler)

    table = ModelTable()
    table.put("1-I", "1.0;2.0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFactorIndex(table)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_als_topk_handler(table)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IVFIndex.build(np.ones((16, 2), np.float32), nlist=2)
    F.write_lines(str(tmp_path / "m"), ["1,U,1.0;2.0", "1,I,0.5;0.5"])
    F.write_lines(str(tmp_path / "r"), ["u\ti\tr", "1\t1\t3.0"])
    args = ["--input", str(tmp_path / "r"), "--model", str(tmp_path / "m")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mse.run(Params.from_args(args))
    assert mse.run(Params.from_args(args + ["--device", "cpu"])) == 2.25
    handler = make_als_topk_handler(table, device="cpu")
    assert handler.by_vector("1.0;1.0", 1) == "1:3.0"
    handler.close()


def test_generators_and_retrain_raise_without_cuda(no_cuda, tmp_path, rng):
    from flink_ms_tpu_torch.gen import als_model_generator as AG
    from flink_ms_tpu_torch.gen import svm_model_generator as SG
    from flink_ms_tpu_torch.serve.autopilot import retrain_candidate

    als = ["--numUsers", "3", "--numItems", "2", "--latentFactors", "2",
           "--parallelism", "1", "--output", str(tmp_path / "als")]
    svm = ["--numFeatures", "5", "--range", "2", "--parallelism", "1",
           "--output", str(tmp_path / "svm")]
    for mod, args in ((AG, als), (SG, svm)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.run(Params.from_args(args))
        # the parallel path draws with numpy, and still asks for the device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.run(Params.from_args(args + ["--parallelism", "2"]))
        assert not os.path.exists(args[-1])
        mod.run(Params.from_args(args + ["--device", "cpu"]))
        assert os.path.exists(args[-1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AG.generate_rows(3, "U", 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SG.generate_bucket_rows(5, 2)
    u = rng.integers(1, 10, 80)
    i = rng.integers(1, 8, 80)
    r = rng.uniform(1, 5, 80)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        retrain_candidate(str(tmp_path / "work"), "models", 0, 1, u, i, r)
    assert not os.path.exists(tmp_path / "work")
    cand = retrain_candidate(str(tmp_path / "work"), "models", 0, 1, u, i, r,
                             device="cpu")
    assert cand["model_id"] == "auto-v000001"


def test_staged_fit_raises_without_cuda(no_cuda, tmp_path, rng):
    u = rng.integers(0, 10, 50)
    i = rng.integers(0, 8, 50)
    r = rng.uniform(1, 5, 50)
    cfg = TA.ALSConfig(num_factors=3, iterations=2)
    stage = str(tmp_path / "stage")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.als_fit(u, i, r, cfg, temporary_path=stage)
    assert not os.path.exists(stage)
    TA.als_fit(u, i, r, cfg, device="cpu", temporary_path=stage)
    assert sorted(os.listdir(stage)) == ["iter_00001.npz", "iter_00002.npz"]


def test_chip_smoke_alone_exits_nonzero_and_prints_no_result(tmp_path):
    """Run from a directory that holds chip_smoke.py and nothing else of
    the repo, with CUDA made to look available, the script stops at its
    import of the port (exit 1) before it prints any result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert out.stdout == ""
    assert "No module named 'flink_ms_tpu_torch'" in out.stderr


def test_observability_clis_load_no_jax(tmp_path):
    """The observability CLIs, run as ``python -m`` would run them, load no
    JAX: the profiler's fleet merge, forensics over a spill and the watch
    loop's one tick answer over an empty registry; without CUDA the
    rehearsal stops at its device before it spawns a member."""
    spill = tmp_path / "spill.jsonl"
    spill.write_text('{"ts": 1.0, "tid": "t", "kind": "client_rpc", '
                     '"sid": "a", "t0": 0.5, "dur_s": 0.5}\n')
    code = textwrap.dedent(f"""
        import runpy, sys
        runs = [("flink_ms_tpu_torch.obs.profiler", ["--fleet"]),
                ("flink_ms_tpu_torch.obs.forensics", [{str(spill)!r}]),
                ("flink_ms_tpu_torch.obs.watch", ["--once"]),
                ("flink_ms_tpu_torch.obs.workload",
                 ["--rehearsal", "--out", {str(tmp_path / "r.json")!r}])]
        out = []
        for mod, argv in runs:
            sys.argv = [mod] + argv
            try:
                runpy.run_module(mod, run_name="__main__")
            except SystemExit as e:
                out.append(f"exit {{e.code}}")
            except Exception as e:
                out.append(type(e).__name__ + ": " + str(e)[:60])
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "flink_ms_tpu" or m.startswith("flink_ms_tpu."))
        print(" | ".join(out))
        print(bad)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               TPUMS_REGISTRY_DIR=str(tmp_path / "registry"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    runs, bad = out.stdout.strip().splitlines()[-2:]
    prof, fx, watch, rehearsal = runs.split(" | ")
    assert (prof, fx, watch) == ("exit 0", "exit 0", "exit 0")
    assert rehearsal.startswith("RuntimeError: device 'cuda' was asked for")
    assert not os.path.exists(tmp_path / "r.json")
    assert bad == "[]"
