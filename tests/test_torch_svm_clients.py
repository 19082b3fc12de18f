"""The port's SVM clients against the JAX package's, on the CPU: the REPL
client, the per-feature random harness and the range-partitioned harness
of each package, against the SVM serving job of each package.  A
recording proxy between client and job captures the request bytes, which
must be equal; the printed output and the CSV rows must be equal too,
apart from the measured milliseconds.  The harnesses draw their vectors
from ``numpy.random.default_rng``, seeded here the same way for both."""

import functools
import io
import socket
import sys
import threading

import numpy as np
import pytest

from flink_ms_tpu.client import range_partition_svm_predict as R_range
from flink_ms_tpu.client import svm_predict as R_repl
from flink_ms_tpu.client import svm_predict_random as R_random
from flink_ms_tpu.core import formats as RF
from flink_ms_tpu.core.params import Params as RefParams
from flink_ms_tpu.serve import consumer as RC
from flink_ms_tpu.serve import journal as RJ
from flink_ms_tpu.serve.client import QueryClient as RefClient
from flink_ms_tpu_torch.client import range_partition_svm_predict as P_range
from flink_ms_tpu_torch.client import svm_predict as P_repl
from flink_ms_tpu_torch.client import svm_predict_random as P_random
from flink_ms_tpu_torch.core import formats as PF
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.serve import consumer as PC
from flink_ms_tpu_torch.serve import journal as PJ
from flink_ms_tpu_torch.serve.client import QueryClient as PortClient

N_FEATURES = 60
RANGE = 10
CLIENTS = {"reference": (R_repl, R_random, R_range, RefParams, RefClient),
           "port": (P_repl, P_random, P_range, Params, PortClient)}


class _Proxy:
    """TCP forwarder that records every byte a client sends."""

    def __init__(self, port):
        self.target = port
        self.sent = bytearray()
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(8)
        self.port = self._lsock.getsockname()[1]
        self._lock = threading.Lock()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            up = socket.create_connection(("127.0.0.1", self.target))
            threading.Thread(target=self._pipe, args=(conn, up, True),
                             daemon=True).start()
            threading.Thread(target=self._pipe, args=(up, conn, False),
                             daemon=True).start()

    def _pipe(self, src, dst, record):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                if record:
                    with self._lock:
                        self.sent += data
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        self._lsock.close()


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "registry"))
    monkeypatch.delenv("TPUMS_PROTO", raising=False)
    real = np.random.default_rng
    # the harnesses seed nothing: every call draws the same stream here
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(11 if seed is None else seed))


def _weights():
    rng = np.random.default_rng(3)
    w = rng.normal(size=N_FEATURES + 1)
    w[[7, 23, 41]] = 0.0
    return w


def _start_job(kind, d, rows):
    PJ.Journal(d, "svm").append(rows)
    if kind == "reference":
        job = RC.ServingJob(RJ.Journal(d, "svm"), RC.SVM_STATE,
                            RC.parse_svm_record, RC.MemoryStateBackend(),
                            host="127.0.0.1", port=0, snapshots=False)
    else:
        job = PC.ServingJob(PJ.Journal(d, "svm"), PC.SVM_STATE,
                            PC.parse_svm_record, PC.MemoryStateBackend(),
                            host="127.0.0.1", port=0)
    job.start()
    assert job.wait_ready(30)
    return job


@pytest.fixture(params=["reference", "port"])
def svm_job(request, tmp_path):
    """A started SVM job of either package serving the flat model
    (``featureIndex,weight`` rows), features 31-33 left out."""
    rows = list(RF.format_svm_flat_rows(_weights()))
    del rows[30:33]
    job = _start_job(request.param, str(tmp_path / "flat"), rows)
    yield job
    job.stop()


@pytest.fixture(params=["reference", "port"])
def range_job(request, tmp_path):
    """A started SVM job of either package serving the range-partitioned
    model (``bucket,idx:w;...`` rows), bucket 3 left out."""
    rows = [r for r in RF.format_svm_range_rows(_weights(), RANGE)
            if not r.startswith("3,")]
    job = _start_job(request.param, str(tmp_path / "range"), rows)
    yield job
    job.stop()


def _through_proxy(job, fn):
    proxy = _Proxy(job.port)
    try:
        out = fn(proxy.port)
    finally:
        proxy.close()
    return out, bytes(proxy.sent)


@pytest.mark.parametrize("decision,threshold", [(False, 0.0), (True, 0.0),
                                                (False, 0.75)])
def test_repl_client_equals_the_reference(svm_job, decision, threshold):
    job = svm_job
    lines = ["1:1.0 2:2.0", "31:0.5 5:-1.5", "999:1.0", "", "3:x",
             "10:0.25 11:0.25 12:0.25"]
    got = {}
    for name, (repl, _, _, _, Client) in CLIENTS.items():
        def run(port):
            out = io.StringIO()
            with Client("127.0.0.1", port) as c:
                repl.run(c, lines, decision, threshold, out=out)
            return out.getvalue()

        got[name] = _through_proxy(job, run)
    assert got["port"] == got["reference"]
    text, sent = got["port"]
    assert "Could not find the value for feature ID: 31" in text
    assert text.count("SVM Prediction =") == 4
    assert sent.count(b"GET\tSVM_MODEL\t") == 9
    for raw in (-2.0, 0.0, 0.5, 3.25):
        assert P_repl.decide(raw, decision, threshold) == R_repl.decide(
            raw, decision, threshold)


def test_repl_main_reads_stdin_like_the_reference(svm_job, monkeypatch,
                                                 capsys):
    job = svm_job
    got = {}
    for name, (repl, *_rest) in CLIENTS.items():
        # ``run`` bound sys.stdout as its default when it was imported
        out = io.StringIO()
        monkeypatch.setattr(repl, "run", functools.partial(repl.run,
                                                           out=out))
        monkeypatch.setattr(sys, "stdin", io.StringIO("1:1.0 2:2.0\n"))
        repl.main(["svm-job", "127.0.0.1", str(job.port), "true", "0.5"])
        got[name] = (capsys.readouterr().out, out.getvalue())
    assert got["port"] == got["reference"]
    assert "SVM Prediction =" in got["port"][1]


def _csv(path):
    with open(path) as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    assert all(len(r) == 4 and float(r[3]) >= 0 for r in rows)
    return [r[:3] for r in rows]


@pytest.mark.parametrize("decision", ["false", "true"])
def test_random_harness_equals_the_reference(svm_job, tmp_path, capsys,
                                             decision):
    job = svm_job
    got = {}
    for name, (_, harness, _, P, _) in CLIENTS.items():
        out = str(tmp_path / f"{name}.csv")

        def run(port):
            return harness.run(P.from_args(
                ["--jobManagerPort", str(port), "--jobId", "svm-job",
                 "--numQueries", "40", "--maxNoOfFeatures", str(N_FEATURES),
                 "--minPercentageOfFeatures", "10",
                 "--outputDecisionFunction", decision,
                 "--outputFile", out]))

        n, sent = _through_proxy(job, run)
        got[name] = (n, sent, _csv(out), capsys.readouterr().out)
    assert got["port"] == got["reference"]
    n, sent, rows, printed = got["port"]
    assert n == 40 and len(rows) == 40
    assert "Feature 31 do not exist in the model." in printed
    if decision == "false":
        assert {r[2] for r in rows} <= {"1.0", "-1.0"}


@pytest.mark.parametrize("server_dot", ["true", "false"])
def test_range_harness_equals_the_reference(range_job, tmp_path, capsys,
                                            server_dot):
    job = range_job
    w = _weights()
    got = {}
    for name, (_, _, harness, P, _) in CLIENTS.items():
        out = str(tmp_path / f"{name}.csv")

        def run(port):
            return harness.run(P.from_args(
                ["--jobManagerPort", str(port), "--jobId", "svm-job",
                 "--numQueries", "30", "--maxNoOfFeatures", str(N_FEATURES),
                 "--minPercentageOfFeatures", "20", "--range", str(RANGE),
                 "--outputDecisionFunction", "true",
                 "--serverDot", server_dot, "--outputFile", out]))

        n, sent = _through_proxy(job, run)
        got[name] = (n, sent, _csv(out), capsys.readouterr().out)
    assert got["port"] == got["reference"]
    n, sent, rows, printed = got["port"]
    assert n == 30
    assert "The current Range of Keys 3 do not exist in the model." in \
        printed
    verb = b"DOT\tSVM_MODEL\t" if server_dot == "true" else \
        b"GET\tSVM_MODEL\t"
    assert sent.count(verb) >= 30
    # the predictions are the float64 dots of the drawn vectors with w
    rng = np.random.default_rng()
    for row in rows:
        vec = R_random.random_sparse_vector(rng, N_FEATURES, 20)
        want = sum(w[f - 1] * v for f, v in vec.items() if f // RANGE != 3)
        assert float(row[2]) == pytest.approx(want, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("partitioned", [False, True])
def test_read_svm_model_equals_the_reference(tmp_path, partitioned):
    """The port's ``read_svm_model`` reads flat and range-partitioned SVM
    rows (repeated indices: the last row wins) into the reference's dense
    vector, exactly, with and without a wider ``n_features``."""
    rng = np.random.default_rng(7 + partitioned)
    w = np.where(rng.random(40) < 0.6, rng.normal(size=40), 0.0)
    rows = (list(RF.format_svm_range_rows(w, 6)) if partitioned
            else list(RF.format_svm_flat_rows(w)))
    rows += rows[:3]
    path = str(tmp_path / "model")
    with open(path, "w") as f:
        f.write("".join(r + "\n" for r in rows))
    for nf in (0, 40, 55):
        got = PF.read_svm_model(path, n_features=nf, partitioned=partitioned)
        want = RF.read_svm_model(path, n_features=nf, partitioned=partitioned)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
