"""Steps 3-8 of ``scripts/e2e_demo.sh`` in the port on the CPU, beside the
same steps in the JAX package: mean vectors, publish, the serving job (a
thread on port 0, through the consumer CLI's own path), the random-load
latency harness, the live MSE, online SGD closing the loop, and the live
MSE again.  The model files are injected (the same for both), so training
noise is out of it; SGD runs as one batch, so its rows do not depend on
when the job ingests the previous ones."""

import os
import shutil
import time

import numpy as np
import pytest

from flink_ms_tpu.client import als_predict_random as R_harness
from flink_ms_tpu.core import formats as RF
from flink_ms_tpu.core.params import Params as RefParams
from flink_ms_tpu.eval import mean_vector as R_mean
from flink_ms_tpu.eval import mse as R_mse
from flink_ms_tpu.online import sgd as R_sgd
from flink_ms_tpu.serve import consumer as R_consumer
from flink_ms_tpu.serve import producer as R_producer
from flink_ms_tpu_torch.client import als_predict_random as P_harness
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.eval import mean_vector as P_mean
from flink_ms_tpu_torch.eval import mse as P_mse
from flink_ms_tpu_torch.online import sgd as P_sgd
from flink_ms_tpu_torch.serve import consumer as P_consumer
from flink_ms_tpu_torch.serve import producer as P_producer

PORT_MODS = (Params, P_mean, P_producer, P_consumer, P_harness, P_mse, P_sgd)
REF_MODS = (RefParams, R_mean, R_producer, R_consumer, R_harness, R_mse,
            R_sgd)


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    monkeypatch.setenv("TPUMS_SNAPSHOTS", "0")


def _inputs(work):
    """The demo's synthetic ratings and fresh updates, and injected model
    files of its shape (50 users x 40 items, rank 8)."""
    rng = np.random.default_rng(42)
    n = 2000
    users = rng.integers(0, 50, n)
    items = rng.integers(0, 40, n)
    uf = rng.normal(size=(50, 4))
    vf = rng.normal(size=(40, 4))
    ratings = (uf[users] * vf[items]).sum(1) + rng.normal(scale=0.1, size=n)
    with open(os.path.join(work, "ratings.tsv"), "w") as f:
        f.write("user\titem\trating\n")
        for u, i, r in zip(users, items, ratings):
            f.write(f"{u}\t{i}\t{r:.4f}\n")
    m = 500
    uu = rng.integers(0, 50, m)
    ii = rng.integers(0, 40, m)
    rr = (uf[uu] * vf[ii]).sum(1) + rng.normal(scale=0.1, size=m)
    with open(os.path.join(work, "updates.tsv"), "w") as f:
        for u, i, r in zip(uu, ii, rr):
            f.write(f"{u}\t{i}\t{r:.4f}\n")
    os.makedirs(os.path.join(work, "model"))
    RF.write_als_model(os.path.join(work, "model", "userFactors"),
                       np.arange(50), "U", rng.normal(size=(50, 8)) * 0.4)
    RF.write_als_model(os.path.join(work, "model", "itemFactors"),
                       np.arange(40), "I", rng.normal(size=(40, 8)) * 0.4)


def _demo(work, mods, job_id, extra_job_args):
    P, mean, producer, consumer, harness, mse, sgd = mods
    w = lambda *p: os.path.join(work, *p)  # noqa: E731
    for side, out in (("user", "meanU"), ("item", "meanI")):
        mean.run(P.from_args(["--type", side, "--input",
                              w("model", f"{side}Factors"),
                              "--output", w("model", out)]))
    n = producer.run(P.from_args(["--input", w("model"), "--journalDir",
                                  w("journal"), "--topic", "als-model"]))
    assert n == 92
    job = consumer._run_consumer_cli(P.from_args(
        ["--journalDir", w("journal"), "--topic", "als-model",
         "--stateBackend", "fs", "--checkpointDataUri", w("ckpt"),
         "--host", "127.0.0.1", "--port", "0", "--jobId", job_id]
        + extra_job_args), consumer.ALS_STATE, consumer.parse_als_record)
    try:
        assert job.wait_ready(60)
        endpoint = ["--jobId", job_id]
        assert harness.run(P.from_args(
            endpoint + ["--numQueries", "200", "--lowerUserId", "0",
                        "--upperUserId", "49", "--lowerItemId", "0",
                        "--upperItemId", "39", "--outputFile",
                        w("latency.csv")])) == 200
        before = mse.run(P.from_args(["--input", w("ratings.tsv"),
                                      "--output", w("mse_before.txt")]
                                     + endpoint))
        assert sgd.run(P.from_args(
            ["--input", w("updates.tsv"), "--mode", "once", "--outputMode",
             "kafka", "--journalDir", w("journal"), "--topic", "als-model",
             "--learningRate", "0.05", "--batchSize", "1000"]
            + endpoint)) == 500
        end = P_consumer.Journal(w("journal"), "als-model").end_offset()
        deadline = time.monotonic() + 60
        while job.offset < end and time.monotonic() < deadline:
            time.sleep(0.02)
        assert job.offset == end
        after = mse.run(P.from_args(["--input", w("ratings.tsv"),
                                     "--output", w("mse_after.txt")]
                                    + endpoint))
    finally:
        job.stop()
    with open(w("latency.csv")) as f:
        latency = [line.rstrip("\n").split(",") for line in f]
    return before, after, latency


def test_steps_3_to_8_equal_the_reference_demo(tmp_path):
    base = str(tmp_path / "base")
    os.makedirs(base)
    _inputs(base)
    port_w, ref_w = str(tmp_path / "port"), str(tmp_path / "ref")
    shutil.copytree(base, port_w)
    shutil.copytree(base, ref_w)
    p = _demo(port_w, PORT_MODS, "demo-port", ["--device", "cpu"])
    r = _demo(ref_w, REF_MODS, "demo-ref", ["--snapshots", "false"])
    assert p[0] == pytest.approx(r[0], rel=1e-9)
    assert p[1] == pytest.approx(r[1], rel=1e-9)
    assert p[1] < p[0]  # the online updates lowered the error
    # the latency CSV: the reference's columns, uId,iId,prediction,ms
    assert len(p[2]) == len(r[2]) == 200
    for row in p[2]:
        assert len(row) == 4
        assert 0 <= int(row[0]) < 49 and 0 <= int(row[1]) < 39
        float(row[2])
        assert int(row[3]) >= 0
    # the served table after the loop is the reference's
    with open(os.path.join(port_w, "journal", "als-model.log"), "rb") as a, \
            open(os.path.join(ref_w, "journal", "als-model.log"), "rb") as b:
        assert a.read() == b.read()
