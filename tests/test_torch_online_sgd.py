"""The port's online SGD updater against the JAX package's: the same
lookups give the same rows byte for byte (v0, v1 and the bias rows, per
rating and batched), and ``run --mode once --outputMode kafka`` of each
package against one served table appends identical journal lines."""

import os

import numpy as np
import pytest

from flink_ms_tpu.core.params import Params as RefParams
from flink_ms_tpu.online import sgd as RS
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.online import sgd as PS
from flink_ms_tpu_torch.serve import consumer as PC
from flink_ms_tpu_torch.serve import journal as PJ

STATE = "ALS_MODEL"


def _pay(v):
    return ";".join(repr(float(x)) for x in v)


def _table(seed=0, k=5, bias=False):
    rng = np.random.default_rng(seed)
    t = {f"{u}-U": _pay(rng.normal(size=k)) for u in range(8)}
    t.update({f"{i}-I": _pay(rng.normal(size=k)) for i in range(6)})
    t["3-I"] = "nan;" + _pay(rng.normal(size=k - 1))  # a NaN row
    return t


def _ratings(seed=1, n=60):
    rng = np.random.default_rng(seed)
    # ids past the table's exercise the MEAN cold start; repeats exercise
    # the carry-forward cache across duplicate-free runs
    return [(int(rng.integers(0, 11)), int(rng.integers(0, 8)),
             float(rng.uniform(1, 5))) for _ in range(n)]


@pytest.mark.parametrize("version", ["v1", "v0"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_rows_equal_the_reference_byte_for_byte(version, bias, batched):
    table = _table()
    means = (_pay(np.full(5, 0.1)), _pay(np.full(5, -0.2)))
    kw = dict(learning_rate=0.05, user_reg=0.01, item_reg=0.02,
              version=version, update_bias=bias)
    steps = []
    for mod in (PS, RS):
        many = (lambda keys: [table.get(k) for k in keys]) if batched \
            else None
        steps.append(mod.SGDStep(table.get, *means, lookup_many=many, **kw))
    port, ref = steps
    ratings = _ratings()
    got = [port.process(*r) for r in ratings[:10]]
    want = [ref.process(*r) for r in ratings[:10]]
    assert got == want
    for size in (1, 7, 60):
        for s in range(0, len(ratings), size):
            chunk = ratings[s:s + size]
            assert port.process_batch(chunk) == ref.process_batch(chunk)
    assert port.nan_records == ref.nan_records
    if version == "v0":
        assert port.nan_records > 0
    if batched:
        assert port.vectorized_chunks == ref.vectorized_chunks > 0


def test_stream_ratings_equals_the_reference(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    (d / "a.tsv").write_text("1\t2\t3.5\n4\t5\t1.0")
    (d / "_skip").write_text("9\t9\t9\n")
    (d / "b.tsv").write_text("\n7\t8\t2.25\n")
    for mode in ("once",):
        assert list(PS.stream_ratings(str(d), mode, 10, "\t")) == list(
            RS.stream_ratings(str(d), mode, 10, "\t"))
    with pytest.raises(ValueError, match="Invalid mode"):
        list(PS.stream_ratings(str(d), "sometimes", 10, "\t"))


@pytest.mark.parametrize("batch", ["1", "16"])
def test_run_once_kafka_appends_the_reference_lines(tmp_path, batch):
    table = _table(seed=3)
    rows = [f"{k[:-2]},{k[-1]},{v}" for k, v in table.items()]
    rows += [f"MEAN,U,{_pay(np.full(5, 0.5))}",
             f"MEAN,I,{_pay(np.full(5, 0.25))}"]
    d = str(tmp_path / "serving")
    PJ.Journal(d, "t").append(rows)
    job = PC.ServingJob(PJ.Journal(d, "t"), STATE, PC.parse_als_record,
                        PC.MemoryStateBackend(), host="127.0.0.1", port=0,
                        job_id="sgd-job", topk_index=False).start()
    assert job.wait_ready(30)
    inp = tmp_path / "updates.tsv"
    inp.write_text("".join(f"{u}\t{i}\t{r}\n" for u, i, r in _ratings(4, 40)))
    try:
        out = {}
        for name, mod, P in (("port", PS, Params), ("ref", RS, RefParams)):
            jd = str(tmp_path / f"out-{name}")
            args = ["--input", str(inp), "--mode", "once", "--outputMode",
                    "kafka", "--journalDir", jd, "--topic", "t",
                    "--jobId", "sgd-job", "--learningRate", "0.05",
                    "--batchSize", batch]
            assert mod.run(P.from_args(args)) == 40
            with open(os.path.join(jd, "t.log"), "rb") as f:
                out[name] = f.read()
        assert out["port"] == out["ref"]
        assert out["port"].count(b"\n") == 80
    finally:
        job.stop()


def test_group_rides_the_elastic_client(tmp_path):
    """``--group`` resolves an elastic topology group through the port's
    ElasticClient (it used to be refused): against the 2-shard generation
    of a group, the run appends the same lines as the reference's run
    with ``--group`` and as the port's run with ``--jobId`` against one
    job serving the whole table."""
    from flink_ms_tpu.serve import registry as RR
    from flink_ms_tpu_torch.serve import sharded as PSH

    table = _table(seed=5)
    rows = [f"{k[:-2]},{k[-1]},{v}" for k, v in table.items()]
    rows += [f"MEAN,U,{_pay(np.full(5, 0.5))}",
             f"MEAN,I,{_pay(np.full(5, 0.25))}"]
    d = str(tmp_path / "serving")
    PJ.Journal(d, "t").append(rows)
    jobs = [PC.ServingJob(
        PJ.Journal(d, "t"), STATE, PSH.sharded_parse(PC.parse_als_record,
                                                     s, 2),
        PC.MemoryStateBackend(), host="127.0.0.1", port=0,
        job_id=f"sg@g1:s{s}r0", replica_of=f"sg@g1/shard-{s}",
        replica_index=0, topology_group="sg", generation=1,
        topk_index=False).start() for s in range(2)]
    jobs.append(PC.ServingJob(PJ.Journal(d, "t"), STATE, PC.parse_als_record,
                              PC.MemoryStateBackend(), host="127.0.0.1",
                              port=0, job_id="sgd-one",
                              topk_index=False).start())
    inp = tmp_path / "updates.tsv"
    inp.write_text("".join(f"{u}\t{i}\t{r}\n" for u, i, r in _ratings(6, 40)))
    try:
        for job in jobs:
            assert job.wait_ready(30)
        RR.publish_topology("sg", 2)
        out = {}
        for name, mod, P, target in (
                ("port", PS, Params, ["--group", "sg"]),
                ("ref", RS, RefParams, ["--group", "sg"]),
                ("port-job", PS, Params, ["--jobId", "sgd-one"])):
            jd = str(tmp_path / f"out-{name}")
            args = ["--input", str(inp), "--mode", "once", "--outputMode",
                    "kafka", "--journalDir", jd, "--topic", "t",
                    "--learningRate", "0.05", "--batchSize", "8"] + target
            assert mod.run(P.from_args(args)) == 40
            with open(os.path.join(jd, "t.log"), "rb") as f:
                out[name] = f.read()
        assert out["port"] == out["ref"] == out["port-job"]
        assert out["port"].count(b"\n") == 80
    finally:
        for job in jobs:
            job.stop()
