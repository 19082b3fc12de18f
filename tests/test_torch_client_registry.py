"""The port's query client, job registry and B2 codec against the JAX
package's: each client against the other package's serving job gives the
results of the same package's pairing, registry entries are the same JSON
and each package resolves the other's job by id, and the frames are the
reference's bytes."""

import json
import os

import numpy as np
import pytest

from flink_ms_tpu.core.params import Params as RefParams
from flink_ms_tpu.serve import client as RCL
from flink_ms_tpu.serve import consumer as RC
from flink_ms_tpu.serve import journal as RJ
from flink_ms_tpu.serve import proto as RP
from flink_ms_tpu.serve import registry as RR
from flink_ms_tpu_torch.core.params import Params
from flink_ms_tpu_torch.serve import client as PCL
from flink_ms_tpu_torch.serve import consumer as PC
from flink_ms_tpu_torch.serve import journal as PJ
from flink_ms_tpu_torch.serve import proto as PP
from flink_ms_tpu_torch.serve import registry as PR

STATE = "ALS_MODEL"


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    monkeypatch.setenv("TPUMS_TOPK_TIER", "exact")


def _pay(v):
    return ";".join(repr(float(x)) for x in v)


@pytest.fixture
def jobs(tmp_path):
    rng = np.random.default_rng(0)
    rows = [f"{u},U,{_pay(v)}" for u, v in
            enumerate(rng.integers(-8, 8, (10, 3)) / 4.0)]
    rows += [f"{i},I,{_pay(v)}" for i, v in
             enumerate(rng.integers(-8, 8, (25, 3)) / 4.0)]
    d = str(tmp_path / "j")
    PJ.Journal(d, "t").append(rows)
    ref = RC.ServingJob(RJ.Journal(d, "t"), STATE, RC.parse_als_record,
                        RC.MemoryStateBackend(), host="127.0.0.1", port=0,
                        job_id="ref-job", snapshots=False).start()
    port = PC.ServingJob(PJ.Journal(d, "t"), STATE, PC.parse_als_record,
                         PC.MemoryStateBackend(), host="127.0.0.1", port=0,
                         job_id="port-job", device="cpu").start()
    assert ref.wait_ready(30) and port.wait_ready(30)
    yield ref, port
    ref.stop()
    port.stop()


def _session(client_mod, port, proto):
    with client_mod.QueryClient("127.0.0.1", port, proto=proto) as c:
        out = [c.ping().split("\t")[2], c.count(STATE),
               c.query_state(STATE, "3-U"), c.query_state(STATE, "nope"),
               c.query_states(STATE, ["1-U", "x", "2-I"]),
               c.topk(STATE, "4", 5), c.topk(STATE, "nobody", 5),
               c.topk_by_vector(STATE, "1.0;0.5;-0.25", 4),
               c.topk_pipelined(STATE, [str(u) for u in range(10)], 3,
                                window=4),
               c.topk_by_vector_pipelined(STATE, ["1;1;1", "0;1;0"], 2),
               c.pipeline([f"GET\t{STATE}\t{u}-U" for u in range(10)], 3),
               c.sparse_dot(STATE, 10, {1: 2.0}),
               c.health(STATE)["keys"], c.metrics()["meta"]["plane"]]
        with pytest.raises(RuntimeError, match="query failed"):
            c.query_state("NOPE", "1-U")
        return out


@pytest.mark.parametrize("proto", ["tab", "b2", "auto"])
def test_each_client_against_each_job(jobs, proto):
    ref, port = jobs
    want = _session(RCL, ref.port, proto)
    assert _session(PCL, ref.port, proto) == want
    assert _session(RCL, port.port, proto) == want
    assert _session(PCL, port.port, proto) == want
    assert want[1] == 35 and want[5] is not None and want[6] is None


def test_refusals_reach_the_reference_client(jobs, tmp_path, monkeypatch):
    """The reference's push client against the port's serving job, and
    the port's push client against the reference's: a B2 HELLO with
    ``su=1`` subscribes in both pairings with the same-package replies;
    what the reference refuses (push over tab, a bad proto) the port
    refuses alike."""
    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "registry"))
    ref, port = jobs
    got = []
    for client_mod, job in ((RCL, port), (PCL, ref), (RCL, ref),
                            (PCL, port)):
        with client_mod.QueryClient("127.0.0.1", job.port, proto="b2",
                                    push=True, timeout_s=10) as c:
            sub = c.subscribe_key(STATE, "3-U")
            job.table.put("3-U", "9.0;9.0;9.0")
            msg = c.next_push(timeout_s=10)
            job.table.put("3-U", sub["snapshot"])  # the journal's value
            c.next_push(timeout_s=10)
            c.unsubscribe(sub["sub_id"])
            got.append((sub["seq"], sub["snapshot"], msg[1:],
                        msg[0] == sub["sub_id"], c.ping()))
    assert got[0][:4] == got[2][:4] == got[1][:4] == got[3][:4]
    assert got[0][2] == (1, "9.0;9.0;9.0") and got[0][3]
    for client_mod in (RCL, PCL):
        with pytest.raises(ValueError, match="needs a B2 connection"):
            client_mod.QueryClient("127.0.0.1", port.port, proto="tab",
                                   push=True)
    with pytest.raises(ValueError, match="proto must be"):
        PCL.QueryClient(proto="b9")


def test_topology_equals_the_reference_client(jobs, tmp_path, monkeypatch):
    """``QueryClient.topology`` (the elastic fields of HEALTH) returns what
    the reference's client returns, exactly, from either package's job,
    and from a port job that is a topology generation's worker."""
    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "registry"))
    ref, port = jobs
    d = str(tmp_path / "j")
    elastic = PC.ServingJob(PJ.Journal(d, "t"), STATE, PC.parse_als_record,
                            PC.MemoryStateBackend(), host="127.0.0.1",
                            port=0, job_id="gen-job", topology_group="g",
                            generation=2, topk_index=False,
                            device="cpu").start()
    try:
        assert elastic.wait_ready(30)
        for job, want in ((ref, None), (port, None), (elastic, "g")):
            got = [mod.QueryClient("127.0.0.1", job.port).topology(STATE)
                   for mod in (RCL, PCL)]
            assert got[0] == got[1]
            assert got[1]["topology_group"] == want
        assert got[1] == {"topology_group": "g", "generation": 2,
                          "topology_gen": 2}
    finally:
        elastic.stop()


def test_retry_policy_matches_the_reference():
    for kw in ({}, {"attempts": 4, "backoff_s": 0.5, "jitter": 0.0}):
        a, b = PCL.RetryPolicy(**kw), RCL.RetryPolicy(**kw)
        assert [a.delay_s(i) for i in range(5)] == [b.delay_s(i)
                                                    for i in range(5)]
    with pytest.raises(ValueError):
        PCL.RetryPolicy(attempts=0)


def test_a_dead_server_is_retried_then_raises(tmp_path):
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    c = PCL.QueryClient("127.0.0.1", dead, timeout_s=1,
                        retry=PCL.RetryPolicy(attempts=3))
    with pytest.raises(OSError):
        c.query_state(STATE, "1-U")


def test_registry_entries_are_the_reference_json(tmp_path):
    PR.register("a/b job", "0.0.0.0", 1234, STATE, ready=True, ttl_s=5.0)
    RR.register("other", "0.0.0.0", 1234, STATE, ready=True, ttl_s=5.0)
    files = sorted(os.listdir(PR.registry_dir()))
    assert PR.registry_dir() == RR.registry_dir()
    assert PR._entry_path("a/b job") == RR._entry_path("a/b job")
    with open(os.path.join(PR.registry_dir(), files[0])) as f:
        mine = json.load(f)
    with open(os.path.join(PR.registry_dir(), files[1])) as f:
        theirs = json.load(f)
    for e in (mine, theirs):
        assert e.pop("heartbeat") > 0
        e.pop("job_id")
    assert mine == theirs
    assert RR.resolve("a/b job")["port"] == 1234
    assert PR.resolve("other")["port"] == 1234
    assert sorted(e["job_id"] for e in PR.list_jobs()) == sorted(
        e["job_id"] for e in RR.list_jobs())
    PR.unregister("a/b job")
    assert RR.resolve("a/b job") is None
    # a heartbeat past its TTL is dead to both, and reaped
    RR.register("stale", "h", 1, STATE, ttl_s=0.1)
    with open(RR._entry_path("stale")) as f:
        e = json.load(f)
    assert PR.entry_is_dead(e, now=e["heartbeat"] + 1.0)
    assert RR.entry_is_dead(e, now=e["heartbeat"] + 1.0)
    assert not PR.entry_is_dead(e, now=e["heartbeat"])
    assert PR.heartbeat_interval_s() == RR.heartbeat_interval_s()
    assert PR.replica_ttl_s() == RR.replica_ttl_s()


def test_each_package_resolves_the_others_job(jobs):
    ref, port = jobs
    for args in (["--jobId", "port-job"], ["--jobId", "ref-job"],
                 ["--jobId", "port-job", "--jobManagerHost", "127.0.0.1"],
                 ["--jobManagerPort", "7", "--jobId", "ref-job"],
                 ["--jobId", "nobody"]):
        got = PR.resolve_endpoint(Params.from_args(args))
        assert got == RR.resolve_endpoint(RefParams.from_args(args))
    assert PR.resolve_endpoint(Params.from_args(
        ["--jobId", "ref-job"]))[1] == ref.port
    assert RR.resolve_endpoint(RefParams.from_args(
        ["--jobId", "port-job"]))[1] == port.port
    # the ready flag reaches the registry just after the job's own event
    import time

    deadline = time.monotonic() + 30
    while not RR.resolve("port-job").get("ready") and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert RR.resolve("port-job")["ready"] is True
    assert PR.merge_endpoint(None, None) == RR.merge_endpoint(None, None)


_LINES = [f"GET\t{STATE}\tk ey", f"MGET\t{STATE}\ta,b,é",
          f"TOPK\t{STATE}\t7\t10", f"TOPKV\t{STATE}\t3\t" + "1.5;" * 100,
          f"DOT\t{STATE}\t10\t1:2.0", f"COUNT\t{STATE}", f"HEALTH\t{STATE}",
          "METRICS", "PING", f"SUBSCRIBE\t{STATE}\tKEY\tk\t0",
          f"RESUME\t{STATE}\tKEY\tk\t0\ts:1", "UNSUB\ts"]


def test_frames_are_the_reference_bytes():
    tids = [None, "ab/cd"] * 6
    for lines in (_LINES, _LINES[:1], _LINES * 12):
        assert PP.encode_request_frame(lines) == RP.encode_request_frame(
            lines)
        t = (tids * 12)[:len(lines)]
        frame = PP.encode_request_frame(lines, tids=t)
        assert frame == RP.encode_request_frame(lines, tids=t)
        assert PP.decode_request_frame(frame, trace=True) == \
            RP.decode_request_frame(frame, trace=True)
        reply = PP.encode_reply_frame(lines)
        assert reply == RP.encode_reply_frame(lines)
        assert PP.decode_reply_frame(reply + b"B2") == RP.decode_reply_frame(
            reply + b"B2")
    for n in (0, 1, 127, 128, 300, 1 << 35):
        assert PP.encode_varint(n) == RP.encode_varint(n)
        assert PP.decode_varint(PP.encode_varint(n), 0) == (
            n, len(PP.encode_varint(n)))
    assert PP.error_frame("x") == RP.error_frame("x")
    for bad in (b"XX\x01", b"B2\x03\x01\x63\x00", b"B2\x02\x02\x01"):
        for mod in (PP, RP):
            with pytest.raises(mod.ProtoError):
                mod.decode_request_frame(bad)
    for parts in (["HELLO", "B2"], ["HELLO", "B2", "tn=a", "tr=1", "st=1"],
                  ["HELLO", "B2", "su=1"], ["HELLO", "B2", "x=1"],
                  ["HELLO", "B2", "tr=1", "tr=1"], ["HELLO"]):
        assert PP.parse_hello(parts) == RP.parse_hello(parts)
    with pytest.raises(PP.ProtoError, match="takes"):
        PP.record_from_line(f"GET\t{STATE}")


def test_frame_reader_splits_back_to_back_frames():
    import io

    data = PP.encode_reply_frame(["V\ta", "N"]) + PP.encode_reply_frame(["C\t3"])
    r = PP.FrameReader(io.BytesIO(data))
    assert r.read_frame() == ["V\ta", "N"]
    assert r.read_frame() == ["C\t3"]
    with pytest.raises(ConnectionError):
        r.read_frame()


def test_console_clients_print_the_reference_lines(jobs, capsys):
    """``als_predict`` (the REPL) and ``als_topk`` (one-shot and the
    latency harness) of both packages against the port's job."""
    import io

    from flink_ms_tpu.client import als_predict as R_predict
    from flink_ms_tpu.client import als_topk as R_topk
    from flink_ms_tpu_torch.client import als_predict as P_predict
    from flink_ms_tpu_torch.client import als_topk as P_topk

    _, port = jobs
    lines = ["1,2", "3,99", "bad", "", "4,4"]
    outs = []
    for mod, cl in ((P_predict, PCL), (R_predict, RCL)):
        buf = io.StringIO()
        with cl.QueryClient("127.0.0.1", port.port) as c:
            mod.run(c, lines, out=buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "ALS Prediction =" in outs[0]
    capsys.readouterr()
    args = ["--jobId", "port-job", "--k", "3", "--user", "2"]
    P_topk.run(Params.from_args(args))
    mine = capsys.readouterr().out
    R_topk.run(RefParams.from_args(args))
    assert mine == capsys.readouterr().out and "  1. item" in mine
    with pytest.raises(ValueError, match="Missing required job ID"):
        P_predict.main([])
