"""The port's standalone serving job against the JAX package's, each over
the same journal on the CPU: every verb in tab and B2 framing gets the
same reply bytes from both (the push plane's verbs and frames included),
the ingest modes build equal tables, ``fs`` checkpoints restore across the
packages, the snapshot and compaction options run as the reference's,
bad options are refused, a geo-replication follower answers ``st=1``
with its status record's staleness, and checkpoints are deferred
during a replay (stepped with a fake clock, no thread raced against a
wall-clock interval)."""

import json
import os
import socket
import types

import numpy as np
import pytest
import torch

from flink_ms_tpu.obs import profiler as RP
from flink_ms_tpu.obs import tracing as ref_tracing
from flink_ms_tpu.serve import consumer as RC
from flink_ms_tpu.serve import journal as RJ
from flink_ms_tpu.serve import proto as ref_proto
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu_torch.obs import tracing as port_tracing
from flink_ms_tpu_torch.serve import consumer as PC
from flink_ms_tpu_torch.serve import georepl as PGeo
from flink_ms_tpu_torch.serve import journal as PJ
from flink_ms_tpu_torch.serve.client import QueryClient
from flink_ms_tpu_torch.serve.table import ModelTable

STATE = "ALS_MODEL"


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    monkeypatch.setenv("TPUMS_TOPK_TIER", "exact")
    monkeypatch.delenv("TPUMS_SNAPSHOTS", raising=False)
    monkeypatch.delenv("TPUMS_COMPACT", raising=False)
    monkeypatch.delenv("TPUMS_TABLE", raising=False)


def _payload(vec) -> str:
    return ";".join(repr(float(x)) for x in vec)


def _model_rows(seed=0, n_users=12, n_items=30, d=4):
    """ALS rows whose dot products are exact in float32, with duplicate
    item rows (ties), MEAN rows, a later rewrite of some rows and one
    malformed row."""
    rng = np.random.default_rng(seed)
    items = rng.integers(-16, 16, size=(n_items, d)) / 8.0
    items[1::5] = items[0]
    users = rng.integers(-16, 16, size=(n_users, d)) / 8.0
    rows = [f"{u},U,{_payload(v)}" for u, v in enumerate(users)]
    rows += [f"{i},I,{_payload(v)}" for i, v in enumerate(items)]
    rows += [f"MEAN,U,{_payload(users.mean(0))}",
             f"MEAN,I,{_payload(items.mean(0))}", "garbage-row"]
    rows += [f"{u},U,{_payload(v + 0.25)}" for u, v in
             list(enumerate(users))[:3]]
    return rows


def _journal(tmp_path, rows, name="j"):
    d = str(tmp_path / name)
    PJ.Journal(d, "t").append(rows)
    return d


def _jobs(journal_dir, port_kw=None, ref_kw=None):
    """(reference job, port job), both started and ready."""
    ref = RC.ServingJob(RJ.Journal(journal_dir, "t"), STATE,
                        RC.parse_als_record, RC.MemoryStateBackend(),
                        host="127.0.0.1", port=0, job_id="ref-job",
                        **dict({"snapshots": False}, **(ref_kw or {}))
                        ).start()
    port = PC.ServingJob(PJ.Journal(journal_dir, "t"), STATE,
                         PC.parse_als_record, PC.MemoryStateBackend(),
                         host="127.0.0.1", port=0, job_id="port-job",
                         device="cpu", **(port_kw or {})).start()
    assert ref.wait_ready(30) and port.wait_ready(30)
    return ref, port


def _norm(reply: str, job_id: str, port: int) -> str:
    """A reply with what names the process taken out: the job id, the
    port and the bootstrap seconds."""
    if reply.startswith("H\t"):
        h = json.loads(reply[2:])
        assert h["job_id"] == job_id
        assert h["metrics_uri"] == f"tpums://127.0.0.1:{port}/METRICS"
        assert h.pop("bootstrap_seconds") >= 0
        h.pop("job_id")
        h.pop("metrics_uri")
        return "H\t" + json.dumps(h, sort_keys=True)
    return reply.replace(job_id, "<job>")


def _requests(k=5):
    reqs = [f"TOPK\t{STATE}\t{u}\t{k}" for u in range(12)]
    reqs += [f"TOPKV\t{STATE}\t{k}\t{_payload([1.0, -0.5, 0.25, 2.0])}",
             f"TOPKV\t{STATE}\t3\t0.5;0.5;0.5;0.5",
             f"TOPK\t{STATE}\tnobody\t{k}", f"TOPK\t{STATE}\t1\t0",
             f"TOPK\t{STATE}\t1\tx", f"TOPKV\t{STATE}\t{k}\t1.0;2.0",
             f"TOPK\tNOPE\t1\t{k}",
             f"GET\t{STATE}\t1-U", f"GET\t{STATE}\tMEAN-I",
             f"GET\t{STATE}\tmissing", f"GET\tNOPE\t1-U",
             f"MGET\t{STATE}\t1-U,missing,2-I,,MEAN-U", f"MGET\tNOPE\ta,b",
             f"COUNT\t{STATE}", "COUNT\tNOPE", f"HEALTH\t{STATE}",
             "HEALTH\tNOPE", "PING",
             f"DOT\t{STATE}\t10\t1:0.5;3:2.0", f"DOT\t{STATE}\t0\t1:1.0",
             f"DOT\t{STATE}\t10\tnot-a-pair"]
    return reqs


TAB_ONLY = ["FOO", f"GET\t{STATE}", "", f"TOPK\t{STATE}\t1", "PING\textra",
            "HELLO\tB3", "HELLO\tB2\tzz=1"]


def _both(ref, port, fn):
    return ([_norm(r, "ref-job", ref.port) for r in fn(ref.port)],
            [_norm(r, "port-job", port.port) for r in fn(port.port)])


@pytest.mark.parametrize("proto", ["tab", "b2"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_every_verb_gets_the_reference_reply_bytes(tmp_path, proto,
                                                   pipelined):
    ref, port = _jobs(_journal(tmp_path, _model_rows()))
    reqs = _requests() + (TAB_ONLY if proto == "tab" else [])
    try:
        def ask(p):
            with QueryClient("127.0.0.1", p, timeout_s=30, proto=proto) as c:
                if pipelined:
                    return c.pipeline(reqs, window=8)
                return [c._roundtrip(r) for r in reqs]

        want, got = _both(ref, port, ask)
        assert got == want
        assert sum(r.startswith("V\t") for r in got) >= 15
        assert got[reqs.index(f"COUNT\t{STATE}")] == "C\t44"
        # the replies hold ties (duplicate item rows, equal scores)
        assert any(len(set(p)) < len(p) for p in (
            [t.rpartition(":")[2] for t in r[2:].split(";")]
            for r in got[:12]))
        for p in (ref.port, port.port):
            with QueryClient("127.0.0.1", p, proto=proto) as c:
                m = c.metrics()
                assert m["meta"]["plane"] == "python"
                assert m["histograms"]
    finally:
        ref.stop()
        port.stop()
    assert port.ingest_stats()["parse_errors"] == 1


def test_traced_tenanted_and_stale_requests(tmp_path):
    ref, port = _jobs(_journal(tmp_path, _model_rows()))
    reqs = _requests()[:14]
    try:
        for kw in ({"tenant": "acme"}, {"stale": True}):
            for proto in ("tab", "b2"):
                def ask(p):
                    with QueryClient("127.0.0.1", p, proto=proto, **kw) as c:
                        out = [c._roundtrip(r) for r in reqs]
                        if kw.get("stale"):
                            assert c.last_staleness_s == 0.0
                        return out

                want, got = _both(ref, port, ask)
                assert got == want
        # a traced request: the raw wire reply carries the tid echo, with
        # the reference's bytes; the port's server records its span
        for p in (ref.port, port.port):
            with socket.create_connection(("127.0.0.1", p)) as s:
                s.sendall(f"GET\t{STATE}\t2-I\ttid=abcd/ef01\n".encode())
                wire = s.makefile("rb").readline().decode()
            assert wire.endswith("\ttid=abcd/ef01\n")
            assert wire.startswith("V\t")
        assert port_tracing.recent_events(tid="abcd", kind="server_reply")
        with port_tracing.trace_span() as tid:
            with QueryClient("127.0.0.1", port.port) as c:
                assert c.query_state(STATE, "2-I") is not None
        assert port_tracing.recent_events(tid=tid, kind="client_rpc")
        with ref_tracing.trace_span():
            with QueryClient("127.0.0.1", ref.port) as c:
                assert c.query_state(STATE, "2-I") is not None
    finally:
        ref.stop()
        port.stop()


def test_raw_b2_frames_and_the_push_plane_refusal(tmp_path, monkeypatch):
    """Corrupt frames answer the reference's error frame; the push plane's
    verbs and its ``su=1`` HELLO get the reference's bytes, its refusal on
    a B2 connection without ``su=1`` included; both jobs' PROFILE replies
    parse and carry the same keys.  Each job's push engine claims epoch 1 from a fresh registry, so
    subscription ids are equal."""
    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "registry"))
    ref, port = _jobs(_journal(tmp_path, _model_rows()))

    def raw(p, data, frames=False):
        with socket.create_connection(("127.0.0.1", p), timeout=10) as s:
            s.sendall(data)
            s.shutdown(socket.SHUT_WR)
            buf = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    return buf
                buf += chunk

    hello = b"HELLO\tB2\n"
    frame = ref_proto.encode_request_frame(
        [f"GET\t{STATE}\t1-U", f"TOPK\t{STATE}\t2\t3",
         f"SUBSCRIBE\t{STATE}\tKEY\t1-U\t0", "UNSUB\tx"])
    try:
        for data in (hello + frame, hello + b"XX\x01\x00",
                     hello + b"B2\x05\x01\x63", b"PROFILE\n",
                     f"SUBSCRIBE\t{STATE}\tKEY\t1-U\t0\nUNSUB\tx\n".encode(),
                     b"HELLO\tB2\tsu=1\n"):
            want = raw(ref.port, data)
            got = raw(port.port, data)
            if data == b"PROFILE\n":
                # each job's profiler sampled its own threads: the replies
                # differ in their numbers but parse alike, key for key
                docs = [RP.parse_profile_reply(r.decode().strip())
                        for r in (want, got)]
                assert None not in docs
                assert sorted(docs[1]) == sorted(docs[0])
                assert sorted(docs[1]["meta"]) == sorted(docs[0]["meta"])
                assert docs[1]["meta"]["plane"] == "python"
                assert docs[1]["unit"] == docs[0]["unit"] == "seconds"
            else:
                assert got == want
                assert got.startswith((b"HELLO\tB2\n", b"S\t1-0\t0\t"))
        texts = ref_proto.decode_reply_frame(raw(port.port, hello + frame)[9:])
        assert texts[0][2:] == ["E\tbad request", "E\tbad request"]
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("mode", ["columnar", "scalar"])
def test_ingest_modes_build_the_reference_table(tmp_path, mode):
    d = _journal(tmp_path, _model_rows(seed=1))
    ref, port = _jobs(d, port_kw={"ingest_mode": mode})
    try:
        assert dict(port.table.items()) == dict(ref.table.items())
        assert port.ingest_stats()["path"] == mode
        assert port.ingest_stats()["parse_errors"] == 1
        # later appends land in both
        PJ.Journal(d, "t").append(["77,I,1.0;1.0;1.0;1.0"])
        _wait_until(lambda: port.table.get("77-I") and ref.table.get("77-I"))
        assert dict(port.table.items()) == dict(ref.table.items())
    finally:
        ref.stop()
        port.stop()


def test_start_from_latest_serves_only_new_rows(tmp_path):
    d = _journal(tmp_path, _model_rows())
    job = PC.ServingJob(PJ.Journal(d, "t"), STATE, PC.parse_als_record,
                        PC.MemoryStateBackend(), host="127.0.0.1", port=0,
                        start_from="latest", device="cpu").start()
    try:
        assert job.wait_ready(30)
        assert len(job.table) == 0
        PJ.Journal(d, "t").append(["5,U,1.0;0.0;0.0;0.0"])
        _wait_until(lambda: len(job.table) == 1)
        with QueryClient("127.0.0.1", job.port) as c:
            assert c.count(STATE) == 1
            assert c.query_state(STATE, "5-U") == "1.0;0.0;0.0;0.0"
    finally:
        job.stop()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_fs_checkpoints_restore_across_packages(tmp_path, writer):
    d = _journal(tmp_path, _model_rows(seed=2))
    ckpt = str(tmp_path / "ckpt")
    if writer == "port":
        job = PC.ServingJob(PJ.Journal(d, "t"), STATE, PC.parse_als_record,
                            PC.FsStateBackend(ckpt), host="127.0.0.1",
                            port=0, device="cpu", topk_index=False)
    else:
        job = RC.ServingJob(RJ.Journal(d, "t"), STATE, RC.parse_als_record,
                            RC.FsStateBackend(ckpt), host="127.0.0.1",
                            port=0, snapshots=False, topk_index=False)
    job.start()
    assert job.wait_ready(30)
    job.backend.snapshot(job.table, job.offset)
    want = dict(job.table.items())
    offset = job.offset
    job.stop()
    for table, backend in ((ModelTable(8), PC.FsStateBackend(ckpt)),
                           (RefTable(8), RC.FsStateBackend(ckpt))):
        assert backend.restore(table) == offset
        assert dict(table.items()) == want
    # and a port job started on that checkpoint replays only the tail
    PJ.Journal(d, "t").append(["88,I,0.5;0.5;0.5;0.5"])
    job = PC.ServingJob(PJ.Journal(d, "t"), STATE, PC.parse_als_record,
                        PC.FsStateBackend(ckpt), host="127.0.0.1", port=0,
                        device="cpu").start()
    try:
        assert job.wait_ready(30)
        assert job.bootstrap_source == "checkpoint"
        _wait_until(lambda: job.table.get("88-I") is not None)
        assert job.ingest_rows == 1
        assert len(job.table) == len(want) + 1
    finally:
        job.stop()


# the fleet's options, refused until the fleet was ported: each job now
# carries them as the reference's job does
_FLEET = [{"replica_of": "g/shard-0"}, {"replica_index": 1},
          {"topology_group": "g"}, {"generation": 2}]


# the options of the reference's job that the port refused until its
# arena and native store were ported: each job now runs them as the
# reference's does (the native server over a memory backend and the dict
# table is refused by both packages alike)
_NATIVE = [{"table": "arena"}, {"table": "arena", "native_server": True},
           {"native_server": True}]


@pytest.mark.parametrize("kw", _NATIVE)
def test_arena_and_native_options_run_as_the_reference(tmp_path, kw):
    """The same journal bytes in two dirs (one arena writer per dir): the
    port's job on the arena table, and its C++ server over the arena,
    answer every verb with the reference job's bytes."""
    rows = _model_rows()
    d_ref = _journal(tmp_path, rows, name="ref")
    d_port = _journal(tmp_path, rows, name="port")
    if kw.get("native_server") and "table" not in kw:
        for C, J, d, extra in ((RC, RJ, d_ref, {}),
                               (PC, PJ, d_port, {"device": "cpu"})):
            with pytest.raises(ValueError, match="--nativeServer needs"):
                C.ServingJob(J.Journal(d, "t"), STATE, C.parse_als_record,
                             C.MemoryStateBackend(), port=0, **kw, **extra)
        return
    ref = RC.ServingJob(RJ.Journal(d_ref, "t"), STATE, RC.parse_als_record,
                        RC.MemoryStateBackend(), host="127.0.0.1", port=0,
                        job_id="ref-job", snapshots=False, **kw).start()
    port = PC.ServingJob(PJ.Journal(d_port, "t"), STATE, PC.parse_als_record,
                         PC.MemoryStateBackend(), host="127.0.0.1", port=0,
                         job_id="port-job", device="cpu", snapshots=False,
                         **kw).start()
    reqs = [r for r in _requests() if not r.startswith("HEALTH")]
    try:
        assert ref.wait_ready(30) and port.wait_ready(30)
        assert port.table_kind == ref.table_kind == "arena"
        assert sorted(port.table.items()) == sorted(ref.table.items())

        def ask(p):
            with QueryClient("127.0.0.1", p, timeout_s=30) as c:
                return [c._roundtrip(r) for r in reqs]

        _wait_until(lambda: ask(port.port)[reqs.index(f"COUNT\t{STATE}")]
                    == "C\t44")
        want, got = _both(ref, port, ask)
        assert got == want
        plane = "native" if kw.get("native_server") else "python"
        for p in (ref.port, port.port):
            with QueryClient("127.0.0.1", p) as c:
                assert c.metrics()["meta"]["plane"] == plane
                assert c.health(STATE)["ready"] is True
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("kw", _FLEET)
def test_fleet_options_run_as_the_reference(tmp_path, monkeypatch, kw):
    """Each fleet option reaches HEALTH and the registry entry as in the
    reference's job, both run with ``TPUMS_TABLE=dict`` (a fleet member
    of either package defaults to the arena, whose directory the two jobs
    would share here)."""
    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "registry"))
    monkeypatch.setenv("TPUMS_TABLE", "dict")
    d = _journal(tmp_path, _model_rows())
    ref, port = _jobs(d, port_kw=dict(kw, topk_index=False),
                      ref_kw=dict(kw, topk_index=False, snapshots=False))
    try:
        fleet = ("replica_of", "replica", "topology_group", "generation",
                 "topology_gen")
        assert {k: port.health()[k] for k in fleet} == \
            {k: ref.health()[k] for k in fleet}
        assert port.table_kind == ref.table_kind == "dict"
        assert dict(port.table.items()) == dict(ref.table.items())
        from flink_ms_tpu_torch.serve import registry as PR

        # the ready flip reaches the registry after the job's ready event
        # (the consume thread writes it): poll past that gap
        _wait_until(lambda: all(PR.resolve(j).get("ready")
                                for j in ("port-job", "ref-job")))
        entries = [PR.resolve(j) for j in ("port-job", "ref-job")]
        assert [{k: e.get(k) for k in ("replica_of", "replica", "ready")}
                for e in entries] == [{"replica_of": kw.get("replica_of"),
                                       "replica": kw.get("replica_index"),
                                       "ready": True}] * 2
    finally:
        port.stop()
        ref.stop()


def test_env_flags_and_other_refusals(tmp_path, monkeypatch):
    real_server = PC.LookupServer
    monkeypatch.setattr(PC, "LookupServer", None)
    j = PJ.Journal(str(tmp_path), "t")

    def make(parse=PC.parse_als_record, **kw):
        return PC.ServingJob(j, STATE, parse, PC.MemoryStateBackend(),
                             port=0, device="cpu", **kw)

    monkeypatch.setattr(PC, "LookupServer",
                        lambda *a, **k: type("S", (), {"port": 0})())
    monkeypatch.setenv("TPUMS_TABLE", "arena")
    job = make()
    assert job.table_kind == "arena"
    assert os.path.basename(job.table.dir) == \
        "t.arena-ALS_MODEL-w0of1-r0-g0"
    job.table.close()
    monkeypatch.setenv("TPUMS_TABLE", "bogus")
    with pytest.raises(ValueError, match="table must be dict|arena"):
        make()
    monkeypatch.delenv("TPUMS_TABLE")
    monkeypatch.setattr(PC, "LookupServer", None)

    def sharded(line):
        return PC.parse_als_record(line)

    sharded.shard_filter = (0, 2)
    # a sharded parser is a fleet member's: the job snapshots its own
    # slice and takes the arena by default, as the reference's does
    # (built on a stand-in server, no socket)
    monkeypatch.setattr(PC, "LookupServer",
                        lambda *a, **k: type("S", (), {"port": 0})())
    job = make(parse=sharded)
    assert job._snap_owner == (0, 2) and job.table_kind == "arena"
    assert os.path.basename(job.table.dir) == \
        "t.arena-ALS_MODEL-w0of2-r0-g0"
    job.table.close()
    monkeypatch.setenv("TPUMS_TABLE", "dict")
    assert make(parse=sharded).table_kind == "dict"
    monkeypatch.delenv("TPUMS_TABLE")
    # a geo-replication follower (the replicator's status record beside
    # the journal) starts, and answers st=1 with the record's staleness:
    # caught up 2.5 s before the clock the record is read by
    monkeypatch.setattr(PC, "LookupServer", real_server)
    with open(os.path.join(str(tmp_path), "t.georepl.json"), "w") as f:
        json.dump({"kind": "georepl", "topic": "t", "caught_up": False,
                   "caught_up_ts": 100.0, "ts": 100.0, "poll_s": 0.2}, f)
    monkeypatch.setattr(PGeo, "time", types.SimpleNamespace(
        time=lambda: 102.5))
    PGeo._STALENESS_CACHE.clear()
    j.append(["1,U,0.5;0.25"])
    job = make(topk_index=False).start()
    try:
        assert job.wait_ready(30)
        with socket.create_connection(("127.0.0.1", job.port), 10) as sock:
            sock.sendall(b"GET\tALS_MODEL\t1-U\tst=1\nGET\tALS_MODEL\t1-U\n")
            sock.shutdown(socket.SHUT_WR)
            got = b""
            while True:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                got += chunk
        assert got == b"V\t0.5;0.25\tst=2.500\nV\t0.5;0.25\n"
    finally:
        job.stop()
    monkeypatch.setattr(PC, "LookupServer", None)
    backend = PC.make_backend("rocksdb", str(tmp_path / "store"))
    assert type(backend).__name__ == "NativeStateBackend"
    assert backend.kind == "rocksdb"
    backend.close()
    with pytest.raises(ValueError, match="requires --checkpointDataUri"):
        PC.make_backend("rocksdb", None)
    with pytest.raises(ValueError, match="start_from"):
        make(start_from="middle")


@pytest.mark.parametrize("kw,env", [
    ({"snapshots": True}, {}), ({"compact": True}, {}),
    ({}, {"TPUMS_SNAPSHOTS": "1"}), ({}, {"TPUMS_COMPACT": "1"}),
    ({"snapshots": False}, {"TPUMS_SNAPSHOTS": "1"}),
    ({}, {"TPUMS_SNAPSHOTS": "0", "TPUMS_COMPACT": "0"})])
def test_snapshot_and_compact_options_run_as_the_reference(
        tmp_path, monkeypatch, kw, env):
    """The options the port used to refuse: each job resolves them as the
    reference's job does (snapshots on unless turned off, compaction off
    unless turned on), serves the same table, and runs its compactor."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "registry"))
    d = _journal(tmp_path, _model_rows())
    ref, port = _jobs(d, port_kw=dict(kw, topk_index=False),
                      ref_kw={"topk_index": False,
                              "snapshots": kw.get("snapshots"),
                              "compact": kw.get("compact")})
    try:
        for attr in ("_snapshots_on", "_compact_on", "bootstrap_source"):
            assert getattr(port, attr) == getattr(ref, attr), attr
        assert dict(port.table.items()) == dict(ref.table.items())
        assert (port._compactor is None) == (ref._compactor is None)
        if port._compact_on:
            assert port._compactor.is_alive()
    finally:
        ref.stop()
        port.stop()


def test_cuda_device_raises_without_cuda_before_any_socket(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opened = []
    real = PC.LookupServer

    def spy(*a, **k):
        opened.append(1)
        return real(*a, **k)

    monkeypatch.setattr(PC, "LookupServer", spy)
    j = PJ.Journal(_journal(tmp_path, _model_rows()), "t")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PC.ServingJob(j, STATE, PC.parse_als_record, PC.MemoryStateBackend(),
                      port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PC.als_main(["--journalDir", j.dir, "--topic", "t", "--port", "0"])
    assert opened == []
    # no index, no device: the job serves on a host without CUDA
    job = PC.ServingJob(j, STATE, PC.parse_als_record, PC.MemoryStateBackend(),
                        host="127.0.0.1", port=0, topk_index=False).start()
    try:
        assert job.wait_ready(30)
        with QueryClient("127.0.0.1", job.port) as c:
            assert c._roundtrip(f"TOPK\t{STATE}\t1\t3") == (
                f"E\tno topk index for state: {STATE}")
    finally:
        job.stop()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_checkpoints_deferred_while_replaying(tmp_path):
    """Stepped with a fake clock: every poll of a replay backlog defers the
    due checkpoint, up to CHECKPOINT_MAX_DEFER_INTERVALS intervals; the
    first poll after the backlog takes it."""
    rows = [f"{i},I,{i}.0;1.0;2.0;3.0" for i in range(400)]
    d = _journal(tmp_path, rows)
    clock = _Clock()
    snaps = []

    class Backend(PC.MemoryStateBackend):
        def snapshot(self, table, offset):
            snaps.append((clock.t, offset, len(table)))
            super().snapshot(table, offset)

    job = PC.ServingJob(PJ.Journal(d, "t"), STATE, PC.parse_als_record,
                        Backend(), port=0, host="127.0.0.1", device="cpu",
                        checkpoint_interval_ms=1000, clock=clock)
    try:
        job.CHUNK_CAP = 512  # ~20 polls of backlog
        job._begin_consume()
        steps = []
        while True:
            clock.t += 1.5  # every poll is past the interval
            got = job.consume_step()
            steps.append((got, job.checkpoints_deferred, len(snaps)))
            if not got:
                break
        end = PJ.Journal(d, "t").end_offset()
        assert job.offset == end and len(job.table) == 400
        assert job.ready
        # deferred while the backlog lasts (1.5, 3.0, 4.5 s past the last
        # checkpoint), forced once 5 intervals have passed (6.0 s), and
        # taken at once by the first poll that finds no backlog
        assert steps[:4] == [(True, 1, 0), (True, 2, 0), (True, 3, 0),
                             (True, 3, 1)]
        assert len(steps) > 12 and steps[-1][0] is False
        assert [b[0] - a[0] for a, b in zip(snaps, snaps[1:-1])] == [
            6.0] * (len(snaps) - 2)
        assert snaps[-1][1:] == (end, 400)
        assert job.checkpoints == len(snaps)
        # every poll past the interval either deferred or checkpointed
        assert job.checkpoints_deferred == len(steps) - len(snaps)
    finally:
        job.server.stop()


def _wait_until(pred, timeout=30.0, interval=0.02):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError("condition not met before the deadline")


def test_svm_job_answers_dot_and_get_as_the_reference(tmp_path):
    """The SVM serving job (range-partitioned rows) of both packages: DOT,
    GET, MGET and COUNT replies are equal byte for byte."""
    d = str(tmp_path / "svm")
    PJ.Journal(d, "t").append(["0,1:0.5;2:-1.25;3:2.0", "1,10:0.75;11:1.5",
                               "3,30:-0.5", "7", "1,10:1.0;12:0.25"])
    jobs = []
    for mod, J, kw in ((RC, RJ, {"snapshots": False}), (PC, PJ, {})):
        jobs.append(mod.ServingJob(J.Journal(d, "t"), mod.SVM_STATE,
                                   mod.parse_svm_record,
                                   mod.MemoryStateBackend(),
                                   host="127.0.0.1", port=0, **kw).start())
    try:
        assert all(j.wait_ready(30) for j in jobs)
        reqs = ["DOT\tSVM_MODEL\t10\t1:2.0;10:1.0;12:4.0;25:1.0",
                "DOT\tSVM_MODEL\t10\t", "DOT\tSVM_MODEL\t10\t1:x",
                "GET\tSVM_MODEL\t1", "GET\tSVM_MODEL\t7",
                "MGET\tSVM_MODEL\t0,1,2", "COUNT\tSVM_MODEL",
                "TOPK\tSVM_MODEL\t1\t3"]
        got = []
        for j in jobs:
            with QueryClient("127.0.0.1", j.port) as c:
                got.append([c._roundtrip(r) for r in reqs])
                assert c.sparse_dot("SVM_MODEL", 10, {1: 2.0, 10: 1.0}) == (
                    2.0, [])
        assert got[0] == got[1]
        assert got[1][0] == "D\t3.0\t2" and got[1][4] == "V\t"
    finally:
        for j in jobs:
            j.stop()


@pytest.mark.parametrize("lossless", [False, True])
def test_recovers_from_a_truncated_offset(tmp_path, lossless):
    """An offset behind retention resumes with a counted gap; one inside a
    compacted prefix re-reads the fold (lossless).  Either way the table
    ends as the reference job's."""
    from flink_ms_tpu.serve import compact as ref_compact

    d = str(tmp_path / "j")
    ref = RJ.Journal(d, "t", segment_bytes=60,
                     retain_segments=None if lossless else 2)
    for i in range(30):
        ref.append([f"{i % 7},I,{i}.0;1.0"])
    if lossless:
        assert ref_compact.compact_journal(
            ref, parse_fn=RC.parse_als_record, min_segments=1)
    job = PC.ServingJob(PJ.Journal(d, "t"), STATE, PC.parse_als_record,
                        PC.MemoryStateBackend(), host="127.0.0.1", port=0,
                        device="cpu")
    try:
        job.offset = 7 if lossless else 0  # inside the fold / expired
        job._begin_consume()
        while job.consume_step():
            pass
        assert job.offset == ref.end_offset()
        from flink_ms_tpu.serve.autopilot import _read_journal_lines

        want = RefTable(8)
        want.put_many([RC.parse_als_record(x)
                       for x in _read_journal_lines(d, "t")])
        assert dict(job.table.items()) == dict(want.items())
        if lossless:
            assert job.journal.compacted_rereads == 1
        else:
            assert job.journal.expired_bytes_skipped > 0
    finally:
        job.server.stop()
