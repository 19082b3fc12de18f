"""The port's geo-replication (``flink_ms_tpu_torch/serve/georepl.py``) and
its follower job against the JAX package's on the CPU.

- Every case of ``tests/test_georepl.py`` runs again with the reference's
  names bound to the port's objects (``_on_port``; imports inside a case's
  body through ``_port_imports``): journal replication byte for byte
  (rotation, folds, resume, a lossy retention hole covered by copied
  snapshots), the ``st=`` wire pins, region namespaces, promotion and the
  write forwarder's re-point.  The staleness case runs on a clock of its
  own (``_Clock``): its sleeps advance the clock the replicator and
  ``staleness_of`` read, so no case waits out a throttle.
- Cross-package cases: each package's replicator following one reference
  home journal writes the same follower tree (the status record equal
  but for its timestamps); a reference follower job on a journal the port
  replicated, and a port job on one the reference replicated, answer the
  same bytes, ``st=`` included; a geo record published by one package
  resolves equal in the other; a port follower job answers ``st=1`` with
  the record's staleness, driven by records with fixed timestamps.
Journals, follower trees and wire bytes must match exactly.
"""

import functools
import inspect
import json
import os
import socket
import time
import types

import pytest

import test_georepl as ref_cases
from test_torch_profiler import _on_port, _port_imports
from flink_ms_tpu.serve import georepl as RG
from flink_ms_tpu.serve import snapshot as RSm
from flink_ms_tpu.serve.compact import compact_journal as ref_compact
from flink_ms_tpu.serve.consumer import MemoryStateBackend as RefMemory
from flink_ms_tpu.serve.consumer import ServingJob as RefJob
from flink_ms_tpu.serve.consumer import parse_als_record as ref_parse
from flink_ms_tpu.serve.journal import Journal as RefJournal
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu_torch.obs import metrics as PM
from flink_ms_tpu_torch.obs import scrape as PSc
from flink_ms_tpu_torch.serve import consumer as PC
from flink_ms_tpu_torch.serve import georepl as PG
from flink_ms_tpu_torch.serve import proto as PProto
from flink_ms_tpu_torch.serve import registry as PReg
from flink_ms_tpu_torch.serve import snapshot as PSm
from flink_ms_tpu_torch.serve.client import QueryClient, RetryPolicy
from flink_ms_tpu_torch.serve.compact import compact_journal
from flink_ms_tpu_torch.serve.elastic import ElasticClient, generation_group
from flink_ms_tpu_torch.serve.ha import shard_group
from flink_ms_tpu_torch.serve.journal import Journal, OffsetTruncatedError
from flink_ms_tpu_torch.serve.server import LookupServer
from flink_ms_tpu_torch.serve.sharded import sharded_parse
from flink_ms_tpu_torch.serve.table import ModelTable, _fnv1a
from flink_ms_tpu_torch.serve.update_plane import input_topic


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "10")
    for name in ("TPUMS_SNAPSHOTS", "TPUMS_COMPACT", "TPUMS_TABLE",
                 "TPUMS_TENANT", "TPUMS_GEO_REGION"):
        monkeypatch.delenv(name, raising=False)
    RG._STALENESS_CACHE.clear()
    PG._STALENESS_CACHE.clear()


class _Clock:
    """A stand-in for the ``time`` module: ``sleep`` advances the clock
    that ``time`` reads, at once."""

    def __init__(self, now: float = 1_700_000_000.0):
        self.now = now

    def time(self) -> float:
        return self.now

    monotonic = time

    def sleep(self, s: float) -> None:
        self.now += max(float(s), 0.0)


PORT = _on_port(ref_cases, {
    "obs_metrics": PM, "georepl": PG, "proto": PProto, "registry": PReg,
    "sm": PSm, "QueryClient": QueryClient, "RetryPolicy": RetryPolicy,
    "compact_journal": compact_journal, "ALS_STATE": PC.ALS_STATE,
    "MemoryStateBackend": PC.MemoryStateBackend,
    "ServingJob": functools.partial(PC.ServingJob, device="cpu"),
    "make_backend": PC.make_backend, "parse_als_record": PC.parse_als_record,
    "ElasticClient": ElasticClient, "generation_group": generation_group,
    "shard_group": shard_group, "Journal": Journal,
    "OffsetTruncatedError": OffsetTruncatedError,
    "LookupServer": LookupServer, "sharded_parse": sharded_parse,
    "ModelTable": ModelTable, "_fnv1a": _fnv1a, "input_topic": input_topic})
CASES = sorted(n for n, f in vars(ref_cases).items()
               if n.startswith("test_") and callable(f))
CLOCKED = {"test_staleness_of_follower_journal"}


def test_the_mirrored_cases_are_all_nineteen():
    assert len(CASES) == 19
    assert CLOCKED <= set(CASES)


@pytest.mark.parametrize("name", CASES)
def test_reference_georepl_case_on_the_port(name, tmp_path, monkeypatch):
    _port_imports(monkeypatch, {"flink_ms_tpu.obs.scrape": PSc})
    fn = PORT[name]
    if name in CLOCKED:
        clock = _Clock()
        monkeypatch.setattr(PG, "time", clock)
        fn = types.FunctionType(fn.__code__, dict(fn.__globals__,
                                                  time=clock),
                                fn.__name__, fn.__defaults__,
                                fn.__closure__)
    have = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: have[p] for p in inspect.signature(fn).parameters})


# ---------------------------------------------------------------------------
# cross-package cases
# ---------------------------------------------------------------------------

def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


_STATUS_TIMES = ("ts", "caught_up_ts")


def _status(blob):
    rec = json.loads(blob)
    return {k: v for k, v in rec.items() if k not in _STATUS_TIMES}


def _home_journal(root):
    """A reference home journal with every shape the replicator mirrors:
    rotated segments, a compacted fold, a retention hole covered by a
    published snapshot, and a live tail after them."""
    home = RefJournal(root, "models", segment_bytes=128, retain_segments=3)
    for i in range(160):
        home.append([f"{i % 16},I,v{i}"], flush=False)
    home.sync()
    assert ref_compact(home, parse_fn=ref_parse) is not None
    t = RefTable(8)
    for i in range(160):
        t.put(f"{i % 16}-I", f"v{i}")
    RSm.publish(RSm.snapshot_root(root, "models"), t, home.end_offset(),
                shard=0, num_shards=1, topic="models")
    for i in range(160, 200):
        home.append([f"{i % 16},I,v{i}"], flush=False)
    home.sync()
    return home


def _status_caught_up(rep, eu, end, timeout_s=30.0):
    """Step ``rep`` until its status record on disk says it is caught up
    at ``end``.  The record is written at most once in two poll intervals,
    so the one on disk when the replicator catches up is whichever step
    last got through the throttle: an earlier state on a fast host, the
    final one on a loaded host."""
    path = os.path.join(eu, "models.georepl.json")
    deadline = time.time() + timeout_s
    while True:
        rep.step()
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            rec = {}
        if rec.get("caught_up") and rec.get("offset") == end:
            return
        assert time.time() < deadline, f"status record still {rec}"
        time.sleep(rep.poll_s)


def test_port_replicator_writes_the_reference_follower_tree(tmp_path):
    us = str(tmp_path / "us")
    home = _home_journal(us)
    trees = {}
    for name, mod in (("ref", RG), ("port", PG)):
        eu = str(tmp_path / f"eu_{name}")
        rep = mod.JournalReplicator(us, eu, "models", "eu", poll_s=0.01)
        try:
            rep.run_until_caught_up()
            _status_caught_up(rep, eu, home.end_offset())
            assert rep.offset == home.end_offset()
            assert rep.lost_bytes == home.start_offset() > 0
            assert rep.folds_mirrored == 1 and rep.snapshots_copied >= 1
        finally:
            rep.stop()
        trees[name] = _tree(eu)
    ref, port = trees["ref"], trees["port"]
    assert sorted(port) == sorted(ref)
    status = "models.georepl.json"
    assert status in ref
    assert _status(port.pop(status)) == _status(ref.pop(status))
    assert port == ref
    assert any(".clog." in n for n in ref)
    assert any(n.startswith("models.snapshots") or "snap" in n for n in ref)


@pytest.mark.parametrize("slow", ["ref", "port"])
def test_follower_trees_agree_when_one_replicator_is_slow(tmp_path,
                                                          monkeypatch,
                                                          slow):
    """A loaded host, as one package's replicator taking 25 ms a step:
    its status record gets through the throttle at other steps than the
    other package's, and the trees still agree once both records say
    caught up."""
    mod = RG if slow == "ref" else PG
    real = mod.JournalReplicator.step

    def step(self):
        time.sleep(0.025)
        return real(self)

    monkeypatch.setattr(mod.JournalReplicator, "step", step)
    test_port_replicator_writes_the_reference_follower_tree(tmp_path)


def _raw(port, payload):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(payload)
        sock.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                return out
            out += chunk


def _serve_bytes(job, keys):
    req = b"".join(f"GET\tALS_MODEL\t{k}\n".encode() for k in keys)
    req += b"".join(f"GET\tALS_MODEL\t{k}\tst=1\n".encode() for k in keys)
    return _raw(job.port, req + b"COUNT\tALS_MODEL\n")


def _status_record(eu, **fields):
    path = os.path.join(eu, "models.georepl.json")
    with open(path) as f:
        rec = json.load(f)
    rec.update(fields)
    with open(path, "w") as f:
        json.dump(rec, f)


def test_follower_jobs_serve_the_same_bytes_across_packages(tmp_path,
                                                           monkeypatch):
    """A reference follower job on the journal the port replicated, and a
    port job on the one the reference replicated: the same bytes, both
    ways, ``st=`` included (caught up: 0.000)."""
    us = str(tmp_path / "us")
    _home_journal(us)
    dirs = {}
    for name, mod in (("ref", RG), ("port", PG)):
        eu = str(tmp_path / f"eu_{name}")
        rep = mod.JournalReplicator(us, eu, "models", "eu", poll_s=0.01)
        try:
            rep.run_until_caught_up()
            rep.step()
        finally:
            rep.stop()
        dirs[name] = eu
    # pin the status records and both packages' clocks: caught up, read
    # at the instant of the record
    for eu in dirs.values():
        _status_record(eu, ts=1000.0, caught_up_ts=1000.0, lag_bytes=0)
    for mod in (RG, PG):
        monkeypatch.setattr(mod, "time", _Clock(1000.0))
    keys = [f"{i}-I" for i in range(18)]
    got = {}
    for job_pkg, journal_of in (("ref", "port"), ("port", "ref")):
        if job_pkg == "ref":
            job = RefJob(RefJournal(dirs[journal_of], "models"), "ALS_MODEL",
                         ref_parse, RefMemory(), port=0, topk_index=False,
                         poll_interval_s=0.02, snapshots=False)
        else:
            job = PC.ServingJob(Journal(dirs[journal_of], "models"),
                                PC.ALS_STATE, PC.parse_als_record,
                                PC.MemoryStateBackend(), port=0,
                                topk_index=False, poll_interval_s=0.02,
                                device="cpu", snapshots=False)
        job.start()
        try:
            assert job.wait_ready(30)
            got[job_pkg] = _serve_bytes(job, keys)
        finally:
            job.stop()
    assert got["port"] == got["ref"]
    assert b"V\tv199\tst=0.000\n" in got["port"]


def test_geo_record_resolves_equal_across_packages(tmp_path):
    regions = {"us": {"journal_dir": str(tmp_path / "us")},
               "eu": {"journal_dir": str(tmp_path / "eu")}}
    for pub, pub_name, read in ((PG, "port", RG), (RG, "ref", PG)):
        group = f"geo-x-{pub_name}"
        rec = pub.publish_region_topology(group, "us", regions,
                                          topic="models")
        for mod in (RG, PG):
            got = mod.resolve_region_topology(group)
            assert got == rec
            assert mod.home_region(group) == "us"
            assert mod.region_journal_dir(group, "eu") == \
                str(tmp_path / "eu")
            assert mod.geo_group(group) == pub.geo_group(group)
        # the next generation from the other package CAS-follows it
        rec2 = read.publish_region_topology(
            group, "eu", regions, topic="models", expect_gen=rec["gen"])
        assert rec2["gen"] == rec["gen"] + 1
        assert pub.home_region(group) == "eu"


def test_port_follower_job_answers_the_records_staleness(tmp_path,
                                                        monkeypatch):
    """The follower job starts on a replicated journal and answers st=1
    with the record's staleness: 0.000 when caught up, the time since the
    last caught-up instant under a partition, growing with the clock."""
    us, eu = str(tmp_path / "us"), str(tmp_path / "eu")
    Journal(us, "models").append([f"{i},I,v{i}" for i in range(10)])
    rep = PG.JournalReplicator(us, eu, "models", "eu", poll_s=0.01)
    try:
        rep.run_until_caught_up()
        rep.step()
    finally:
        rep.stop()
    clock = _Clock(5000.0)
    monkeypatch.setattr(PG, "time", clock)
    job = PC.ServingJob(Journal(eu, "models"), PC.ALS_STATE,
                        PC.parse_als_record, PC.MemoryStateBackend(),
                        port=0, topk_index=False, poll_interval_s=0.02,
                        device="cpu", snapshots=False).start()
    try:
        assert job.wait_ready(30)
        _status_record(eu, ts=5000.0, caught_up_ts=5000.0, lag_bytes=0)
        assert _raw(job.port, b"GET\tALS_MODEL\t3-I\tst=1\n") == \
            b"V\tv3\tst=0.000\n"
        # partitioned: the record stops at its last caught-up instant
        _status_record(eu, ts=5000.0, caught_up_ts=5000.0, lag_bytes=128,
                       caught_up=False)
        seen = []
        for step in (1.25, 2.0, 3.5):
            clock.sleep(step)  # past the 100 ms cache each time
            reply = _raw(job.port, b"GET\tALS_MODEL\t3-I\tst=1\n")
            assert reply.startswith(b"V\tv3\tst=")
            seen.append(reply)
        assert seen == [b"V\tv3\tst=1.250\n", b"V\tv3\tst=3.250\n",
                        b"V\tv3\tst=6.750\n"]
        # healed: caught up again
        clock.sleep(0.2)
        _status_record(eu, ts=clock.now, caught_up_ts=clock.now,
                       lag_bytes=0, caught_up=True)
        assert _raw(job.port, b"GET\tALS_MODEL\t3-I\tst=1\n") == \
            b"V\tv3\tst=0.000\n"
        # untagged reads stay byte-identical
        assert _raw(job.port, b"GET\tALS_MODEL\t3-I\n") == b"V\tv3\n"
    finally:
        job.stop()
