"""The port's snapshot plane against the JAX package's, on the CPU: the
column files and manifests are the reference's byte for byte (apart from
``ts``), a snapshot either package publishes bootstraps the other's table
and serving job, both fall from a bad checksum to an older snapshot and
then to replay, a job started with the defaults publishes and restores
snapshots as the reference's does, and arena snapshots are refused by
name.  Tables compare as equal dicts (tolerance 0)."""

import json
import os
import shutil
import time

import pytest

from flink_ms_tpu.serve import consumer as RC
from flink_ms_tpu.serve import journal as RJ
from flink_ms_tpu.serve import registry as ref_registry
from flink_ms_tpu.serve import snapshot as RS
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu_torch.obs import metrics as port_metrics
from flink_ms_tpu_torch.serve import consumer as PC
from flink_ms_tpu_torch.serve import journal as PJ
from flink_ms_tpu_torch.serve import registry as port_registry
from flink_ms_tpu_torch.serve import snapshot as PS
from flink_ms_tpu_torch.serve.journal import OffsetTruncatedError
from flink_ms_tpu_torch.serve.table import ModelTable as PortTable

STATE = "ALS_MODEL"
PKG = {"reference": (RS, RefTable, RC, RJ), "port": (PS, PortTable, PC, PJ)}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "registry"))
    for name in ("TPUMS_SNAPSHOTS", "TPUMS_SNAPSHOT_MIN_BYTES",
                 "TPUMS_SNAPSHOT_KEEP", "TPUMS_COMPACT", "TPUMS_TABLE"):
        monkeypatch.delenv(name, raising=False)


def _rows(n=300, tag="v"):
    rows = [(f"{i}-I", f"{tag}{i};{i * 0.25}") for i in range(n)]
    rows += [("k ey-I", "v\x85al ue\v\f"), ("MEAN-I", "0.5;0.5"),
             ("tab-freeé-U", " ")]
    return rows


def _table(Table, rows, n_shards=4):
    t = Table(n_shards)
    t.put_many(rows)
    return t


def _strip(manifest):
    m = dict(manifest)
    m.pop("ts")
    m.pop("path", None)
    return m


def _files(path):
    out = {}
    for name in ("keys.txt", "vals.txt"):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    with open(os.path.join(path, "MANIFEST.json")) as f:
        out["MANIFEST.json"] = _strip(json.load(f))
    return out


@pytest.mark.parametrize("n_rows,shards", [(0, 1), (1, 2), (300, 4),
                                           (2000, 8)])
@pytest.mark.parametrize("identity", [(0, 1), (1, 3)])
def test_published_files_equal_the_reference(tmp_path, n_rows, shards,
                                             identity):
    rows = _rows(n_rows) if n_rows else []
    got = {}
    for name, (S, Table, _, _) in PKG.items():
        m = S.publish(str(tmp_path / name), _table(Table, rows, shards),
                      offset=4321, shard=identity[0], num_shards=identity[1],
                      group="g" if identity[1] > 1 else None, topic="als")
        assert os.path.basename(m["path"]).startswith(
            f"snap-{identity[1]}-{identity[0]}-4321-")
        got[name] = (_files(m["path"]), _strip(m))
    assert got["port"] == got["reference"]
    assert got["port"][1]["rows"] == len(rows)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_one_package_publishes_the_other_bootstraps(tmp_path, writer,
                                                    reader):
    root = str(tmp_path / "snaps")
    W, R = PKG[writer], PKG[reader]
    src = _table(W[1], _rows())
    W[0].publish(root, src, offset=77, shard=0, num_shards=1, topic="als")
    dst = R[1](4)
    info = R[0].bootstrap(dst, root, owner=(0, 1))
    assert (info["offset"], info["rows"], info["members"], info["exact"]) \
        == (77, len(_rows()), 1, True)
    assert dict(dst.items()) == dict(src.items())
    # a resharded family: the reader takes its slice of two members
    fam = str(tmp_path / "family")
    for s in range(2):
        part = W[1](4)
        part.put_many([(k, v) for n, (k, v) in enumerate(_rows())
                       if n % 2 == s or s == 1])
        W[0].publish(fam, part, offset=100 + s, shard=s, num_shards=2)
    want, got = [], []
    for S, Table in ((RS, RefTable), (PS, PortTable)):
        t = Table(4)
        plan = S.bootstrap(t, fam, owner=(1, 3))
        want.append((plan["offset"], plan["members"], plan["exact"]))
        got.append(dict(t.items()))
    assert want[0] == want[1] == (100, 2, False)
    assert got[0] == got[1] and 0 < len(got[0]) < len(_rows())


@pytest.mark.parametrize("name", ["reference", "port"])
def test_bad_checksum_falls_to_older_then_to_replay(tmp_path, name):
    S, Table = PKG[name][:2]
    root = str(tmp_path / "snaps")
    S.publish(root, _table(Table, _rows(50, "old")), 100, keep=5)
    time.sleep(0.002)
    S.publish(root, _table(Table, _rows(50, "new")), 200, keep=5)
    ms = PS.list_manifests(root)
    assert ms == RS.list_manifests(root)
    assert [m["offset"] for m in ms] == [100, 200]
    with open(os.path.join(ms[1]["path"], "vals.txt"), "ab") as f:
        f.write(b"garbage\n")
    seen = []
    t = PortTable(4)
    info = PS.bootstrap(t, root, owner=(0, 1),
                        on_corrupt=lambda m: seen.append(m["path"]))
    assert info["offset"] == 100 and t.get("3-I") == "old3;0.75"
    assert seen == [ms[1]["path"]]
    with pytest.raises(PS.SnapshotCorruptError, match="checksum mismatch"):
        PS.read_columns(ms[1])
    with open(os.path.join(ms[0]["path"], "keys.txt"), "ab") as f:
        f.write(b"extra\n")
    t2 = PortTable(4)
    assert PS.bootstrap(t2, root, owner=(0, 1)) is None
    assert len(t2) == 0  # verified before any row loads


def test_resolve_and_prune_equal_the_reference(tmp_path):
    """The same manifests resolve to the same plan in both packages, for
    every owner and offset window, and both prune the same members."""
    roots = {k: str(tmp_path / k) for k in PKG}
    specs = [(100, 0, 4), (101, 1, 4), (102, 2, 4), (103, 3, 4),
             (150, 0, 1), (160, 0, 2), (90, 1, 2), (170, 0, 2)]
    for name, root in roots.items():
        S, Table = PKG[name][:2]
        for off, shard, n in specs:
            S.publish(root, _table(Table, _rows(20)), off, shard=shard,
                      num_shards=n, keep=3)
    listed = {k: [(m["offset"], m["shard"], m["num_shards"])
                  for m in S.list_manifests(roots[k])]
              for k, (S, *_rest) in PKG.items()}
    assert listed["port"] == listed["reference"]
    for owner in ((0, 1), (1, 2), (2, 4), (0, 3), None):
        for lo, hi in ((None, None), (101, None), (None, 150), (161, None)):
            plans = []
            for k, (S, *_rest) in PKG.items():
                p = S.resolve(roots[k], owner=owner, min_offset=lo,
                              max_offset=hi)
                plans.append(None if p is None else (
                    p["offset"], p["exact"],
                    [(m["offset"], m["shard"], m["num_shards"])
                     for m in p["members"]]))
            assert plans[0] == plans[1], (owner, lo, hi)


def test_registry_snapshot_record_is_the_reference(tmp_path):
    m = PS.publish(str(tmp_path / "s"), _table(PortTable, _rows(5)), 10,
                   shard=0, num_shards=2, group="g1", topic="als")
    scope = port_registry.snapshot_scope("g1", "als", 2, 0)
    assert scope == ref_registry.snapshot_scope("g1", "als", 2, 0)
    for reg in (port_registry, ref_registry):
        rec = reg.resolve_snapshot(scope)
        assert rec["offset"] == 10 and rec["checksum"] == m["checksum"]
    assert port_registry._snapshot_path(scope) == \
        ref_registry._snapshot_path(scope)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_arena_snapshots_cross_the_packages(tmp_path, writer, reader):
    """An arena table of either package publishes ``arena/1`` (one copy of
    its mapped file); the other package lists it, reads it back row for
    row, and bootstraps a dict table and an arena table from it."""
    from flink_ms_tpu.serve import arena as RA
    from flink_ms_tpu_torch.serve import arena as PA

    ARENA = {"reference": RA, "port": PA}
    rows = [(f"{i % 300}-{'UI'[i % 2]}", ";".join(f"{0.5 * j + i}"
                                                    for j in range(5)))
            for i in range(700)]
    table = ARENA[writer].ArenaModelTable(2, dir=str(tmp_path / "live"),
                                          capacity=64)
    table.put_many_columns([k for k, _ in rows], [v for _, v in rows])
    want = dict(rows)
    W, R = PKG[writer][0], PKG[reader][0]
    root = str(tmp_path / "snaps")
    m = W.publish(root, table, 77)
    table.close()
    assert m["format"] == RS.ARENA_FORMAT == PS.ARENA_FORMAT
    (listed,) = R.list_manifests(root)
    assert listed["rows"] == len(want) and listed["offset"] == 77
    keys, vals = R.read_columns(listed)
    assert dict(zip(keys, vals)) == want and len(keys) == len(want)
    dict_table = PKG[reader][1](2)
    info = R.bootstrap(dict_table, root, owner=(0, 1))
    assert info["offset"] == 77 and dict(dict_table.items()) == want
    arena_table = ARENA[reader].ArenaModelTable(
        2, dir=str(tmp_path / "restored"))
    try:
        assert R.bootstrap(arena_table, root, owner=(0, 1))["rows"] == \
            len(want)
        assert dict(arena_table.items()) == want
    finally:
        arena_table.close()


# ---------------------------------------------------------------------------
# the serving jobs
# ---------------------------------------------------------------------------

def _seed(tmp_path, n=2000, keys=200):
    d = str(tmp_path / "journal")
    j = PJ.Journal(d, "als")
    j.append([f"{i % keys},I,v{i}" for i in range(n)])
    return d


def _job(name, d, **kw):
    _, _, C, J = PKG[name]
    kw.setdefault("backend", C.MemoryStateBackend())
    kw.setdefault("topk_index", False)
    kw.setdefault("poll_interval_s", 0.02)
    if name == "port":
        kw.setdefault("device", "cpu")
    return C.ServingJob(J.Journal(d, "als"), STATE, C.parse_als_record,
                        kw.pop("backend"), host="127.0.0.1", port=0, **kw)


def _run(name, d, **kw):
    job = _job(name, d, **kw).start()
    assert job.wait_ready(30)
    return job


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference"),
                                           ("port", "port")])
def test_a_job_restarts_from_the_other_packages_snapshot(tmp_path, writer,
                                                         reader):
    d = _seed(tmp_path)
    first = _run(writer, d, snapshot_min_bytes=1)
    assert first.bootstrap_source == "replay"
    want = dict(first.table.items())
    snap_off = first.offset
    first.stop()
    ms = PS.list_manifests(PS.snapshot_root(d, "als"))
    assert [m["offset"] for m in ms] == [snap_off]
    PJ.Journal(d, "als").append(["0,I,tail-row"])
    second = _run(reader, d, snapshot_min_bytes=1)
    try:
        assert second.bootstrap_source == "snapshot"
        assert second.health()["bootstrap_source"] == "snapshot"
        want["0-I"] = "tail-row"
        assert dict(second.table.items()) == want
        assert second.ingest_rows == 1  # only the tail was replayed
    finally:
        second.stop()


def test_default_job_publishes_and_restores_like_the_reference(tmp_path):
    """No ``TPUMS_SNAPSHOTS`` set: both packages' jobs publish a snapshot
    at ready (the journal passes the 1 MiB default), their restarts from
    an older checkpoint lay it over the table, and ``TPUMS_SNAPSHOTS=0``
    turns it all off in both."""
    rows = [f"{i % 5000},I,{'x' * 220}{i}" for i in range(6000)]
    out = {}
    for name in ("reference", "port"):
        d = str(tmp_path / name)
        PJ.Journal(d, "als").append(rows[:100])
        ckpt = str(tmp_path / f"ckpt-{name}")
        C = PKG[name][2]
        job = _run(name, d, backend=C.FsStateBackend(ckpt))
        job.backend.snapshot(job.table, job.offset)  # an early checkpoint
        job.stop()
        PJ.Journal(d, "als").append(rows[100:])
        job = _run(name, d, backend=C.FsStateBackend(ckpt))
        first = (job.bootstrap_source, job.offset)
        job.stop()
        ms = PS.list_manifests(PS.snapshot_root(d, "als"))
        job = _run(name, d, backend=C.FsStateBackend(ckpt))
        try:
            out[name] = (first, [(m["offset"], m["rows"]) for m in ms],
                         job.bootstrap_source, job.offset,
                         dict(job.table.items()))
        finally:
            job.stop()
    assert out["port"] == out["reference"]
    first, published, source, offset, table = out["port"]
    end = PJ.Journal(str(tmp_path / "port"), "als").end_offset()
    assert first == ("checkpoint", end)
    assert published == [(end, 5000)] and (source, offset) == (
        "snapshot", end)
    assert len(table) == 5000


@pytest.mark.parametrize("name", ["reference", "port"])
def test_snapshots_off_and_corrupt_snapshots_replay(tmp_path, monkeypatch,
                                                   name):
    d = _seed(tmp_path, n=400)
    _run(name, d, snapshot_min_bytes=1).stop()
    monkeypatch.setenv("TPUMS_SNAPSHOTS", "0")
    job = _run(name, d)
    assert job.bootstrap_source == "replay" and len(job.table) == 200
    job.stop()
    monkeypatch.delenv("TPUMS_SNAPSHOTS")
    (m,) = PS.list_manifests(PS.snapshot_root(d, "als"))
    with open(os.path.join(m["path"], "vals.txt"), "ab") as f:
        f.write(b"junk\n")

    def failures():
        for c in port_metrics.get_registry().snapshot()["counters"]:
            if c["name"] == "tpums_snapshot_restore_failures_total" and \
                    c["labels"].get("state") == STATE:
                return c["value"]
        return 0

    before = failures()
    job = _run(name, d)
    try:
        assert job.bootstrap_source == "replay" and len(job.table) == 200
        if name == "port":
            assert failures() == before + 1
    finally:
        job.stop()


def test_an_arena_snapshot_does_not_bootstrap_a_port_job(tmp_path):
    """An ``arena/1`` member whose arena file is missing is corrupt: the
    port's job counts it and falls down the chain to a full replay, as
    the reference's job does."""
    d = _seed(tmp_path, n=50)
    root = PS.snapshot_root(d, "als")
    arena = os.path.join(root, "snap-1-0-999999-1")
    os.makedirs(arena)
    with open(os.path.join(arena, "MANIFEST.json"), "w") as f:
        json.dump({"format": "arena/1", "shard": 0, "num_shards": 1,
                   "offset": 999999, "rows": 1, "checksum": 0, "ts": 1.0}, f)
    (m,) = PS.list_manifests(root)
    with pytest.raises(PS.SnapshotCorruptError, match="unreadable arena"):
        PS.read_columns(m)
    with pytest.raises(RS.SnapshotCorruptError, match="unreadable arena"):
        RS.read_columns(RS.list_manifests(root)[0])
    failures = port_metrics.get_registry().counter(
        "tpums_snapshot_restore_failures_total", state="ALS_MODEL")
    before = failures.value
    for name in ("port", "reference"):
        job = _run(name, d)
        try:
            assert job.bootstrap_source == "replay" and len(job.table) == 50
        finally:
            job.stop()
    assert failures.value == before + 1


@pytest.mark.parametrize("name", ["reference", "port"])
def test_truncated_offsets_recover_through_a_snapshot(tmp_path, name):
    """A consumer below retention resumes at a covering snapshot; one
    inside the hole narrows the counted gap but is never resumed from."""
    d = _seed(tmp_path, n=600, keys=60)
    S, Table, C, J = PKG[name]
    end = J.Journal(d, "als").end_offset()
    root = S.snapshot_root(d, "als")
    S.publish(root, _table(Table, [(f"{i % 60}-I", f"v{i}")
                                   for i in range(600)]), end)
    job = _job(name, d)
    err = OffsetTruncatedError(0, 500, lossless=False, reason="expired")
    assert job._recover_truncated(err) == end
    assert job.table.get("59-I") == "v599"
    shutil.rmtree(root)
    S.publish(root, _table(Table, [(f"{i % 60}-I", f"v{i}")
                                   for i in range(400)]), 400)
    job2 = _job(name, d)
    err = OffsetTruncatedError(0, 500, lossless=False, reason="expired")
    assert job2._recover_truncated(err) == 500
    assert job2.journal.expired_bytes_skipped == 100
    assert job2.table.get("39-I") == "v399"
    shutil.rmtree(root)
    job3 = _job(name, d)
    assert job3._recover_truncated(err) == 500
    assert job3.journal.expired_bytes_skipped == 500
    for j in (job, job2, job3):
        # never started: close the socket (the reference's stop() would
        # wait for a serve loop that never ran)
        j.server._server.server_close()
