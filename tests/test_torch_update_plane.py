"""The port's online-update plane (``flink_ms_tpu_torch/serve/
update_plane.py``) against the JAX package's: routing aligned with the
consumer's ``hash % N`` filter, rows byte for byte the reference's (v1,
v0, bias), cross-shard item reads through the coalesced MGET cache, the
exactly-once sequence audit across a mid-stream 2 -> 4 reshard, crash
recovery, leases, and read-your-writes against a live port serving job.
Each case of ``tests/test_update_plane.py`` runs on the port; the planes
of the two packages share their logs (one resumes the other's
watermarks), and a co-located plane on ``--updatePlane true`` workers
(``--device cpu``) applies every rating once."""

import os
import random
import threading
import time

import pytest

from flink_ms_tpu.online.sgd import SGDStep as RefSGDStep
from flink_ms_tpu.serve import update_plane as rup
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.online.sgd import SGDStep
from flink_ms_tpu_torch.serve import registry
from flink_ms_tpu_torch.serve import update_plane as up
from flink_ms_tpu_torch.serve.consumer import (ALS_STATE, ServingJob,
                                               make_backend,
                                               parse_als_record)
from flink_ms_tpu_torch.serve.journal import Journal
from flink_ms_tpu_torch.serve.sharded import (ShardedQueryClient, owner_of,
                                              sharded_parse,
                                              spawn_worker_procs,
                                              stop_worker_procs)
from flink_ms_tpu_torch.serve.table import ModelTable

WAIT_S = 30


@pytest.fixture()
def base(tmp_path):
    return str(tmp_path)


def seed_table(n_users=64, n_items=64, dim=4, seed=7, Table=ModelTable):
    rng = random.Random(seed)
    table = Table(4)
    for i in range(n_users):
        table.put(f"{i}-U", ";".join(
            f"{rng.uniform(-1, 1):.6f}" for _ in range(dim)))
    for i in range(n_items):
        table.put(f"{i}-I", ";".join(
            f"{rng.uniform(-1, 1):.6f}" for _ in range(dim)))
    return table


def make_ratings(n, n_users=64, n_items=64, seed=3):
    rng = random.Random(seed)
    return [(rng.randrange(n_users), rng.randrange(n_items),
             round(rng.uniform(0.5, 5.0), 3)) for _ in range(n)]


class TableClient:
    """Stand-in fleet client: MGET against a shared table, with a call
    counter so the read-through cache is observable."""

    def __init__(self, table):
        self.table = table
        self.calls = 0
        self.keys_fetched = 0

    def query_states(self, state, keys):
        self.calls += 1
        self.keys_fetched += len(keys)
        return [self.table.get(k) for k in keys]

    def close(self):
        pass


def _wait(pred, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.01)
    return pred()


# ---------------------------------------------------------------------------
# routing / ownership
# ---------------------------------------------------------------------------

def test_partition_ownership_aligns_with_consumer_filter():
    P = 16
    for user in range(2000):
        p = up.partition_of(user, P)
        for n in (1, 2, 4, 8, 16):
            assert p % n == owner_of(f"{user}-U", n)


def test_partition_of_equals_the_reference_on_10000_users():
    users = list(range(5000)) + [random.Random(1).randrange(10**9)
                                 for _ in range(5000)]
    for P in (1, 4, 16, 64):
        assert [up.partition_of(u, P) for u in users] == \
            [rup.partition_of(u, P) for u in users]
    assert up.default_partitions() == rup.default_partitions()


def test_client_routes_by_user_partition(base):
    cli = up.UpdatePlaneClient(base, "models", partitions=8)
    ratings = make_ratings(200)
    for u, i, r in ratings:
        assert cli.submit(u, i, r) == up.partition_of(u, 8)
    for p, n in cli.totals().items():
        lines = up._read_all_lines(Journal(base, up.input_topic("models", p)))
        assert [int(ln.split("\t", 1)[0]) for ln in lines] == list(range(n))
    cli2 = up.UpdatePlaneClient(base, "models", partitions=8)
    p = cli2.submit(*ratings[0])
    tail = Journal(base, up.input_topic("models", p)).tail_line()
    assert int(tail.split("\t", 1)[0]) == cli.totals()[p]


def test_input_logs_equal_the_reference_producer(tmp_path):
    """The port's producer writes the reference's input logs byte for
    byte, and each package's client resumes the other's sequences."""
    ratings = make_ratings(300)
    logs = {}
    for name, mod in (("port", up), ("ref", rup)):
        d = str(tmp_path / name)
        mod.UpdatePlaneClient(d, "models", partitions=4).submit_many(
            ratings[:200])
        logs[name] = {p: open(os.path.join(
            d, f"{mod.input_topic('models', p)}.log"), "rb").read()
            for p in range(4)}
    assert logs["port"] == logs["ref"]
    d = str(tmp_path / "port")
    rup.UpdatePlaneClient(d, "models", partitions=4).submit_many(ratings[200:])
    assert up.submitted_watermarks(d, "models", 4) == \
        rup.submitted_watermarks(d, "models", 4)
    assert sum(up.submitted_watermarks(d, "models", 4).values()) == 300


def test_tail_line_basics(base):
    j = Journal(base, "t")
    assert j.tail_line() is None
    j.append(["a"])
    assert j.tail_line() == "a"
    j.append([f"row-{i}" for i in range(500)])
    assert j.tail_line() == "row-499"


def test_tail_line_ignores_torn_tail(base):
    j = Journal(base, "t")
    j.append(["committed"])
    with open(j.path, "a") as f:
        f.write("torn-no-newline")
    assert j.tail_line() == "committed"


# ---------------------------------------------------------------------------
# rows byte for byte the reference's
# ---------------------------------------------------------------------------

def _run_plane(mod, base, topic, table, ratings, num_workers, *,
               version="v1", update_bias=False, partitions=8,
               batch_size=32):
    cli = mod.UpdatePlaneClient(base, topic, partitions=partitions)
    cli.submit_many(ratings)
    workers = []
    for w in range(num_workers):
        shared = TableClient(table)
        workers.append(mod.UpdateWorker(
            base, topic, w, num_workers,
            table=table, client_factory=lambda sc=shared: sc,
            partitions=partitions, batch_size=batch_size,
            poll_s=0.005, version=version, update_bias=update_bias,
            visibility_probe=False).start())
    _wait(lambda: sum(mod.applied_watermarks(
        base, topic, partitions).values()) >= len(ratings))
    for w in workers:
        w.stop()
    return cli, workers


def _published_rows(base, topic, partitions=8):
    rows = []
    for p in range(partitions):
        for ln in up._read_all_lines(Journal(base, up.apply_topic(topic, p))):
            fields = ln.split("\t", 3)
            if len(fields) > 3 and fields[3]:
                rows.extend(fields[3].split("|"))
    return rows


@pytest.mark.parametrize("version,bias", [("v1", False), ("v0", False),
                                          ("v1", True)])
def test_plane_matches_reference_rows(base, version, bias):
    """The port's batched plane emits the rows of a reference per-rating
    SGD loop over a duplicate-free stream byte for byte, and the
    reference's own plane emits the same rows, in the same apply logs."""
    rng = random.Random(11)
    items = list(range(64))
    rng.shuffle(items)
    ratings = [(u, items[u], round(rng.uniform(0.5, 5.0), 3))
               for u in range(64)]
    ref_table = seed_table(Table=RefTable)
    zero = ";".join(["0.0"] * 4)
    step = RefSGDStep(ref_table.get, zero, zero, version=version,
                      update_bias=bias)
    ref_rows = []
    for u, i, r in ratings:
        ref_rows.extend(step.process(u, i, r))
    port_step = SGDStep(seed_table().get, zero, zero, version=version,
                        update_bias=bias)
    assert port_step.process_batch(ratings) == \
        RefSGDStep(ref_table.get, zero, zero, version=version,
                   update_bias=bias).process_batch(ratings)

    got = {}
    for name, mod, Table in (("port", up, ModelTable),
                             ("ref", rup, RefTable)):
        dirn = os.path.join(base, f"{name}-{version}-{bias}")
        os.makedirs(dirn)
        _run_plane(mod, dirn, "models", seed_table(Table=Table), ratings, 2,
                   version=version, update_bias=bias)
        got[name] = _published_rows(dirn, "models")
    assert sorted(got["port"]) == sorted(ref_rows) == sorted(got["ref"])


def test_cross_shard_item_reads_are_coalesced_and_cached(base):
    table = seed_table()
    cli = up.UpdatePlaneClient(base, "models", partitions=4)
    remote_items = [i for i in range(64) if owner_of(f"{i}-I", 2) != 0]
    users_of_0 = [u for u in range(64) if up.partition_of(u, 4) % 2 == 0]
    ratings = [(users_of_0[k % len(users_of_0)],
                remote_items[k % len(remote_items)], 3.0)
               for k in range(40)]
    cli.submit_many(ratings)
    tc = TableClient(table)
    w = up.UpdateWorker(
        base, "models", 0, 2, table=table,
        client_factory=lambda: tc, partitions=4, batch_size=64,
        poll_s=0.005, cache_ttl_s=30.0, visibility_probe=False).start()
    assert _wait(lambda: w.stats["applied"] >= len(ratings))
    assert w.stats["applied"] == len(ratings)
    assert 0 < tc.calls <= 8
    calls_before = tc.calls
    cli.submit_many(ratings)
    assert _wait(lambda: w.stats["applied"] >= 2 * len(ratings))
    assert tc.calls == calls_before
    w._overlay.clear()
    cli.submit_many(ratings)
    assert _wait(lambda: w.stats["applied"] >= 3 * len(ratings))
    w.stop()
    assert w.stats["applied"] == 3 * len(ratings)
    assert w.stats["cache_hits"] > 0
    assert tc.calls == calls_before
    assert tc.keys_fetched <= len(set(f"{i}-I" for _, i, _ in ratings)) + 2


# ---------------------------------------------------------------------------
# exactly-once: reshard + crash recovery + audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [up, rup], ids=["port", "ref"])
def test_audit_detects_crafted_gaps_and_duplicates(base, mod):
    cli = up.UpdatePlaneClient(base, "models", partitions=1)
    cli.submit_many([(1, 2, 3.0)] * 10)
    app = Journal(base, up.apply_topic("models", 0))
    app.append(["0\t4\t100\t", "6\t8\t200\t", "6\t10\t300\t"])
    audit = mod.audit_partitions(base, "models", 1)
    assert audit["submitted"] == 10
    assert audit["gaps"] == 2
    assert audit["duplicates"] == 2
    assert audit["lost"] == 2
    assert not audit["clean"]
    assert audit == rup.audit_partitions(base, "models", 1)


def test_mid_stream_reshard_2_to_4_zero_lost_zero_doubled(base):
    table = seed_table(256, 256)
    cli = up.UpdatePlaneClient(base, "models", partitions=8)
    stop_produce = threading.Event()
    produced = []

    def producer():
        k = 0
        while not stop_produce.is_set() and len(produced) < 3000:
            batch = make_ratings(50, 256, 256, seed=k)
            cli.submit_many(batch)
            produced.extend(batch)
            k += 1
            time.sleep(0.002)

    gen1 = [up.UpdateWorker(
        base, "models", w, 2, table=table,
        client_factory=lambda: TableClient(table), partitions=8,
        batch_size=64, poll_s=0.002, visibility_probe=False).start()
        for w in range(2)]
    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.25)
    for w in gen1:
        w.stop()
    gen2 = [up.UpdateWorker(
        base, "models", w, 4, table=table,
        client_factory=lambda: TableClient(table), partitions=8,
        batch_size=64, poll_s=0.002, visibility_probe=False).start()
        for w in range(4)]
    stop_produce.set()
    t.join(timeout=10)
    cli.sync()
    _wait(lambda: sum(up.applied_watermarks(base, "models", 8).values())
          >= len(produced))
    for w in gen2:
        w.stop()
    audit = up.audit_partitions(base, "models", 8)
    assert audit["submitted"] == len(produced)
    assert audit["lost"] == 0, audit
    assert audit["duplicates"] == 0, audit
    assert audit["clean"]
    assert audit == rup.audit_partitions(base, "models", 8)


def test_a_plane_resumes_the_other_packages_watermarks(base):
    """The reference's plane applies the first wave and stops; the port's
    takes the leases and applies the second from the recorded watermarks
    (and the other way round): nothing lost, nothing applied twice."""
    table = seed_table()
    cli = up.UpdatePlaneClient(base, "models", partitions=4)
    total = 0
    for k, mod in enumerate((rup, up, rup)):
        wave = make_ratings(150, seed=20 + k)
        cli.submit_many(wave)
        total += len(wave)
        w = mod.UpdateWorker(base, "models", 0, 1, table=table, partitions=4,
                             batch_size=16, poll_s=0.002,
                             visibility_probe=False).start()
        _wait(lambda: sum(up.applied_watermarks(
            base, "models", 4).values()) >= total)
        w.stop()
    audit = up.audit_partitions(base, "models", 4)
    assert (audit["submitted"], audit["lost"], audit["duplicates"]) == \
        (total, 0, 0)


def test_recovery_republishes_last_commit_rows(base):
    table = seed_table()
    row = F.format_als_row(5, "U", [0.5, 0.5, 0.5, 0.5])
    app = Journal(base, up.apply_topic("models", 0))
    app.append([f"0\t1\t37\t{row}"])
    w = up.UpdateWorker(base, "models", 0, 1, table=table,
                        partitions=1, visibility_probe=False).start()
    _wait(lambda: w.stats["replayed_rows"] >= 1, 10)
    w.stop()
    assert w.stats["replayed_rows"] == 1
    assert row in Journal(base, "models").read_lines()
    assert up.applied_watermarks(base, "models", 1)[0] == 1


def test_replay_skips_already_applied_sequences(base):
    table = seed_table()
    ratings = make_ratings(120)
    cli = up.UpdatePlaneClient(base, "models", partitions=4)
    cli.submit_many(ratings)
    w1 = up.UpdateWorker(base, "models", 0, 1, table=table, partitions=4,
                         batch_size=16, poll_s=0.002,
                         visibility_probe=False).start()
    _wait(lambda: sum(up.applied_watermarks(base, "models", 4).values())
          >= len(ratings))
    w1.stop()
    w2 = up.UpdateWorker(base, "models", 0, 1, table=table, partitions=4,
                         batch_size=16, poll_s=0.002,
                         visibility_probe=False).start()
    time.sleep(0.3)
    w2.stop()
    audit = up.audit_partitions(base, "models", 4)
    assert audit["duplicates"] == 0
    assert audit["lost"] == 0
    assert audit["clean"]


@pytest.mark.parametrize("sibling", [up, rup], ids=["port", "ref"])
def test_lease_excludes_sibling_replica(base, sibling):
    """Two workers of one shard (the sibling of either package) contend on
    the flock: exactly one holds each partition, and the sibling takes
    over when the holder releases."""
    table = seed_table()
    a = up.UpdateWorker(base, "models", 0, 1, table=table, partitions=4,
                        poll_s=0.005, visibility_probe=False).start()
    _wait(lambda: len(a.held_partitions) >= 4, 5)
    b = sibling.UpdateWorker(base, "models", 0, 1, table=table,
                             partitions=4, poll_s=0.005,
                             visibility_probe=False).start()
    time.sleep(0.3)
    assert a.held_partitions == [0, 1, 2, 3]
    assert b.held_partitions == []
    a.stop()
    _wait(lambda: len(b.held_partitions) >= 4, 5)
    assert b.held_partitions == [0, 1, 2, 3]
    b.stop()


# ---------------------------------------------------------------------------
# read-your-writes against a live serving job; the co-located plane
# ---------------------------------------------------------------------------

def test_visibility_probe_against_live_serving_job(base):
    journal = Journal(base, "models")
    rng = random.Random(5)
    rows = []
    for i in range(32):
        rows.append(F.format_als_row(
            i, "U", [rng.uniform(-1, 1) for _ in range(4)]))
        rows.append(F.format_als_row(
            i, "I", [rng.uniform(-1, 1) for _ in range(4)]))
    journal.append(rows)
    job = ServingJob(journal, ALS_STATE,
                     sharded_parse(parse_als_record, 0, 1),
                     make_backend("memory", None), port=0,
                     poll_interval_s=0.01, device="cpu").start()
    try:
        assert job.wait_ready(20)
        # the registry's ready flag lags the job's ready event: wait for it
        # before the worker resolves anything through the registry
        assert _wait(lambda: (registry.resolve(job.job_id) or {}).get("ready"),
                     20)
        w = up.UpdateWorker(base, "models", 0, 1, job=job,
                            model_journal=journal, partitions=4,
                            batch_size=8, poll_s=0.005)
        w.start()
        cli = up.UpdatePlaneClient(base, "models", partitions=4)
        cli.submit_many(make_ratings(64, 32, 32))
        _wait(lambda: w.stats["applied"] >= 64 and w._probe.observed >= 1,
              20)
        w.stop()
        assert w.stats["applied"] == 64
        assert w._probe.observed >= 1
        assert w._probe.last_visibility_s < 2.0
    finally:
        job.stop()


def test_colocated_plane_on_sharded_workers(tmp_path, monkeypatch):
    """``--updatePlane true`` on two ``--device cpu`` workers of a
    replicated job group: the workers' co-located planes apply every
    submitted rating exactly once (the audit), and each updated user's
    row is served by its owner."""
    monkeypatch.setenv("TPUMS_UPDATE_POLL_S", "0.005")
    monkeypatch.setenv("TPUMS_HEARTBEAT_S", "0.2")
    bus = str(tmp_path / "bus")
    journal = Journal(bus, "models")
    rng = random.Random(2)
    journal.append([F.format_als_row(i, t, [rng.uniform(-1, 1)
                                            for _ in range(4)])
                    for i in range(40) for t in ("U", "I")])
    os.makedirs(tmp_path / "ports")
    procs, ports = spawn_worker_procs(
        2, bus, "models", str(tmp_path / "ports"), device="cpu",
        extra_args=["--updatePlane", "true", "--updatePartitions", "4",
                    "--replicaIndex", "0", "--jobGroup", "upg",
                    "--pollInterval", "0.01"], timeout_s=60)
    try:
        ratings = make_ratings(200, 40, 40, seed=8)
        up.UpdatePlaneClient(bus, "models", partitions=4).submit_many(
            ratings)
        assert _wait(lambda: sum(up.applied_watermarks(
            bus, "models", 4).values()) >= len(ratings), 60)
        audit = up.audit_partitions(bus, "models", 4)
        assert (audit["submitted"], audit["lost"], audit["duplicates"]) == \
            (200, 0, 0)
        last = {}
        for row in _published_rows(bus, "models", 4):
            i, t, v = row.split(",", 2)
            last[f"{i}-{t}"] = v
        with ShardedQueryClient([("127.0.0.1", p) for p in ports]) as c:
            users = sorted(k for k in last if k.endswith("-U"))
            assert _wait(lambda: c.query_states(ALS_STATE, users)
                         == [last[k] for k in users], 30)
    finally:
        stop_worker_procs(procs)
    assert all(p.returncode is not None for p in procs)
