"""The port's HA serving plane (``flink_ms_tpu_torch/serve/ha.py``) against
the JAX package's: the retry policy, HEALTH's readiness gate, the registry
heartbeat, client failover across a replica set with zero client-visible
errors, and the supervisor's respawn of a SIGKILLed replica (``--device
cpu`` workers here).  Each case of ``tests/test_ha_serving.py`` runs on the
port (its registry cases are in ``test_torch_fleet_registry.py``); a
replica set that mixes one job of each package serves either package's
client through a failover, and a fleet member of each package writes the
same snapshot files, on the dict table and on the arena (the default of
both packages' fleet members)."""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from flink_ms_tpu.serve import consumer as RC
from flink_ms_tpu.serve import ha as RH
from flink_ms_tpu.serve import journal as RJ
from flink_ms_tpu.serve import sharded as RSH
from flink_ms_tpu.serve.client import RetryPolicy as RefRetryPolicy
from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.serve import registry
from flink_ms_tpu_torch.serve import snapshot as PS
from flink_ms_tpu_torch.serve.client import QueryClient, RetryPolicy
from flink_ms_tpu_torch.serve.consumer import (ALS_STATE, ServingJob,
                                               make_backend,
                                               parse_als_record)
from flink_ms_tpu_torch.serve.ha import (HAShardedClient, ReplicaSupervisor,
                                         shard_group)
from flink_ms_tpu_torch.serve.journal import Journal
from flink_ms_tpu_torch.serve.sharded import sharded_parse


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    for name in ("TPUMS_SNAPSHOTS", "TPUMS_SNAPSHOT_MIN_BYTES",
                 "TPUMS_COMPACT", "TPUMS_TABLE"):
        monkeypatch.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

def test_retry_policy_delays_bounded_and_jittered():
    p = RetryPolicy(attempts=6, backoff_s=0.1, max_backoff_s=0.5, jitter=0.25)
    for i in range(20):
        d = p.delay_s(i)
        base = min(0.1 * 2 ** i, 0.5)
        assert base <= d <= base * 1.25 + 1e-9
    assert RetryPolicy().delay_s(0) == 0.0
    assert RetryPolicy().attempts == 2
    with pytest.raises(ValueError):
        RetryPolicy(attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(jitter=2.0)


def test_roundtrip_retries_through_server_restart():
    from flink_ms_tpu_torch.serve.server import LookupServer
    from flink_ms_tpu_torch.serve.table import ModelTable

    table = ModelTable(2)
    table.put("k", "v")
    srv = LookupServer({ALS_STATE: table}, host="127.0.0.1", port=0).start()
    port = srv.port
    c = QueryClient("127.0.0.1", port, timeout_s=5,
                    retry=RetryPolicy(attempts=5, backoff_s=0.02))
    c_noretry = QueryClient("127.0.0.1", port, timeout_s=5,
                            retry=RetryPolicy(attempts=1))
    try:
        assert c.query_state(ALS_STATE, "k") == "v"
        assert c_noretry.query_state(ALS_STATE, "k") == "v"
        srv.stop()
        srv = LookupServer(
            {ALS_STATE: table}, host="127.0.0.1", port=port).start()
        assert c.query_state(ALS_STATE, "k") == "v"
        with pytest.raises((ConnectionError, OSError)):
            c_noretry.query_state(ALS_STATE, "k")
    finally:
        c.close()
        c_noretry.close()
        srv.stop()


# ---------------------------------------------------------------------------
# HEALTH + readiness gating
# ---------------------------------------------------------------------------

def test_health_verb_readiness_gates_replay(tmp_path):
    journal = Journal(str(tmp_path / "bus"), "t")
    n = 500
    journal.append([F.format_als_row(i, "U", [0.5, float(i)])
                    for i in range(n)])
    job = ServingJob(
        journal, ALS_STATE, parse_als_record, make_backend("memory", None),
        host="127.0.0.1", port=0, poll_interval_s=0.01, job_id="health-e2e",
        replica_of="hg/shard-0", replica_index=0, device="cpu",
    ).start()
    try:
        with QueryClient("127.0.0.1", job.port, timeout_s=10) as c:
            deadline = time.time() + 30
            while time.time() < deadline:
                h = c.health(ALS_STATE)
                if h["ready"]:
                    break
                assert h["status"] == "replaying"
                time.sleep(0.005)
            assert h["ready"] and h["status"] == "ready"
            assert h["keys"] == n
            assert h["backlog_bytes"] == 0
            assert h["state"] == ALS_STATE
            assert h["replica_of"] == "hg/shard-0" and h["replica"] == 0
            assert h["topology_group"] is None and h["generation"] is None
        deadline = time.time() + 30
        entry = registry.resolve("health-e2e")
        while not (entry and entry.get("ready")) and time.time() < deadline:
            time.sleep(0.02)
            entry = registry.resolve("health-e2e")
        assert entry["ready"] is True
        assert entry["replica_of"] == "hg/shard-0"
        assert "heartbeat" in entry and entry["ttl_s"] > 0
    finally:
        job.stop()
    assert registry.resolve("health-e2e") is None


def test_bare_lookup_server_health_is_ready():
    from flink_ms_tpu_torch.serve.server import LookupServer
    from flink_ms_tpu_torch.serve.table import ModelTable

    table = ModelTable(2)
    table.put("a", "1")
    srv = LookupServer({ALS_STATE: table}, host="127.0.0.1", port=0).start()
    try:
        with QueryClient("127.0.0.1", srv.port) as c:
            h = c.health(ALS_STATE)
            assert h["ready"] is True and h["keys"] == 1
            with pytest.raises(RuntimeError):
                c.health("NO_SUCH_STATE")
    finally:
        srv.stop()


def test_heartbeat_refreshes_registry(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUMS_HEARTBEAT_S", "0.05")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "10")
    job = ServingJob(
        Journal(str(tmp_path / "bus"), "t"), ALS_STATE, parse_als_record,
        make_backend("memory", None), host="127.0.0.1", port=0,
        poll_interval_s=0.01, job_id="hb-refresh", device="cpu",
    ).start()
    try:
        first = registry.resolve("hb-refresh")["heartbeat"]
        deadline = time.time() + 10
        while time.time() < deadline:
            entry = registry.resolve("hb-refresh")
            if entry and entry["heartbeat"] > first:
                break
            time.sleep(0.02)
        assert entry["heartbeat"] > first, "heartbeat never refreshed"
    finally:
        job.stop()


# ---------------------------------------------------------------------------
# client failover (in-process replica sets)
# ---------------------------------------------------------------------------

def _seed_journal(tmp_path, n_users=12, n_items=16, k=3, seed=0):
    journal = Journal(str(tmp_path / "bus"), "models")
    rng = np.random.default_rng(seed)
    uf = rng.normal(size=(n_users, k))
    itf = rng.normal(size=(n_items, k))
    rows = [F.format_als_row(u, "U", uf[u]) for u in range(n_users)]
    rows += [F.format_als_row(i, "I", itf[i]) for i in range(n_items)]
    journal.append(rows)
    return journal, uf, itf


def _inprocess_replica(journal, group, replica, package="port"):
    kw = dict(host="127.0.0.1", port=0, poll_interval_s=0.01,
              job_id=f"{group}:s0r{replica}",
              replica_of=shard_group(group, 0), replica_index=replica,
              topk_index=False)
    if package == "port":
        return ServingJob(journal, ALS_STATE, parse_als_record,
                          make_backend("memory", None), device="cpu",
                          **kw).start()
    return RC.ServingJob(RJ.Journal(journal.dir, journal.topic), ALS_STATE,
                         RC.parse_als_record, RC.make_backend("memory", None),
                         snapshots=False, table="dict", **kw).start()


def _await_registry_ready(job_ids, timeout_s=30):
    """A job's ready event fires before its registry entry says ready (the
    consume thread writes the flag after the flip): a registry-resolved
    client sees a replica only from then on."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all((registry.resolve(j) or {}).get("ready") for j in job_ids):
            return
        time.sleep(0.02)
    raise AssertionError(f"registry never showed {job_ids} ready")


def test_failover_absorbs_dead_replica_with_zero_errors(tmp_path):
    journal, uf, _ = _seed_journal(tmp_path)
    jobs = [_inprocess_replica(journal, "ha", r) for r in range(2)]
    try:
        for job in jobs:
            assert job.wait_ready(30)
        _await_registry_ready([job.job_id for job in jobs])
        client = HAShardedClient(
            1, job_group="ha",
            retry=RetryPolicy(attempts=5, backoff_s=0.01, max_backoff_s=0.2),
            timeout_s=5)
        with client:
            keys = [f"{u}-U" for u in range(len(uf))]
            for key in keys:
                assert client.query_state(ALS_STATE, key)
            # stop the replica the client sticks to, whichever it is
            sticky = client._shards[0].prefer
            next(j for j in jobs if j.port == sticky[1]).server.stop()
            errors = []
            for _ in range(3):
                for key in keys:
                    try:
                        assert client.query_state(ALS_STATE, key) is not None
                    except Exception as e:  # pragma: no cover
                        errors.append((key, e))
            assert errors == [], f"client-visible errors: {errors[:3]}"
            assert client.failovers > 0
            got = client.query_states(ALS_STATE, keys)
            assert all(v is not None for v in got)
            assert client.total_count(ALS_STATE) == len(uf) + 16
    finally:
        for job in jobs:
            job.stop()


def test_failover_exhausts_budget_when_all_replicas_dead(tmp_path):
    journal, _, _ = _seed_journal(tmp_path)
    job = _inprocess_replica(journal, "solo", 0)
    assert job.wait_ready(30)
    client = HAShardedClient(
        1, job_group="solo",
        retry=RetryPolicy(attempts=3, backoff_s=0.01, max_backoff_s=0.05),
        timeout_s=2)
    with client:
        assert client.query_state(ALS_STATE, "0-U") is not None
        job.stop()
        t0 = time.monotonic()
        with pytest.raises((ConnectionError, OSError)):
            client.query_state(ALS_STATE, "0-U")
        assert time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_mixed_replica_set_fails_over_across_the_packages(tmp_path,
                                                          client_pkg):
    """Replica 0 a port job, replica 1 a reference job, one shard group:
    either package's HA client reads the same bytes from both, and when
    the replica it sticks to dies it fails over to the other package's
    replica with zero client-visible errors."""
    journal, uf, itf = _seed_journal(tmp_path, seed=4)
    jobs = [_inprocess_replica(journal, "mix", 0, "port"),
            _inprocess_replica(journal, "mix", 1, "ref")]
    Client = HAShardedClient if client_pkg == "port" else RH.HAShardedClient
    Retry = RetryPolicy if client_pkg == "port" else RefRetryPolicy
    try:
        for job in jobs:
            assert job.wait_ready(30)
        keys = [f"{u}-U" for u in range(len(uf))] + \
            [f"{i}-I" for i in range(len(itf))] + ["nope"]
        req = f"MGET\t{ALS_STATE}\t" + ",".join(keys)
        with QueryClient("127.0.0.1", jobs[0].port) as a, \
                QueryClient("127.0.0.1", jobs[1].port) as b:
            assert a._roundtrip(req) == b._roundtrip(req)
            assert a.count(ALS_STATE) == b.count(ALS_STATE)
        client = Client(1, job_group="mix", timeout_s=5, retry=Retry(
            attempts=5, backoff_s=0.01, max_backoff_s=0.2))
        with client:
            before = client.query_states(ALS_STATE, keys)
            sticky = client._shards[0].prefer
            victim = next(j for j in jobs if j.port == sticky[1])
            victim.server.stop()
            errors = []
            for key in keys[:-1]:
                try:
                    assert client.query_state(ALS_STATE, key) is not None
                except Exception as e:  # pragma: no cover
                    errors.append((key, e))
            assert errors == []
            assert client.failovers > 0
            assert client.query_states(ALS_STATE, keys) == before
            assert client._shards[0].prefer != sticky
    finally:
        for job in jobs:
            job.stop()


# ---------------------------------------------------------------------------
# supervised recovery e2e (real processes, SIGKILL, respawn, readiness)
# ---------------------------------------------------------------------------

def test_supervisor_kill_respawn_readiness_e2e(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUMS_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "30")
    journal, uf, _ = _seed_journal(tmp_path, seed=3)
    sup = ReplicaSupervisor(
        num_workers=1, replication=2,
        journal_dir=str(tmp_path / "bus"), topic="models",
        port_dir=str(tmp_path / "ports"), state_backend="memory",
        check_interval_s=0.2, respawn_delay_s=0.1, spawn_timeout_s=60,
        device="cpu")
    with sup.start():
        assert sup.wait_all_ready(60), "replica set never became ready"
        keys = [f"{u}-U" for u in range(len(uf))]
        errors = []
        stop_stream = threading.Event()
        served = [0]

        def stream():
            client = sup.client(retry=RetryPolicy(
                attempts=6, backoff_s=0.02, max_backoff_s=0.5), timeout_s=10)
            with client:
                while not stop_stream.is_set():
                    for key in keys:
                        try:
                            if client.query_state(ALS_STATE, key) is None:
                                errors.append((key, "missing"))
                        except Exception as e:
                            errors.append((key, repr(e)))
                        served[0] += 1

        t = threading.Thread(target=stream, daemon=True)
        t.start()
        deadline = time.time() + 10
        while served[0] < 50 and time.time() < deadline:
            time.sleep(0.02)
        victim = sup.procs[(0, 0)]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)
        mark = served[0]
        deadline = time.time() + 10
        while served[0] < mark + 100 and time.time() < deadline:
            time.sleep(0.02)
        stop_stream.set()
        t.join(timeout=30)
        assert errors == [], f"client-visible errors: {errors[:5]}"

        assert sup.wait_all_ready(60), "killed replica never rejoined ready"
        deadline = time.time() + 30
        while (sup.respawns < 1 or sup.procs[(0, 0)].pid == victim.pid) \
                and time.time() < deadline:
            time.sleep(0.05)
        assert sup.respawns >= 1
        assert sup.procs[(0, 0)].pid != victim.pid
        with QueryClient("127.0.0.1", sup.ports[(0, 0)], timeout_s=10) as d:
            h = d.health(ALS_STATE)
            assert h["ready"] is True and h["status"] == "ready"
            assert h["keys"] > 0
            assert h["replica_of"] == sup.group_of(0) and h["replica"] == 0
        assert "respawn" in [e["action"] for e in sup.events]


def test_supervisor_raises_with_the_rc_of_a_worker_without_cuda(tmp_path):
    """The supervisor's default device is ``cuda``: where CUDA is out of
    reach (here, and with ``CUDA_VISIBLE_DEVICES`` empty) the first worker
    exits before it publishes a port, and the launcher
    raises with its exit code instead of running on the CPU."""
    _seed_journal(tmp_path)
    sup = ReplicaSupervisor(1, 1, str(tmp_path / "bus"), "models",
                            str(tmp_path / "ports"), spawn_timeout_s=60,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    with pytest.raises(RuntimeError, match=r"died at spawn rc=1"):
        sup.start()
    assert all(p.poll() is not None for p in sup.procs.values())


# ---------------------------------------------------------------------------
# the arena divergence: the files a fleet member writes
# ---------------------------------------------------------------------------

def _member(package, d, rows):
    parse = sharded_parse(parse_als_record, 1, 2) if package == "port" \
        else RSH.sharded_parse(RC.parse_als_record, 1, 2)
    kw = dict(host="127.0.0.1", port=0, poll_interval_s=0.01,
              job_id=f"{package}:s1r0", replica_of="fg@g1/shard-1",
              replica_index=0, topology_group="fg", generation=1,
              topk_index=False, snapshot_min_bytes=1)
    if package == "port":
        Journal(d, "als").append(rows)
        return ServingJob(Journal(d, "als"), ALS_STATE, parse,
                          make_backend("memory", None), device="cpu",
                          **kw).start()
    RJ.Journal(d, "als").append(rows)
    return RC.ServingJob(RJ.Journal(d, "als"), ALS_STATE, parse,
                         RC.make_backend("memory", None), **kw).start()


def test_fleet_members_write_the_same_snapshot_files(tmp_path, monkeypatch):
    """A sharded, replicated, elastic fleet member of each package over
    the same journal bytes, on each table: with ``TPUMS_TABLE=dict`` both
    publish the same columnar snapshot at ready (keys, values, manifest
    apart from ``ts``), and on their default table, the arena, the same
    ``arena/1`` snapshot (the arena file byte for byte, the manifest apart
    from ``ts``) and the same ``<topic>.arena-*`` directory beside the
    journal."""
    rows = [F.format_als_row(u, "U", [0.25 * u, -1.0]) for u in range(40)]
    rows += [F.format_als_row(i, "I", [1.0, 0.5 * i]) for i in range(30)]
    for table in ("dict", None):
        got = {}
        for package in ("port", "ref"):
            if table:
                monkeypatch.setenv("TPUMS_TABLE", table)
            else:
                monkeypatch.delenv("TPUMS_TABLE", raising=False)
            d = str(tmp_path / f"{package}-{table or 'default'}")
            job = _member(package, d, rows)
            try:
                assert job.wait_ready(30)
                assert job.table_kind == (table or "arena")
                deadline = time.time() + 30
                while not PS.list_manifests(PS.snapshot_root(d, "als")) and \
                        time.time() < deadline:
                    time.sleep(0.02)
                (m,) = PS.list_manifests(PS.snapshot_root(d, "als"))
                files = {name: open(os.path.join(m["path"], name),
                                    "rb").read()
                         for name in sorted(os.listdir(m["path"]))
                         if name != "MANIFEST.json"}
                with open(os.path.join(m["path"], "MANIFEST.json")) as f:
                    manifest = json.load(f)
                manifest.pop("ts")
                got[package] = (files, manifest, sorted(os.listdir(d)),
                                dict(job.table.items()))
            finally:
                job.stop()
        assert got["port"] == got["ref"]
        assert got["port"][1]["num_shards"] == 2 and \
            got["port"][1]["shard"] == 1
        if table is None:
            assert got["port"][1]["format"] == "arena/1"
            assert list(got["port"][0]) == ["arena.dat"]
            assert "als.arena-ALS_MODEL-w1of2-r0-g1" in got["port"][2]
        else:
            assert list(got["port"][0]) == ["keys.txt", "vals.txt"]
