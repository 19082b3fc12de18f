"""The port's sharded serving (``flink_ms_tpu_torch/serve/sharded.py``)
against the JAX package's: N worker processes over one journal (each a
``--device cpu`` process here), client-side hash routing, the fan-out TOPK
merge, a SIGKILLed worker and its restart from the checkpoint.  Each case
of ``tests/test_sharded_serving.py`` runs on the port, and the packages
cross: the port's client against the reference's workers and the
reference's client against the port's give the same bytes for GET, MGET
and COUNT and the same TOPK lists."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from flink_ms_tpu.serve import sharded as JS
from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.serve.client import QueryClient
from flink_ms_tpu_torch.serve.journal import Journal
from flink_ms_tpu_torch.serve.sharded import (ShardedQueryClient, owner_of,
                                              stop_worker_procs)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_WORKERS = 3
STATE = "ALS_MODEL"
WAIT_S = 60
MODULES = {"port": "flink_ms_tpu_torch.serve.sharded",
           "ref": "flink_ms_tpu.serve.sharded"}


def _spawn_worker(tmp_path, idx, n=N_WORKERS, extra=(), package="port",
                  env=None, tag=""):
    port_file = tmp_path / f"port-{package}{tag}-{idx}.json"
    if port_file.exists():
        port_file.unlink()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "TPUMS_TOPK_SHARDED": "0", **(env or {})}
    cmd = [sys.executable, "-m", MODULES[package],
           "--workerIndex", str(idx), "--numWorkers", str(n),
           "--journalDir", str(tmp_path / "bus"), "--topic", "models",
           "--stateBackend", "fs",
           "--checkpointDataUri", str(tmp_path / f"chk-{package}{tag}"),
           "--checkPointInterval", "200",
           "--host", "127.0.0.1", "--port", "0",
           "--portFile", str(port_file), *extra]
    if package == "port":
        cmd += ["--device", "cpu"]
    log_path = tmp_path / f"worker-{package}{tag}-{idx}.log"
    with open(log_path, "wb") as log_fh:
        proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log_fh,
                                stderr=subprocess.STDOUT)
    return proc, port_file, log_path


def _wait_port(spawned):
    proc, port_file, log_path = spawned
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        if port_file.exists() and port_file.stat().st_size > 0:
            with open(port_file) as f:
                return json.load(f)["port"]
        if proc.poll() is not None:
            raise RuntimeError(
                f"worker died rc={proc.returncode}:\n"
                + log_path.read_text(errors="replace")[-800:])
        time.sleep(0.05)
    proc.kill()
    proc.wait(timeout=10)
    raise RuntimeError("worker never published its port")


def _start_cluster(tmp_path, n=N_WORKERS, package="port", extra=(),
                   tag=""):
    spawned = [_spawn_worker(tmp_path, i, n, extra, package, tag=tag)
               for i in range(n)]
    procs = [s[0] for s in spawned]
    try:
        return procs, [_wait_port(s) for s in spawned]
    except Exception:
        stop_worker_procs(procs)
        raise


def _seed(tmp_path, seed, n_users=20, n_items=30, k=4):
    journal = Journal(str(tmp_path / "bus"), "models")
    rng = np.random.default_rng(seed)
    uf = rng.normal(size=(n_users, k))
    itf = rng.normal(size=(n_items, k))
    rows = [F.format_als_row(u, "U", uf[u]) for u in range(n_users)]
    rows += [F.format_als_row(i, "I", itf[i]) for i in range(n_items)]
    journal.append(rows)
    return journal, uf, itf


@pytest.fixture
def cluster(tmp_path):
    procs = []
    try:
        journal, uf, itf = _seed(tmp_path, 0)
        procs, ports = _start_cluster(tmp_path)
        yield journal, procs, ports, uf, itf, tmp_path
    finally:
        stop_worker_procs(procs)


def _wait_keys(client, keys, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if all(v is not None for v in client.query_states(STATE, keys)):
                return True
        except (ConnectionError, OSError):
            pass
        time.sleep(0.1)
    return False


ALL_KEYS = [f"{u}-U" for u in range(20)] + [f"{i}-I" for i in range(30)]


def test_routing_and_ownership(cluster):
    _journal, _procs, ports, uf, itf, _tmp = cluster
    with ShardedQueryClient([("127.0.0.1", p) for p in ports]) as client:
        assert _wait_keys(client, ALL_KEYS)
        for u in range(20):
            payload = client.query_state(STATE, f"{u}-U")
            np.testing.assert_allclose(
                [float(t) for t in payload.split(";")], uf[u])
        owners = {owner_of(key, N_WORKERS) for key in ALL_KEYS}
        assert owners == set(range(N_WORKERS))
        key = "0-U"
        wrong = (owner_of(key, N_WORKERS) + 1) % N_WORKERS
        with QueryClient("127.0.0.1", ports[wrong]) as direct:
            assert direct.query_state(STATE, key) is None
        values = client.query_states(STATE, ["5-U", "17-I", "nope-U", "3-I"])
        assert values[2] is None
        np.testing.assert_allclose(
            [float(t) for t in values[0].split(";")], uf[5])
        np.testing.assert_allclose(
            [float(t) for t in values[3].split(";")], itf[3])
        # each worker's HEALTH reports its own slice
        counts = [QueryClient("127.0.0.1", p).health(STATE)["keys"]
                  for p in ports]
        assert counts == [sum(owner_of(k_, N_WORKERS) == w for k_ in ALL_KEYS)
                          for w in range(N_WORKERS)]


def test_fanout_topk_matches_brute_force(cluster):
    _journal, _procs, ports, uf, itf, _tmp = cluster
    with ShardedQueryClient([("127.0.0.1", p) for p in ports],
                            timeout_s=30) as client:
        assert _wait_keys(client, ALL_KEYS)
        k = 5
        got = client.topk(STATE, "7", k)
        scores = itf @ uf[7]
        best = np.argsort(-scores)[:k]
        assert [item for item, _ in got] == [str(i) for i in best]
        np.testing.assert_allclose([s for _, s in got], scores[best],
                                   rtol=1e-5)
        assert client.topk(STATE, "999", k) is None
        # the bulk sweep gives every user the same list
        users = [str(u) for u in range(20)] + ["999"]
        many = client.topk_many(STATE, users, k)
        assert many == [client.topk(STATE, u, k) for u in users]


def test_kill_one_worker_and_restart(cluster):
    journal, procs, ports, uf, _itf, tmp_path = cluster
    with ShardedQueryClient([("127.0.0.1", p) for p in ports],
                            timeout_s=2) as client:
        assert _wait_keys(client, [f"{u}-U" for u in range(20)])
        victim = owner_of("0-U", N_WORKERS)
        survivor_key = next(
            f"{u}-U" for u in range(20)
            if owner_of(f"{u}-U", N_WORKERS) != victim)
        # the victim has written a checkpoint (every 200 ms) to restart from
        latest = tmp_path / "chk-port" / f"worker-{victim}" / "latest"
        deadline = time.time() + WAIT_S
        while not latest.exists() and time.time() < deadline:
            time.sleep(0.05)
        assert latest.exists()
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=10)
        assert client.query_state(STATE, survivor_key) is not None
        with pytest.raises((ConnectionError, OSError)):
            client.query_state(STATE, "0-U")

    spawned = _spawn_worker(tmp_path, victim)
    procs[victim] = spawned[0]
    ports[victim] = _wait_port(spawned)
    with ShardedQueryClient([("127.0.0.1", p) for p in ports]) as client:
        assert _wait_keys(client, ["0-U"])
        payload = client.query_state(STATE, "0-U")
        np.testing.assert_allclose(
            [float(t) for t in payload.split(";")], uf[0])
        with QueryClient("127.0.0.1", ports[victim]) as direct:
            assert direct.health(STATE)["bootstrap_source"] == "checkpoint"


def test_sharded_ingest_filter_counts():
    """The parse wrapper drops foreign rows without counting them as
    errors, row for row as the reference's wrapper does, and advertises
    the same columnar mode and ownership predicate."""
    from flink_ms_tpu.serve.consumer import parse_als_record as ref_parse
    from flink_ms_tpu_torch.serve.consumer import parse_als_record
    from flink_ms_tpu_torch.serve.sharded import sharded_parse

    rows = [F.format_als_row(i, "U", [float(i)]) for i in range(40)]
    parse = sharded_parse(parse_als_record, 1, N_WORKERS)
    ref = JS.sharded_parse(ref_parse, 1, N_WORKERS)
    kept = 0
    for row in rows:
        parsed = parse(row)
        assert parsed == ref(row)
        if parsed is not None:
            kept += 1
            assert owner_of(parsed[0], N_WORKERS) == 1
    assert 0 < kept < 40
    assert parse.shard_filter == ref.shard_filter == (1, N_WORKERS)
    assert parse.columnar_mode == ref.columnar_mode


def test_owner_of_equals_the_reference_on_10000_keys():
    rng = np.random.default_rng(3)
    keys = [f"{u}-U" for u in rng.integers(0, 10**9, 5000)]
    keys += [f"{i}-I" for i in rng.integers(0, 10**6, 4990)]
    keys += ["MEAN-U", "MEAN-I", "", "é-U", "0", "-1", "a,b", "x" * 300,
             "中-I", "7-U"]
    for n in (1, 2, 3, 4, 8, 16):
        assert [owner_of(k, n) for k in keys] == \
            [JS.owner_of(k, n) for k in keys]


@pytest.mark.parametrize("extra,env", [
    (("--stateBackend", "rocksdb", "--nativeServer", "true"), {}),
    (("--nativeServer", "true"), {}),
    ((), {"TPUMS_TABLE": "arena"})])
def test_native_and_arena_workers_serve_like_the_reference(tmp_path, extra,
                                                           env):
    """The reference's native-plane worker (``--nativeServer true`` over
    ``rocksdb`` or over its default arena) and its arena table run in the
    port: a port worker, then a reference worker on the same journal (and,
    for the arena, on the arena directory the port's worker left), answer
    GET, MGET, COUNT, TOPK and TOPKV with the same bytes."""
    _seed(tmp_path, 1)
    users = [str(u) for u in range(20)] + ["nobody"]
    reqs = ([f"GET\t{STATE}\t{k_}" for k_ in ALL_KEYS[::7]]
            + [f"MGET\t{STATE}\t" + ",".join(ALL_KEYS + ["nope"]),
               f"COUNT\t{STATE}"]
            + [f"TOPK\t{STATE}\t{u}\t5" for u in users]
            + [f"TOPKV\t{STATE}\t4\t1.0;-0.5;0.25;2.0"])
    replies, logs = {}, {}
    for package in ("port", "ref"):
        spawned = _spawn_worker(tmp_path, 0, 1, extra=extra,
                                package=package, env=env)
        try:
            port = _wait_port(spawned)
            with QueryClient("127.0.0.1", port, timeout_s=60) as c:
                deadline = time.time() + WAIT_S
                while c.count(STATE) < 50 and time.time() < deadline:
                    time.sleep(0.05)
                replies[package] = [c._roundtrip(r) for r in reqs]
                plane = c.metrics()["meta"]["plane"]
                assert plane == ("native" if "--nativeServer" in extra
                                 else "python")
        finally:
            stop_worker_procs([spawned[0]])
        logs[package] = spawned[2].read_text(errors="replace")
    assert replies["port"] == replies["ref"]
    assert replies["port"][len(ALL_KEYS[::7]) + 1] == "C\t50"
    assert "not ported" not in logs["port"]
    if "rocksdb" in extra:
        assert list((tmp_path / "chk-port").glob("**/data.log"))
    else:
        assert "table: arena" in logs["port"]
        assert os.path.isdir(tmp_path / "bus" /
                             "models.arena-ALS_MODEL-w0of1-r0-g0")


def test_clients_and_workers_cross_the_packages(tmp_path):
    """A port fleet and a reference fleet over one journal, each on its
    default table for a fleet member, the arena (the port's fleet is
    replica 1 of its own group, so that the two fleets' arena directories
    differ): each client package against each worker package gives the
    same bytes for GET, MGET and COUNT, and the same TOPK lists; each port
    worker answers a raw MGET of its slice with the reference worker's
    bytes."""
    n = 2
    _seed(tmp_path, 2)
    procs = []
    try:
        p_procs, p_ports = _start_cluster(
            tmp_path, n, "port",
            extra=("--replicaIndex", "1", "--jobGroup", "portfleet"))
        procs += p_procs
        r_procs, r_ports = _start_cluster(tmp_path, n, "ref")
        procs += r_procs
        clients = {("port", "port"): ShardedQueryClient(
                       [("127.0.0.1", p) for p in p_ports], timeout_s=60),
                   ("port", "ref"): ShardedQueryClient(
                       [("127.0.0.1", p) for p in r_ports], timeout_s=60),
                   ("ref", "port"): JS.ShardedQueryClient(
                       [("127.0.0.1", p) for p in p_ports], timeout_s=60),
                   ("ref", "ref"): JS.ShardedQueryClient(
                       [("127.0.0.1", p) for p in r_ports], timeout_s=60)}
        try:
            for c in clients.values():
                assert _wait_keys(c, ALL_KEYS)
            users = [str(u) for u in range(20)] + ["nobody"]
            keys = ALL_KEYS + ["nope-U", "MEAN-I"]
            replies, sweeps = {}, {}
            for pair, c in clients.items():
                replies[pair] = (
                    [c.query_state(STATE, k_) for k_ in keys[:10]],
                    c.query_states(STATE, keys),
                    c.total_count(STATE),
                    [c.topk(STATE, u, 5) for u in users])
                sweeps[pair] = c.topk_many(STATE, users, 5)
            want = replies[("port", "port")]
            for pair, got in replies.items():
                assert got == want, pair
            assert want[2] == 50
            # a sweep's vectors reach each worker's batcher together, and a
            # batched product may round a score's last bit differently in
            # the two packages: the same items, the scores to f32 rounding
            for pair, got in sweeps.items():
                assert [[i for i, _ in lst] for lst in got[:-1]] == \
                    [[i for i, _ in lst] for lst in want[3][:-1]], pair
                np.testing.assert_allclose(
                    [[s_ for _, s_ in lst] for lst in got[:-1]],
                    [[s_ for _, s_ in lst] for lst in want[3][:-1]],
                    rtol=1e-6)
                assert got[-1] is None
            for w in range(n):
                mine = [k_ for k_ in keys if owner_of(k_, n) == w]
                req = f"MGET\t{STATE}\t" + ",".join(mine)
                with QueryClient("127.0.0.1", p_ports[w]) as a, \
                        QueryClient("127.0.0.1", r_ports[w]) as b:
                    assert a._roundtrip(req) == b._roundtrip(req)
                    assert a.count(STATE) == b.count(STATE)
        finally:
            for c in clients.values():
                c.close()
    finally:
        stop_worker_procs(procs)
