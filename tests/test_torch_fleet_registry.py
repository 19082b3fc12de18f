"""The fleet's registry records in the port (``flink_ms_tpu_torch/serve/
registry.py``) against the JAX package's: heartbeat TTLs and GC, replica
sets, tenant names, topology records (atomic, CAS-guarded, bounded
history), the controller lease (refuse, steal from a dead holder) and the
generation GC.  Each case of the reference's registry tests runs on the
port, and every record or lease one package writes is read and honoured by
the other (both read the same ``TPUMS_REGISTRY_DIR``, private to each test
through conftest.py)."""

import json
import pathlib
import subprocess
import sys
import threading

import pytest

from flink_ms_tpu.serve import registry as JR
from flink_ms_tpu_torch.serve import registry as R
from flink_ms_tpu_torch.serve.elastic import generation_group
from flink_ms_tpu_torch.serve.ha import resolve_shard_endpoints

STATE = "ALS_MODEL"
PACKAGES = {"port": R, "ref": JR}


def _backdate(path, seconds):
    path = pathlib.Path(path)
    entry = json.loads(path.read_text())
    entry["heartbeat"] -= seconds
    path.write_text(json.dumps(entry))
    return path


# ---------------------------------------------------------------------------
# liveness: heartbeat TTL + GC
# ---------------------------------------------------------------------------

def test_heartbeat_ttl_expiry_reaps_entry():
    R.register("hb-job", "127.0.0.1", 7100, STATE, ttl_s=5.0)
    assert R.resolve("hb-job")["port"] == 7100
    path = _backdate(R._entry_path("hb-job"), 60.0)
    assert R.resolve("hb-job") is None
    assert not path.exists(), "stale entry not GC'd on resolve()"


def test_entry_without_ttl_is_never_ttl_checked():
    R.register("manual-job", "127.0.0.1", 7101, STATE)
    entry = R.resolve("manual-job")
    assert entry is not None and "ttl_s" not in entry


def test_list_jobs_gcs_stale_and_dead_entries():
    R.register("live-a", "127.0.0.1", 7102, STATE)
    R.register("stale-b", "127.0.0.1", 7103, STATE, ttl_s=5.0)
    _backdate(R._entry_path("stale-b"), 60.0)
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait(timeout=30)
    R.register("dead-c", "127.0.0.1", 7104, STATE)
    dead_path = pathlib.Path(R._entry_path("dead-c"))
    entry = json.loads(dead_path.read_text())
    entry["pid"] = child.pid
    dead_path.write_text(json.dumps(entry))

    jobs = R.list_jobs()
    assert [e["job_id"] for e in jobs] == ["live-a"]
    files = list(pathlib.Path(R.registry_dir()).iterdir())
    assert len(files) == 1, "stale/dead entries not GC'd on list_jobs()"


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_resolve_replicas_sorted_and_ready_fallback(writer):
    """Replica entries written by either package: the same members, in
    replica order, with the readiness-gated endpoints of the port's HA
    resolution (and the live set as the last resort)."""
    reg = PACKAGES[writer]
    group = "g/shard-0"
    reg.register("r2", "127.0.0.1", 7202, STATE,
                 replica_of=group, replica=2, ready=False)
    reg.register("r0", "127.0.0.1", 7200, STATE,
                 replica_of=group, replica=0, ready=False)
    reg.register("r1", "127.0.0.1", 7201, STATE,
                 replica_of=group, replica=1, ready=True)
    reg.register("other", "127.0.0.1", 7300, STATE,
                 replica_of="g/shard-1", replica=0, ready=True)
    members = R.resolve_replicas(group)
    assert [e["replica"] for e in members] == [0, 1, 2]
    assert members == JR.resolve_replicas(group)
    assert resolve_shard_endpoints("g", 0) == [("127.0.0.1", 7201)]
    reg.register("r1", "127.0.0.1", 7201, STATE,
                 replica_of=group, replica=1, ready=False)
    assert len(resolve_shard_endpoints("g", 0)) == 3


def test_port_entry_equals_the_reference_entry_but_time():
    """The port writes the reference's entry, key for key: only the
    heartbeat's timestamp differs between two writes."""
    kw = dict(replica_of="grp/shard-1", replica=1, ready=True, ttl_s=5.0)
    R.register("same", "127.0.0.1", 7500, STATE, **kw)
    port = json.loads(pathlib.Path(R._entry_path("same")).read_text())
    JR.register("same", "127.0.0.1", 7500, STATE, **kw)
    ref = json.loads(pathlib.Path(JR._entry_path("same")).read_text())
    assert R._entry_path("same") == JR._entry_path("same")
    port.pop("heartbeat"), ref.pop("heartbeat")
    assert port == ref


# ---------------------------------------------------------------------------
# tenant names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group,tenant,env", [
    ("als", None, None), ("als", None, "acme"), ("als", "", "acme"),
    ("als", "beta", "acme"), ("acme::als", "beta", None),
    ("als@g3/shard-0", " t1 ", None)])
def test_tenant_helpers_equal_the_reference(monkeypatch, group, tenant, env):
    if env is None:
        monkeypatch.delenv("TPUMS_TENANT", raising=False)
    else:
        monkeypatch.setenv("TPUMS_TENANT", env)
    assert R.default_tenant() == JR.default_tenant()
    q = R.qualify_group(group, tenant)
    assert q == JR.qualify_group(group, tenant)
    assert R.split_tenant(q) == JR.split_tenant(q)


def test_bad_tenant_is_refused_as_in_the_reference():
    for bad in ("a::b", "a/b", "a\tb"):
        with pytest.raises(ValueError, match="bad tenant name"):
            R.qualify_group("g", bad)
        with pytest.raises(ValueError, match="bad tenant name"):
            JR.qualify_group("g", bad)


# ---------------------------------------------------------------------------
# topology records: atomic publish + CAS
# ---------------------------------------------------------------------------

def test_topology_publish_resolve_roundtrip():
    assert R.resolve_topology("tg") is None
    rec = R.publish_topology("tg", 2, 1)
    assert (rec["gen"], rec["shards"], rec["replicas"]) == (1, 2, 1)
    got = R.resolve_topology("tg")
    assert got["gen"] == 1 and got["kind"] == "topology"
    assert R.list_jobs() == []
    R.drop_topology("tg")
    assert R.resolve_topology("tg") is None


def test_topology_cas_guard_raises_on_stale_generation():
    R.publish_topology("cas", 2)
    R.publish_topology("cas", 4, expect_gen=1)
    with pytest.raises(R.TopologyConflict):
        R.publish_topology("cas", 8, expect_gen=1)
    got = R.resolve_topology("cas")
    assert got["gen"] == 2 and got["shards"] == 4


def test_topology_history_records_and_bounds_superseded_gens():
    for i in range(R.TOPOLOGY_HISTORY + 3):
        R.publish_topology("hist", i + 1)
    rec = R.resolve_topology("hist")
    assert rec["gen"] == R.TOPOLOGY_HISTORY + 3
    assert len(rec["history"]) == R.TOPOLOGY_HISTORY
    gens = [h["gen"] for h in rec["history"]]
    assert gens == list(range(rec["gen"] - R.TOPOLOGY_HISTORY, rec["gen"]))


def test_topology_concurrent_publish_is_atomic():
    n = 8
    errs = []

    def publish(i):
        try:
            R.publish_topology("race", i + 1)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=publish, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert errs == []
    assert R.resolve_topology("race")["gen"] == n
    raw = json.loads(pathlib.Path(R._topology_path("race")).read_text())
    assert raw["kind"] == "topology"


@pytest.mark.parametrize("first,second", [("port", "ref"), ("ref", "port")])
def test_topology_records_cross_the_packages(first, second):
    """A record one package publishes is the other's current generation:
    the CAS guard and the history hold across them, the model binding
    follows a generation into history, and the record carries the same
    keys from either writer."""
    a, b = PACKAGES[first], PACKAGES[second]
    assert a._topology_path("x") == b._topology_path("x")
    a.publish_topology("x", 2, extra={"model": {"model_id": "m1"}})
    assert b.resolve_topology("x")["model"] == {"model_id": "m1"}
    rec = b.publish_topology("x", 4, 2, expect_gen=1)
    assert rec["gen"] == 2 and rec["history"][0]["model"] == \
        {"model_id": "m1"}
    with pytest.raises((R.TopologyConflict, JR.TopologyConflict)):
        a.publish_topology("x", 8, expect_gen=1)
    got = a.resolve_topology("x")
    assert (got["gen"], got["shards"], got["replicas"]) == (2, 4, 2)
    assert sorted(got) == sorted(JR.resolve_topology("x"))
    b.drop_topology("x")
    assert a.resolve_topology("x") is None


def test_strict_topology_read_raises_on_a_torn_record():
    """``strict=True`` tells "unreadable now" from "no record", as the
    reference's does; the default read treats both as no record."""
    R.publish_topology("torn", 2)
    pathlib.Path(R._topology_path("torn")).write_text("{not json")
    assert R.resolve_topology("torn") is None
    assert JR.resolve_topology("torn") is None
    with pytest.raises(ValueError):
        R.resolve_topology("torn", strict=True)
    with pytest.raises(ValueError):
        JR.resolve_topology("torn", strict=True)
    assert R.resolve_topology("never", strict=True) is None


# ---------------------------------------------------------------------------
# controller lease: single-writer guard
# ---------------------------------------------------------------------------

def test_controller_lease_second_acquirer_refuses():
    t1 = R.acquire_controller_lease("lg")
    assert t1 is not None
    assert R.acquire_controller_lease("lg") is None
    assert R.refresh_controller_lease("lg", t1)
    R.release_controller_lease("lg", t1)
    t2 = R.acquire_controller_lease("lg")
    assert t2 is not None and t2 != t1
    R.release_controller_lease("lg", t2)


def test_controller_lease_concurrent_acquirers_exactly_one_wins():
    tokens = []

    def acquire():
        tokens.append(R.acquire_controller_lease("cl"))

    threads = [threading.Thread(target=acquire) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sum(tok is not None for tok in tokens) == 1


def test_controller_lease_stolen_from_dead_holder():
    t1 = R.acquire_controller_lease("dead-ctl", ttl_s=5.0)
    assert t1 is not None
    _backdate(R._controller_path("dead-ctl"), 60.0)
    t2 = R.acquire_controller_lease("dead-ctl")
    assert t2 is not None and t2 != t1
    assert not R.refresh_controller_lease("dead-ctl", t1)
    assert R.refresh_controller_lease("dead-ctl", t2)
    R.release_controller_lease("dead-ctl", t2)


def test_controller_lease_dead_steal_single_winner_under_race():
    t1 = R.acquire_controller_lease("dead-race", ttl_s=5.0)
    assert t1 is not None
    path = _backdate(R._controller_path("dead-race"), 60.0)
    tokens = []
    barrier = threading.Barrier(8)

    def steal():
        barrier.wait()
        tokens.append(R.acquire_controller_lease("dead-race", ttl_s=5.0))

    threads = [threading.Thread(target=steal) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    winners = [tok for tok in tokens if tok]
    assert len(winners) <= 1
    if not winners:
        winners = [R.acquire_controller_lease("dead-race")]
        assert winners[0] is not None
    assert json.loads(path.read_text())["token"] == winners[0]
    assert not path.with_name(path.name + ".steal").exists()
    R.release_controller_lease("dead-race", winners[0])


@pytest.mark.parametrize("holder,other", [("port", "ref"), ("ref", "port")])
def test_controller_lease_crosses_the_packages(holder, other):
    """A live lease of one package refuses the other's controller; once
    its holder is dead, the other steals it, and the corpse's token no
    longer refreshes in either package."""
    a, b = PACKAGES[holder], PACKAGES[other]
    t1 = a.acquire_controller_lease("xl", ttl_s=5.0)
    assert t1 is not None
    assert b.acquire_controller_lease("xl") is None
    assert b.refresh_controller_lease("xl", t1)
    _backdate(a._controller_path("xl"), 60.0)
    t2 = b.acquire_controller_lease("xl")
    assert t2 is not None and t2 != t1
    assert not a.refresh_controller_lease("xl", t1)
    assert a.refresh_controller_lease("xl", t2)
    a.release_controller_lease("xl", t2)
    assert b.acquire_controller_lease("xl") is not None


# ---------------------------------------------------------------------------
# stale-generation GC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,collector", [
    ("port", "port"), ("ref", "port"), ("port", "ref")])
def test_gc_generation_entries_reaps_dead_old_gens_only(writer, collector):
    reg = PACKAGES[writer]
    g1 = generation_group("eg", 1)
    g2 = generation_group("eg", 2)
    reg.register("old-dead", "127.0.0.1", 7400, STATE,
                 replica_of=f"{g1}/shard-0", replica=0, ttl_s=5.0)
    _backdate(reg._entry_path("old-dead"), 60.0)
    reg.register("old-live", "127.0.0.1", 7401, STATE,
                 replica_of=f"{g1}/shard-1", replica=0, ttl_s=5.0)
    reg.register("new-stale", "127.0.0.1", 7402, STATE,
                 replica_of=f"{g2}/shard-0", replica=0, ttl_s=5.0)
    _backdate(reg._entry_path("new-stale"), 60.0)
    reg.register("other-group", "127.0.0.1", 7403, STATE,
                 replica_of="unrelated/shard-0", replica=0)

    assert PACKAGES[collector].gc_generation_entries("eg", active_gen=2) == 1
    assert R.resolve("old-dead") is None
    paths = {p.name for p in pathlib.Path(R.registry_dir()).iterdir()}
    assert not any("old-dead" in n for n in paths)
    assert any("old-live" in n for n in paths)
    assert any("new-stale" in n for n in paths)
    assert any("other-group" in n for n in paths)


def test_generation_of_parses_only_matching_group():
    e = {"replica_of": f"{generation_group('g', 7)}/shard-3"}
    assert R.generation_of(e, "g") == 7 == JR.generation_of(e, "g")
    assert R.generation_of(e, "other") is None
    assert R.generation_of({"replica_of": "g/shard-0"}, "g") is None
    assert R.generation_of({}, "g") is None


# ---------------------------------------------------------------------------
# alert records (read by the fleet signals when no gauge carries them)
# ---------------------------------------------------------------------------

def test_alert_records_of_a_reference_watcher_read_the_same():
    assert R.resolve_alerts() is None
    JR.publish_alerts("g1", {"firing": 2, "max_severity": "warn",
                             "max_severity_level": 2, "alerts": ["a"]})
    JR.publish_alerts("g2", {"firing": 1, "max_severity": "page",
                             "max_severity_level": 3, "alerts": ["b"]})
    JR.publish_alerts("old", {"firing": 9, "max_severity_level": 3},
                      ttl_s=5.0)
    old = pathlib.Path(JR._alerts_path("old"))
    rec = json.loads(old.read_text())
    rec["published_at"] -= 60.0
    old.write_text(json.dumps(rec))
    assert R.resolve_alerts("g1") == JR.resolve_alerts("g1")
    got = R.resolve_alerts()
    assert got["firing"] == 3 and got["max_severity"] == "page"
    assert sorted(got["alerts"]) == ["a", "b"]
    assert not old.exists(), "the expired record was not GC'd"
    assert got == JR.resolve_alerts()
