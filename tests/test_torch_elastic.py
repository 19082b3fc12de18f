"""The port's elastic serving plane (``flink_ms_tpu_torch/serve/elastic.py``
and the fleet scrape in ``obs/scrape.py``) against the JAX package's: the
controller lease guard, the ElasticClient's generation swap under traffic
(its topology cases are in ``test_torch_fleet_registry.py``), a live
subprocess rescale with zero failed queries (``--device cpu`` workers),
the compactor's stand-down, the autoscaler's policy and dry run, and the
fleet signals.  Each case of ``tests/test_elastic_serving.py`` runs on the
port; the client of each package follows generations served by the other
package's workers, and the fleet merge and signals equal the reference's
on the same snapshots, series the port never publishes included."""

import threading
import time

import numpy as np
import pytest

from flink_ms_tpu.obs import metrics as RM
from flink_ms_tpu.obs import scrape as RS
from flink_ms_tpu.serve import consumer as RC
from flink_ms_tpu.serve import elastic as RE
from flink_ms_tpu.serve import journal as RJ
from flink_ms_tpu.serve import sharded as RSH
from flink_ms_tpu.serve.client import RetryPolicy as RefRetryPolicy
from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.obs import metrics as PM
from flink_ms_tpu_torch.obs import scrape as PSC
from flink_ms_tpu_torch.serve import registry
from flink_ms_tpu_torch.serve.client import RetryPolicy
from flink_ms_tpu_torch.serve.consumer import (ALS_STATE, ServingJob,
                                               make_backend,
                                               parse_als_record)
from flink_ms_tpu_torch.serve.elastic import (Autoscaler, AutoscalerPolicy,
                                              ControllerBusy, ElasticClient,
                                              ScaleController,
                                              generation_group)
from flink_ms_tpu_torch.serve.ha import shard_group
from flink_ms_tpu_torch.serve.journal import Journal
from flink_ms_tpu_torch.serve.sharded import sharded_parse


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    for name in ("TPUMS_SNAPSHOTS", "TPUMS_COMPACT", "TPUMS_TABLE",
                 "TPUMS_TENANT"):
        monkeypatch.delenv(name, raising=False)


def test_scale_controller_refuses_when_lease_held(tmp_path):
    token = registry.acquire_controller_lease("busy")
    assert token is not None
    ctl = ScaleController("busy", str(tmp_path / "bus"), "models",
                          port_dir=str(tmp_path / "ports"), device="cpu")
    with pytest.raises(ControllerBusy):
        ctl.scale_to(1)
    registry.release_controller_lease("busy", token)


def test_tenant_scopes_the_controller_and_the_client(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUMS_TENANT", "acme")
    ctl = ScaleController("als", str(tmp_path / "bus"), "models",
                          port_dir=str(tmp_path / "ports"), device="cpu")
    assert ctl.group == "acme::als" == RE.ScaleController(
        "als", str(tmp_path / "bus"), "models",
        port_dir=str(tmp_path / "ports")).group
    registry.publish_topology("acme::als", 1)
    with pytest.raises(ConnectionError):  # gen 1 has no workers: no entry
        ElasticClient("als", resolve_timeout_s=0.2).query_state(
            ALS_STATE, "1-U")
    assert generation_group(ctl.group, 3) == "acme::als@g3" == \
        RE.generation_group("acme::als", 3)


# ---------------------------------------------------------------------------
# ElasticClient: generation swap under traffic (in-process workers)
# ---------------------------------------------------------------------------

def _seed_journal(tmp_path, n=24, k=3, seed=0):
    journal = Journal(str(tmp_path / "bus"), "models")
    rng = np.random.default_rng(seed)
    journal.append([F.format_als_row(u, "U", rng.normal(size=k))
                    for u in range(n)])
    return journal, [f"{u}-U" for u in range(n)]


def _gen_worker(journal, group, gen, shard, shards, package="port"):
    gg = generation_group(group, gen)
    kw = dict(host="127.0.0.1", port=0, poll_interval_s=0.01,
              job_id=f"{gg}:s{shard}r0", replica_of=shard_group(gg, shard),
              replica_index=0, topk_index=False, topology_group=group,
              generation=gen)
    if package == "port":
        return ServingJob(journal, ALS_STATE,
                          sharded_parse(parse_als_record, shard, shards),
                          make_backend("memory", None), device="cpu",
                          **kw).start()
    return RC.ServingJob(RJ.Journal(journal.dir, journal.topic), ALS_STATE,
                         RSH.sharded_parse(RC.parse_als_record, shard, shards),
                         RC.make_backend("memory", None), snapshots=False,
                         table="dict", **kw).start()


def _await_ready(jobs, timeout_s=30):
    """Each job ready, and its registry entry too: the entry's flag lags
    the job's ready event (the consume thread writes it after the flip),
    and the elastic client resolves the workers through the registry."""
    for job in jobs:
        assert job.wait_ready(timeout_s)
    deadline = time.time() + timeout_s
    while not all((registry.resolve(j.job_id) or {}).get("ready")
                  for j in jobs):
        assert time.time() < deadline, "registry never showed ready"
        time.sleep(0.02)


@pytest.mark.parametrize("client_pkg,worker_pkg", [
    ("port", "port"), ("port", "ref"), ("ref", "port")])
def test_elastic_client_follows_generation_swap(tmp_path, client_pkg,
                                                worker_pkg):
    """gen1 = 2 shards, gen2 = 3 shards over the same journal; a client
    built at gen1 answers through the cutover with the same bytes, through
    the forced re-resolve after gen1 stops, whichever package serves and
    whichever package asks."""
    journal, keys = _seed_journal(tmp_path)
    Client = ElasticClient if client_pkg == "port" else RE.ElasticClient
    Retry = RetryPolicy if client_pkg == "port" else RefRetryPolicy
    gen1 = [_gen_worker(journal, "ec", 1, s, 2, worker_pkg)
            for s in range(2)]
    gen2 = []
    try:
        _await_ready(gen1)
        registry.publish_topology("ec", 2)
        c = Client("ec", refresh_s=999.0, timeout_s=5,
                   retry=Retry(attempts=4, backoff_s=0.01, max_backoff_s=0.1))
        with c:
            assert c.generation == 1 and c.num_workers == 2
            before = {k_: c.query_state(ALS_STATE, k_) for k_ in keys}
            assert all(v is not None for v in before.values())
            h = c.shard_health(ALS_STATE, 0)
            assert h["topology_group"] == "ec" and h["generation"] == 1
            assert h["topology_gen"] == 1
            gen2 = [_gen_worker(journal, "ec", 2, s, 3, worker_pkg)
                    for s in range(3)]
            _await_ready(gen2)
            registry.publish_topology("ec", 3, expect_gen=1)
            for job in gen1:
                job.stop()
            after = {k_: c.query_state(ALS_STATE, k_) for k_ in keys}
            assert after == before
            assert c.generation == 2 and c.num_workers == 3
            assert c.generation_swaps == 1
            assert c.query_states(ALS_STATE, keys) == \
                [before[k_] for k_ in keys]
            assert c.total_count(ALS_STATE) == len(keys)
    finally:
        for job in gen1 + gen2:
            job.stop()


def test_elastic_client_hint_triggers_refresh(tmp_path):
    journal, keys = _seed_journal(tmp_path, n=8)
    gen1 = [_gen_worker(journal, "hint", 1, 0, 1)]
    gen2 = []
    try:
        _await_ready(gen1)
        registry.publish_topology("hint", 1)
        c = ElasticClient("hint", refresh_s=999.0, timeout_s=5)
        with c:
            assert c.query_state(ALS_STATE, keys[0]) is not None
            gen2 = [_gen_worker(journal, "hint", 2, s, 2) for s in range(2)]
            _await_ready(gen2)
            registry.publish_topology("hint", 2, expect_gen=1)
            assert c.generation == 1
            c.note_topology_gen(2)
            assert c.query_state(ALS_STATE, keys[0]) is not None
            assert c.generation == 2
    finally:
        for job in gen1 + gen2:
            job.stop()


def test_elastic_client_no_topology_times_out():
    with pytest.raises(ConnectionError):
        ElasticClient("nope", resolve_timeout_s=0.2)


def test_heartbeat_hint_and_compactor_stand_down(tmp_path, monkeypatch):
    """A worker's heartbeat re-reads its group's active generation into
    HEALTH's ``topology_gen``; the compactor runs only on the active
    generation's worker 0 of replica 0, as in the reference."""
    monkeypatch.setenv("TPUMS_HEARTBEAT_S", "0.05")
    journal, _ = _seed_journal(tmp_path, n=4)
    registry.publish_topology("cg", 1)
    old = _gen_worker(journal, "cg", 1, 0, 1)
    new = _gen_worker(journal, "cg", 2, 0, 1)
    try:
        assert old._compactor_active() and not new._compactor_active()
        registry.publish_topology("cg", 1, expect_gen=1)
        # each worker's own heartbeat re-reads the record: wait for both
        deadline = time.time() + 10
        while (new.health()["topology_gen"], old.health()["topology_gen"]) \
                != (2, 2) and time.time() < deadline:
            time.sleep(0.02)
        assert new.health()["topology_gen"] == 2 == \
            old.health()["topology_gen"]
        assert new._compactor_active() and not old._compactor_active()
    finally:
        old.stop()
        new.stop()
    for shard, replica, want in ((0, None, True), (0, 0, True),
                                 (1, None, False), (0, 1, False)):
        kw = dict(port=0, device="cpu", compact=True, topk_index=False,
                  replica_index=replica, replica_of="g/shard-0")
        parse = sharded_parse(parse_als_record, shard, 2)
        job = ServingJob(journal, ALS_STATE, parse,
                         make_backend("memory", None), **kw)
        ref = RC.ServingJob(RJ.Journal(journal.dir, journal.topic),
                            ALS_STATE,
                            RSH.sharded_parse(RC.parse_als_record, shard, 2),
                            RC.make_backend("memory", None), table="dict",
                            snapshots=False, **{k: v for k, v in kw.items()
                                                if k != "device"})
        try:
            assert job._compact_on == ref._compact_on == want
            assert job._snap_owner == ref._snap_owner == (shard, 2)
        finally:
            job.server._server.server_close()
            ref.server._server.server_close()
            # a fleet member's arena (the port's default here) holds its
            # writer flock until closed, and the next case opens its dir
            if job.table_kind == "arena":
                job.table.close()


# ---------------------------------------------------------------------------
# ScaleController e2e: live rescale, zero failed queries (subprocesses)
# ---------------------------------------------------------------------------

def test_scale_controller_live_rescale_zero_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUMS_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "30")
    journal, keys = _seed_journal(tmp_path, n=30, seed=5)
    ctl = ScaleController(
        "live", str(tmp_path / "bus"), "models",
        port_dir=str(tmp_path / "ports"), ready_timeout_s=60, device="cpu")
    try:
        rec = ctl.scale_to(1)
        assert rec["gen"] == 1 and rec["shards"] == 1
        errors = []
        served = [0]
        stop = threading.Event()

        def stream():
            c = ElasticClient(
                "live", retry=RetryPolicy(attempts=6, backoff_s=0.02,
                                          max_backoff_s=0.5), timeout_s=10)
            with c:
                while not stop.is_set():
                    for key in keys:
                        try:
                            if c.query_state(ALS_STATE, key) is None:
                                errors.append((key, "missing"))
                        except Exception as e:
                            errors.append((key, repr(e)))
                        served[0] += 1

        probe = ElasticClient("live", timeout_s=10)
        before = probe.query_states(ALS_STATE, keys)
        assert all(v is not None for v in before)
        t = threading.Thread(target=stream, daemon=True)
        t.start()
        deadline = time.time() + 10
        while served[0] < 30 and time.time() < deadline:
            time.sleep(0.02)

        rec = ctl.scale_to(2)
        assert rec["gen"] == 2 and rec["shards"] == 2

        mark = served[0]
        deadline = time.time() + 10
        while served[0] < mark + 60 and time.time() < deadline:
            time.sleep(0.02)
        stop.set()
        t.join(timeout=30)
        assert errors == [], f"client-visible errors: {errors[:5]}"
        assert probe.query_states(ALS_STATE, keys) == before
        assert probe.generation == 2
        probe.close()
        assert 1 not in ctl.supervisors and 2 in ctl.supervisors
        gen1_left = [e for e in registry.list_jobs()
                     if registry.generation_of(e, "live") == 1]
        assert gen1_left == []
        kinds = [e["kind"] for e in ctl.events]
        assert kinds.count("cutover") == 2 and "drained" in kinds
    finally:
        ctl.stop(drop_topology=True)


# ---------------------------------------------------------------------------
# autoscaler policy + dry run; the fleet signals
# ---------------------------------------------------------------------------

def test_autoscaler_decide_hysteresis_and_cooldown():
    for P in (AutoscalerPolicy, RE.AutoscalerPolicy):
        p = P(qps_high_per_shard=500, qps_low_per_shard=100,
              p99_high_s=0.05, backlog_high_bytes=1 << 20,
              min_shards=1, max_shards=8, cooldown_s=30)
        calm = {"qps": 50.0, "p99_s": 0.001, "backlog_bytes": 0}
        hot = {"qps": 5000.0, "p99_s": 0.001, "backlog_bytes": 0}
        assert p.decide(hot, 2, now=100.0, last_scale_t=90.0)["target"] \
            is None
        assert p.decide(hot, 2, 100.0, 0.0)["target"] == 4
        assert p.decide(hot, 8, 100.0, 0.0)["target"] is None
        assert p.decide({"qps": 10, "p99_s": 0.2, "backlog_bytes": 0},
                        2, 100.0, 0.0)["target"] == 4
        assert p.decide({"qps": 10, "p99_s": 0.001,
                         "backlog_bytes": 2 << 20}, 2, 100.0, 0.0)[
            "target"] == 4
        assert p.decide(calm, 4, 100.0, 0.0)["target"] == 2
        assert p.decide(calm, 1, 100.0, 0.0)["target"] is None
        steady = {"qps": 600.0, "p99_s": 0.001, "backlog_bytes": 0}
        assert p.decide(steady, 2, 100.0, 0.0)["target"] is None
        assert p.decide({"qps": 0.0, "p99_s": None, "backlog_bytes": 0},
                        4, 100.0, 0.0)["target"] == 2
    port, ref = AutoscalerPolicy(), RE.AutoscalerPolicy()
    for sig in ({"qps": 4000.0, "p99_s": 0.2, "backlog_bytes": 9 << 20},
                {"qps": 10.0, "p99_s": None}, {}):
        assert port.decide(sig, 3, 100.0, 0.0) == ref.decide(sig, 3, 100.0,
                                                             0.0)


def test_autoscaler_dry_run_records_but_never_scales(tmp_path):
    ctl = ScaleController("dry", str(tmp_path / "bus"), "models",
                          port_dir=str(tmp_path / "ports"), device="cpu")
    scaler = Autoscaler(ctl, AutoscalerPolicy(cooldown_s=0),
                        interval_s=60, dry_run=True)
    d1 = scaler.run_once()
    assert d1["target"] is None and "first scrape" in d1["reason"]
    d2 = scaler.run_once()
    assert d2["target"] is None
    assert ctl.scales == 0 and ctl.current() is None
    assert len(scaler.decisions) == 1


def _hist(verb, count, total_s, counts, name="tpums_server_latency_seconds"):
    return {"name": name, "labels": {"verb": verb},
            "le": list(PM.LATENCY_BUCKETS_S), "counts": counts,
            "count": count, "sum": total_s}


def test_fleet_signals_derives_qps_p99_backlog():
    n_b = len(PM.LATENCY_BUCKETS_S) + 1
    zero = [0] * n_b
    bucket = 40
    after_counts = list(zero)
    after_counts[bucket] = 100
    before = {"ts": 1000.0,
              "histograms": [_hist("GET", 0, 0.0, zero),
                             _hist("HEALTH", 0, 0.0, zero)],
              "gauges": []}
    after = {"ts": 1010.0,
             "histograms": [_hist("GET", 100, 0.5, after_counts),
                            _hist("HEALTH", 500, 1.0, [500] + zero[1:])],
             "gauges": [{"name": "tpums_journal_backlog_bytes",
                         "labels": {"state": ALS_STATE}, "value": 4096}]}
    sig = PSC.fleet_signals(before, after)
    assert sig["qps"] == pytest.approx(10.0)
    assert sig["requests"] == 100
    assert sig["backlog_bytes"] == 4096
    assert sig["dt_s"] == pytest.approx(10.0)
    lo = PM.LATENCY_BUCKETS_S[bucket - 1]
    hi = PM.LATENCY_BUCKETS_S[bucket]
    assert lo <= sig["p99_s"] <= hi
    assert sig == RS.fleet_signals(before, after)


def test_fleet_signals_read_absent_series_as_the_reference():
    """Series no module of the port publishes (alerts, ANN recall, arena,
    edge, autopilot, profiler) read as the reference reads them when they
    are absent, the alert fields through the registry's alert record; and
    when a reference worker does publish them, both read them alike."""
    from flink_ms_tpu.serve import registry as RR

    empty = {"ts": 0.0}
    sig = PSC.fleet_signals(empty, {"ts": 2.0})
    assert sig == RS.fleet_signals(empty, {"ts": 2.0})
    assert sig["ann_recall"] is None and sig["p99_s"] is None
    assert sig["alerts_firing"] == 0 and sig["alerts_max_severity"] is None
    assert sig["arena_publish_seconds"] is None
    assert sig["autopilot_heldout_mse"] is None
    assert sig["forensics_staleness_s"] is None
    assert sig["edge_p99_s"] is None and sig["push_p99_s"] is None
    RR.publish_alerts("fleet", {"firing": 2, "max_severity": "warn",
                                "max_severity_level": 2, "alerts": []})
    sig = PSC.fleet_signals(empty, {"ts": 2.0})
    assert (sig["alerts_firing"], sig["alerts_max_severity"]) == (2, "warn")
    n_b = len(PM.LATENCY_BUCKETS_S) + 1
    c = [0] * n_b
    c[30] = 7
    g = lambda name, v, **lab: {"name": name, "labels": lab, "value": v}  # noqa: E731
    ctr = lambda name, v, **lab: {"name": name, "labels": lab, "value": v}  # noqa: E731
    after = {"ts": 5.0,
             "gauges": [g("tpums_ann_recall_probe", 0.97, pid="1"),
                        g("tpums_ann_recall_probe", 0.99, pid="2"),
                        g("tpums_alerts_firing", 1),
                        g("tpums_alerts_max_severity", 3),
                        g("tpums_admission_pressure", 1.7, tenant="a"),
                        g("tpums_topk_index_staleness_seconds", 0.5),
                        g("tpums_arena_publish_seconds", 0.25),
                        g("tpums_autopilot_heldout_mse", 0.81)],
             "counters": [ctr("tpums_admission_shed_total", 10),
                          ctr("tpums_edge_hedges_total", 4, result="won"),
                          ctr("tpums_push_deltas_total", 30)],
             "histograms": [_hist("TOPK", 7, 0.1, c),
                            _hist("GET", 7, 0.1, c,
                                  name="tpums_edge_latency_seconds"),
                            _hist("x", 7, 0.1, c,
                                  name="tpums_push_latency_seconds")]}
    sig = PSC.fleet_signals(empty, after)
    assert sig == RS.fleet_signals(empty, after)
    assert sig["ann_recall"] == 0.97 and sig["admission_pressure"] == 1.0
    assert (sig["alerts_firing"], sig["alerts_max_severity"]) == (1, "page")


def test_merge_snapshots_equals_the_reference():
    n_b = len(PM.LATENCY_BUCKETS_S) + 1
    rng = np.random.default_rng(9)
    snaps = []
    for r in range(3):
        counts = [int(x) for x in rng.integers(0, 5, n_b)]
        snaps.append({
            "ts": float(r),
            "counters": [{"name": "tpums_ingest_rows_total",
                          "labels": {"state": ALS_STATE}, "value": r + 1}],
            "gauges": [{"name": "tpums_journal_backlog_bytes",
                        "labels": {"state": ALS_STATE}, "value": 10 * r}],
            "histograms": [_hist("GET", sum(counts), 0.5 * r, counts),
                           {**_hist("TOPK", 1, 0.1, [1] + [0] * (n_b - 1)),
                            "exemplars": {"0": ["t%d" % r, 0.1, float(r)]}},
                           {"name": "odd", "labels": {},
                            "le": [1.0] if r else [2.0], "counts": [1, 0],
                            "count": 1, "sum": 1.0}]})
    got, want = PM.merge_snapshots(snaps), RM.merge_snapshots(snaps)
    got.pop("ts"), want.pop("ts")
    assert got == want and got["skipped"] == ["odd"]
    for h in got["histograms"]:
        if h["count"]:
            for q in (50, 99):
                assert PM.snapshot_quantile(h, q) == \
                    RM.snapshot_quantile(h, q)


def test_scrape_fleet_merges_live_workers(tmp_path):
    """``scrape_fleet`` over two live port workers of one generation: one
    METRICS round trip each, merged per shard group and fleet-wide."""
    journal, keys = _seed_journal(tmp_path, n=10)
    jobs = [_gen_worker(journal, "sf", 1, s, 2) for s in range(2)]
    try:
        for job in jobs:
            assert job.wait_ready(30)
        out = PSC.scrape_fleet()
        assert out["scraped"] == 2 and out["unreachable"] == 0
        assert sorted(out["per_shard"]) == [shard_group("sf@g1", s)
                                            for s in range(2)]
        assert {r["job_id"] for r in out["replicas"]} == \
            {j.job_id for j in jobs}
        assert out["fleet"]["merged_from"] == 2
    finally:
        for job in jobs:
            job.stop()
