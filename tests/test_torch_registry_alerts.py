"""The registry's tenant operations and alert records in the port
(``flink_ms_tpu_torch/serve/registry.py``) and HEALTH's alert hint
(``serve/consumer.py`` ``ServingJob.health``) against the JAX package's on
the CPU, both packages on one registry directory:
- tenant listings and GC counts are equal, and GC of one tenant never
  reaches another's entries;
- an alert record published by one package is resolved, expired and
  dropped by the other;
- a port job's HEALTH reply equals a reference job's byte for byte with no
  alert record, with a fresh one, with an expired one and with the
  ``TPUMS_WATCH_HEALTH_HINT=0`` kill switch (the port's job of the
  previous slice answered without ``alerts_firing`` /
  ``alerts_max_severity``, so the fresh-record case failed there).
"""

import json
import os
import re
import time

import numpy as np
import pytest

from flink_ms_tpu.serve import consumer as RC
from flink_ms_tpu.serve import journal as RJ
from flink_ms_tpu.serve import registry as RR
from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.serve import consumer as PC
from flink_ms_tpu_torch.serve import journal as PJ
from flink_ms_tpu_torch.serve import registry as PR
from flink_ms_tpu_torch.serve.client import QueryClient

STATE = "ALS_MODEL"
SUMMARY = {"firing": 2, "max_severity": "page", "max_severity_level": 3,
           "alerts": [{"rule": "model_drift", "severity": "warn"},
                      {"rule": "replica_drop", "severity": "page"}]}


# ---------------------------------------------------------------------------
# tenants
# ---------------------------------------------------------------------------

MEMBERS = (("acme::j/s0r0", "acme::j/shard-0"),
           ("acme::j/s1r0", "acme::j/shard-1"),
           ("globex::j/s0r0", "globex::j/shard-0"),
           ("j/s0r0", "j/shard-0"))


def _register(mod, ttl_s=None):
    for job_id, group in MEMBERS:
        mod.register(job_id, "127.0.0.1", 1, STATE, replica_of=group,
                     replica=0, **({} if ttl_s is None else {"ttl_s": ttl_s}))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_tenant_listings_equal_across_packages(writer):
    _register(RR if writer == "ref" else PR)
    PR.publish_topology(PR.qualify_group("g", "initech"), 1)
    RR.publish_topology("plain", 2)
    assert PR.list_tenants() == RR.list_tenants() == \
        ["acme", "globex", "initech"]
    for tenant in ("acme", "globex", "initech", None):
        got = sorted(e["job_id"] for e in PR.list_tenant_jobs(tenant))
        want = sorted(e["job_id"] for e in RR.list_tenant_jobs(tenant))
        assert got == want
    assert sorted(e["job_id"] for e in PR.list_tenant_jobs("acme")) == \
        ["acme::j/s0r0", "acme::j/s1r0"]
    for name in ("acme::x@g3/shard-0", "x", "::x"):
        assert PR.tenant_of(name) == RR.tenant_of(name)


@pytest.mark.parametrize("gc_first", ["ref", "port"])
def test_tenant_gc_counts_equal_across_packages(gc_first):
    _register(PR, ttl_s=0.01)
    time.sleep(0.05)
    first, second = (RR, PR) if gc_first == "ref" else (PR, RR)
    assert first.gc_tenant_entries("acme") == 2
    assert second.gc_tenant_entries("acme") == 0     # already reaped
    assert second.gc_tenant_entries("globex") == 1
    assert first.gc_tenant_entries("globex") == 0
    # the shared entry is out of every tenant GC's reach
    assert os.path.exists(PR._entry_path("j/s0r0"))
    assert RR._entry_path("j/s0r0") == PR._entry_path("j/s0r0")
    for mod in (PR, RR):
        with pytest.raises(ValueError):
            mod.gc_tenant_entries("")


def test_the_reference_tenant_cases_hold_on_the_port(monkeypatch):
    """``tests/test_rollout.py``'s registry cases, on the port's registry."""
    assert PR.qualify_group("als", "acme") == "acme::als"
    assert PR.qualify_group("acme::als", "globex") == "acme::als"
    assert PR.qualify_group("als", "") == "als"
    for bad in ("a::b", "a/b", "a\tb", "a\nb"):
        with pytest.raises(ValueError):
            PR.qualify_group("als", bad)
    monkeypatch.setenv("TPUMS_TENANT", "acme")
    assert PR.qualify_group("als") == "acme::als"
    assert PR.qualify_group("als", "") == "als"
    monkeypatch.delenv("TPUMS_TENANT")
    assert PR.split_tenant("acme::als@g3/shard-0") == \
        ("acme", "als@g3/shard-0")
    for name, shards in (("acme::g", 2), ("globex::g", 4), ("g", 8)):
        PR.publish_topology(name, shards)
    PR.drop_topology("acme::g")
    assert RR.resolve_topology("acme::g") is None
    assert RR.resolve_topology("globex::g")["shards"] == 4
    rec = PR.publish_topology("mdl", 2, extra={"model": {
        "journal_dir": "/d/v1", "topic": "m", "model_id": "v1"}})
    rec = RR.publish_topology("mdl", 2, extra={"gen": 999, "model": {
        "journal_dir": "/d/v2", "topic": "m", "model_id": "v2"}})
    got = PR.resolve_topology("mdl")
    assert got == rec and got["gen"] == 2
    assert got["history"][-1]["model"]["model_id"] == "v1"


# ---------------------------------------------------------------------------
# alert records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pub,res", [("ref", "port"), ("port", "ref")])
def test_alert_records_cross_the_packages(pub, res):
    writer = RR if pub == "ref" else PR
    reader = PR if res == "port" else RR
    writer.publish_alerts("fleet", SUMMARY, ttl_s=30.0)
    writer.publish_alerts("acme::als", {"firing": 1, "max_severity": "warn",
                                        "max_severity_level": 2,
                                        "alerts": [{"rule": "a"}]})
    assert reader.resolve_alerts("fleet") == SUMMARY
    assert reader.resolve_alerts() == RR.resolve_alerts() == \
        PR.resolve_alerts()
    merged = reader.resolve_alerts()
    assert merged["firing"] == 3 and merged["max_severity"] == "page"
    with open(PR._alerts_path("fleet")) as f:
        rec = json.load(f)
    assert PR._alerts_path("fleet") == RR._alerts_path("fleet")
    assert sorted(rec) == ["kind", "published_at", "scope", "summary",
                           "ttl_s"]
    reader.drop_alerts("fleet")
    assert writer.resolve_alerts("fleet") is None
    writer.drop_alerts("nothing-there")  # best-effort: no raise


def test_expired_alert_records_are_dropped_by_either_package():
    PR.publish_alerts("fleet", SUMMARY, ttl_s=0.01)
    RR.publish_alerts("other", SUMMARY, ttl_s=0.01)
    time.sleep(0.05)
    assert RR.resolve_alerts("fleet") is None
    assert not os.path.exists(PR._alerts_path("fleet"))
    assert PR.resolve_alerts() is None
    assert not os.path.exists(RR._alerts_path("other"))


# ---------------------------------------------------------------------------
# HEALTH's alert hint
# ---------------------------------------------------------------------------

def _journal(tmp_path):
    rng = np.random.default_rng(0)
    d = str(tmp_path / "bus")
    PJ.Journal(d, "t").append(
        [F.format_als_row(u, "U", rng.normal(size=3)) for u in range(8)]
        + [F.format_als_row(i, "I", rng.normal(size=3)) for i in range(8)])
    return d


def _jobs(journal_dir):
    ref = RC.ServingJob(RJ.Journal(journal_dir, "t"), STATE,
                        RC.parse_als_record, RC.MemoryStateBackend(),
                        host="127.0.0.1", port=0, job_id="ref-job",
                        snapshots=False).start()
    port = PC.ServingJob(PJ.Journal(journal_dir, "t"), STATE,
                         PC.parse_als_record, PC.MemoryStateBackend(),
                         host="127.0.0.1", port=0, job_id="port-job",
                         device="cpu", snapshots=False).start()
    assert ref.wait_ready(30) and port.wait_ready(30)
    return ref, port


def _health_bytes(job, job_id):
    """The raw HEALTH reply with what names the process taken out: the
    job id, the port and the bootstrap seconds."""
    with QueryClient("127.0.0.1", job.port, timeout_s=30) as c:
        reply = c._roundtrip(f"HEALTH\t{STATE}")
    reply = reply.replace(job_id, "<job>").replace(
        f":{job.port}/", ":<port>/")
    return re.sub(r'"bootstrap_seconds": [0-9.e-]+',
                  '"bootstrap_seconds": <s>', reply)


CASES = {
    "no_record": ({}, None),
    "fresh_port_published": ({}, ("port", 30.0)),
    "fresh_ref_published": ({}, ("ref", 30.0)),
    "expired": ({}, ("port", 0.01)),
    "kill_switch": ({"TPUMS_WATCH_HEALTH_HINT": "0"}, ("ref", 30.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_health_reply_equals_the_reference_job(case, tmp_path, monkeypatch):
    env, record = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if record is not None:
        pub, ttl = record
        (RR if pub == "ref" else PR).publish_alerts("fleet", SUMMARY,
                                                    ttl_s=ttl)
        time.sleep(0.05)
    ref, port = _jobs(_journal(tmp_path))
    try:
        want = _health_bytes(ref, "ref-job")
        got = _health_bytes(port, "port-job")
    finally:
        ref.stop()
        port.stop()
    assert got == want
    h = json.loads(got[2:].replace("<s>", "0"))
    fresh = case.startswith("fresh")
    assert ("alerts_firing" in h) is fresh
    if fresh:
        assert (h["alerts_firing"], h["alerts_max_severity"]) == (2, "page")


def test_health_hint_is_cached_for_a_second(tmp_path):
    job = PC.ServingJob(PJ.Journal(_journal(tmp_path), "t"), STATE,
                        PC.parse_als_record, PC.MemoryStateBackend(),
                        host="127.0.0.1", port=0, device="cpu",
                        snapshots=False).start()
    try:
        assert job.wait_ready(30)
        assert "alerts_firing" not in job.health()
        PR.publish_alerts("fleet", SUMMARY, ttl_s=30.0)
        # the cached "no record" answer holds inside the hint's TTL
        assert "alerts_firing" not in job.health()
        job._alert_hint_cache = (time.time() - 2.0,
                                 job._alert_hint_cache[1])
        assert job.health()["alerts_firing"] == 2
    finally:
        job.stop()
