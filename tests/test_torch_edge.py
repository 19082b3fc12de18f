"""The port's edge proxy (``flink_ms_tpu_torch/serve/edge.py``) against the
JAX package's on the CPU.

- Every case of ``tests/test_edge_proxy.py`` runs again with the
  reference's names bound to the port's objects (``_on_port``; its fake B2
  workers register in the port's registry): reply routing under
  interleaved pipelines, coalescing, hedging, a 2 -> 4 cutover with no
  error, the ``st=`` bound's routing, edge admission, the verb surface on
  tab and B2, discovery and rotation, and the proxy hop's spans.
- Cross-package cases: in front of two reference shard workers (in-process
  JAX-package jobs with their top-k index), a reference ``EdgeClient``
  through a port proxy gets the bytes a reference proxy gives, for GET,
  MGET, TOPK, TOPKV and COUNT, on tab (raw socket bytes) and on B2; and a
  port ``EdgeClient`` reads through a reference proxy alike.
Wire bytes must match exactly.
"""

import inspect
import socket

import numpy as np
import pytest

import test_edge_proxy as ref_cases
from test_torch_profiler import _on_port
from flink_ms_tpu.serve import edge as RE
from flink_ms_tpu.serve import registry as RReg
from flink_ms_tpu.serve.consumer import (
    ALS_STATE,
    MemoryStateBackend,
    ServingJob,
    parse_als_record,
)
from flink_ms_tpu.serve.elastic import generation_group as ref_gen_group
from flink_ms_tpu.serve.ha import shard_group as ref_shard_group
from flink_ms_tpu.serve.journal import Journal
from flink_ms_tpu.serve.sharded import sharded_parse
from flink_ms_tpu_torch.obs import metrics as PM
from flink_ms_tpu_torch.obs import tracing as PT
from flink_ms_tpu_torch.serve import edge as PE
from flink_ms_tpu_torch.serve import georepl as PG
from flink_ms_tpu_torch.serve import proto as PProto
from flink_ms_tpu_torch.serve import registry as PReg
from flink_ms_tpu_torch.serve.admission import AdmissionController
from flink_ms_tpu_torch.serve.elastic import generation_group
from flink_ms_tpu_torch.serve.ha import shard_group
from flink_ms_tpu_torch.serve.sharded import owner_of


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "10")
    for name in ("TPUMS_SNAPSHOTS", "TPUMS_COMPACT", "TPUMS_TABLE",
                 "TPUMS_TENANT", "TPUMS_GEO_REGION"):
        monkeypatch.delenv(name, raising=False)
    PG._STALENESS_CACHE.clear()


PORT = _on_port(ref_cases, {
    "obs_metrics": PM, "georepl": PG, "proto": PProto, "registry": PReg,
    "AdmissionController": AdmissionController,
    "EdgeClient": PE.EdgeClient, "EdgeProxy": PE.EdgeProxy,
    "generation_group": generation_group, "shard_group": shard_group,
    "owner_of": owner_of, "T": PT})


def _params(fn):
    marks = getattr(fn, "pytestmark", [])
    for m in marks:
        if m.name == "parametrize":
            argname, values = m.args
            return [(argname, v) for v in values]
    return [(None, None)]


CASES = [(n, arg, v) for n, f in sorted(vars(ref_cases).items())
         if n.startswith("test_") and callable(f)
         for arg, v in _params(f)]


def test_the_mirrored_cases_are_twelve_functions_fourteen_cases():
    assert len({n for n, _, _ in CASES}) == 12
    assert len(CASES) == 14


@pytest.mark.parametrize("name,arg,value", CASES,
                         ids=[f"{n}-{v}" if arg else n
                              for n, arg, v in CASES])
def test_reference_edge_case_on_the_port(name, arg, value, tmp_path,
                                         monkeypatch):
    fn = PORT[name]
    have = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    if arg:
        have[arg] = value
    fn(**{p: have[p] for p in inspect.signature(fn).parameters})


# ---------------------------------------------------------------------------
# cross-package: either package's proxy in front of reference workers
# ---------------------------------------------------------------------------

GROUP = "xedge"
N_USERS, N_ITEMS, RANK = 24, 40, 4


def _model_rows():
    rng = np.random.default_rng(14)
    rows = []
    for kind, n in (("U", N_USERS), ("I", N_ITEMS)):
        vals = rng.standard_normal((n, RANK)).astype(np.float32)
        for i in range(n):
            rows.append(f"{i},{kind}," + ";".join(repr(float(x))
                                                 for x in vals[i]))
    return rows


@pytest.fixture
def ref_fleet(tmp_path, monkeypatch):
    """Two reference shard workers (one generation, one replica each) in
    this process, registered under ``GROUP`` with its topology record."""
    j = Journal(str(tmp_path / "journal"), "als")
    j.append(_model_rows())
    gg = ref_gen_group(GROUP, 1)
    jobs = []
    try:
        for shard in range(2):
            job = ServingJob(
                Journal(j.dir, "als"), ALS_STATE,
                sharded_parse(parse_als_record, shard, 2),
                MemoryStateBackend(), host="127.0.0.1", port=0,
                poll_interval_s=0.01, job_id=f"{gg}:s{shard}r0",
                replica_of=ref_shard_group(gg, shard), replica_index=0,
                topology_group=GROUP, generation=1, snapshots=False,
            ).start()
            jobs.append(job)
        for job in jobs:
            assert job.wait_ready(60)
        RReg.publish_topology(GROUP, 2)
        yield jobs
    finally:
        for job in jobs:
            job.stop()


def _lines():
    """(pipelined lines, scoring lines): a worker's batcher may score
    concurrent vectors together, which can move a score's last bit, so
    the scoring verbs are sent one at a time (single replies are equal)."""
    keys = [f"{u}-U" for u in range(0, N_USERS, 3)] + \
        [f"{i}-I" for i in range(0, N_ITEMS, 5)] + ["999-I"]
    vec = "0.5;-1.0;0.25;2.0"
    lines = [f"GET\t{ALS_STATE}\t{k}" for k in keys]
    lines += [f"MGET\t{ALS_STATE}\t" + ",".join(keys), f"COUNT\t{ALS_STATE}"]
    scoring = [f"TOPK\t{ALS_STATE}\t{u}\t5" for u in range(0, N_USERS, 4)]
    scoring.append(f"TOPKV\t{ALS_STATE}\t7\t{vec}")
    return lines, scoring


def _raw(port, lines):
    payload = "".join(f"{line}\n" for line in lines).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(payload)
        sock.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                return out
            out += chunk


def _replies(client, lines, scoring):
    return client.pipeline(lines, window=8) + \
        [client.pipeline([line], window=1)[0] for line in scoring]


def test_reference_client_through_either_proxy_gets_the_same_bytes(
        ref_fleet):
    lines, scoring = _lines()
    got = {}
    for name, mod in (("ref", RE), ("port", PE)):
        proxy = mod.EdgeProxy(GROUP, register=False, hedge=False).start()
        try:
            tab = _raw(proxy.port, lines) + b"".join(
                _raw(proxy.port, [line]) for line in scoring)
            replies = {}
            for wire in ("tab", "b2"):
                c = RE.EdgeClient(endpoints=[("127.0.0.1", proxy.port)],
                                  proto=wire, timeout_s=30.0)
                try:
                    replies[wire] = _replies(c, lines, scoring)
                finally:
                    c.close()
            got[name] = (tab, replies)
        finally:
            proxy.stop()
    assert got["port"] == got["ref"]
    tab, replies = got["ref"]
    assert tab.count(b"\n") == len(lines) + len(scoring)
    assert replies["tab"] == replies["b2"] == \
        tab.decode().rstrip("\n").split("\n")
    assert [r for r in replies["tab"] if r.startswith(("E", "N\t"))] == []
    assert replies["tab"][len(lines) - 1] == f"C\t{N_USERS + N_ITEMS}"


def test_port_client_reads_through_a_reference_proxy(ref_fleet):
    lines, scoring = _lines()
    proxy = RE.EdgeProxy(GROUP, register=False, hedge=False).start()
    try:
        want = RE.EdgeClient(endpoints=[("127.0.0.1", proxy.port)],
                             proto="b2", timeout_s=30.0)
        try:
            ref = _replies(want, lines, scoring)
        finally:
            want.close()
        for wire in ("tab", "b2"):
            c = PE.EdgeClient(endpoints=[("127.0.0.1", proxy.port)],
                              proto=wire, timeout_s=30.0)
            try:
                assert _replies(c, lines, scoring) == ref
            finally:
                c.close()
    finally:
        proxy.stop()


def test_proxies_of_both_packages_register_alike(monkeypatch):
    """A proxy's registry entry under ``edge_group`` resolves through the
    other package's client discovery."""
    for mod, other in ((PE, RE), (RE, PE)):
        proxy = mod.EdgeProxy("disc", replica=0).start()
        try:
            c = other.EdgeClient("disc")
            assert c._endpoints == [("127.0.0.1", proxy.port)]
            assert [e["port"] for e in
                    PReg.resolve_replicas(PReg.edge_group("disc"))] == \
                [e["port"] for e in
                 RReg.resolve_replicas(RReg.edge_group("disc"))] == \
                [proxy.port]
            c.close()
        finally:
            proxy.stop()
