"""The port's per-tenant admission (``flink_ms_tpu_torch/serve/admission.py``)
and its lookup server's shedding, held against the JAX package's on the CPU.

- Each of the 10 cases of ``tests/test_admission.py`` runs again with the
  reference's names bound to the port's objects (``_on_port``): the token
  bucket's accounting and reserve floor, the tenant-rate parsing,
  ``from_env`` off unless a rate knob is set, the controller's shed order
  and tenant isolation, the default rate of untenanted traffic,
  ``pop_tenant``, the server shedding TOPK before GET per tenant, the B2
  connection-bound tenant, and the wire bytes with no tenant.
- Differential cases on the same inputs and the same injected clock: both
  packages' token buckets and controllers take equal decisions over
  seeded random scripts, ``from_env`` and ``pop_tenant`` read alike, the
  same request sequence gets equal replies from either package's server
  through either package's client (tab and B2), and a port client writes
  the reference client's bytes with and without a tenant.
"""

import inspect

import numpy as np
import pytest

import test_admission as ref_cases
from test_torch_profiler import _on_port
from flink_ms_tpu.serve import admission as RA
from flink_ms_tpu.serve.client import QueryClient as RefClient
from flink_ms_tpu.serve.server import LookupServer as RefServer
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu.serve.topk import make_als_topk_handler as ref_topk_handler
from flink_ms_tpu_torch.serve import admission as PA
from flink_ms_tpu_torch.serve.client import QueryClient as PortClient
from flink_ms_tpu_torch.serve.consumer import ALS_STATE
from flink_ms_tpu_torch.serve.server import LookupServer as PortServer
from flink_ms_tpu_torch.serve.table import ModelTable as PortTable
from flink_ms_tpu_torch.serve.topk import make_als_topk_handler


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    for name in ("TPUMS_TENANT", "TPUMS_ADMIT_QPS", "TPUMS_ADMIT_TENANT_QPS",
                 "TPUMS_ADMIT_BURST_S", "TPUMS_ADMIT_RESERVE"):
        monkeypatch.delenv(name, raising=False)


def _port_topk_handler(table):
    return make_als_topk_handler(table, device="cpu")


PORT = _on_port(ref_cases, {
    "admission": PA, "AdmissionController": PA.AdmissionController,
    "TokenBucket": PA.TokenBucket, "QueryClient": PortClient,
    "ALS_STATE": ALS_STATE, "LookupServer": PortServer,
    "ModelTable": PortTable, "make_als_topk_handler": _port_topk_handler})
CASES = sorted(n for n, f in vars(ref_cases).items()
               if n.startswith("test_") and callable(f))


def test_the_mirrored_cases_are_all_ten():
    assert len(CASES) == 10


@pytest.mark.parametrize("name", CASES)
def test_reference_admission_case_on_the_port(name, monkeypatch):
    fn = PORT[name]
    have = {"monkeypatch": monkeypatch}
    fn(**{p: have[p] for p in inspect.signature(fn).parameters})


# ---------------------------------------------------------------------------
# equal decisions on the same inputs and clock
# ---------------------------------------------------------------------------

def _bucket_script(seed, n=400):
    """Seeded calls on a token bucket: takes of cost 0.5-2 under a floor,
    level reads, the clock mostly forward, sometimes back."""
    rng = np.random.default_rng(seed)
    now, out = 10.0, []
    for _ in range(n):
        now += float(rng.choice([0.0, 0.01, 0.05, 0.3, -0.2],
                                p=[0.4, 0.3, 0.15, 0.1, 0.05]))
        if rng.uniform() < 0.15:
            out.append(("level", now))
        else:
            out.append(("take", float(rng.choice([0.5, 1.0, 2.0])),
                        float(rng.choice([0.0, 0.0, 1.0, 2.5])), now))
    return out


def _run_bucket(mod, rate, burst, script):
    b = mod.TokenBucket(rate, burst, now=10.0)
    got = []
    for op in script:
        if op[0] == "level":
            got.append(round(b.level(now=op[1]), 12))
        else:
            got.append(b.try_take(op[1], floor=op[2], now=op[3]))
    return got


@pytest.mark.parametrize("seed,rate,burst", [(0, 4.0, 4.0), (1, 10.0, 5.0),
                                             (2, 0.5, 3.0)])
def test_token_buckets_decide_alike(seed, rate, burst):
    script = _bucket_script(seed)
    got = _run_bucket(PA, rate, burst, script)
    want = _run_bucket(RA, rate, burst, script)
    assert got == want
    takes = [g for g, op in zip(got, script) if op[0] == "take"]
    assert any(takes) and not all(takes)


VERBS = ("GET", "MGET", "TOPK", "TOPKV", "DOT", "COUNT", "HEALTH", "METRICS",
         "PING", "HELLO")


def _controller_script(seed, n=600):
    """Seeded (tenant, verb, clock) decisions: three tenants and the
    untenanted default, every verb, the clock stepping forward."""
    rng = np.random.default_rng(seed)
    now, out = 100.0, []
    for _ in range(n):
        now += float(rng.exponential(0.02))
        tenant = ("hot", "cold", "free", None)[int(rng.integers(4))]
        out.append((tenant, VERBS[int(rng.integers(len(VERBS)))], now))
    return out


def _run_controller(mod, kw, script):
    ctl = mod.AdmissionController(**kw)
    got = [ctl.admit(t, v, now=now) for t, v, now in script]
    levels = {k: round(v, 9) for k, v in
              ctl.levels(now=script[-1][2]).items()}
    return got, ctl.admitted, ctl.shed, levels


@pytest.mark.parametrize("seed,kw", [
    (0, dict(tenant_qps={"hot": 20.0, "cold": 2.0})),
    (1, dict(default_qps=5.0, tenant_qps={"hot": 40.0}, burst_s=0.5)),
    (2, dict(tenant_qps={"hot": 3.0}, burst_s=2.0, reserve_frac=0.25)),
    (3, dict(default_qps=8.0, burst_s=1.0, reserve_frac=1.0))])
def test_controllers_decide_alike(seed, kw):
    script = _controller_script(seed)
    got = _run_controller(PA, kw, script)
    assert got == _run_controller(RA, kw, script)
    decisions, _, shed, _ = got
    assert shed > 0 and sum(decisions) > 0
    # the ops surface was never shed
    for ok, (_, verb, _) in zip(decisions, script):
        if verb not in PA.ADMITTED_VERBS:
            assert ok


@pytest.mark.parametrize("env", [
    {}, {"TPUMS_ADMIT_QPS": "0"}, {"TPUMS_ADMIT_BURST_S": "4"},
    {"TPUMS_ADMIT_TENANT_QPS": "hot=5"},
    {"TPUMS_ADMIT_QPS": "20", "TPUMS_ADMIT_TENANT_QPS": "hot=5,cold=50",
     "TPUMS_ADMIT_BURST_S": "2.5", "TPUMS_ADMIT_RESERVE": "0.25"},
    {"TPUMS_ADMIT_QPS": "ten", "TPUMS_ADMIT_TENANT_QPS": "a=1",
     "TPUMS_ADMIT_BURST_S": "wide", "TPUMS_ADMIT_RESERVE": "half"},
    {"TPUMS_ADMIT_TENANT_QPS": "x,=5,a=abc, b = 7 ,"},
    {"TPUMS_ADMIT_QPS": "-3", "TPUMS_ADMIT_RESERVE": "7"}])
def test_from_env_reads_alike(env):
    def read(mod):
        ctl = mod.AdmissionController.from_env(env=env)
        return None if ctl is None else (
            ctl.default_qps, ctl.tenant_qps, ctl.burst_s, ctl.reserve_frac)

    assert read(PA) == read(RA)


@pytest.mark.parametrize("parts", [
    ["GET", "S", "k", "tn=acme"], ["GET", "S", "k"], ["GET", "S", "tn="],
    ["GET", "tn=a", "k"], ["tn=a"], ["TOPK", "S", "7", "10", "tn=x=y"],
    ["MGET", "S", "a,b", "tid=1", "tn=t"]])
def test_pop_tenant_alike(parts):
    a, b = list(parts), list(parts)
    assert PA.pop_tenant(a) == RA.pop_tenant(b)
    assert a == b


def test_the_wire_constants_are_the_references():
    for name in ("TENANT_FIELD", "SHED_REPLY", "SHED_MARKER",
                 "DEFAULT_TENANT", "ADMITTED_VERBS", "LOW_PRIORITY_VERBS"):
        assert getattr(PA, name) == getattr(RA, name), name


# ---------------------------------------------------------------------------
# equal replies from either package's server, through either client
# ---------------------------------------------------------------------------

PACKAGES = {
    "port": (PA, PortServer, PortTable, _port_topk_handler, PortClient),
    "reference": (RA, RefServer, RefTable, ref_topk_handler, RefClient)}


def _server(package, **kw):
    mod, server, table_cls, handler, _ = PACKAGES[package]
    table = table_cls(2)
    for i in range(8):
        table.put(f"{i}-U", "1.0;2.0")
        table.put(f"{i}-I", "0.5;0.5")
    return server({ALS_STATE: table}, host="127.0.0.1", port=0,
                  job_id="admit-x",
                  topk_handlers={ALS_STATE: handler(table)},
                  admission=mod.AdmissionController(**kw)).start()


def _outcome(fn):
    try:
        return ("ok", fn())
    except RuntimeError as e:
        return ("shed" if RA.SHED_MARKER in str(e) else "error", None)


# the reference cases' sequences: rate 0.5/s keeps the clock's drift
# inside a fraction of a token over a whole sequence
SEQUENCES = {
    "tab": (dict(tenant_qps={"hot": 0.5}, burst_s=6.0, reserve_frac=0.5),
            [("hot", "topk", "1"), ("hot", "topk", "1"),
             ("hot", "get", "1-U"), ("hot", "get", "2-U"),
             ("hot", "get", "3-U"), ("hot", "topk", "2"),
             ("", "topk", "1"), ("", "get", "1-U")]),
    "b2": (dict(tenant_qps={"hot": 0.5}, burst_s=4.0, reserve_frac=0.0),
           [("hot", "get", "1-U"), ("hot", "get", "2-U"),
            ("hot", "get", "3-U"), ("hot", "topk", "1"),
            ("", "get", "1-U"), ("", "topk", "3")])}
WANT = {
    "tab": ["ok", "shed", "ok", "ok", "shed", "shed", "ok", "ok"],
    "b2": ["ok", "ok", "shed", "shed", "ok", "ok"]}


@pytest.mark.parametrize("server_pkg", sorted(PACKAGES))
@pytest.mark.parametrize("client_pkg", sorted(PACKAGES))
@pytest.mark.parametrize("proto", sorted(SEQUENCES))
def test_servers_shed_alike(proto, client_pkg, server_pkg):
    kw, seq = SEQUENCES[proto]
    client_cls = PACKAGES[client_pkg][4]
    srv = _server(server_pkg, **kw)
    clients = {}
    try:
        got = []
        for tenant, op, arg in seq:
            c = clients.get(tenant)
            if c is None:
                c = clients[tenant] = client_cls(
                    "127.0.0.1", srv.port, timeout_s=5.0, tenant=tenant,
                    **({"proto": "b2"} if proto == "b2" else {}))
            fn = ((lambda: c.topk(ALS_STATE, arg, 2)) if op == "topk"
                  else (lambda: c.query_state(ALS_STATE, arg)))
            got.append(_outcome(fn))
        assert [k for k, _ in got] == WANT[proto]
        # what was served is what the reference's server serves (every
        # item scores 1.5 for every user: the ids of the ties may differ)
        for (kind, payload), (_, op, _) in zip(got, seq):
            if kind == "ok":
                assert (payload == "1.0;2.0" if op == "get"
                        else [s for _, s in payload] == [1.5, 1.5])
    finally:
        for c in clients.values():
            c.close()
        srv.stop()


@pytest.mark.parametrize("tenant,ambient", [(None, None), ("acme", None),
                                             (None, "globex"),
                                             ("acme", "globex")])
def test_clients_write_the_same_bytes(tenant, ambient, monkeypatch):
    if ambient is None:
        monkeypatch.delenv("TPUMS_TENANT", raising=False)
    else:
        monkeypatch.setenv("TPUMS_TENANT", ambient)
    sent = {}
    for name, cls in (("port", PortClient), ("reference", RefClient)):
        srv, port, received = ref_cases._recording_server()
        try:
            kw = {} if tenant is None else {"tenant": tenant}
            c = cls("127.0.0.1", port, timeout_s=5.0, **kw)
            assert c.query_state(ALS_STATE, "1-U") == "1.0;2.0"
            c.close()
            sent[name] = received[0]
        finally:
            srv.close()
    assert sent["port"] == sent["reference"]
    name = tenant or ambient
    assert sent["port"] == (f"GET\t{ALS_STATE}\t1-U"
                            + (f"\ttn={name}" if name else "")
                            + "\n").encode()
