"""The port's ``ALSTopkHandler`` behind the JAX package's ``LookupServer``
(through its ``topk_handlers=`` argument): TOPK and TOPKV replies over TCP
equal, byte for byte, those of the same server running the reference's
handler, on a table whose dot products are exact in float32.  This holds
the port's handler to the server's ``submit_query`` / ``by_vector``
contract without copying the server."""

import numpy as np
import pytest

from flink_ms_tpu.serve.client import QueryClient
from flink_ms_tpu.serve.server import LookupServer
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu.serve.topk import ALSTopkHandler as RefHandler
from flink_ms_tpu_torch.serve.table import ModelTable
from flink_ms_tpu_torch.serve.topk import make_als_topk_handler

STATE = "ALS_MODEL"


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")
    monkeypatch.setenv("TPUMS_TOPK_TIER", "exact")


def _exact_rows(rng, shape):
    """Small multiples of 1/8, with duplicates so that replies hold ties."""
    rows = rng.integers(-16, 16, size=shape) / 8.0
    rows[1::7] = rows[0]
    return rows


def _payload(vec) -> str:
    return ";".join(repr(float(x)) for x in vec)


def _requests(users, vectors, k):
    reqs = [f"TOPK\t{STATE}\t{u}\t{k}" for u in users]
    reqs += [f"TOPKV\t{STATE}\t{k}\t{_payload(v)}" for v in vectors]
    reqs += [f"TOPK\t{STATE}\tnobody\t{k}", f"TOPKV\t{STATE}\t{k}\t1.0;2.0"]
    return reqs


def _serve(table, handler, reqs, pipelined):
    srv = LookupServer({STATE: table}, host="127.0.0.1", port=0,
                       topk_handlers={STATE: handler}).start()
    try:
        with QueryClient("127.0.0.1", srv.port, timeout_s=30) as c:
            if pipelined:
                return c.pipeline(reqs, window=16)
            return [c._roundtrip(r) for r in reqs]
    finally:
        srv.stop()


@pytest.mark.parametrize("batch", ["0", "1"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_reply_bytes_equal_the_reference_handler(monkeypatch, batch,
                                                 pipelined):
    monkeypatch.setenv("TPUMS_TOPK_BATCH", batch)
    rng = np.random.default_rng(0)
    d = 6
    items = _exact_rows(rng, (120, d))
    users = rng.integers(-16, 16, size=(10, d)) / 8.0
    ref_t, port_t = RefTable(4), ModelTable(4)
    for t in (ref_t, port_t):
        t.put_many([(f"{i}-I", _payload(v)) for i, v in enumerate(items)]
                   + [(f"{u}-U", _payload(v)) for u, v in enumerate(users)])
    reqs = _requests(range(10), rng.integers(-16, 16, size=(6, d)) / 8.0, 15)
    want = _serve(ref_t, RefHandler(ref_t), reqs, pipelined)
    got = _serve(port_t, make_als_topk_handler(port_t, device="cpu"), reqs,
                 pipelined)
    assert got == want
    assert all(r.startswith("V\t") for r in got[:16])
    assert got[16] == "N" and got[17].startswith("E\ttopk failed")
    # ties are in the replies: an item and its duplicate, lower id first
    assert any(";1:" in r or r.startswith("V\t0:") for r in got[:16])


def test_server_stop_closes_the_port_batcher(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_BATCH", "1")
    table = ModelTable(2)
    for i in range(30):
        table.put(f"{i}-I", _payload(np.full(4, i / 8.0)))
    table.put("1-U", _payload(np.ones(4)))
    handler = make_als_topk_handler(table, device="cpu")
    srv = LookupServer({STATE: table}, host="127.0.0.1", port=0,
                       topk_handlers={STATE: handler}).start()
    with QueryClient("127.0.0.1", srv.port, timeout_s=30) as c:
        assert [i for i, _ in c.topk(STATE, "1", 3)] == ["29", "28", "27"]
    srv.stop()
    with pytest.raises(RuntimeError, match="closed"):
        handler.batcher.submit(np.zeros(4, np.float32), 1)
