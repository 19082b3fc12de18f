"""Wire protocol v2 on the port's two planes (``serve/proto.py`` and the
port's ``native/lookup_server.cpp``): each case of
``tests/test_native_protocol.py`` on the port.  HELLO negotiation, the
frozen-v1 byte pins (old clients and old servers stay byte-identical on
the wire), binary<->tab reply parity per verb, HEALTH/METRICS schema parity
between the C++ and Python planes, malformed frames, tracing on the wire,
the fleet scrape's ladder check, and the native HA+elastic rescale smoke
(``--device cpu`` workers)."""

import json
import signal
import socket
import threading
import time

import numpy as np
import pytest

from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.obs.metrics import LATENCY_BUCKETS_S, merge_snapshots
from flink_ms_tpu_torch.serve import proto, registry
from flink_ms_tpu_torch.serve.client import QueryClient, RetryPolicy
from flink_ms_tpu_torch.serve.consumer import (
    ALS_STATE,
    ServingJob,
    make_backend,
    parse_als_record,
)
from flink_ms_tpu_torch.serve.elastic import ElasticClient, ScaleController
from flink_ms_tpu_torch.serve.journal import Journal
from flink_ms_tpu_torch.serve.server import LookupServer
from flink_ms_tpu_torch.serve.table import ModelTable
from flink_ms_tpu_torch.serve.topk import make_als_topk_handler


def _native_available():
    from flink_ms_tpu_torch.serve import native_store

    try:
        native_store._load_lib()
        return True
    except (OSError, RuntimeError):
        return False


# native-plane tests skip on a machine without g++ (the library is built
# from the port's sources at first use); the Python-plane protocol tests
# below still run there
_needs_native = pytest.mark.skipif(
    not _native_available(), reason="no g++ to build the native library"
)

# factor values on a 0.25 grid (same trick as test_native_server): every
# product and sum is exact in f32, so both planes format identical scores
ROWS = [
    ("10-I", "1.0;0.5;-2.0;0.25"),
    ("11-I", "0.5;0.5;0.5;0.5"),
    ("12-I", "-1.0;2.0;1.5;-0.5"),
    ("7-U", "1.0;2.0;0.5;-1.0"),
]

HELLO = b"HELLO\tB2\n"


def _pyserver():
    table = ModelTable(2)
    for k, v in ROWS:
        table.put(k, v)
    return LookupServer(
        {ALS_STATE: table}, host="127.0.0.1", port=0, job_id="jid",
        topk_handlers={ALS_STATE: make_als_topk_handler(table,
                                                        device="cpu")},
    ).start()


@pytest.fixture
def pysrv():
    srv = _pyserver()
    yield srv
    srv.stop()


@pytest.fixture
def nsrv(tmp_path):
    from flink_ms_tpu_torch.serve.native_store import NativeLookupServer, NativeStore

    if not _native_available():
        pytest.skip("no g++ to build the native library")
    store = NativeStore(str(tmp_path / "store"))
    for k, v in ROWS:
        store.put(k, v)
    with NativeLookupServer(store, ALS_STATE, job_id="jid", port=0,
                            topk_suffixes=("-I", "-U")) as srv:
        yield srv
    store.close()


def _raw(port, payload):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(payload)
        sock.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                return out
            out += chunk


def _binary_exchange(port, frames):
    """HELLO + raw frame bytes, half-close -> reply bytes after the HELLO
    reply line."""
    out = _raw(port, HELLO + frames)
    assert out.startswith(HELLO), out[:64]
    return out[len(HELLO):]


def _decode_all(buf):
    """Decode back-to-back reply frames -> flat list of reply lines."""
    texts, pos = [], 0
    while pos < len(buf):
        res = proto.decode_reply_frame(buf, pos)
        assert res is not None, f"truncated reply frame at {pos}"
        frame, pos = res
        texts.extend(frame)
    return texts


# ---------------------------------------------------------------------------
# HELLO negotiation (tentpole): accept, refuse, stay-tab
# ---------------------------------------------------------------------------

def _negotiation_roundtrip(port):
    frame = proto.encode_request_frame(
        [f"GET\t{ALS_STATE}\t7-U", "PING"])
    replies = _decode_all(_binary_exchange(port, frame))
    assert replies == ["V\t1.0;2.0;0.5;-1.0", "PONG\tjid\tALS_MODEL"]


def test_hello_negotiation_python(pysrv):
    _negotiation_roundtrip(pysrv.port)


@_needs_native
def test_hello_negotiation_native(nsrv):
    _negotiation_roundtrip(nsrv.port)


@_needs_native
def test_hello_unsupported_refused_identically(pysrv, nsrv):
    # refused proto -> error line, and the connection STAYS tab: the PING
    # pipelined behind the bad HELLO is still answered
    payload = b"HELLO\tB9\nPING\n"
    want = b"E\tunsupported proto: B9\nPONG\tjid\tALS_MODEL\n"
    assert _raw(pysrv.port, payload) == want
    assert _raw(nsrv.port, payload) == want
    # malformed HELLO (extra field) never switches framing either
    payload = b"HELLO\tB2\textra\nPING\n"
    assert _raw(pysrv.port, payload) == _raw(nsrv.port, payload)


# ---------------------------------------------------------------------------
# frozen v1: old clients and old servers byte-identical (acceptance pin)
# ---------------------------------------------------------------------------

_V1_REQUESTS = (
    b"GET\tALS_MODEL\t7-U\n"
    b"GET\tALS_MODEL\tmissing\n"
    b"MGET\tALS_MODEL\t7-U,missing,10-I\n"
    b"TOPK\tALS_MODEL\t7\t2\n"
    b"TOPKV\tALS_MODEL\t2\t1.0;2.0;0.5;-1.0\n"
    b"DOT\tALS_MODEL\t2\t1:0.5;3:1.5\n"
    b"COUNT\tALS_MODEL\n"
    b"PING\n"
    b"NONSENSE\n"
)
# literal bytes, NOT computed: if either server's tab plane drifts, this
# fails even when both planes drift together
_V1_REPLIES = (
    b"V\t1.0;2.0;0.5;-1.0\n"
    b"N\n"
    b"M\tV1.0;2.0;0.5;-1.0\tN\tV1.0;0.5;-2.0;0.25\n"
    b"V\t12:4.25;11:1.25\n"
    b"V\t12:4.25;11:1.25\n"
    b"D\t0.0\t0,1\n"
    b"C\t4\n"
    b"PONG\tjid\tALS_MODEL\n"
    b"E\tbad request\n"
)


def test_v1_server_bytes_pinned_python(pysrv):
    assert _raw(pysrv.port, _V1_REQUESTS) == _V1_REPLIES


@_needs_native
def test_v1_server_bytes_pinned_native(nsrv):
    assert _raw(nsrv.port, _V1_REQUESTS) == _V1_REPLIES


def test_v1_client_bytes_pinned():
    """The request direction of the freeze: a default (tab) QueryClient puts
    exactly the seed bytes on the wire — no HELLO, no framing, no stamps."""
    captured = []
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def serve():
        conn, _ = lsock.accept()
        with conn, conn.makefile("rb") as f:
            for reply in (b"V\t1.0;2.0\n", b"M\tN\tN\n", b"C\t4\n",
                          b"PONG\tjid\tALS_MODEL\n"):
                line = f.readline()
                if not line:
                    return
                captured.append(line)
                conn.sendall(reply)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        with QueryClient("127.0.0.1", port) as c:
            c.query_state(ALS_STATE, "7-U")
            c.query_states(ALS_STATE, ["a", "b"])
            c.count(ALS_STATE)
            c.ping()
        t.join(timeout=5)
    finally:
        lsock.close()
    assert captured == [
        b"GET\tALS_MODEL\t7-U\n",
        b"MGET\tALS_MODEL\ta,b\n",
        b"COUNT\tALS_MODEL\n",
        b"PING\n",
    ]


# ---------------------------------------------------------------------------
# binary <-> tab reply parity per verb, both planes (tentpole)
# ---------------------------------------------------------------------------

_PARITY_LINES = [
    "GET\tALS_MODEL\t7-U",
    "GET\tALS_MODEL\tmissing",
    "GET\tOTHER\tx",
    "MGET\tALS_MODEL\t7-U,missing,10-I",
    "TOPK\tALS_MODEL\t7\t2",
    "TOPK\tALS_MODEL\tmissing\t2",
    "TOPKV\tALS_MODEL\t2\t1.0;2.0;0.5;-1.0",
    "TOPKV\tALS_MODEL\tx\t1.0",
    "DOT\tALS_MODEL\t2\t1:0.5;3:1.5",
    "COUNT\tALS_MODEL",
    "COUNT\tOTHER",
    "PING",
]


def _parity_per_verb(port):
    for line in _PARITY_LINES:
        tab = _raw(port, line.encode("utf-8") + b"\n")
        assert tab.endswith(b"\n")
        binary = _decode_all(_binary_exchange(
            port, proto.encode_request_frame([line])))
        assert binary == [tab[:-1].decode("utf-8")], line
    # whole batch in one frame == the same lines pipelined over tab
    tab = _raw(port, "".join(l + "\n" for l in _PARITY_LINES).encode("utf-8"))
    binary = _decode_all(_binary_exchange(
        port, proto.encode_request_frame(_PARITY_LINES)))
    assert binary == tab.decode("utf-8").split("\n")[:-1]


def test_binary_tab_parity_python(pysrv):
    _parity_per_verb(pysrv.port)


@_needs_native
def test_binary_tab_parity_native(nsrv):
    _parity_per_verb(nsrv.port)


# ---------------------------------------------------------------------------
# HEALTH / METRICS schema parity (tentpole: native observability surface)
# ---------------------------------------------------------------------------

def _metrics_snapshot(port):
    out = _raw(port, b"METRICS\n")
    assert out.startswith(b"J\t")
    return json.loads(out[2:].decode("utf-8"))


@_needs_native
def test_metrics_schema_matches_python(nsrv, monkeypatch):
    from flink_ms_tpu_torch.obs import metrics as obs_metrics

    # the Python plane's registry is process-wide: give this test a fresh
    # one (after the server and its index registered their own series) so
    # both planes see exactly this test's verb mix
    pysrv = _pyserver()
    monkeypatch.setattr(obs_metrics, "_REGISTRY",
                        obs_metrics.MetricsRegistry())
    try:
        # exercise the same verb mix on both planes so the same series
        # exist
        for port in (pysrv.port, nsrv.port):
            _raw(port, _V1_REQUESTS)
        py = _metrics_snapshot(pysrv.port)
        nat = _metrics_snapshot(nsrv.port)
    finally:
        pysrv.stop()

    assert set(nat) == set(py) == {
        "ts", "enabled", "counters", "gauges", "histograms", "meta"}
    assert py["meta"]["plane"] == "python"
    assert nat["meta"]["plane"] == "native"
    assert nat["meta"]["job_id"] == "jid"

    def series(snap):
        return {(c["name"], c["labels"].get("verb"))
                for c in snap["counters"]}

    # every tab verb in the mix shows up as requests_total on both planes
    # (+ NONSENSE errors land in errors_total); set equality keeps the two
    # planes from diverging in which series they export.  The native plane
    # additionally books per-verb CPU self-time (the Python plane's CPU
    # accounting lives in the sampling profiler instead) — that series is
    # native-only by design, so exclude it from the parity set and pin it
    # separately.
    self_time = {(n, v) for (n, v) in series(nat)
                 if n == "tpums_native_self_seconds_total"}
    assert series(nat) - self_time == series(py)
    for verb in ("GET", "MGET", "TOPK", "TOPKV", "DOT", "COUNT", "PING"):
        assert ("tpums_server_requests_total", verb) in series(nat)
        assert ("tpums_native_self_seconds_total", verb) in self_time

    # histograms ride the shared obs ladder — the exact bounds the fleet
    # scraper asserts on (build-skew detection)
    for snap in (py, nat):
        hists = [h for h in snap["histograms"]
                 if h["name"] == "tpums_server_latency_seconds"]
        assert hists
        for h in hists:
            assert h["le"] == list(LATENCY_BUCKETS_S)
            assert len(h["counts"]) == len(LATENCY_BUCKETS_S) + 1
            assert h["count"] == sum(h["counts"])

    # and the two planes AGGREGATE: merge_snapshots must not silently drop
    # the native histograms (that is what the scrape assert protects)
    fleet = merge_snapshots([py, nat])
    fleet_get = [h for h in fleet["histograms"]
                 if h["name"] == "tpums_server_latency_seconds"
                 and h["labels"].get("verb") == "GET"]
    assert len(fleet_get) == 1

    def get_count(snap):
        return sum(h["count"] for h in snap["histograms"]
                   if h["name"] == "tpums_server_latency_seconds"
                   and h["labels"].get("verb") == "GET")

    assert fleet_get[0]["count"] == get_count(py) + get_count(nat)


@_needs_native
def test_bare_health_byte_identical(pysrv, nsrv):
    # without a pushed report (no ServingJob), the native HEALTH synthesizes
    # the same minimal JSON the bare Python server serves — byte-identical
    # once each server's own bind host:port is masked out of its metrics_uri
    import re

    def health(port):
        out = _raw(port, b"HEALTH\tALS_MODEL\n")
        return re.sub(rb"tpums://[0-9.]+:\d+/", b"tpums://HOST/", out)

    assert health(nsrv.port) == health(pysrv.port)
    assert _raw(nsrv.port, b"HEALTH\tOTHER\n") == \
        _raw(pysrv.port, b"HEALTH\tOTHER\n")


@_needs_native
def test_serving_job_native_health_and_metrics(tmp_path):
    """End-to-end --nativeServer: the consumer pushes its HEALTH report into
    the C++ server (ready/topology fields visible on the wire) and METRICS
    serves the native-plane snapshot — the autoscaler's two inputs."""
    journal = Journal(str(tmp_path / "bus"), "models")
    rng = np.random.default_rng(0)
    journal.append([F.format_als_row(u, "U", rng.normal(size=3))
                    for u in range(8)])
    job = ServingJob(
        journal, ALS_STATE, parse_als_record,
        make_backend("rocksdb", str(tmp_path / "ckpt")),
        host="127.0.0.1", port=0, poll_interval_s=0.05,
        job_id="native-job", native_server=True,
        topology_group="ng", generation=3, device="cpu",
    ).start()
    try:
        assert job.wait_ready(30)
        with QueryClient("127.0.0.1", job.port, timeout_s=10) as c:
            # wait_ready unblocks on the flip itself; the flip's immediate
            # heartbeat pushes the updated report a beat later
            deadline = time.time() + 10
            h = c.health(ALS_STATE)
            while not h["ready"] and time.time() < deadline:
                time.sleep(0.05)
                h = c.health(ALS_STATE)
            assert h["ready"] is True and h["status"] == "ready"
            assert h["job_id"] == "native-job"
            assert h["topology_group"] == "ng" and h["generation"] == 3
            assert h["keys"] == 8  # spliced in by the C++ server
            assert h["metrics_uri"].endswith(f":{job.port}/METRICS")
            m = c.metrics()
            assert m["meta"]["plane"] == "native"
            assert m["meta"]["job_id"] == "native-job"
    finally:
        job.stop()


# ---------------------------------------------------------------------------
# malformed frames: graceful E-reply + close, identical across planes
# ---------------------------------------------------------------------------

_BAD_FRAMES = [
    # bad magic
    b"XZ" + proto.encode_varint(3) + b"abc",
    # body_len over the request cap
    b"B2" + proto.encode_varint(proto.MAX_REQUEST_BODY + 1),
    # unknown opcode
    b"B2" + proto.encode_varint(2) + proto.encode_varint(1) + b"\xff",
    # record count says 1 but the body holds trailing junk after it
    b"B2" + proto.encode_varint(4) + proto.encode_varint(1) +
    bytes([proto.OPCODES["PING"]]) + b"!!",
    # field length runs past the body end
    b"B2" + proto.encode_varint(4) + proto.encode_varint(1) +
    bytes([proto.OPCODES["COUNT"]]) + proto.encode_varint(200),
]


@_needs_native
def test_malformed_frames_identical_across_planes(pysrv, nsrv):
    for bad in _BAD_FRAMES:
        nat = _binary_exchange(nsrv.port, bad)
        py = _binary_exchange(pysrv.port, bad)
        assert nat == py, bad
        replies = _decode_all(nat)
        assert len(replies) == 1 and \
            replies[0].startswith("E\tbad frame: "), (bad, replies)
    # a good frame pipelined BEHIND a corrupt one is never answered: the
    # stream is poisoned and closed at the corruption point
    bad = _BAD_FRAMES[0] + proto.encode_request_frame(["PING"])
    assert _decode_all(_binary_exchange(nsrv.port, bad)) == \
        _decode_all(_binary_exchange(pysrv.port, bad))


@_needs_native
def test_truncated_frame_at_eof_closes_silently(pysrv, nsrv):
    # half a frame then EOF: like a half line at EOF in v1 it is dropped —
    # but silently (a reply frame for it could never be framed correctly)
    partial = b"B2" + proto.encode_varint(100) + b"only a few bytes"
    assert _binary_exchange(pysrv.port, partial) == b""
    assert _binary_exchange(nsrv.port, partial) == b""


# ---------------------------------------------------------------------------
# client proto modes: b2, auto-fallback, refusal
# ---------------------------------------------------------------------------

def _fake_v1_server():
    """A pre-B2 server: answers E\\tbad request to anything but PING."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def serve():
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            with conn, conn.makefile("rb") as f:
                for line in f:
                    if line.rstrip(b"\n") == b"PING":
                        conn.sendall(b"PONG\told\tALS_MODEL\n")
                    else:
                        conn.sendall(b"E\tbad request\n")

    threading.Thread(target=serve, daemon=True).start()
    return lsock


def test_client_auto_falls_back_on_old_server():
    lsock = _fake_v1_server()
    try:
        with QueryClient("127.0.0.1", lsock.getsockname()[1],
                         proto="auto") as c:
            assert c.ping() == "PONG\told\tALS_MODEL"
            assert not c._binary
    finally:
        lsock.close()


def test_client_forced_b2_raises_on_old_server():
    lsock = _fake_v1_server()
    try:
        c = QueryClient("127.0.0.1", lsock.getsockname()[1], proto="b2")
        with pytest.raises(RuntimeError, match="refused"):
            c.ping()
        c.close()
    finally:
        lsock.close()


def _client_b2_roundtrips(port):
    with QueryClient("127.0.0.1", port, proto="b2") as c:
        assert c.query_state(ALS_STATE, "7-U") == "1.0;2.0;0.5;-1.0"
        assert c.query_state(ALS_STATE, "missing") is None
        assert c.query_states(ALS_STATE, ["7-U", "nope"]) == \
            ["1.0;2.0;0.5;-1.0", None]
        assert c.topk(ALS_STATE, "7", 2) == [("12", 4.25), ("11", 1.25)]
        assert c.count(ALS_STATE) == 4
        assert c.ping() == "PONG\tjid\tALS_MODEL"
        assert c.health(ALS_STATE)["state"] == ALS_STATE
        assert c.metrics()["meta"]["plane"] in ("python", "native")
        assert c._binary
        # pipelining crosses frame boundaries (window < len(requests))
        reqs = [f"GET\t{ALS_STATE}\t7-U"] * 70
        assert c.pipeline(reqs, window=16) == ["V\t1.0;2.0;0.5;-1.0"] * 70


def test_client_b2_python(pysrv):
    _client_b2_roundtrips(pysrv.port)


@_needs_native
def test_client_b2_native(nsrv):
    _client_b2_roundtrips(nsrv.port)


# ---------------------------------------------------------------------------
# tracing on the wire: tab tid echo, the B2 tr=1 extension, and
# the native span spill — untraced traffic stays pinned byte-identical by
# the v1/parity tests above even with all of this code present
# ---------------------------------------------------------------------------

_RAW_TID = "00c0ffee00c0ffee/01ab23cd"  # composite tid/sid wire form


def _tab_tid_echo(port):
    """Stamped lines come back with the RAW tid echoed verbatim (composite
    form included); unstamped lines pipelined on the same connection come
    back without any suffix."""
    payload = (f"GET\tALS_MODEL\t7-U\ttid={_RAW_TID}\n"
               f"TOPKV\tALS_MODEL\t2\t1.0;2.0;0.5;-1.0\ttid={_RAW_TID}\n"
               f"GET\tALS_MODEL\tmissing\ttid=bare16hexdigits\n"
               "PING\n").encode("utf-8")
    want = (f"V\t1.0;2.0;0.5;-1.0\ttid={_RAW_TID}\n"
            f"V\t12:4.25;11:1.25\ttid={_RAW_TID}\n"
            f"N\ttid=bare16hexdigits\n"
            "PONG\tjid\tALS_MODEL\n").encode("utf-8")
    assert _raw(port, payload) == want


def test_tab_tid_echo_python(pysrv):
    _tab_tid_echo(pysrv.port)


@_needs_native
def test_tab_tid_echo_native(nsrv):
    _tab_tid_echo(nsrv.port)


@_needs_native
def test_hello_with_tid_stays_tab_identically(pysrv, nsrv):
    # a traced HELLO is a tab request like any other: echoed, never a
    # protocol flip (the flip requires a clean negotiation line)
    payload = b"HELLO\tB2\ttid=abc\nPING\n"
    assert _raw(pysrv.port, payload) == _raw(nsrv.port, payload)
    assert b"PONG" in _raw(pysrv.port, payload)  # connection stayed tab


def _b2_trace_roundtrip(port):
    """HELLO tr=1: every request record carries one extra trace field
    (empty when untraced); replies are never tid-suffixed — the span
    linkage travels through the server's spill, not the reply bytes."""
    lines = ["GET\tALS_MODEL\t7-U", "PING",
             "TOPKV\tALS_MODEL\t2\t1.0;2.0;0.5;-1.0"]
    frame = proto.encode_request_frame(lines, tids=[_RAW_TID, None, None])
    out = _raw(port, b"HELLO\tB2\ttr=1\n" + frame)
    assert out.startswith(HELLO)
    replies = _decode_all(out[len(HELLO):])
    assert replies == ["V\t1.0;2.0;0.5;-1.0", "PONG\tjid\tALS_MODEL",
                       "V\t12:4.25;11:1.25"]
    # same lines over a plain (no tr=1) B2 connection: byte-identical
    # reply stream, proving tr=1 changes only the request framing
    plain = _binary_exchange(port, proto.encode_request_frame(lines))
    assert _decode_all(plain) == replies


def test_b2_trace_extension_python(pysrv):
    _b2_trace_roundtrip(pysrv.port)


@_needs_native
def test_b2_trace_extension_native(nsrv):
    _b2_trace_roundtrip(nsrv.port)


@_needs_native
def test_native_spill_records_spans(nsrv, tmp_path):
    spill = str(tmp_path / "native_spans.jsonl")
    nsrv.set_trace(spill)
    payload = (f"GET\tALS_MODEL\t7-U\ttid={_RAW_TID}\n"
               f"TOPK\tALS_MODEL\t7\t2\ttid={_RAW_TID}\n"
               "PING\n").encode("utf-8")
    _raw(nsrv.port, payload)
    deadline = time.time() + 5
    spans = []
    while time.time() < deadline and len(spans) < 2:
        try:
            with open(spill) as f:
                events = [json.loads(line) for line in f if line.strip()]
        except (OSError, ValueError):
            events = []
        spans = [e for e in events if e.get("plane") == "native"]
        time.sleep(0.02)
    assert len(spans) == 2  # traced GET + TOPK; the untraced PING spilled
    tid, psid = _RAW_TID.split("/")
    for ev in spans:
        assert ev["tid"] == tid and ev["psid"] == psid
        assert ev["kind"] == "server_reply" and ev["ok"]
        assert ev["dur_s"] >= 0 and ev["sid"]
    topk = next(e for e in spans if e["verb"] == "TOPK")
    assert topk["queue_wait_s"] >= 0 and topk["serve_s"] >= 0


# ---------------------------------------------------------------------------
# fleet scrape: foreign native ladder is an error, not a silent skip
# ---------------------------------------------------------------------------

def _fake_metrics_server(snapshot):
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    payload = ("J\t" + json.dumps(snapshot) + "\n").encode("utf-8")

    def serve():
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            with conn:
                conn.recv(1024)
                conn.sendall(payload)

    threading.Thread(target=serve, daemon=True).start()
    return lsock


def _ladder_snapshot(le):
    return {"ts": 1.0, "enabled": True, "counters": [], "gauges": [],
            "histograms": [{"name": "tpums_server_latency_seconds",
                            "labels": {"verb": "GET"}, "le": le,
                            "counts": [0] * (len(le) + 1),
                            "count": 0, "sum": 0.0}],
            "meta": {"plane": "native"}}


def test_scrape_fleet_rejects_foreign_native_ladder():
    from flink_ms_tpu_torch.obs.scrape import scrape_fleet

    good = _fake_metrics_server(_ladder_snapshot(list(LATENCY_BUCKETS_S)))
    bad = _fake_metrics_server(_ladder_snapshot([0.001, 0.1, 10.0]))
    try:
        registry.register("native-good", "127.0.0.1",
                          good.getsockname()[1], ALS_STATE)
        assert scrape_fleet()["scraped"] == 1  # correct ladder: accepted
        registry.register("native-skewed", "127.0.0.1",
                          bad.getsockname()[1], ALS_STATE)
        with pytest.raises(ValueError, match="foreign bucket bounds"):
            scrape_fleet()
    finally:
        good.close()
        bad.close()


# ---------------------------------------------------------------------------
# HA + elastic smoke on the native plane (acceptance: kill + 2->4 rescale,
# zero failed queries, native fleets on both sides of the cutover)
# ---------------------------------------------------------------------------

@_needs_native
def test_native_fleet_kill_and_rescale_zero_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUMS_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("TPUMS_REPLICA_TTL_S", "30")
    journal = Journal(str(tmp_path / "bus"), "models")
    rng = np.random.default_rng(7)
    n = 24
    journal.append([F.format_als_row(u, "U", rng.normal(size=3))
                    for u in range(n)])
    keys = [f"{u}-U" for u in range(n)]
    ctl = ScaleController(
        "nat", str(tmp_path / "bus"), "models",
        port_dir=str(tmp_path / "ports"),
        state_backend="rocksdb",
        checkpoint_uri=str(tmp_path / "ckpt"),
        replication=2,
        extra_args=["--nativeServer", "true"],
        ready_timeout_s=120,
        device="cpu",
    )
    try:
        rec = ctl.scale_to(2)
        assert rec["gen"] == 1 and rec["shards"] == 2

        # the fleet really is on the C++ plane (a worker that silently fell
        # back to the Python server would still answer queries)
        entry = registry.list_jobs()[0]
        with QueryClient(entry["host"], entry["port"], timeout_s=10) as c:
            assert c.metrics()["meta"]["plane"] == "native"
        # and the fleet scraper aggregates it without a ladder complaint
        from flink_ms_tpu_torch.obs.scrape import scrape_fleet
        fleet = scrape_fleet()
        assert fleet["scraped"] >= 1

        errors = []
        served = [0]
        stop = threading.Event()

        def stream():
            c = ElasticClient(
                "nat", retry=RetryPolicy(attempts=6, backoff_s=0.02,
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

        probe = ElasticClient("nat", timeout_s=10)
        before = probe.query_states(ALS_STATE, keys)
        assert all(v is not None for v in before)

        t = threading.Thread(target=stream, daemon=True)
        t.start()
        deadline = time.time() + 10
        while served[0] < 30 and time.time() < deadline:
            time.sleep(0.02)

        # kill one replica mid-stream: R=2 failover keeps it invisible
        victim = ctl.supervisors[1].procs[(0, 0)]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)
        mark = served[0]
        deadline = time.time() + 10
        while served[0] < mark + 50 and time.time() < deadline:
            time.sleep(0.02)

        # rescale 2 -> 4 under the same stream: a fresh native generation
        # warms from its own checkpoint slice, then the topology cuts over
        rec = ctl.scale_to(4)
        assert rec["gen"] == 2 and rec["shards"] == 4
        mark = served[0]
        deadline = time.time() + 10
        while served[0] < mark + 50 and time.time() < deadline:
            time.sleep(0.02)
        stop.set()
        t.join(timeout=30)
        assert errors == [], f"client-visible errors: {errors[:5]}"

        # served-key parity across kill + cutover, on the new generation
        assert probe.query_states(ALS_STATE, keys) == before
        assert probe.generation == 2
        probe.close()
        assert 1 not in ctl.supervisors and 2 in ctl.supervisors

        # the NEW generation is native-plane too
        gen2 = [e for e in registry.list_jobs()
                if registry.generation_of(e, "nat") == 2]
        assert len(gen2) == 8  # 4 shards x R=2
        with QueryClient(gen2[0]["host"], gen2[0]["port"],
                         timeout_s=10) as c:
            assert c.metrics()["meta"]["plane"] == "native"
    finally:
        ctl.stop(drop_topology=True)
