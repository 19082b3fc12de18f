"""The port's C++ epoll lookup server
(``flink_ms_tpu_torch/native/lookup_server.cpp``): each case of
``tests/test_native_server.py`` on the port (protocol parity with the
port's Python ``LookupServer``, concurrency, native TOPK/TOPKV/DOT, the
``--nativeServer`` serving job end to end), and the port's native server
against the reference's: the same store rows give byte-equal replies for
GET, MGET, COUNT, TOPK, TOPKV and DOT, on the tab protocol and in B2
frames."""

import socket
import threading
import time

import pytest

from flink_ms_tpu_torch.serve.client import QueryClient
from flink_ms_tpu_torch.serve.consumer import (
    ALS_STATE,
    ServingJob,
    make_backend,
    parse_als_record,
)
from flink_ms_tpu_torch.serve.journal import Journal
from flink_ms_tpu_torch.serve.native_store import NativeLookupServer, NativeStore
from flink_ms_tpu_torch.serve.server import LookupServer
from flink_ms_tpu_torch.serve.table import ModelTable


@pytest.fixture
def store(tmp_path):
    s = NativeStore(str(tmp_path / "store"))
    s.put("1-U", "0.5;1.5")
    s.put("2-I", "2.0;-1.0")
    yield s
    s.close()


@pytest.fixture
def server(store):
    with NativeLookupServer(store, ALS_STATE, job_id="jid", port=0) as srv:
        yield srv


def _raw(port: int, payload: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sock:
        sock.sendall(payload)
        sock.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                return out
            out += chunk


def test_get_ping_and_misses(server):
    with QueryClient("127.0.0.1", server.port) as c:
        assert c.query_state(ALS_STATE, "1-U") == "0.5;1.5"
        assert c.query_state(ALS_STATE, "2-I") == "2.0;-1.0"
        assert c.query_state(ALS_STATE, "999-U") is None
        assert c.count(ALS_STATE) == 2  # the fixture's two rows
        assert "jid" in c.ping()
        with pytest.raises(Exception):
            c.query_state("NO_SUCH_STATE", "1-U")
    assert server.requests >= 5


def test_protocol_matches_python_server(store):
    """Byte-for-byte response parity on every verb (the Python server is the
    semantics contract)."""
    table = ModelTable(2)
    for k, v in store.items():
        table.put(k, v)
    pysrv = LookupServer({ALS_STATE: table}, host="127.0.0.1", port=0,
                         job_id="jid").start()
    requests = (
        b"GET\tALS_MODEL\t1-U\n"
        b"GET\tALS_MODEL\tmissing\n"
        b"GET\tOTHER\tx\n"
        b"TOPK\tALS_MODEL\t1\t5\n"
        b"PING\n"
        b"PING\textra\tfields\n"
        b"NONSENSE\n"
        b"GET\ttoo\tmany\ttabs\n"
        b"GET\teven\tmore\ttabs\there\n"
        b"TOPK\ta\tb\tc\td\n"
        b"TOPK\tALS_MODEL\t1\n"
        b"MGET\tALS_MODEL\t1-U,missing,2-I\n"
        b"MGET\tALS_MODEL\t1-U\n"
        b"MGET\tALS_MODEL\t\n"
        b"MGET\tOTHER\t1-U\n"
        b"MGET\tALS_MODEL\ta\tb\n"
        b"COUNT\tALS_MODEL\n"
        b"COUNT\tOTHER\n"
        b"COUNT\tALS_MODEL\textra\n"
        b"\n"
    )
    try:
        with NativeLookupServer(store, ALS_STATE, job_id="jid",
                                port=0) as nsrv:
            assert _raw(nsrv.port, requests) == _raw(pysrv.port, requests)
    finally:
        pysrv.stop()


def test_pipelined_and_split_requests(server):
    # two requests in one segment, then one request dribbled byte-by-byte
    out = _raw(server.port, b"GET\tALS_MODEL\t1-U\nPING\n")
    assert out == b"V\t0.5;1.5\nPONG\tjid\tALS_MODEL\n"
    with socket.create_connection(("127.0.0.1", server.port), timeout=5) as s:
        for b in b"GET\tALS_MODEL\t2-I\n":
            s.sendall(bytes([b]))
        f = s.makefile("rb")
        assert f.readline() == b"V\t2.0;-1.0\n"


def test_final_line_without_newline_is_answered(server):
    # readline()-at-EOF parity: the Python server answers a trailing
    # partial line on half-close, so the native server must too
    assert _raw(server.port, b"PING") == b"PONG\tjid\tALS_MODEL\n"
    assert _raw(server.port, b"PING\nGET\tALS_MODEL\t1-U") == (
        b"PONG\tjid\tALS_MODEL\nV\t0.5;1.5\n"
    )


def test_large_pipelined_burst_is_answered(server):
    # >1 MB of small valid requests in one burst: the request-line cap must
    # bound a single line, not the whole unparsed buffer
    n = 80_000
    burst = b"GET\tALS_MODEL\t1-U\n" * n
    assert len(burst) > (1 << 20)
    out = _raw(server.port, burst)
    assert out == b"V\t0.5;1.5\n" * n


def test_slow_reader_is_disconnected(server):
    # a client that pipelines forever without reading responses must be
    # dropped once the buffered-response cap is hit, not OOM the server
    line = b"GET\tALS_MODEL\t1-U\n"
    with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
        try:
            # 32 MB of requests -> ~18 MB of buffered responses > 16 MB cap
            for _ in range(2048):
                s.sendall(line * 1024)
        except (ConnectionResetError, BrokenPipeError):
            return  # server dropped us: expected
        # server may also close gracefully after we stop sending
        s.shutdown(socket.SHUT_WR)
        total = 0
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            total += len(chunk)
        assert total < (32 << 20)


def test_oversized_single_line_closes_connection(server):
    # the server drops the connection mid-send; depending on timing the
    # client sees a clean EOF with no payload, a reset, or a failed
    # shutdown on the already-closed socket (ENOTCONN)
    try:
        out = _raw(server.port, b"GET\tALS_MODEL\t" + b"x" * (2 << 20) + b"\n")
    except OSError:
        return
    assert out == b""


def test_concurrent_clients(server):
    errors = []

    def worker():
        try:
            with QueryClient("127.0.0.1", server.port) as c:
                for _ in range(50):
                    assert c.query_state(ALS_STATE, "1-U") == "0.5;1.5"
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    assert server.requests >= 400


def test_serving_job_native_server_end_to_end(tmp_path):
    journal = Journal(str(tmp_path / "journal"), "als-topic")
    journal.append(["1,U,0.5;1.5", "7,I,3.0;4.0"])
    backend = make_backend("rocksdb", str(tmp_path / "chk"))
    job = ServingJob(
        journal, ALS_STATE, parse_als_record, backend,
        port=0, poll_interval_s=0.05, checkpoint_interval_ms=100,
        native_server=True,
    ).start()
    try:
        with QueryClient("127.0.0.1", job.port) as c:
            deadline = 50
            while c.query_state(ALS_STATE, "7-I") is None and deadline:
                threading.Event().wait(0.1)
                deadline -= 1
            assert c.query_state(ALS_STATE, "1-U") == "0.5;1.5"
            assert c.query_state(ALS_STATE, "7-I") == "3.0;4.0"
            # the native ALS plane serves the full verb set: TOPK scores
            # the "-I" catalog straight from the store
            got = c.topk(ALS_STATE, "1", 3)
            assert got == [("7", pytest.approx(0.5 * 3.0 + 1.5 * 4.0))]
    finally:
        job.stop()


def test_native_server_requires_native_backend(tmp_path):
    journal = Journal(str(tmp_path / "journal"), "t")
    with pytest.raises(ValueError, match="nativeServer"):
        ServingJob(journal, ALS_STATE, parse_als_record,
                   make_backend("memory", None), port=0, native_server=True)


def test_mget_batches_native(server):
    """MGET on the C++ server: order-preserving, one round trip."""
    with QueryClient("127.0.0.1", server.port) as c:
        before = server.requests
        vals = c.query_states(ALS_STATE, ["2-I", "nope", "1-U"])
        assert vals == ["2.0;-1.0", None, "0.5;1.5"]
        assert server.requests == before + 1
        assert c.query_states(ALS_STATE, []) == []


# -- native TOPK/TOPKV (the C++ plane serves the full verb set; serve/topk.py
# -- and server.py are the semantics contract)

def _als_store(tmp_path, rows):
    s = NativeStore(str(tmp_path / "topk_store"))
    for k, v in rows:
        s.put(k, v)
    return s


def _als_pyserver(rows):
    from flink_ms_tpu_torch.serve.topk import make_als_topk_handler

    table = ModelTable(2)
    for k, v in rows:
        table.put(k, v)
    return LookupServer(
        {ALS_STATE: table}, host="127.0.0.1", port=0, job_id="jid",
        topk_handlers={ALS_STATE: make_als_topk_handler(table,
                                                        device="cpu")},
    ).start()


# factor values on a 0.25 grid: every product and 4-term sum is exactly
# representable in f32, so the torch-scored Python plane and the C++ plane
# compute bit-identical scores and byte-identical formatted payloads
_EXACT_ROWS = [
    ("10-I", "1.0;0.5;-2.0;0.25"),
    ("11-I", "0.5;0.5;0.5;0.5"),
    ("12-I", "-1.0;2.0;1.5;-0.5"),
    ("13-I", "2.0;-0.25;0.75;1.0"),
    ("7-U", "1.0;2.0;0.5;-1.0"),
    ("MEAN-I", "9.0;9.0;9.0;9.0"),      # cold-start row: excluded
    ("bad-I", "1.0;2.0"),               # off the modal width: dropped
]


def test_native_topkv_byte_parity(tmp_path):
    # formatting edges ride along: a 4e5-scale score (Python repr stays
    # fixed-notation where bare to_chars would flip to "4e+05") and a
    # ~1e-5 score (scientific on both sides)
    rows = _EXACT_ROWS + [
        ("20-I", "400000.0;0.0;0.0;0.0"),
        ("21-I", "0.00001;0.0;0.0;0.0"),
    ]
    pysrv = _als_pyserver(rows)
    store = _als_store(tmp_path, rows)
    requests = (
        b"TOPKV\tALS_MODEL\t3\t1.0;2.0;0.5;-1.0\n"
        b"TOPKV\tALS_MODEL\t99\t1.0;2.0;0.5;-1.0\n"   # k > catalog
        b"TOPK\tALS_MODEL\t7\t2\n"                     # resolves 7-U
        b"TOPK\tALS_MODEL\tmissing\t2\n"               # unknown user -> N
        b"TOPKV\tALS_MODEL\t0\t1.0\n"                  # k < 1
        b"TOPKV\tALS_MODEL\tx\t1.0\n"                  # non-integer k
        b"TOPKV\tALS_MODEL\t2\t1.0;2.0\n"              # width mismatch
        b"TOPKV\tALS_MODEL\t2\t1.0;oops;3.0;4.0\n"     # non-numeric token
        b"TOPKV\tOTHER\t2\t1.0\n"                      # unknown state
    )
    try:
        with NativeLookupServer(store, ALS_STATE, job_id="jid", port=0,
                                topk_suffixes=("-I", "-U")) as nsrv:
            native = _raw(nsrv.port, requests)
            python = _raw(pysrv.port, requests)
            assert native == python, (native, python)
    finally:
        pysrv.stop()
        store.close()


def test_native_topkv_semantic_parity_random(tmp_path):
    """Random float factors: ranking identical, scores equal to f32
    round-off (the planes may differ in accumulation order)."""
    import numpy as np

    rng = np.random.default_rng(5)
    rows = [(f"{i}-I", ";".join(repr(float(x)) for x in rng.normal(size=6)))
            for i in range(40)]
    rows += [(f"{u}-U", ";".join(repr(float(x)) for x in rng.normal(size=6)))
             for u in range(3)]
    pysrv = _als_pyserver(rows)
    store = _als_store(tmp_path, rows)
    try:
        with NativeLookupServer(store, ALS_STATE, job_id="jid", port=0,
                                topk_suffixes=("-I", "-U")) as nsrv:
            with QueryClient("127.0.0.1", nsrv.port) as nc, \
                    QueryClient("127.0.0.1", pysrv.port) as pc:
                payload = ";".join(repr(float(x))
                                   for x in rng.normal(size=6))
                nat = nc.topk_by_vector(ALS_STATE, payload, 7)
                pyr = pc.topk_by_vector(ALS_STATE, payload, 7)
                assert [i for i, _ in nat] == [i for i, _ in pyr]
                for (_, a), (_, b) in zip(nat, pyr):
                    assert a == pytest.approx(b, rel=1e-5, abs=1e-5)
                nat_u = nc.topk(ALS_STATE, "1", 5)
                pyr_u = pc.topk(ALS_STATE, "1", 5)
                assert [i for i, _ in nat_u] == [i for i, _ in pyr_u]
    finally:
        pysrv.stop()
        store.close()


def test_native_topkv_index_refreshes_on_store_change(tmp_path):
    store = _als_store(tmp_path, _EXACT_ROWS)
    try:
        with NativeLookupServer(store, ALS_STATE, job_id="jid", port=0,
                                topk_suffixes=("-I", "-U")) as nsrv:
            with QueryClient("127.0.0.1", nsrv.port) as c:
                def poll_until(expect_ids, k):
                    deadline = time.time() + 20
                    while time.time() < deadline:
                        got = c.topk_by_vector(
                            ALS_STATE, "1.0;0.0;0.0;0.0", k)
                        if [i for i, _ in got] == expect_ids:
                            return got
                        time.sleep(0.02)
                    return got

                got = c.topk_by_vector(ALS_STATE, "1.0;0.0;0.0;0.0", 1)
                assert got[0][0] == "13"      # 2.0 leads dim 0
                # overwrite an existing row to the new best: the version
                # proxy (count unchanged, log_bytes grew) must invalidate.
                # Serve-stale semantics: the change lands via a BACKGROUND
                # rebuild, so poll rather than assert the first answer.
                store.put("11-I", "50.0;0.0;0.0;0.0")
                got = poll_until(["11"], 1)
                assert got[0] == ("11", 50.0)
                # and a brand-new item (count changes) lands too
                store.put("99-I", "100.0;0.0;0.0;0.0")
                got = poll_until(["99", "11"], 2)
                assert [i for i, _ in got] == ["99", "11"]
    finally:
        store.close()


def test_native_topkv_serve_stale_under_writes(tmp_path):
    """A streaming writer must not head-of-line-block the plane: once a
    snapshot exists, queries under continuous writes answer from the
    current (possibly stale) index while the rebuild runs in the
    background, and the new best eventually lands."""
    store = _als_store(tmp_path, _EXACT_ROWS)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            store.put(f"{100 + (i % 50)}-I", "0.125;0.125;0.125;0.125")
            i += 1

    try:
        with NativeLookupServer(store, ALS_STATE, job_id="jid", port=0,
                                topk_suffixes=("-I", "-U")) as nsrv:
            with QueryClient("127.0.0.1", nsrv.port, timeout_s=30) as c:
                c.topk_by_vector(ALS_STATE, "1.0;0.0;0.0;0.0", 1)  # build
                t = threading.Thread(target=writer)
                t.start()
                try:
                    # under the writer every query window sees a moved
                    # version; answers must keep coming (stale is fine)
                    for _ in range(50):
                        got = c.topk_by_vector(
                            ALS_STATE, "1.0;0.0;0.0;0.0", 1)
                        assert got, "no answer under streaming writes"
                    # a decisive new best lands once a rebuild completes
                    store.put("999-I", "1000.0;0.0;0.0;0.0")
                    deadline = time.time() + 20
                    while time.time() < deadline:
                        got = c.topk_by_vector(
                            ALS_STATE, "1.0;0.0;0.0;0.0", 1)
                        if got and got[0][0] == "999":
                            break
                        time.sleep(0.05)
                    assert got[0][0] == "999"
                finally:
                    stop.set()
                    t.join()
    finally:
        store.close()


def test_native_topkv_empty_catalog(tmp_path):
    store = NativeStore(str(tmp_path / "empty_store"))
    try:
        with NativeLookupServer(store, ALS_STATE, job_id="jid", port=0,
                                topk_suffixes=("-I", "-U")) as nsrv:
            out = _raw(nsrv.port, b"TOPKV\tALS_MODEL\t3\t1.0;2.0\n")
            assert out == b"V\t\n"
    finally:
        store.close()


def test_native_topkv_pipelined_reply_order(tmp_path):
    """A GET pipelined behind a TOPKV on one connection must come back
    AFTER the TOPKV reply even though the top-k runs on the worker thread
    (per-connection FIFO via deferred reply slots)."""
    store = _als_store(tmp_path, _EXACT_ROWS)
    try:
        with NativeLookupServer(store, ALS_STATE, job_id="jid", port=0,
                                topk_suffixes=("-I", "-U")) as nsrv:
            out = _raw(nsrv.port,
                       b"TOPKV\tALS_MODEL\t1\t1.0;0.0;0.0;0.0\n"
                       b"GET\tALS_MODEL\t7-U\n"
                       b"TOPK\tALS_MODEL\t7\t1\n"
                       b"PING\n")
            lines = out.split(b"\n")
            assert lines[0].startswith(b"V\t13:")   # TOPKV first
            assert lines[1] == b"V\t1.0;2.0;0.5;-1.0"
            assert lines[2].startswith(b"V\t")      # TOPK third
            assert lines[3].startswith(b"PONG")
    finally:
        store.close()


def test_native_topkv_nan_scores_deterministic(tmp_path):
    """NaN tokens parse (like Python float('nan')) and rank above +inf in
    lax.top_k's total order, with deterministic id-sorted tie-breaking —
    no undefined comparator behavior."""
    rows = [("1-I", "1.0;2.0"), ("2-I", "3.0;1.0"), ("3-I", "0.5;0.5")]
    store = _als_store(tmp_path, rows)
    try:
        with NativeLookupServer(store, ALS_STATE, job_id="jid", port=0,
                                topk_suffixes=("-I", "-U")) as nsrv:
            out = _raw(nsrv.port, b"TOPKV\tALS_MODEL\t3\tnan;0.0\n")
            # every score is NaN -> all tie -> id-sorted catalog order
            assert out == b"V\t1:nan;2:nan;3:nan\n"
            out = _raw(nsrv.port, b"TOPKV\tALS_MODEL\t2\tinf;0.0\n")
            # finite*inf = inf for rows 1,2; 0.5*inf = inf too -> ties in
            # id order
            assert out == b"V\t1:inf;2:inf\n"
    finally:
        store.close()


def test_native_dot_byte_parity(tmp_path):
    """DOT verb across planes: the native server answers the
    server-side sparse dot byte-identically to the Python contract plane
    on exact-grid fixtures — valid dots, in-row duplicate fids resolving
    last-wins, missing-bucket reporting, empty query, bad range, unknown
    state, and wrong arity."""
    from flink_ms_tpu_torch.serve.consumer import SVM_STATE

    rows = [
        ("0", "1:1.0;2:0.5;3:-2.0"),
        ("1", "5:0.25;7:2.0"),
        ("2", "9:1.0;9:2.5"),       # duplicate fid: last wins (2.5)
        ("3", "13:4.0;"),           # trailing ';' must parse
    ]
    table = ModelTable(2)
    for k, v in rows:
        table.put(k, v)
    pysrv = LookupServer({SVM_STATE: table}, host="127.0.0.1", port=0,
                         job_id="jid").start()
    store = _als_store(tmp_path, rows)
    requests = (
        b"DOT\tSVM_MODEL\t4\t1:2.0;2:-4.0;7:0.5\n"   # all-hit dot
        b"DOT\tSVM_MODEL\t4\t9:1.0\n"                # dup fid -> 2.5
        b"DOT\tSVM_MODEL\t4\t1:2.0;17:1.0;100:3.0\n" # missing buckets 4,25
        b"DOT\tSVM_MODEL\t4\t13:0.25;15:1.0\n"       # fid miss, bucket hit
        b"DOT\tSVM_MODEL\t4\t\n"                     # empty query
        b"DOT\tSVM_MODEL\t0\t1:1.0\n"                # range < 1
        b"DOT\tSVM_MODEL\tx\t1:1.0\n"                # non-integer range
        b"DOT\tOTHER\t4\t1:1.0\n"                    # unknown state
        b"DOT\tSVM_MODEL\t4\n"                       # arity -> bad request
        b"DOT\tSVM_MODEL\t 4 \t 1 : 2.0 \n"          # whitespace padding
        b"DOT\tSVM_MODEL\t4\t5:0.25;;;\n"            # trailing ';' run ok
        b"DOT\tSVM_MODEL\t4\t1:1.0;;2:0.5\n"         # empty interior seg
        b"DOT\tSVM_MODEL\t4\t1:2.0:3.0\n"            # two colons in a pair
    )
    try:
        with NativeLookupServer(store, SVM_STATE, job_id="jid",
                                port=0) as nsrv:
            native = _raw(nsrv.port, requests)
            python = _raw(pysrv.port, requests)
            assert native == python, (native, python)
            # pin the actual semantics, not just agreement
            lines = python.decode().splitlines()
            assert lines[0] == "D\t1.0\t"       # 2-2+1
            assert lines[1] == "D\t2.5\t"
            assert lines[2] == "D\t2.0\t4,25"
            assert lines[3] == "D\t1.0\t"
            assert lines[4] == "D\t0.0\t"
            assert lines[5] == "E\trange must be >= 1"
            assert lines[8] == "E\tbad request"
            assert lines[9] == "D\t2.0\t"
            assert lines[10] == "D\t0.0625\t"
            assert lines[11].startswith("E\tdot failed: malformed pair")
            assert lines[12].startswith("E\tdot failed: malformed pair")
            # numeric-literal failures: both planes reject (E), but the
            # message text is plane-specific (numpy vs strtod) — compare
            # acceptance only
            for bad in (b"DOT\tSVM_MODEL\t4\t1:abc\n",
                        b"DOT\tSVM_MODEL\t4\tzz:1.0\n"):
                assert _raw(nsrv.port, bad).startswith(b"E\tdot failed")
                assert _raw(pysrv.port, bad).startswith(b"E\tdot failed")
    finally:
        pysrv.stop()
        store.close()


# -- the port's native server against the reference's --------------------

def _two_stores(tmp_path, rows, tag):
    from flink_ms_tpu.serve import native_store as RN

    out = []
    for name, mod in (("port", None), ("ref", RN)):
        s = (NativeStore if mod is None else mod.NativeStore)(
            str(tmp_path / f"{tag}-{name}"))
        for k, v in rows:
            s.put(k, v)
        out.append(s)
    return out


@pytest.mark.parametrize("proto", ["tab", "b2"])
def test_native_servers_of_both_packages_answer_the_same_bytes(tmp_path,
                                                               proto):
    """Random rows (numpy, seeded) in a store of each package, each served
    by its own package's C++ server: every ALS and SVM verb gets the same
    reply bytes, through a tab connection or B2 frames."""
    import numpy as np

    from flink_ms_tpu.serve import native_store as RN
    from flink_ms_tpu_torch.serve.consumer import SVM_STATE

    rng = np.random.default_rng(11)

    def pay(n):
        return ";".join(repr(float(x)) for x in rng.normal(size=n))

    als = [(f"{i}-I", pay(5)) for i in range(80)]
    als += [(f"{u}-U", pay(5)) for u in range(12)] + [("MEAN-I", pay(5))]
    svm = [(str(b), ";".join(f"{b * 8 + j + 1}:{rng.normal():.6f}"
                             for j in range(0, 8, 2))) for b in range(10)]
    als_reqs = ([f"GET\t{ALS_STATE}\t{k}" for k, _ in als[::9]]
                + [f"MGET\t{ALS_STATE}\t" + ",".join(
                    [k for k, _ in als[:20]] + ["nope"]),
                   f"COUNT\t{ALS_STATE}", "PING"]
                + [f"TOPK\t{ALS_STATE}\t{u}\t7" for u in range(12)]
                + [f"TOPKV\t{ALS_STATE}\t5\t{pay(5)}" for _ in range(4)]
                + [f"TOPK\t{ALS_STATE}\tnobody\t3",
                   f"TOPKV\t{ALS_STATE}\t2\t1.0;2.0"])
    svm_reqs = [f"DOT\t{SVM_STATE}\t8\t" + ";".join(
        f"{int(f)}:{rng.normal():.4f}" for f in rng.integers(1, 100, 6))
        for _ in range(6)] + [f"GET\t{SVM_STATE}\t3", f"COUNT\t{SVM_STATE}"]
    replies = {}
    stores = _two_stores(tmp_path, als, "als") + \
        _two_stores(tmp_path, svm, "svm")
    try:
        for i, (name, Srv) in enumerate((("port", NativeLookupServer),
                                         ("ref", RN.NativeLookupServer))):
            got = []
            for store, state, reqs in ((stores[i], ALS_STATE, als_reqs),
                                       (stores[2 + i], SVM_STATE, svm_reqs)):
                kw = {"topk_suffixes": ("-I", "-U")} \
                    if state == ALS_STATE else {}
                with Srv(store, state, job_id="jid", port=0, **kw) as srv:
                    with QueryClient("127.0.0.1", srv.port,
                                     proto=proto) as c:
                        got.append([c._roundtrip(r) for r in reqs])
            replies[name] = got
    finally:
        for s in stores:
            s.close()
    assert replies["port"] == replies["ref"]
    als_got, svm_got = replies["port"]
    assert sum(r.startswith("V\t") for r in als_got) >= 25
    assert all(r.startswith("D\t") for r in svm_got[:6])
