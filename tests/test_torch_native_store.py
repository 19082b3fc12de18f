"""The port's C++ persistent store (``flink_ms_tpu_torch/native/store.cpp``
through ``serve/native_store.py``): each case of
``tests/test_native_store.py`` on the port (durability, torn-tail recovery,
compaction, the writer lock, the native bulk ingest, the rocksdb serving
path end to end), and the packages cross: a store directory written by
either package's library opens in the other's with the same rows and the
same log bytes, and the port's handles are served by the port's own
library, built under ``build/native/``."""

import ctypes
import os
import struct
import time

import numpy as np
import pytest

from flink_ms_tpu_torch.core import formats as F
from flink_ms_tpu_torch.serve.client import QueryClient
from flink_ms_tpu_torch.serve.consumer import (
    ALS_STATE,
    ServingJob,
    make_backend,
    parse_als_record,
)
from flink_ms_tpu_torch.serve.journal import Journal
from flink_ms_tpu_torch.serve.native_store import (
    NativeStateBackend,
    NativeStore,
    StoreLockedError,
)


def _wait_until(pred, timeout=10.0, interval=0.02):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(interval)
    return False


def test_put_get_overwrite_delete(tmp_path):
    with NativeStore(str(tmp_path / "db")) as s:
        s.put("a", "1")
        s.put("b", "2")
        s.put("a", "updated")
        assert s.get("a") == "updated"
        assert s.get("b") == "2"
        assert s.get("missing") is None
        assert len(s) == 2
        s.delete("b")
        assert s.get("b") is None
        assert len(s) == 1


def test_unicode_and_large_values(tmp_path):
    with NativeStore(str(tmp_path / "db")) as s:
        s.put("ключ-Ü", "значение-ß")
        big = "x" * 1_000_000
        s.put("big", big)
        assert s.get("ключ-Ü") == "значение-ß"
        assert s.get("big") == big


def test_durability_across_reopen(tmp_path):
    d = str(tmp_path / "db")
    s = NativeStore(d)
    for i in range(500):
        s.put(f"k{i}", f"v{i}")
    s.flush()
    s.close()
    with NativeStore(d) as s2:
        assert len(s2) == 500
        assert s2.get("k499") == "v499"


def test_torn_tail_recovery(tmp_path):
    d = str(tmp_path / "db")
    s = NativeStore(d)
    s.put("good", "value")
    s.flush()
    s.close()
    # simulate crash mid-append: garbage partial record at the tail
    with open(os.path.join(d, "data.log"), "ab") as f:
        f.write(struct.pack("<II", 4, 100))  # header promises 100-byte value
        f.write(b"keyX")
        f.write(b"only-ten")  # but only 8 bytes arrive
    with NativeStore(d) as s2:
        assert s2.get("good") == "value"
        assert s2.get("keyX") is None
        assert len(s2) == 1
        # the torn record was truncated; new appends land cleanly
        s2.put("after", "crash")
        assert s2.get("after") == "crash"
    with NativeStore(d) as s3:
        assert s3.get("after") == "crash"


def test_compaction_reclaims_space(tmp_path):
    d = str(tmp_path / "db")
    with NativeStore(d) as s:
        for _ in range(50):
            s.put("hot", "y" * 1000)  # 50 versions of one key
        before = s.log_bytes
        assert s.live_bytes < before
        s.compact()
        assert s.log_bytes < before
        assert s.get("hot") == "y" * 1000
        s.put("post", "compact")
        assert s.get("post") == "compact"
    with NativeStore(d) as s2:
        assert s2.get("hot") == "y" * 1000
        assert s2.get("post") == "compact"


def test_items_iteration(tmp_path):
    with NativeStore(str(tmp_path / "db")) as s:
        s.put("a", "1")
        s.put("b", "2")
        assert dict(s.items()) == {"a": "1", "b": "2"}


def test_make_backend_rocksdb_returns_native(tmp_path):
    b = make_backend("rocksdb", str(tmp_path / "chk"))
    assert isinstance(b, NativeStateBackend)
    t = b.make_table()
    t.put("1-U", "0.5;0.5")
    assert t.get("1-U") == "0.5;0.5"
    assert len(t) == 1
    b.snapshot(t, offset=777)
    assert b.restore(t) == 777
    # offset marker hidden from iteration/len
    assert dict(t.items()) == {"1-U": "0.5;0.5"}


def test_rocksdb_serving_survives_process_state_loss(tmp_path):
    """End-to-end rocksdb-parity: rows ingested through the journal live in
    the C++ store; a fresh ServingJob over the same store dir serves them
    from disk without journal replay."""
    jdir = str(tmp_path / "j")
    chk = str(tmp_path / "store")
    journal = Journal(jdir, "t")
    job = ServingJob(
        journal, ALS_STATE, parse_als_record, make_backend("rocksdb", chk),
        poll_interval_s=0.01, checkpoint_interval_ms=50,
        host="127.0.0.1", port=0, device="cpu",
    )
    job.start()
    try:
        journal.append([F.format_als_row(i, "U", [float(i)]) for i in range(30)])
        assert _wait_until(lambda: len(job.table) == 30)
        # wait for a checkpoint (offset marker) to land
        assert _wait_until(
            lambda: job.backend.restore(job.table) is not None, timeout=5
        )
        offset_at_chk = job.backend.restore(job.table)
    finally:
        job.stop()

    # "new process": fresh backend over the same store dir
    backend2 = make_backend("rocksdb", chk)
    job2 = ServingJob(
        Journal(jdir, "t"), ALS_STATE, parse_als_record, backend2,
        poll_interval_s=0.01, host="127.0.0.1", port=0, device="cpu",
    )
    job2.start()
    try:
        assert len(job2.table) == 30  # served straight from the C++ store
        assert job2.offset == offset_at_chk
        with QueryClient("127.0.0.1", job2.port) as c:
            assert c.query_state(ALS_STATE, "29-U") == "29.0"
            # topk over the native table (items() path)
            journal2 = Journal(jdir, "t")
            journal2.append([F.format_als_row(5, "I", [2.0])])
            assert _wait_until(lambda: job2.table.get("5-I") == "2.0")
            res = c.topk(ALS_STATE, "3", 1)
            assert res and res[0][0] == "5"
    finally:
        job2.stop()


def test_second_writer_rejected(tmp_path):
    d = str(tmp_path / "db")
    s1 = NativeStore(d)
    s1.put("k", "v")
    with pytest.raises(OSError):
        NativeStore(d)  # writer lock held
    s1.close()
    with NativeStore(d) as s2:  # released after close
        assert s2.get("k") == "v"


def test_second_writer_raises_locked_error(tmp_path):
    d = str(tmp_path / "db")
    s1 = NativeStore(d)
    with pytest.raises(StoreLockedError):
        NativeStore(d)
    # rocksdb backend on a locked dir must raise, not silently degrade to fs
    with pytest.raises(StoreLockedError):
        make_backend("rocksdb", d)
    s1.close()


def test_writer_lock_survives_compaction(tmp_path):
    d = str(tmp_path / "db")
    s1 = NativeStore(d)
    for _ in range(10):
        s1.put("k", "v" * 100)
    s1.compact()
    with pytest.raises(StoreLockedError):
        NativeStore(d)  # lock must follow the new inode
    s1.put("post", "ok")
    s1.close()
    with NativeStore(d) as s2:
        assert s2.get("post") == "ok"


def test_oversized_record_rejected_at_write(tmp_path):
    with NativeStore(str(tmp_path / "db")) as s:
        s.put("fits", "x")
        with pytest.raises(OSError):
            s.put("k" * ((1 << 20) + 1), "v")  # key > 1MiB
        assert s.get("fits") == "x"


def test_native_ingest_buf_matches_python_parsers(tmp_path):
    """tpums_ingest_buf must mirror parse_als_record/parse_svm_record
    byte-for-byte, including malformed-row counting and the SVM
    no-comma rule."""
    from flink_ms_tpu_torch.serve.consumer import parse_als_record, parse_svm_record
    from flink_ms_tpu_torch.serve.native_store import NativeStore
    from flink_ms_tpu_torch.serve.table import ModelTable

    als_lines = [
        "1,U,0.5;0.25;",
        "2,I,1.0",
        "MEAN,U,0.1;0.2",
        "badrow",           # no comma: parse error
        "alsoBad",          # no comma
        "3,U",              # ONE comma: parse error (split(',', 2) raises? no)
        "1,U,9.9",          # overwrite
        "",                 # blank: skipped, not an error
    ]
    # Python-path oracle
    oracle = ModelTable(4)
    py_errs = 0
    for line in als_lines:
        if not line:
            continue
        try:
            oracle.put(*parse_als_record(line))
        except ValueError:
            py_errs += 1
    store = NativeStore(str(tmp_path / "als"))
    data = "".join(l + "\n" for l in als_lines).encode()
    rows, errs = store.ingest_buf(data, 0)
    assert errs == py_errs == 3
    assert rows == 4  # valid rows, overwrites counted per row
    for key, val in oracle.items():
        assert store.get(key) == val, key
    assert len(store) == len(oracle)
    store.close()

    svm_lines = ["7,0.5", "12,", "nocomma", "7,0.75"]
    oracle2 = ModelTable(4)
    for line in svm_lines:
        oracle2.put(*parse_svm_record(line))
    store2 = NativeStore(str(tmp_path / "svm"))
    rows2, errs2 = store2.ingest_buf(
        "".join(l + "\n" for l in svm_lines).encode(), 1)
    assert (rows2, errs2) == (4, 0)
    for key, val in oracle2.items():
        assert store2.get(key) == val, key
    store2.close()


def test_serving_job_uses_native_bulk_ingest(tmp_path):
    """With the rocksdb backend and no listeners, the consume loop takes
    the one-FFI-call-per-chunk path (parse errors still surface); a
    registered listener forces the per-row Python path."""
    bus = str(tmp_path / "bus")
    j = Journal(bus, "m")
    j.append(["1,U,0.5;1.5", "junk-no-comma", "2,I,2.5"], flush=True)
    backend = make_backend("rocksdb", str(tmp_path / "store"))
    # native_server=True: the Python topk handler (which registers a
    # change listener and would force the per-row path) is not created
    job = ServingJob(
        Journal(bus, "m"), ALS_STATE, parse_als_record, backend,
        host="127.0.0.1", port=0, poll_interval_s=0.01,
        native_server=True,
    )
    calls = []
    real_ingest = job.table.ingest_lines
    job.table.ingest_lines = lambda data, mode: (
        calls.append(mode) or real_ingest(data, mode)
    )
    job.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and len(job.table) < 2:
            time.sleep(0.02)
        assert job.table.get("1-U") == "0.5;1.5"
        assert job.table.get("2-I") == "2.5"
        assert job.parse_errors == 1
        assert job.table.puts == 2
        assert calls and all(m == 0 for m in calls), "fast path did not run"
    finally:
        job.stop()


def test_native_bulk_ingest_over_rotating_journal(tmp_path):
    """The C++ bulk-ingest path reads through segment rolls: rows written
    across several sealed segments all land in the store, offsets commit
    past segment boundaries."""
    bus = str(tmp_path / "bus")
    j = Journal(bus, "m", segment_bytes=256)
    rows = [F.format_als_row(i, "U", [float(i), 0.5]) for i in range(60)]
    for s in range(0, len(rows), 10):
        j.append(rows[s:s + 10], flush=False)
    j.sync()
    assert len(j._scan()) > 1, "rotation must have occurred"
    job = ServingJob(
        Journal(bus, "m", segment_bytes=256), ALS_STATE, parse_als_record,
        make_backend("rocksdb", str(tmp_path / "store")),
        host="127.0.0.1", port=0, poll_interval_s=0.01, native_server=True,
    ).start()
    try:
        assert _wait_until(lambda: len(job.table) == 60)
        assert job.table.get("59-U") == "59.0;0.5"
        assert job.offset == j.end_offset()
    finally:
        job.stop()


# ---------------------------------------------------------------------------
# the packages cross
# ---------------------------------------------------------------------------

def _random_rows(seed, n=400):
    rng = np.random.default_rng(seed)
    keys = [f"{u}-{'UI'[u % 2]}" for u in rng.integers(0, 150, n)]
    vals = [";".join(repr(float(x)) for x in rng.normal(size=4))
            for _ in range(n)]
    return list(zip(keys, vals))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_dirs_cross_the_packages(tmp_path, writer):
    """The same puts, deletes and a compaction through each package's
    library write the same ``data.log`` bytes, and a store either package
    wrote opens in the other with the same ``items()``."""
    from flink_ms_tpu.serve import native_store as RN
    from flink_ms_tpu_torch.serve import native_store as PN

    W, R = (PN, RN) if writer == "port" else (RN, PN)
    rows = _random_rows(3)
    logs = {}
    for name, mod in (("w", W), ("r", R)):
        d = str(tmp_path / name)
        with mod.NativeStore(d) as s:
            for k, v in rows:
                s.put(k, v)
            s.delete(rows[0][0])
            s.put("ключ", "значение")
            s.compact()
            s.put("after", "compaction")
            s.flush()
        with open(os.path.join(d, "data.log"), "rb") as f:
            logs[name] = f.read()
    assert logs["w"] == logs["r"]
    want = dict(rows)
    del want[rows[0][0]]
    want.update({"ключ": "значение", "after": "compaction"})
    with R.NativeStore(str(tmp_path / "w")) as s:
        assert dict(s.items()) == want and len(s) == len(want)
        assert s.log_bytes == len(logs["w"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_rocksdb_job_restarts_on_the_other_packages_store(tmp_path, writer):
    """A rocksdb serving job of one package ingests the journal natively
    and checkpoints; a job of the other package restarts on that store
    from its offset marker and serves the same rows without replay."""
    from flink_ms_tpu.serve import consumer as RC
    from flink_ms_tpu.serve import journal as RJ

    pkgs = {"port": (ServingJob, make_backend, Journal, parse_als_record,
                     {"device": "cpu"}),
            "reference": (RC.ServingJob, RC.make_backend, RJ.Journal,
                          RC.parse_als_record, {})}
    order = [writer, "reference" if writer == "port" else "port"]
    jdir, chk = str(tmp_path / "j"), str(tmp_path / "store")
    Journal(jdir, "t").append([F.format_als_row(i, "U", [float(i), 0.5])
                               for i in range(40)])
    Job, mk, J, parse, kw = pkgs[order[0]]
    job = Job(J(jdir, "t"), ALS_STATE, parse, mk("rocksdb", chk),
              poll_interval_s=0.01, checkpoint_interval_ms=20,
              host="127.0.0.1", port=0, native_server=True, **kw).start()
    try:
        assert _wait_until(lambda: len(job.table) == 40)
        assert job.ingest_path == "native"
        assert _wait_until(
            lambda: job.backend.restore(job.table) == job.offset > 0)
        offset = job.offset
    finally:
        job.stop()
    Job, mk, J, parse, kw = pkgs[order[1]]
    backend = mk("rocksdb", chk)
    assert type(backend).__name__ == "NativeStateBackend"
    job = Job(J(jdir, "t"), ALS_STATE, parse, backend, poll_interval_s=0.01,
              host="127.0.0.1", port=0, native_server=True, **kw).start()
    try:
        assert job.wait_ready(30)
        assert job.bootstrap_source == "checkpoint" and job.offset == offset
        assert job.ingest_rows == 0 and len(job.table) == 40
        with QueryClient("127.0.0.1", job.port) as c:
            assert c.query_state(ALS_STATE, "39-U") == "39.0;0.5"
    finally:
        job.stop()


class _DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p),
                ("dli_fbase", ctypes.c_void_p),
                ("dli_sname", ctypes.c_char_p),
                ("dli_saddr", ctypes.c_void_p)]


def _defining_file(fn) -> str:
    """The shared object that defines the function ``fn`` points at."""
    libc = ctypes.CDLL(None)
    libc.dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
    info = _DlInfo()
    assert libc.dladdr(ctypes.cast(fn, ctypes.c_void_p), ctypes.byref(info))
    return os.path.realpath(info.dli_fname.decode())


def test_port_handles_are_served_by_the_ports_own_library(tmp_path):
    """Both packages' libraries in one process, each with the same
    ``tpums_*`` symbols: a store the port opens is served by the port's
    build under ``build/native/``, and the reference's by its
    ``native/libtpums.so``, never the other way round."""
    from flink_ms_tpu.serve import native_store as RN
    from flink_ms_tpu_torch.native import _build
    from flink_ms_tpu_torch.serve import native_store as PN

    with PN.NativeStore(str(tmp_path / "p")) as ps, \
            RN.NativeStore(str(tmp_path / "r")) as rs:
        ps.put("k", "port")
        rs.put("k", "reference")
        assert ps.get("k") == "port" and rs.get("k") == "reference"
        port_lib = _defining_file(ps._lib.tpums_open)
        assert port_lib == os.path.realpath(str(_build.library_path()))
        assert os.path.dirname(port_lib).endswith(
            os.path.join("build", "native"))
        for fn in ("tpums_get", "tpums_put", "tpums_server_start3",
                   "tpums_arena_put_batch", "tpums_arena_cas_floats"):
            assert _defining_file(getattr(ps._lib, fn)) == port_lib
        ref_lib = _defining_file(rs._lib.tpums_open)
        assert ref_lib != port_lib and ref_lib.endswith("libtpums.so")
