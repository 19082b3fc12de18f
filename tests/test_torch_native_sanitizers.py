"""Race and memory gates for the port's native store, lookup server and
arena (``flink_ms_tpu_torch/native/``): each case of
``tests/test_native_sanitizers.py`` on the port, all marked slow as there.

The native components are multi-threaded (epoll loop and control thread;
store mutex under concurrent readers, writer and compaction; the arena's
seqlock between the batch writer, the CAS and the readers), so the tsan and
asan builds of ``native/_build.py`` (``build("tsan")``, ``build("asan")``,
under ``build/native/``) run a concurrency workload in a subprocess, loaded
through ``TPUMS_NATIVE_LIB``, and the gate fails on any sanitizer report
naming the sources.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# Exercises every cross-thread interaction: concurrent put/get/compact on
# the store while the epoll server answers pipelined client queries, then
# the stop/join handoff.
WORKLOAD = r"""
import os, socket, threading, sys, tempfile
# gate-validity marker: the runner asserts the sanitizer runtime is
# actually mapped, else a broken LD_PRELOAD would pass the gate vacuously
print("sanitizer-maps:", open("/proc/self/maps").read().count("san.so"),
      file=sys.stderr)
sys.path.insert(0, os.environ["REPO_ROOT"])
from flink_ms_tpu_torch.serve.native_store import NativeStore, NativeLookupServer

d = tempfile.mkdtemp()
store = NativeStore(d)
for i in range(100):
    store.put(f"{i}-U", "0.5;1.5;2.5")
    store.put(f"{i}-I", "1.5;0.5;2.0")
for b in range(10):
    store.put(str(b), f"{b * 4 + 1}:0.5;{b * 4 + 2}:1.5")  # DOT bucket rows

with NativeLookupServer(store, "ALS_MODEL", job_id="san", port=0,
                        topk_suffixes=("-I", "-U")) as srv:
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        while not stop.is_set():
            store.put(f"{i % 100}-U", f"{i};{i + 1}")
            # republish a DOT bucket row: every put moves the store
            # version, racing the serve-stale dot/topk index builder
            # threads against the scan below
            store.put(str(i % 10), f"{i % 40 + 1}:{i % 9}.5")
            if i % 7 == 0:
                # the bulk-ingest path shares the mutex with reads: keep
                # it under the race gate too
                chunk = "".join(
                    f"{j % 100},U,{i};{j}\n" for j in range(20)
                ).encode()
                store.ingest_buf(chunk, 0)
            i += 1
        store.compact()

    def querier():
        try:
            with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as s:
                f = s.makefile("rb")
                for i in range(300):
                    s.sendall(b"GET\tALS_MODEL\t%d-U\n" % (i % 100))
                    if not f.readline().startswith(b"V\t"):
                        errors.append("bad reply")
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    def worker_verbs():
        # DOT + TOPKV run on the worker thread with O(catalog) index
        # builds behind serve-stale swaps: the cross-thread machinery
        try:
            with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as s:
                f = s.makefile("rb")
                for i in range(150):
                    s.sendall(b"DOT\tALS_MODEL\t4\t%d:1.0;2:0.5\n" % (i % 40 + 1))
                    line = f.readline()
                    if not line.startswith(b"D\t"):
                        errors.append("bad DOT reply: %r" % line)
                    s.sendall(b"TOPKV\tALS_MODEL\t3\t1.0;0.5;0.25\n")
                    line = f.readline()
                    if not line.startswith(b"V\t"):
                        errors.append("bad TOPKV reply: %r" % line)
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=querier) for _ in range(4)]
    threads += [threading.Thread(target=worker_verbs) for _ in range(2)]
    wt = threading.Thread(target=writer)
    wt.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    wt.join()
    assert not errors, errors
store.close()
print("WORKLOAD-OK")
"""


# The arena gate: the instrumented C++ reader — epoll server verbs,
# direct handle calls, stats/refresh from a second thread — runs against
# a LIVE Python writer mutating the same mmap from another process.
# Scope honesty: tsan cannot model the uninstrumented cross-process
# writer's stores, so this is a READER-LOOP soundness gate (the reader's
# own threads must not race each other over the handle, the remap path,
# or the seqlock retry loop), not a whole-protocol proof; the protocol's
# torn-row contract is tested behaviorally in test_arena.py (forged odd
# seq, SIGKILL post-mortem) and scripts/chaos_kill.py CHAOS_MODE=arena.
ARENA_WORKLOAD = r"""
import os, socket, subprocess, sys, tempfile, threading, time
print("sanitizer-maps:", open("/proc/self/maps").read().count("san.so"),
      file=sys.stderr)
sys.path.insert(0, os.environ["REPO_ROOT"])
from flink_ms_tpu_torch.serve.native_store import NativeArena, NativeLookupServer

d = tempfile.mkdtemp()
arena_dir = os.path.join(d, "arena")

WRITER = '''
import os, sys, time
sys.path.insert(0, os.environ["REPO_ROOT"])
from flink_ms_tpu_torch.serve.arena import ArenaModelTable
t = ArenaModelTable(4, dir=sys.argv[1], capacity=512, stride=32, key_cap=16)
for i in range(150):
    t.put(f"{i}-U", "0.5;1.5;2.5")
print("READY", flush=True)
i = 0
grew = False
end = time.time() + 5
while time.time() < end:
    t.put(f"{i % 150}-U", f"{i};{i + 1}")
    if not grew and time.time() > end - 4:
        t.put("big-U", "x" * 200)  # oversize value: generation flip
        grew = True                # while readers are mid-probe
    i += 1
t.close()
'''
wenv = dict(os.environ)
wenv.pop("LD_PRELOAD", None)  # the writer is pure Python, uninstrumented
# ... and must STAY pure Python: letting it open the native batch writer
# would dlopen the instrumented lib into an interpreter without the
# sanitizer runtime preloaded (asan aborts on the mismatched allocator)
wenv["TPUMS_ARENA_BATCH"] = "0"
w = subprocess.Popen([sys.executable, "-c", WRITER, arena_dir],
                     stdout=subprocess.PIPE, text=True, env=wenv)
assert "READY" in w.stdout.readline()

arena = NativeArena(arena_dir)
errors = []
with NativeLookupServer(arena, "ALS_MODEL", job_id="san-arena", port=0,
                        topk_suffixes=("-I", "-U")) as srv:
    def querier():
        try:
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=10) as s:
                f = s.makefile("rb")
                for i in range(400):
                    s.sendall(b"GET\tALS_MODEL\t%d-U\n" % (i % 160))
                    if f.readline()[:1] not in (b"V", b"N"):
                        errors.append("bad reply")
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    def worker_verbs():
        # TOPK scans the whole arena (seqlock-iterates every slot) on
        # the worker thread while the epoll thread answers GETs
        try:
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=10) as s:
                f = s.makefile("rb")
                for i in range(100):
                    s.sendall(b"TOPKV\tALS_MODEL\t3\t1.0;0.5;0.25\n")
                    if f.readline()[:1] not in (b"V", b"N", b"E"):
                        errors.append("bad TOPKV reply")
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    def direct_reader():
        # handle-level calls race the server threads over the shared
        # handle: get (seqlock probe + retired-remap), stats, len
        try:
            for i in range(400):
                arena.get(f"{i % 160}-U")
                if i % 16 == 0:
                    arena.stats()
                    len(arena)
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=querier) for _ in range(3)]
    threads += [threading.Thread(target=worker_verbs)]
    threads += [threading.Thread(target=direct_reader) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
assert not errors, errors
arena.close()
w.wait(timeout=30)
print("WORKLOAD-OK")
"""


# The write-plane gate: unlike ARENA_WORKLOAD's uninstrumented
# cross-process Python writer, BOTH sides of this race are instrumented
# C++ in ONE process — the batch writer + CAS updater (ctypes straight
# into tpums_arena_put_batch/tpums_arena_cas_floats, GIL released per
# call) against the reader loop (epoll server verbs + direct handle
# reads).  This is the real seqlock proof: tsan models every access pair
# (claim/close seq stores, per-byte payload copies, header count/
# mutations, the writer.stats sidecar fetch_adds vs the METRICS splice).
# The arena is seeded before any thread starts and sized never to grow,
# so the single-writer contract holds without the Python table lock.
ARENA_WRITE_WORKLOAD = r"""
import ctypes, os, socket, sys, tempfile, threading
print("sanitizer-maps:", open("/proc/self/maps").read().count("san.so"),
      file=sys.stderr)
sys.path.insert(0, os.environ["REPO_ROOT"])
os.environ["TPUMS_ARENA_BATCH"] = "0"  # seed via pure Python (pre-race)
from flink_ms_tpu_torch.serve.arena import ArenaModelTable
from flink_ms_tpu_torch.serve.native_store import (
    NativeArena, NativeLookupServer, _load_lib)

d = tempfile.mkdtemp()
arena_dir = os.path.join(d, "arena")
table = ArenaModelTable(4, dir=arena_dir, capacity=4096, stride=64,
                        key_cap=16)
keys = [f"{i}-U" for i in range(200)]
table.put_many_columns(keys, ["0.5;1.5;2.5"] * len(keys))
# the table object only holds the writer flock from here on: every
# racing write below goes through the instrumented C++ writer handle
lib = _load_lib()
wh = lib.tpums_arena_writer_open(table.arena.path.encode(),
                                 arena_dir.encode())
assert wh, "writer open failed"

errors = []
stop = threading.Event()

def native_writer():
    kb64 = "\n".join(keys[:64]).encode()
    k0 = keys[0].encode()
    i = 0
    mk = ctypes.c_uint32(0)
    mv = ctypes.c_uint32(0)
    while not stop.is_set():
        vals = [f"{i};{j}" for j in range(64)]
        vbuf = "\n".join(vals).encode()
        n = lib.tpums_arena_put_batch(wh, kb64, len(kb64), vbuf, len(vbuf),
                                      64, ctypes.byref(mk), ctypes.byref(mv))
        if n != 64:
            errors.append(f"put_batch applied {n}")
            return
        e0 = vals[0].encode()
        # CAS the row just written (single writer: must swap) ...
        if lib.tpums_arena_cas_floats(wh, k0, len(k0), e0, len(e0),
                                      b"9;9", 3) != 1:
            errors.append("cas swap failed")
            return
        # ... then against a stale expect (must report a retry, not swap)
        if lib.tpums_arena_cas_floats(wh, k0, len(k0), b"stale", 5,
                                      b"8;8", 3) != 0:
            errors.append("stale cas did not miss")
            return
        i += 1

arena = NativeArena(arena_dir)
with NativeLookupServer(arena, "ALS_MODEL", job_id="san-wr", port=0,
                        topk_suffixes=("-I", "-U")) as srv:
    def querier():
        try:
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=10) as s:
                f = s.makefile("rb")
                for i in range(400):
                    s.sendall(b"GET\tALS_MODEL\t%d-U\n" % (i % 200))
                    if f.readline()[:1] not in (b"V", b"N"):
                        errors.append("bad reply")
                    if i % 50 == 0:
                        # METRICS reads the writer.stats sidecar the
                        # writer thread is fetch_add-ing right now
                        s.sendall(b"METRICS\n")
                        if not f.readline().startswith(b"J\t"):
                            errors.append("bad METRICS reply")
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    def direct_reader():
        try:
            for i in range(400):
                arena.get(f"{i % 200}-U")
                if i % 16 == 0:
                    arena.stats()
                    len(arena)
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    wt = threading.Thread(target=native_writer)
    threads = [threading.Thread(target=querier) for _ in range(3)]
    threads += [threading.Thread(target=direct_reader) for _ in range(2)]
    wt.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    wt.join()
assert not errors, errors
lib.tpums_arena_writer_close(wh)
arena.close()
table.close()
print("WORKLOAD-OK")
"""


def _runtime(name: str) -> str:
    out = subprocess.run(
        ["g++", f"-print-file-name={name}"], capture_output=True, text=True
    ).stdout.strip()
    return out if os.path.isabs(out) else ""


def _run_gate(variant: str, runtime_so: str, extra_env: dict,
              workload: str = WORKLOAD) -> None:
    from flink_ms_tpu_torch.native import _build

    lib = str(_build.build(variant))
    env = {
        **os.environ,
        "REPO_ROOT": REPO,
        "TPUMS_NATIVE_LIB": lib,
        "LD_PRELOAD": runtime_so,
        **extra_env,
    }
    proc = subprocess.run(
        [sys.executable, "-c", workload],
        capture_output=True, text=True, env=env, timeout=120,
    )
    report = proc.stdout + proc.stderr
    assert "WORKLOAD-OK" in report, report
    import re

    m = re.search(r"sanitizer-maps: (\d+)", report)
    assert m and int(m.group(1)) > 0, (
        "sanitizer runtime not mapped in the workload child — the race "
        "gate would pass vacuously\n" + report
    )
    # only reports that implicate our code fail the gate; the uninstrumented
    # interpreter can trip unrelated interceptor noise.  Scan whole report
    # stanzas, not just the SUMMARY line: tsan/asan summaries show a single
    # top frame, which can resolve to tpums.h, an inlined frame, or a libc
    # interceptor even when the race is ours.
    for stanza in _report_stanzas(report):
        if any(m in stanza for m in
               ("store.cpp", "lookup_server", "arena.cpp", "tpums")):
            raise AssertionError(stanza + "\n--- full report ---\n" + report)


def _report_stanzas(report: str):
    """Split sanitizer output into per-report blocks (WARNING/ERROR header
    through the matching SUMMARY line)."""
    stanza = None
    for line in report.splitlines():
        if "WARNING: ThreadSanitizer" in line or "ERROR: AddressSanitizer" in line:
            stanza = [line]
        elif stanza is not None:
            stanza.append(line)
            if "SUMMARY:" in line:
                yield "\n".join(stanza)
                stanza = None
    if stanza is not None:  # truncated report still counts
        yield "\n".join(stanza)


@pytest.mark.slow
def test_store_and_server_race_free_under_tsan():
    rt = _runtime("libtsan.so")
    if not rt:
        pytest.skip("libtsan not available")
    _run_gate(
        "tsan", rt,
        {"TSAN_OPTIONS": "exitcode=0 report_thread_leaks=0"},
    )


@pytest.mark.slow
def test_store_and_server_clean_under_asan():
    rt = _runtime("libasan.so")
    if not rt:
        pytest.skip("libasan not available")
    _run_gate(
        "asan", rt,
        {"ASAN_OPTIONS": "detect_leaks=0:exitcode=0:verify_asan_link_order=0"},
    )


@pytest.mark.slow
def test_arena_reader_race_free_under_tsan():
    """Instrumented C++ arena reader loop (see ARENA_WORKLOAD's scope
    note) vs a live uninstrumented Python mmap writer."""
    rt = _runtime("libtsan.so")
    if not rt:
        pytest.skip("libtsan not available")
    _run_gate(
        "tsan", rt,
        {"TSAN_OPTIONS": "exitcode=0 report_thread_leaks=0"},
        workload=ARENA_WORKLOAD,
    )


@pytest.mark.slow
def test_arena_batch_writer_race_free_under_tsan():
    """Instrumented C++ batch writer + CAS updater racing the instrumented
    C++ reader loop in one process — the full seqlock access-pair proof
    (see ARENA_WRITE_WORKLOAD's note)."""
    rt = _runtime("libtsan.so")
    if not rt:
        pytest.skip("libtsan not available")
    _run_gate(
        "tsan", rt,
        {"TSAN_OPTIONS": "exitcode=0 report_thread_leaks=0"},
        workload=ARENA_WRITE_WORKLOAD,
    )


@pytest.mark.slow
def test_arena_batch_writer_clean_under_asan():
    """The batch writer's memchr row walk and the CAS probe loop must stay
    inside the mapping (and the writer.stats sidecar inside its 64 bytes)
    under asan."""
    rt = _runtime("libasan.so")
    if not rt:
        pytest.skip("libasan not available")
    _run_gate(
        "asan", rt,
        {"ASAN_OPTIONS": "detect_leaks=0:exitcode=0:verify_asan_link_order=0"},
        workload=ARENA_WRITE_WORKLOAD,
    )


@pytest.mark.slow
def test_arena_reader_clean_under_asan():
    """The same arena reader loop under asan: the remap path (mmap/munmap
    across generation flips) and the seqlock row copies must stay inside
    the mapping."""
    rt = _runtime("libasan.so")
    if not rt:
        pytest.skip("libasan not available")
    _run_gate(
        "asan", rt,
        {"ASAN_OPTIONS": "detect_leaks=0:exitcode=0:verify_asan_link_order=0"},
        workload=ARENA_WORKLOAD,
    )
