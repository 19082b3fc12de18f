"""What held a fleet member's registry heartbeat back, pinned without a
clock.

A member refreshes its registry entry from a thread of its own every
``TPUMS_HEARTBEAT_S``; its supervisor takes it for dead once the entry is
older than ``TPUMS_REPLICA_TTL_S`` (1.5 s in the rehearsal).  Two calls
in the member held the GIL for longer than that at the served model's
width, and the member was respawned:

- the top-k index's full build parsed every item payload in ONE join,
  split and float parse, each a single C call under the GIL.  The build
  now parses in blocks of ``_PARSE_BLOCK_ROWS`` rows, and gives the same
  rows as the reference's one parse;
- torch's lazy CUDA init ran on the index's warm-up thread, after the job
  had registered.  The context is now made on the thread that builds the
  index, before the job registers; the warm-up thread runs only
  operations that release the GIL;
- a checkpoint of an arena-backed job flushed the arena with
  ``mmap.flush``, whose ``msync`` holds the GIL until the disk has taken
  every dirty page (after a replay, the whole arena).  The arena now
  writes its pages back with ``os.fsync`` of its file, which releases
  the GIL while the disk works;
- the members of a fleet reach ready, and their first checkpoint,
  together, and each then syncs its arena or a snapshot copy of it,
  hundreds of MB: synced at once, they held every small file write and
  read on the host, a heartbeat's among them.  The processes of a host
  now write back their arenas in turns (``arena.host_writeback``);
- a registry reader judged a heartbeat against its clock read AFTER the
  file: a read held up that long, or a reader descheduled between the
  read and its clock, aged a fresh entry past the TTL, reaped it, and
  the supervisor respawned the live member whose entry was gone.  The
  reader's clock is now read before the file is opened.
"""

import tempfile
import threading
import types

import numpy as np
import pytest
import torch

from flink_ms_tpu.serve import topk as RT
from flink_ms_tpu.serve.table import ModelTable as RefTable
from flink_ms_tpu_torch.serve import topk as PT
from flink_ms_tpu_torch.serve.table import ModelTable


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TPUMS_TOPK_SHARDED", "0")


def _tables(n, width, bad=()):
    rng = np.random.default_rng(21)
    rows = rng.standard_normal((n, width)).astype(np.float32)
    out = []
    for table in (ModelTable(8), RefTable(8)):
        for i in range(n):
            payload = ";".join(repr(float(x)) for x in rows[i])
            if i in bad:
                payload = payload.replace(";", ";x", 1)
            table.put(f"{i}-I", payload)
        table.put("3-U", "1;2")           # another suffix: not indexed
        table.put("7777-I", "1.0;2.0")    # off width: dropped
        out.append(table)
    return out


@pytest.mark.parametrize("bad", [(), (5, 2049)])
def test_index_build_parses_in_bounded_blocks(monkeypatch, bad):
    n = 3 * PT._PARSE_BLOCK_ROWS + 17
    port_table, ref_table = _tables(n, 6, bad)
    blocks = []
    real = PT._parse_block

    def recording(payloads, width):
        blocks.append(len(payloads))
        return real(payloads, width)

    monkeypatch.setattr(PT, "_parse_block", recording)
    port = PT.DeviceFactorIndex(port_table, "-I", device="cpu")
    ids, rows, width = port._snapshot_rows()
    ref = RT.DeviceFactorIndex(ref_table, "-I")._snapshot_rows()
    assert blocks and max(blocks) <= PT._PARSE_BLOCK_ROWS
    if not bad:
        # every row went through a block, none through the per-row path
        assert sum(blocks) == n and len(blocks) == 4
    assert ids == ref[0] and width == ref[2] == 6
    assert rows.dtype == np.float32
    np.testing.assert_array_equal(rows, ref[1])
    assert len(ids) == n - len(bad)


def test_a_block_with_a_bad_token_raises_for_the_per_row_path():
    with pytest.raises(ValueError):
        PT._parse_block(["1;2", "3;x"], 2)
    with pytest.raises(ValueError):
        PT._parse_block(["1;2", "3;"], 2)
    np.testing.assert_array_equal(PT._parse_block(["1;2", "3;4.5"], 2),
                                  np.array([[1, 2], [3, 4.5]], np.float32))


def test_cuda_context_is_made_on_the_callers_thread(monkeypatch):
    """The warm-up makes the context on the calling thread, before its
    daemon thread exists."""
    order = []
    monkeypatch.setattr(PT.torch.cuda, "init",
                        lambda: order.append(("init",
                                              threading.get_ident())))

    class Recorder:
        def __init__(self, target=None, name=None, daemon=None):
            order.append(("thread", name))
            self.target = target

        def start(self):
            order.append(("start", None))

    monkeypatch.setattr(PT, "threading", types.SimpleNamespace(
        Thread=Recorder))
    monkeypatch.setattr(PT, "_warmed", {})
    dev = torch.device("cuda", 0)
    PT._warm_async(dev)
    assert order == [("init", threading.get_ident()),
                     ("thread", "topk-cuda-warm"), ("start", None)]
    # once per process and card
    PT._warm_async(dev)
    assert len(order) == 3
    # the CPU needs no context and starts no thread
    PT._warm_async(torch.device("cpu"))
    assert len(order) == 3


class _FlushRecorder:
    """Stands in for an arena's mapping in ``Arena.flush``: records a
    ``flush`` (the GIL-holding ``msync``) instead of making it."""

    def __init__(self):
        self.flushes = 0

    def flush(self):
        self.flushes += 1


def _fsyncs(monkeypatch):
    import os

    from flink_ms_tpu_torch.serve import arena

    inodes = []
    real = os.fsync

    def fsync(fd):
        inodes.append(os.fstat(fd).st_ino)
        real(fd)

    monkeypatch.setattr(arena.os, "fsync", fsync)
    return inodes


def test_a_checkpoint_flushes_the_arena_by_fsync_of_its_file(
        monkeypatch, tmp_path):
    """The memory backend's checkpoint of an arena table writes the arena
    back by ``os.fsync`` of the arena's own file, and never through the
    mapping's ``flush``; the rows are in the file for a fresh reader."""
    import os

    from flink_ms_tpu_torch.serve import arena
    from flink_ms_tpu_torch.serve.consumer import MemoryStateBackend

    t = arena.ArenaModelTable(2, dir=str(tmp_path / "a"))
    t.put_many([(f"{i}-U", f"{i}.5;1.0") for i in range(300)])
    inodes = _fsyncs(monkeypatch)
    mm, rec = t.arena.mm, _FlushRecorder()
    t.arena.mm = rec
    try:
        MemoryStateBackend().snapshot(t, 300)
    finally:
        t.arena.mm = mm
    assert rec.flushes == 0
    assert inodes == [os.stat(t.arena.path).st_ino]
    rows = dict(arena.iter_arena_file(t.arena.path))
    assert len(rows) == 300 and rows["7-U"] == "7.5;1.0"
    t.close()


def test_a_flush_of_an_arena_whose_file_is_gone_uses_the_mapping(
        monkeypatch, tmp_path):
    """A grown-out generation's file is unlinked while its mapping lives:
    its flush falls back to the mapping's own, and a read-only arena
    flushes nothing."""
    import os

    from flink_ms_tpu_torch.serve import arena

    path = str(tmp_path / "g1")
    a = arena.Arena.create(path, 64, 64, 16, 1)
    assert a.put_bytes(b"k", b"v")
    ro = arena.Arena(path, writable=False)
    inodes = _fsyncs(monkeypatch)
    mm, rec = ro.mm, _FlushRecorder()
    ro.mm = rec
    ro.flush()
    ro.mm = mm
    assert (rec.flushes, inodes) == (0, [])
    os.unlink(path)
    mm, rec = a.mm, _FlushRecorder()
    a.mm = rec
    a.flush()
    a.mm = mm
    assert (rec.flushes, inodes) == (1, [])
    ro.close()
    a.close()


def _timed_fsyncs(monkeypatch, hold_s=0.15):
    """``os.fsync`` in the arena module records each call's (start, end)
    and takes ``hold_s`` longer, as a sync of hundreds of MB does."""
    import os
    import time

    from flink_ms_tpu_torch.serve import arena

    spans, real = [], os.fsync

    def fsync(fd):
        t0 = time.monotonic()
        time.sleep(hold_s)
        real(fd)
        spans.append((t0, time.monotonic()))

    monkeypatch.setattr(arena.os, "fsync", fsync)
    return spans


def _arena_table(path, n=300):
    from flink_ms_tpu_torch.serve import arena

    t = arena.ArenaModelTable(2, dir=str(path))
    t.put_many([(f"{i}-U", f"{i}.5;1.0") for i in range(n)])
    return t


def test_the_arenas_of_a_host_write_back_in_turns(monkeypatch, tmp_path):
    """Two members' checkpoints and snapshot copies at once (a fleet
    reaching ready together): no two of their syncs overlap, and the
    copies are whole arena files."""
    import threading

    from flink_ms_tpu_torch.serve import arena
    from flink_ms_tpu_torch.serve.consumer import MemoryStateBackend

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    tables = [_arena_table(tmp_path / f"m{i}") for i in range(2)]
    spans = _timed_fsyncs(monkeypatch)
    start = threading.Barrier(4)

    def checkpoint(t):
        start.wait()
        MemoryStateBackend().snapshot(t, 300)

    def publish(t, dst):
        start.wait()
        t.quiesce_copy(dst)

    threads = [threading.Thread(target=checkpoint, args=(t,))
               for t in tables]
    threads += [threading.Thread(target=publish,
                                 args=(t, str(tmp_path / f"copy{i}.dat")))
                for i, t in enumerate(tables)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert len(spans) == 4
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), spans
    for i in range(2):
        rows = dict(arena.iter_arena_file(str(tmp_path / f"copy{i}.dat")))
        assert len(rows) == 300 and rows["7-U"] == "7.5;1.0"
        tables[i].close()


def test_a_write_back_waits_for_another_process_turn(monkeypatch, tmp_path):
    """The turn is the host's: while a process of its own holds it, a
    table's checkpoint flush waits, and the table takes writes
    meanwhile (the wait is outside the table's lock)."""
    import os
    import subprocess
    import sys
    import threading
    import time

    from flink_ms_tpu_torch.serve import arena

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    t = _arena_table(tmp_path / "m")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time\n"
         f"sys.path.insert(0, {root!r})\n"
         "from flink_ms_tpu_torch.serve import arena\n"
         "with arena.host_writeback():\n"
         "    print('held', flush=True)\n"
         "    time.sleep(1.0)\n"],
        env=dict(os.environ, TMPDIR=str(tmp_path)), stdout=subprocess.PIPE,
        text=True)
    try:
        assert holder.stdout.readline().strip() == "held"
        done = []
        flusher = threading.Thread(
            target=lambda: (t.flush(), done.append(time.monotonic())))
        t0 = time.monotonic()
        flusher.start()
        time.sleep(0.2)
        t.put_many([("new-U", "1.0;2.0")])
        put_s = time.monotonic() - t0
        flusher.join(timeout=30)
        assert put_s < 0.6
        assert done and done[0] - t0 >= 0.6
        assert t.get("new-U") == "1.0;2.0"
    finally:
        holder.wait(timeout=30)
        t.close()


class _Clock:
    """``registry.time`` with a wall clock the test moves."""

    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now

    def sleep(self, s):
        self.now += s


def _entry(monkeypatch, tmp_path, age_s):
    from flink_ms_tpu_torch.serve import registry

    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path / "reg"))
    clock = _Clock(1_000.0)
    monkeypatch.setattr(registry, "time", clock)
    registry.register("g@g1:s0r0", "127.0.0.1", 1, "S", replica_of="g",
                      replica=0, ready=True, ttl_s=1.5)
    clock.now += age_s
    # a live member's entry stays on disk: its process is this one
    return registry, clock


@pytest.mark.parametrize("reader", ["resolve", "list_jobs"])
def test_a_read_held_up_past_the_ttl_does_not_age_a_fresh_entry(
        monkeypatch, tmp_path, reader):
    """An entry 0.2 s old whose read is held up 2 s (the file system busy)
    is alive to the reader, and stays on disk."""
    import os

    registry, clock = _entry(monkeypatch, tmp_path, 0.2)
    real = registry._load_json_retry

    def held_up(path, strict=False):
        got = real(path, strict)
        clock.now += 2.0
        return got

    monkeypatch.setattr(registry, "_load_json_retry", held_up)
    path = registry._entry_path("g@g1:s0r0")
    if reader == "resolve":
        assert registry.resolve("g@g1:s0r0")["port"] == 1
    else:
        assert [e["job_id"] for e in registry.list_jobs()] == ["g@g1:s0r0"]
    assert os.path.exists(path)


@pytest.mark.parametrize("reader", ["resolve", "list_jobs"])
def test_a_lapsed_heartbeat_is_still_dead(monkeypatch, tmp_path, reader):
    """An entry 1.6 s old against its 1.5 s TTL is dead at once, and
    reaped."""
    import os

    registry, _ = _entry(monkeypatch, tmp_path, 1.6)
    path = registry._entry_path("g@g1:s0r0")
    if reader == "resolve":
        assert registry.resolve("g@g1:s0r0") is None
    else:
        assert registry.list_jobs() == []
    assert not os.path.exists(path)
