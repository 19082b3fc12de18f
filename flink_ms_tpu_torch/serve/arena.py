"""Zero-copy shared-memory arena: ONE factor store shared by the serving
job's planes.

Own copy of ``flink_ms_tpu/serve/arena.py``: the same file layout, seqlock
protocol, store order, growth rule and knobs, so an arena directory either
package writes is read by the other's ``NativeArena``, ``attach_reader``
and ``iter_arena_file`` with the same rows.  The native batch writer and
CAS are the port's own library (``native/_build.py``).

The dict-backed ``ModelTable`` keeps the model private to the consumer
process: the C++ lookup server needs its own store fed row-by-row over a
socket/FFI, the SGD update plane round-trips freshness through the
journal reader, and snapshot/geo publish is an O(state) *serialize*.
The arena collapses those copies: a single mmap'd file holds fixed-
stride factor slabs addressed by an open-addressing key index, the
consumer's ingest path writes rows in place, and every reader — the C++
epoll server (``native/arena.cpp``), co-located update workers, the
snapshotter, the geo replicator — maps the same pages.

File layout (little-endian throughout)::

    <dir>/CURRENT                 name of the live generation file
    <dir>/writer.lock             flock'd by THE writer (kernel-released)
    <dir>/arena-<gen>.dat:
        [0:64)   header: magic "TPMA" | version u32 | capacity u64 |
                 stride u32 | key_cap u32 | count u64 | generation u64 |
                 retired u32 | pad u32 | mutations u64
        [64:..)  capacity slots of ceil8(12 + key_cap + stride) bytes:
                 seq u32 | klen u32 | vlen u32 | key[key_cap] |
                 value[stride]

The slot array IS the index: a key hashes (32-bit FNV-1a, the same
``table._fnv1a`` that routes shards everywhere else) to ``h % capacity``
and linear-probes from there.  Model tables only ever upsert (last-
writer-wins, no deletes), so probe chains are stable and an EMPTY slot
(``seq == 0``) terminates a lookup.

Seqlock protocol (readers are lock-free; one writer, flock-excluded):

    writer: seq -> odd, write klen/vlen/key/value, seq -> even
    reader: s1 = load(seq); if 0 -> chain end (missing); if odd ->
            bounded retry then missing; copy row; s2 = load(seq);
            s1 != s2 -> torn, retry the slot (bounded), count the retry

A writer SIGKILLed mid-row leaves that slot's seq odd forever: readers
report the key missing — never a torn value — and the respawned
consumer's at-least-once journal replay rewrites the row (even seq),
repairing it.  Ordering relies on the x86-TSO store order the CPython
writer emits through mmap slice stores; the native reader pairs it with
acquire loads (``native/arena.cpp``).

Growth (load factor, oversize value/key) builds generation g+1, rehashes
live rows, repoints CURRENT, then sets the old header's ``retired`` flag
— attached readers see the flag on their next lookup and remap through
CURRENT (``tpums_arena_refresh``).

Batched writes go through the native plane when the toolchain is
available: ``put_many_columns`` encodes the whole batch into contiguous
columnar blobs OUTSIDE the table lock, then hands them to the C++
``tpums_arena_put_batch`` (``native/arena.cpp``) — one FFI call and zero
Python bytecode per row, byte-parity-exact with ``put_bytes``.  Growth
falls back to the Python path for the blocking row, then resumes
natively.  ``cas_many_columns`` is the update plane's in-place
compare-and-swap (``tpums_arena_cas_floats``): same seqlock discipline,
value drift reported back for an LWW re-put instead of clobbered.

Knobs: ``TPUMS_ARENA_CAPACITY`` (slots, default 65536),
``TPUMS_ARENA_STRIDE`` (max value bytes, default 256),
``TPUMS_ARENA_KEYCAP`` (max key bytes, default 48),
``TPUMS_ARENA_BATCH=0`` (disable the native batch writer),
``TPUMS_ARENA_CAS=0`` (update plane re-puts rows instead of CAS),
``TPUMS_ARENA_PREFAULT=1`` (bulk-populate the writer mapping at attach
— bootstrap replay then never stalls on first-touch faults);
selection is ``--table arena`` / ``TPUMS_TABLE=arena`` on the consumer
CLI (the default for sharded/HA/elastic fleets — ``TPUMS_TABLE=dict``
opts out).
"""

from __future__ import annotations

import contextlib
import ctypes
import errno
import json
import mmap
import os
import struct
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

from .table import _fnv1a, _fnv1a_batch

# The processes of one host write back their arenas one at a time: a
# member's checkpoint flush or snapshot copy syncs hundreds of MB, and
# several members synced at once (a fleet reaches ready, and its first
# checkpoint, together) held every small file write on the host, a
# registry heartbeat among them, for up to 0.85 s; taken in turns, for at
# most 0.12 s, in about the same total time (10 writers of 275 MB on an
# H100 host, ``scripts/writeback_stall.py``).  The lock is a file in the
# temp dir, which the processes of one host share.
WRITEBACK_LOCK = "tpums-arena-writeback.lock"


@contextlib.contextmanager
def host_writeback():
    """Hold the host's arena write-back turn (an ``flock``; released when
    the block ends, or by the kernel when its holder dies).  Taken before
    a table's own lock, never inside it."""
    import fcntl
    import tempfile

    fd = os.open(os.path.join(tempfile.gettempdir(), WRITEBACK_LOCK),
                 os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)

try:  # SIMD newline guard for the columnar blobs (bytes.count restarts
    # memchr at every match — ~1 GB/s on 100-byte rows; the vectorized
    # compare-and-sum runs at memory bandwidth)
    import numpy as _np
except Exception:  # pragma: no cover - numpy ships with torch
    _np = None


def _nl_count(b: bytes) -> int:
    if _np is not None and len(b) >= 4096:
        return int((_np.frombuffer(b, _np.uint8) == 10).sum())
    return b.count(b"\n")


MAGIC = b"TPMA"
VERSION = 1
HEADER_SIZE = 64
SLOT_HDR = 12  # seq u32 | klen u32 | vlen u32
CURRENT = "CURRENT"
WRITER_LOCK = "writer.lock"
# bounded seqlock retries: past this the writer is dead mid-row (odd) or
# the slot is being rewritten faster than we can copy it (never at our
# write rates) — report missing, journal replay repairs
MAX_SEQ_RETRIES = 64

_HDR = struct.Struct("<4sIQIIQQI")  # through `retired`; rest reserved


def _env_int(name: str, default: int, lo: int) -> int:
    try:
        return max(int(os.environ.get(name, default)), lo)
    except ValueError:
        return default


def default_capacity() -> int:
    return _env_int("TPUMS_ARENA_CAPACITY", 1 << 16, 64)


def default_stride() -> int:
    return _env_int("TPUMS_ARENA_STRIDE", 256, 16)


def default_key_cap() -> int:
    return _env_int("TPUMS_ARENA_KEYCAP", 48, 8)


def slot_size(key_cap: int, stride: int) -> int:
    return (SLOT_HDR + key_cap + stride + 7) & ~7


def gen_filename(generation: int) -> str:
    return f"arena-{generation:08d}.dat"


class ArenaBusy(RuntimeError):
    """Another live process holds this arena's writer flock."""


class Arena:
    """One mapped generation file.  ``writable`` attaches the mapping
    read-write (the single writer); readers map shared read-only."""

    def __init__(self, path: str, writable: bool):
        self.path = path
        self.writable = writable
        fd = os.open(path, os.O_RDWR if writable else os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            self.mm = mmap.mmap(
                fd, size,
                prot=(mmap.PROT_READ | mmap.PROT_WRITE) if writable
                else mmap.PROT_READ)
        finally:
            os.close(fd)
        (magic, version, self.capacity, self.stride, self.key_cap,
         _count, self.generation, _retired) = _HDR.unpack_from(self.mm, 0)
        if magic != MAGIC or version != VERSION:
            self.mm.close()
            raise ValueError(f"{path}: not a tpums arena (magic/version)")
        self.slot_size = slot_size(self.key_cap, self.stride)
        if size < HEADER_SIZE + self.capacity * self.slot_size:
            # a truncated copy (torn snapshot ship) must fail structurally
            # here, not as an out-of-bounds read mid-scan
            self.mm.close()
            raise ValueError(
                f"{path}: short arena file ({size} bytes for capacity "
                f"{self.capacity})")
        if writable and os.environ.get("TPUMS_ARENA_PREFAULT") == "1":
            # bulk-populate the mapping at attach time: hash-distributed
            # inserts otherwise take a first-touch fault on nearly every
            # row, and prefetch can't hide a fault the way it hides a
            # cache miss.  One kernel pass here is far cheaper than a
            # million faults during bootstrap replay.
            try:
                self.mm.madvise(getattr(mmap, "MADV_POPULATE_WRITE", 23))
            except (AttributeError, OSError, ValueError):
                pass  # kernel < 5.14: faults amortize as before

    # -- header fields (count/retired are live, re-read per call) ---------

    @property
    def count(self) -> int:
        return struct.unpack_from("<Q", self.mm, 24)[0]

    def _set_count(self, n: int) -> None:
        struct.pack_into("<Q", self.mm, 24, n)

    @property
    def mutations(self) -> int:
        """Writer-bumped change counter: in-place updates move neither
        ``count`` nor the file size, so index-staleness checks (top-k/DOT
        version probes via ``tpums_log_bytes``) read this instead."""
        return struct.unpack_from("<Q", self.mm, 48)[0]

    def _bump_mutations(self) -> None:
        struct.pack_into("<Q", self.mm, 48,
                         (self.mutations + 1) & 0xFFFFFFFFFFFFFFFF)

    @property
    def retired(self) -> bool:
        return struct.unpack_from("<I", self.mm, 40)[0] != 0

    def retire(self) -> None:
        struct.pack_into("<I", self.mm, 40, 1)

    @property
    def size_bytes(self) -> int:
        return HEADER_SIZE + self.capacity * self.slot_size

    def resident_bytes(self) -> int:
        """Pages actually allocated (the file is sparse until written)."""
        try:
            return os.stat(self.path).st_blocks * 512
        except OSError:
            return 0

    # -- creation ---------------------------------------------------------

    @classmethod
    def create(cls, path: str, capacity: int, stride: int, key_cap: int,
               generation: int) -> "Arena":
        size = HEADER_SIZE + capacity * slot_size(key_cap, stride)
        tmp = f"{path}.tmp.{os.getpid()}"
        fd = os.open(tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.ftruncate(fd, size)
            hdr = bytearray(HEADER_SIZE)
            _HDR.pack_into(hdr, 0, MAGIC, VERSION, capacity, stride,
                           key_cap, 0, generation, 0)
            os.pwrite(fd, bytes(hdr), 0)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.rename(tmp, path)
        return cls(path, writable=True)

    # -- seqlock row access ----------------------------------------------

    def _slot_off(self, idx: int) -> int:
        return HEADER_SIZE + idx * self.slot_size

    def _read_slot(self, off: int) -> Optional[Tuple[bytes, bytes]]:
        """Seqlock-read one slot -> (key, value) bytes, or None when the
        slot is EMPTY, mid-write (odd), or torn past the retry bound.
        The caller distinguishes empty via ``peek_seq``."""
        mm = self.mm
        for _ in range(MAX_SEQ_RETRIES):
            s1 = struct.unpack_from("<I", mm, off)[0]
            if s1 == 0:
                return None
            if s1 & 1:
                _RETRIES.inc()
                continue
            klen, vlen = struct.unpack_from("<II", mm, off + 4)
            if klen > self.key_cap or vlen > self.stride:
                return None  # torn mid-claim on a pre-TSO arch; never LWW
            key = mm[off + SLOT_HDR:off + SLOT_HDR + klen]
            val = mm[off + SLOT_HDR + self.key_cap:
                     off + SLOT_HDR + self.key_cap + vlen]
            s2 = struct.unpack_from("<I", mm, off)[0]
            if s1 == s2:
                return key, val
            _RETRIES.inc()
        return None

    def peek_seq(self, idx: int) -> int:
        return struct.unpack_from("<I", self.mm, self._slot_off(idx))[0]

    def get(self, key: str) -> Optional[str]:
        kb = key.encode("utf-8")
        return self.get_bytes(kb)

    def get_bytes(self, kb: bytes) -> Optional[str]:
        if len(kb) > self.key_cap:
            return None
        cap = self.capacity
        idx = _fnv1a_bytes(kb) % cap
        for _ in range(cap):
            off = self._slot_off(idx)
            seq = struct.unpack_from("<I", self.mm, off)[0]
            if seq == 0:
                return None  # chain end
            row = self._read_slot(off)
            if row is not None and row[0] == kb:
                return row[1].decode("utf-8")
            if row is None and not (seq & 1) and seq != 0:
                pass  # torn even-seq read: fall through and keep probing
            idx = idx + 1
            if idx == cap:
                idx = 0
        return None

    # -- writer side ------------------------------------------------------

    def put_bytes(self, kb: bytes, vb: bytes, h: Optional[int] = None
                  ) -> bool:
        """Upsert one row in place; False when the arena must grow
        (oversize key/value or load factor ceiling).  Caller holds the
        table lock — there is exactly one writer."""
        if len(kb) > self.key_cap or len(vb) > self.stride:
            return False
        cap = self.capacity
        idx = (_fnv1a_bytes(kb) if h is None else h) % cap
        mm = self.mm
        for _ in range(cap):
            off = self._slot_off(idx)
            seq, klen = struct.unpack_from("<II", mm, off)
            if seq == 0 and klen == 0:
                n = self.count
                if n + 1 > (cap - (cap >> 3)):  # keep 1/8 headroom
                    return False
                # claim: odd seq first so a concurrent reader never
                # trusts the half-written key/value bytes
                struct.pack_into("<I", mm, off, 1)
                kc = self.key_cap
                mm[off + SLOT_HDR:off + SLOT_HDR + len(kb)] = kb
                mm[off + SLOT_HDR + kc:off + SLOT_HDR + kc + len(vb)] = vb
                struct.pack_into("<II", mm, off + 4, len(kb), len(vb))
                struct.pack_into("<I", mm, off, 2)
                self._set_count(n + 1)
                self._bump_mutations()
                return True
            if (klen == len(kb)
                    and mm[off + SLOT_HDR:off + SLOT_HDR + klen] == kb):
                # in-place update: key is immutable after the claim, only
                # vlen + value move under the odd window
                struct.pack_into("<I", mm, off, seq | 1)
                kc = self.key_cap
                mm[off + SLOT_HDR + kc:off + SLOT_HDR + kc + len(vb)] = vb
                struct.pack_into("<I", mm, off + 8, len(vb))
                struct.pack_into("<I", mm, off, (seq | 1) + 1)
                self._bump_mutations()
                return True
            idx = idx + 1
            if idx == cap:
                idx = 0
        return False

    def items(self) -> Iterator[Tuple[str, str]]:
        """Seqlock-scan every claimed slot.  Rows written during the scan
        may or may not appear (same contract as dict-table ``items`` on a
        copied shard); odd-stuck rows are skipped."""
        for idx in range(self.capacity):
            if self.peek_seq(idx) == 0:
                continue
            row = self._read_slot(self._slot_off(idx))
            if row is not None:
                yield row[0].decode("utf-8"), row[1].decode("utf-8")

    def flush(self) -> None:
        """Write the mapping's dirty pages back to the file.  ``fsync`` of
        the file writes them as ``msync`` does and releases the GIL while
        the disk works; ``mmap.flush`` holds the GIL throughout, so a
        checkpoint's flush of every page a replay dirtied would hold back
        the process's other threads (a serving job's registry heartbeat
        first) for as long as the disk takes."""
        if not self.writable:
            return
        try:
            fd = os.open(self.path, os.O_RDONLY)
        except OSError:
            self.mm.flush()  # the file is gone (a grown-out generation)
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def occupied_runs(self) -> Iterator[Tuple[int, int]]:
        """Yield ``(first_slot, last_slot_exclusive)`` runs of claimed
        slots — the occupancy map behind the sparse publish copy.  A
        numpy strided view over the mapping finds run edges in O(cap/8)
        memory; the struct fallback scans slot headers one by one."""
        ss = self.slot_size
        try:
            import numpy as np

            n_words = self.capacity * ss // 4
            seqs = np.frombuffer(self.mm, dtype=np.uint32, count=n_words,
                                 offset=HEADER_SIZE)[::ss // 4]
            occ = (seqs != 0).view(np.int8)
            edges = np.flatnonzero(np.diff(
                np.concatenate((np.int8([0]), occ, np.int8([0])))))
            for s, e in zip(edges[0::2].tolist(), edges[1::2].tolist()):
                yield s, e
            return
        except ImportError:
            pass
        start = None
        for idx in range(self.capacity):
            if self.peek_seq(idx) != 0:
                if start is None:
                    start = idx
            elif start is not None:
                yield start, idx
                start = None
        if start is not None:
            yield start, self.capacity

    def sparse_copy_to(self, dst_path: str) -> int:
        """Copy this arena to ``dst_path`` writing ONLY the header and
        occupied slot runs — empty slots become holes, so bytes copied
        track rows, not capacity.  Offsets are preserved (holes read as
        zeros = empty slots), so the result is a valid arena file.
        FICLONE is tried first: on reflink filesystems the whole publish
        is one O(1) ioctl.  Returns bytes actually written (== logical
        size after a reflink).  Caller quiesces the writer; durability
        (fsync) is the caller's."""
        size = HEADER_SIZE + self.capacity * self.slot_size
        dfd = os.open(dst_path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            sfd = os.open(self.path, os.O_RDONLY)
            try:
                import fcntl

                fcntl.ioctl(dfd, _FICLONE, sfd)
                return size
            except OSError:
                pass  # not a reflink fs — sparse slot-run copy below
            finally:
                os.close(sfd)
            os.ftruncate(dfd, size)
            written = os.pwrite(dfd, self.mm[:HEADER_SIZE], 0)
            ss = self.slot_size
            chunk_slots = max((8 << 20) // ss, 1)
            # coalesce runs whose gap is below one syscall's worth of
            # bytes: scattered hash occupancy (runs of ~1/(1-load) slots)
            # must degrade to a few big sequential writes, not a pwrite
            # per probe-chain fragment
            merge_gap = max((64 << 10) // ss, 1)
            for s, e in self._merged_runs(merge_gap):
                while s < e:
                    run = min(e - s, chunk_slots)
                    off = HEADER_SIZE + s * ss
                    written += os.pwrite(
                        dfd, self.mm[off:off + run * ss], off)
                    s += run
            return written
        finally:
            os.close(dfd)

    def _merged_runs(self, max_gap_slots: int) -> Iterator[Tuple[int, int]]:
        cur = None
        for s, e in self.occupied_runs():
            if cur is None:
                cur = (s, e)
            elif s - cur[1] <= max_gap_slots:
                cur = (cur[0], e)
            else:
                yield cur
                cur = (s, e)
        if cur is not None:
            yield cur

    def link_to(self, dst_path: str) -> int:
        """O(1) publish: hardlink this generation's inode at ``dst_path``.
        The artifact SHARES the live mapping — in-place updates after
        publish are visible in it, which is sound for this upsert-only
        LWW table (restore + journal replay from the manifest offset
        rewrites every row the journal touched after the offset, so
        at-publish and newer-than-publish row values converge to the
        same head state).  Falls back to a sparse copy across
        filesystems.  Returns bytes newly written (0 for a link)."""
        try:
            os.link(self.path, dst_path)
            return 0
        except OSError as e:
            if e.errno not in (errno.EXDEV, errno.EPERM, errno.EMLINK):
                raise
            return self.sparse_copy_to(dst_path)

    def close(self) -> None:
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass  # a reader still holds a buffer; refcount closes it


def _fnv1a_bytes(b: bytes) -> int:
    h = 0x811C9DC5
    for ch in b:
        h ^= ch
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


# -- metrics (module-level: readers are lock-free, the counter is shared) --

class _LazyCounter:
    """Defer the obs registry import so arena readers work in contexts
    that never touch observability (e.g. the snapshot loader)."""

    def __init__(self, name: str):
        self._name = name
        self._c = None

    def inc(self, n: int = 1) -> None:
        if self._c is None:
            from ..obs.metrics import get_registry

            self._c = get_registry().counter(self._name)
        self._c.inc(n)


class _LazyHistogram:
    """Same deferred-registry trick as ``_LazyCounter`` for histograms."""

    def __init__(self, name: str):
        self._name = name
        self._h = None

    def observe(self, v: float) -> None:
        if self._h is None:
            from ..obs.metrics import get_registry

            self._h = get_registry().histogram(self._name)
        self._h.observe(v)


_RETRIES = _LazyCounter("tpums_arena_read_retries_total")
# write-plane counters: batch rows/seconds through the native writer and
# CAS outcomes; the C++ writer mirrors them into the <dir>/writer.stats
# sidecar so the native METRICS verb exports the same names from server
# processes that never run Python on the write path
_BATCH_ROWS = _LazyCounter("tpums_arena_batch_rows_total")
_BATCH_SECONDS = _LazyCounter("tpums_arena_batch_put_seconds_total")
_BATCH_HIST = _LazyHistogram("tpums_arena_batch_put_seconds")
_CAS_SUCCESS = _LazyCounter("tpums_arena_cas_success_total")
_CAS_RETRY = _LazyCounter("tpums_arena_cas_retry_total")


# -- directory-level open/create ------------------------------------------

def current_path(dir_: str) -> Optional[str]:
    try:
        with open(os.path.join(dir_, CURRENT)) as f:
            name = f.read().strip()
    except OSError:
        return None
    return os.path.join(dir_, name) if name else None


def _write_current(dir_: str, name: str) -> None:
    tmp = os.path.join(dir_, f".{CURRENT}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dir_, CURRENT))


def attach_reader(dir_: str) -> Optional[Arena]:
    """Map the live generation read-only, or None when no arena exists."""
    path = current_path(dir_)
    if path is None or not os.path.exists(path):
        return None
    return Arena(path, writable=False)


# -- hole-aware clone (snapshot publish + geo shipping) --------------------

_FICLONE = 0x40049409  # linux ioctl: reflink the whole file (btrfs/xfs)


def clone_file(src: str, dst: str, do_fsync: bool = True) -> int:
    """Copy ``src`` to ``dst`` O(resident-data): reflink when the
    filesystem supports it (O(1)), else ``copy_file_range`` over the
    SEEK_DATA extents so the arena's unwritten slots (file holes) cost
    nothing.  Returns the logical size.  The destination is sized first
    so holes stay holes.  ``do_fsync=False`` leaves durability to the
    caller (``quiesce_copy`` fsyncs AFTER releasing the writer lock so
    ingest stalls only for the in-cache copy, not the disk flush)."""
    size = os.stat(src).st_size
    sfd = os.open(src, os.O_RDONLY)
    try:
        dfd = os.open(dst, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            try:
                import fcntl

                fcntl.ioctl(dfd, _FICLONE, sfd)
                return size
            except OSError:
                pass  # not a reflink fs — extent copy below
            os.ftruncate(dfd, size)
            off = 0
            while off < size:
                try:
                    data_start = os.lseek(sfd, off, os.SEEK_DATA)
                except OSError as e:
                    if e.errno == errno.ENXIO:
                        break  # trailing hole
                    raise
                hole = os.lseek(sfd, data_start, os.SEEK_HOLE)
                pos = data_start
                while pos < hole:
                    try:
                        n = os.copy_file_range(sfd, dfd, hole - pos,
                                               offset_src=pos,
                                               offset_dst=pos)
                    except OSError:
                        os.lseek(sfd, pos, os.SEEK_SET)
                        chunk = os.read(sfd, min(hole - pos, 1 << 22))
                        n = os.pwrite(dfd, chunk, pos)
                    if n <= 0:
                        raise OSError(f"short copy at {pos} of {src}")
                    pos += n
                off = hole
            if do_fsync:
                os.fsync(dfd)
            return size
        finally:
            os.close(dfd)
    finally:
        os.close(sfd)


def iter_arena_file(path: str) -> Iterator[Tuple[str, str]]:
    """Row iterator over a standalone arena file (snapshot restore into
    ANY table kind — the portable read side of the O(state) publish)."""
    a = Arena(path, writable=False)
    try:
        yield from a.items()
    finally:
        a.close()


# -- the table ------------------------------------------------------------

class ArenaModelTable:
    """Drop-in for ``serve.table.ModelTable`` backed by the shared arena.

    Same surface (put/put_many/put_many_columns/get/items/len, version +
    puts counters, change listeners, TSV checkpoint snapshot/restore) so
    every consumer of the table contract — top-k index, DOT index, the
    Python lookup server, MemoryStateBackend checkpoints — runs
    unchanged; what changes is WHERE rows live: one mmap'd file the C++
    server and the snapshotter read without a single per-row push."""

    kind = "arena"

    def __init__(self, n_shards: int = 8, dir: Optional[str] = None,
                 capacity: Optional[int] = None,
                 stride: Optional[int] = None,
                 key_cap: Optional[int] = None,
                 publish_mode: Optional[str] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards  # shard_of() parity for routing callers
        self.publish_mode = publish_mode or \
            os.environ.get("TPUMS_ARENA_PUBLISH", "copy")
        if self.publish_mode not in ("copy", "link"):
            raise ValueError("publish_mode must be copy|link")
        self.dir = dir or os.environ.get("TPUMS_ARENA_DIR") or \
            os.path.join(os.getcwd(), "arena")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.RLock()
        self.puts = 0
        self.version = 0
        self._listeners: List = []
        self._batch_listeners: List = []
        self._lock_fd = self._acquire_writer_lock(self.dir)
        # Observed row-size maxima drive the adaptive geometry in _grow.
        # Fresh arenas start at 0; attaching to an existing file seeds
        # them from its geometry (its rows are unscanned — never shrink
        # slabs below what might already be stored).
        self._max_klen = 0
        self._max_vlen = 0
        cur = current_path(self.dir)
        if cur is not None and os.path.exists(cur):
            self.arena = Arena(cur, writable=True)
            self._max_klen = self.arena.key_cap
            self._max_vlen = self.arena.stride
        else:
            self.arena = Arena.create(
                os.path.join(self.dir, gen_filename(0)),
                capacity or default_capacity(),
                stride or default_stride(),
                key_cap or default_key_cap(), 0)
            _write_current(self.dir, gen_filename(0))
        # Native batch writer (native/arena.cpp tpums_arena_put_batch):
        # maps the SAME generation file read-write and applies whole
        # columnar batches with zero Python bytecode per row.  Optional —
        # no toolchain (or TPUMS_ARENA_BATCH=0) leaves the pure-Python
        # path serving every write.  Reopened after every growth flip.
        self._writer_h: Optional[int] = None
        self._writer_lib = None
        self._native_batch = \
            os.environ.get("TPUMS_ARENA_BATCH", "1") != "0"
        self._reopen_native_writer()
        self._last_gauge_ts = 0.0
        self._publish_gauges()

    def _reopen_native_writer(self) -> None:
        """(Re)attach the C++ batch writer to the live generation file.
        Any failure — no compiler, stale lib without the writer ABI —
        degrades silently to the Python write path."""
        if self._writer_h is not None:
            self._writer_lib.tpums_arena_writer_close(self._writer_h)
            self._writer_h = None
        if not self._native_batch:
            return
        try:
            from .native_store import _load_lib

            lib = _load_lib()
            h = lib.tpums_arena_writer_open(
                self.arena.path.encode("utf-8"), self.dir.encode("utf-8"))
        except Exception:
            return
        if h:
            self._writer_lib = lib
            self._writer_h = h

    @staticmethod
    def _acquire_writer_lock(dir_: str) -> int:
        import fcntl

        fd = os.open(os.path.join(dir_, WRITER_LOCK),
                     os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            raise ArenaBusy(f"another live writer holds {dir_} "
                            "(flock) — one arena, one writer")
        os.write(fd, f"{os.getpid()}\n".encode())
        return fd

    # -- ModelTable surface ----------------------------------------------

    def add_change_listener(self, fn, batch_fn=None) -> None:
        with self._lock:
            self._listeners.append(fn)
            self._batch_listeners.append(batch_fn)

    def shard_of(self, key: str) -> int:
        return _fnv1a(key) % self.n_shards

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._put_locked(key.encode("utf-8"), value.encode("utf-8"))
            self.puts += 1
            self.version += 1
            for fn in self._listeners:
                fn(key)
            self._maybe_gauges()

    def put_many(self, pairs) -> None:
        pairs = list(pairs)
        if not pairs:
            return
        self.put_many_columns([k for k, _ in pairs], [v for _, v in pairs])

    def put_many_columns(self, keys, values, hashes=None) -> None:
        n = len(keys)
        if n == 0:
            return
        if not isinstance(keys, list):
            keys = list(keys)
        if not isinstance(values, list):
            values = list(values)
        # ALL encoding happens before the lock: the writer lock bounds
        # reader-visible seqlock windows and publish quiesce time, so it
        # must cover memory stores only — never per-row utf-8 encodes.
        kbuf = vbuf = None
        if self._writer_h is not None:
            kbuf = "\n".join(keys).encode("utf-8")
            vbuf = "\n".join(values).encode("utf-8")
            if (_nl_count(kbuf) != n - 1
                    or _nl_count(vbuf) != n - 1):
                # embedded newline in a row: the columnar framing can't
                # carry it — per-row path below
                kbuf = vbuf = None
        if kbuf is None:
            kbs = [k.encode("utf-8") for k in keys]
            vbs = [v.encode("utf-8") for v in values]
            if hashes is None and n >= 32:
                hashes = _fnv1a_batch(keys)
            hs = hashes.tolist() if hasattr(hashes, "tolist") else hashes
        with self._lock:
            if kbuf is not None:
                self._put_batch_locked(kbuf, vbuf, n)
            elif hs is None:
                for kb, vb in zip(kbs, vbs):
                    self._put_locked(kb, vb)
            else:
                for kb, vb, h in zip(kbs, vbs, hs):
                    self._put_locked(kb, vb, h)
            self.puts += n
            self.version += 1
            self._notify_locked(keys)
            self._maybe_gauges()

    def _put_batch_locked(self, kbuf: bytes, vbuf: bytes, n: int) -> None:
        """Apply a columnar batch through the C++ writer, falling back to
        the Python path for any row that needs growth (which rebuilds the
        file and reopens the native handle), then resuming natively."""
        lib = self._writer_lib
        t0 = time.perf_counter()
        native_rows = 0
        remaining = n
        while remaining > 0:
            mk = ctypes.c_uint32(0)
            mv = ctypes.c_uint32(0)
            applied = int(lib.tpums_arena_put_batch(
                self._writer_h, kbuf, len(kbuf), vbuf, len(vbuf),
                remaining, ctypes.byref(mk), ctypes.byref(mv)))
            if applied < 0:
                raise OSError("tpums_arena_put_batch failed")
            if mk.value > self._max_klen:
                self._max_klen = mk.value
            if mv.value > self._max_vlen:
                self._max_vlen = mv.value
            native_rows += applied
            remaining -= applied
            if remaining == 0:
                break
            # row `applied` needs growth: put it through the Python path
            # (grows + reopens the native writer), resume with the rest
            kbs = kbuf.split(b"\n")
            vbs = vbuf.split(b"\n")
            self._put_locked(kbs[applied], vbs[applied])
            remaining -= 1
            if remaining == 0:
                break
            kbuf = b"\n".join(kbs[applied + 1:])
            vbuf = b"\n".join(vbs[applied + 1:])
            if self._writer_h is None:
                # native writer did not survive the reopen: finish in
                # Python rather than spinning on applied == 0
                for kb, vb in zip(kbs[applied + 1:], vbs[applied + 1:]):
                    self._put_locked(kb, vb)
                remaining = 0
        dt = time.perf_counter() - t0
        if native_rows:
            _BATCH_ROWS.inc(native_rows)
            _BATCH_SECONDS.inc(dt)
            _BATCH_HIST.observe(dt)

    def cas_many_columns(self, keys: Sequence[str],
                         expected: Sequence[Optional[str]],
                         values: Sequence[str]) -> List[int]:
        """In-place compare-and-swap of whole value payloads: row ``i``
        flips to ``values[i]`` iff the stored bytes still equal
        ``expected[i]`` (seqlock odd/even preserved, so concurrent
        readers never see a torn row).  Returns the indices that did NOT
        swap — key missing, value drifted, ``expected[i] is None``, or
        geometry overflow — which the caller repairs with an LWW re-put.
        Swapped rows move puts/version and fire listeners like a put."""
        n = len(keys)
        if n == 0:
            return []
        kbs = [k.encode("utf-8") for k in keys]
        ebs = [e.encode("utf-8") if e is not None else None
               for e in expected]
        vbs = [v.encode("utf-8") for v in values]
        failed: List[int] = []
        swapped: List[str] = []
        retries = 0
        with self._lock:
            lib, h = self._writer_lib, self._writer_h
            for i in range(n):
                eb = ebs[i]
                if eb is None:
                    failed.append(i)
                    continue
                if h is not None:
                    rc = lib.tpums_arena_cas_floats(
                        h, kbs[i], len(kbs[i]), eb, len(eb),
                        vbs[i], len(vbs[i]))
                else:
                    # Python fallback: the table lock already excludes
                    # every other writer, so read-compare-put IS atomic
                    cur = self.arena.get_bytes(kbs[i])
                    if (cur is not None
                            and cur.encode("utf-8") == eb):
                        self._put_locked(kbs[i], vbs[i])
                        rc = 1
                    else:
                        rc = 0
                if rc == 1:
                    swapped.append(keys[i])
                elif rc == 0:
                    retries += 1
                    failed.append(i)
                else:
                    failed.append(i)
            if swapped:
                self.puts += len(swapped)
                self.version += 1
                self._notify_locked(swapped)
                self._maybe_gauges()
        if swapped:
            _CAS_SUCCESS.inc(len(swapped))
        if retries:
            _CAS_RETRY.inc(retries)
        return failed

    def _notify_locked(self, keys) -> None:
        for fn, batch_fn in zip(self._listeners, self._batch_listeners):
            if batch_fn is not None:
                batch_fn(keys)
            else:
                for key in keys:
                    fn(key)

    def get(self, key: str) -> Optional[str]:
        return self.arena.get(key)

    def __len__(self) -> int:
        return self.arena.count

    def items(self) -> Iterator[Tuple[str, str]]:
        return self.arena.items()

    def flush(self) -> None:
        with host_writeback(), self._lock:
            self.arena.flush()

    # -- write path + growth ---------------------------------------------

    def _put_locked(self, kb: bytes, vb: bytes,
                    h: Optional[int] = None) -> None:
        if len(kb) > self._max_klen:
            self._max_klen = len(kb)
        if len(vb) > self._max_vlen:
            self._max_vlen = len(vb)
        while not self.arena.put_bytes(kb, vb, h):
            self._grow(len(kb), len(vb))

    def _grow(self, need_klen: int, need_vlen: int) -> None:
        old = self.arena
        cap = old.capacity
        if old.count + 1 > (cap - (cap >> 3)):
            cap *= 2
        # Rehash is the one moment geometry is free to change, so fit the
        # slabs to OBSERVED row sizes (+25% headroom, 8-byte rounded)
        # instead of doubling the defaults: file size — hence publish
        # copy cost — tracks the payload, not the worst-case guess.
        def _fit(observed: int, need: int, floor: int) -> int:
            want = max(need, observed + (observed >> 2), floor)
            return (want + 7) & ~7

        stride = min(old.stride, _fit(self._max_vlen, need_vlen, 16))
        while stride < need_vlen:
            stride *= 2
        key_cap = min(old.key_cap, _fit(self._max_klen, need_klen, 8))
        while key_cap < need_klen:
            key_cap *= 2
        gen = old.generation + 1
        new = Arena.create(os.path.join(self.dir, gen_filename(gen)),
                           cap, stride, key_cap, gen)
        for k, v in old.items():
            if not new.put_bytes(k.encode("utf-8"), v.encode("utf-8")):
                raise RuntimeError("arena grow rehash overflow")
        _write_current(self.dir, gen_filename(gen))
        old.retire()  # attached readers remap through CURRENT
        self.arena = new
        self._reopen_native_writer()  # the old mapping is dead weight now
        try:
            os.unlink(old.path)  # live mappings keep the inode alive
        except OSError:
            pass

    # -- O(state) publish support ----------------------------------------

    def quiesce_copy(self, dst_path: str) -> dict:
        """Materialize the arena at ``dst_path`` with no writer racing it
        (the table lock IS the quiesce) and return the artifact's
        geometry for the snapshot manifest.

        ``publish_mode="copy"`` (default): reflink / sparse slot-run
        copy, zero serialize — a point-in-time immutable artifact.
        ``publish_mode="link"``: one hardlink, O(1) at ANY row count —
        the artifact shares the live inode, so rows mutated after
        publish show their newer values; sound here because restore
        always replays the journal from the manifest offset and the
        table is upsert-only LWW, so both converge to the same head
        state (torn/short decodes are caught structurally and fall down
        the bootstrap chain)."""
        with host_writeback():
            with self._lock:
                if self.publish_mode == "link":
                    copied = self.arena.link_to(dst_path)
                else:
                    # no msync first: the copy reads the same inode through
                    # the page cache (always coherent with our mmap stores);
                    # it is the DESTINATION that must be durable, and its
                    # fsync happens below, OUTSIDE the lock — writers stall
                    # only for the in-cache copy, not the disk flush
                    copied = self.arena.sparse_copy_to(dst_path)
                geom = {
                    "file": os.path.basename(dst_path),
                    "size": HEADER_SIZE + self.arena.capacity
                    * self.arena.slot_size,
                    "bytes_copied": copied,
                    "publish": self.publish_mode,
                    "rows": self.arena.count,
                    "capacity": self.arena.capacity,
                    "stride": self.arena.stride,
                    "key_cap": self.arena.key_cap,
                    "generation": self.arena.generation,
                }
            if self.publish_mode != "link":
                # link mode skips the data fsync: flushing would msync the
                # LIVE mapping, and the journal — not the artifact — is the
                # durability source there (a short decode after a crash is
                # detected and falls back to replay)
                fd = os.open(dst_path, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
            return geom

    # -- metrics ----------------------------------------------------------

    def _maybe_gauges(self) -> None:
        now = time.monotonic()
        if now - self._last_gauge_ts >= 0.5:
            self._last_gauge_ts = now
            self._publish_gauges()

    def _publish_gauges(self) -> None:
        try:
            from ..obs.metrics import get_registry

            reg = get_registry()
            a = self.arena
            reg.gauge("tpums_arena_resident_bytes").set(a.resident_bytes())
            reg.gauge("tpums_arena_rows").set(a.count)
            reg.gauge("tpums_arena_index_load_factor").set(
                a.count / a.capacity if a.capacity else 0.0)
        except Exception:
            pass

    # -- checkpoint parity (MemoryStateBackend cycle) ---------------------

    def snapshot(self, checkpoint_dir: str, offset: int) -> str:
        """Same TSV-per-shard checkpoint ``ModelTable.snapshot`` writes —
        the arena is the SERVING copy; the checkpoint stays portable
        across table kinds (the O(state) fast path is
        ``serve.snapshot.publish``'s arena format, not this)."""
        with self._lock:
            rows = list(self.arena.items())
        shards: List[List[Tuple[str, str]]] = [[] for _ in
                                               range(self.n_shards)]
        for k, v in rows:
            shards[self.shard_of(k)].append((k, v))
        chk_id = f"chk-{int(time.time() * 1000)}"
        tmp = os.path.join(checkpoint_dir, f".tmp-{chk_id}")
        os.makedirs(tmp, exist_ok=True)
        for idx, shard in enumerate(shards):
            with open(os.path.join(tmp, f"shard-{idx}.tsv"), "w") as f:
                for k, v in shard:
                    f.write(f"{k}\t{v}\n")
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump({"offset": offset, "n_shards": self.n_shards,
                       "ts": time.time()}, f)
        final = os.path.join(checkpoint_dir, chk_id)
        os.rename(tmp, final)
        with open(os.path.join(checkpoint_dir, "latest.tmp"), "w") as f:
            f.write(chk_id)
        os.replace(os.path.join(checkpoint_dir, "latest.tmp"),
                   os.path.join(checkpoint_dir, "latest"))
        from .table import ModelTable

        ModelTable._prune(checkpoint_dir, keep=2)
        return final

    def restore(self, checkpoint_dir: str) -> Optional[int]:
        latest_file = os.path.join(checkpoint_dir, "latest")
        if not os.path.exists(latest_file):
            return None
        with open(latest_file) as f:
            chk_id = f.read().strip()
        chk = os.path.join(checkpoint_dir, chk_id)
        with open(os.path.join(chk, "MANIFEST.json")) as f:
            manifest = json.load(f)
        keys: List[str] = []
        vals: List[str] = []
        for idx in range(int(manifest["n_shards"])):
            path = os.path.join(chk, f"shard-{idx}.tsv")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    k, _, v = line.partition("\t")
                    keys.append(k)
                    vals.append(v)
        self.put_many_columns(keys, vals)
        return int(manifest["offset"])

    def close(self) -> None:
        with host_writeback(), self._lock:
            if self._writer_h is not None:
                self._writer_lib.tpums_arena_writer_close(self._writer_h)
                self._writer_h = None
            self.arena.flush()
            self.arena.close()
            try:
                os.close(self._lock_fd)  # releases the flock
            except OSError:
                pass
