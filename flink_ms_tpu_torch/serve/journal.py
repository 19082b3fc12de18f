"""Replayable ingest journal: the stand-in for the reference's Kafka 0.10
model bus (SURVEY.md §2.5).

Own copy of ``flink_ms_tpu/serve/journal.py``, with the same files and the
same offsets, so either package reads what the other wrote.  A topic is an
append-only log of text lines under a journal directory.  Producers append
model rows (at-least-once, ``ALSKafkaProducer.java:29-37``); consumers poll
from a byte offset and commit it in their checkpoints, so a replay after a
failure re-delivers rows, which the last-writer-wins table absorbs.

Topics are segmented like Kafka's log: appends go to the active segment;
with ``segment_bytes`` a full segment is sealed and a new one starts at the
current end offset, and ``retain_segments`` deletes the oldest sealed
segments.  Offsets are global byte positions (segment base + position),
contiguous across rotation.  Segment files are ``<topic>.log`` (base 0),
``<topic>.log.<base>``, and ``<topic>.clog.<base>.<logical_end>`` for a
compacted prefix: the JAX package's compactor folds sealed segments
last-writer-wins per key into one such file, which carries its base and the
logical end of the history it replaced.  The port reads compacted topics
(a reader at the base gets the folded rows, then continues at
``logical_end``) and appends after a fold; the fold itself
(``compact_prefix``, ``serve/compact.py``) is not ported yet (ROADMAP.md,
Queue 1, item 'Snapshot bootstrap and compaction').

A reader whose offset points at history that no longer exists byte for byte
gets a typed ``OffsetTruncatedError``, never a silent skip: below the
earliest retained base the rows are gone (``lossless=False``); strictly
inside a compacted prefix they were folded (``lossless=True``: resuming at
the prefix base re-reads a last-writer-wins superset).
``on_truncated="reset"`` resumes at the earliest offset instead, counting
what it skipped.  ``read_lines`` reads the whole topic back (the
autopilot's journal reader).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterable, List, NamedTuple, Optional, Tuple


class OffsetTruncatedError(RuntimeError):
    """A reader's offset points at journal history that no longer exists
    byte-for-byte.

    Attributes:
        offset:        the offset the reader asked for
        resume_offset: the earliest offset a replay may resume from
        lossless:      True when resuming at ``resume_offset`` re-delivers
                       a last-writer-wins superset of the missing range (a
                       compacted prefix); False when the rows are gone
                       (retention deleted them) and resuming skips data
    """

    def __init__(self, offset: int, resume_offset: int, lossless: bool,
                 reason: str):
        super().__init__(
            f"offset {offset} truncated ({reason}); resume at "
            f"{resume_offset} ({'lossless' if lossless else 'LOSSY'})"
        )
        self.offset = offset
        self.resume_offset = resume_offset
        self.lossless = lossless
        self.reason = reason


class _Seg(NamedTuple):
    base: int
    path: str
    # logical end offset for a COMPACTED segment (the history it replaced
    # ran [base, logical_end)); None for a plain segment
    logical_end: Optional[int]


class Journal:
    """One topic inside a journal directory."""

    def __init__(
        self,
        journal_dir: str,
        topic: str,
        segment_bytes: Optional[int] = None,
        retain_segments: Optional[int] = None,
    ):
        if not topic or "/" in topic or topic.startswith("."):
            raise ValueError(f"invalid topic name: {topic!r}")
        if segment_bytes is not None and segment_bytes < 1:
            raise ValueError("segment_bytes must be >= 1")
        if retain_segments is not None and retain_segments < 1:
            raise ValueError("retain_segments must be >= 1")
        self.dir = journal_dir
        self.topic = topic
        self.segment_bytes = segment_bytes
        self.retain_segments = retain_segments
        os.makedirs(journal_dir, exist_ok=True)
        self.path = os.path.join(journal_dir, f"{topic}.log")  # base-0 segment
        self._lock = threading.Lock()
        self.expired_bytes_skipped = 0  # consumer-side observability
        self.torn_bytes_skipped = 0     # newline-less tails of sealed segments
        self.compacted_rereads = 0      # reset-mode restarts into a fold
        self._seg_cache: Optional[List[_Seg]] = None
        # producer-side (dir_mtime_ns, base, path) — see _active_segment
        self._active_cache: Optional[Tuple[int, int, str]] = None

    # -- segment layout ------------------------------------------------------

    def _scan(self) -> List[_Seg]:
        """All raw segment files on disk, sorted by (base, plain-first)."""
        plain = f"{self.topic}.log"
        clog = f"{self.topic}.clog."
        out: List[_Seg] = []
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        for name in names:
            if name == plain:
                out.append(_Seg(0, os.path.join(self.dir, name), None))
            elif name.startswith(plain + "."):
                suffix = name[len(plain) + 1:]
                try:
                    out.append(
                        _Seg(int(suffix), os.path.join(self.dir, name), None)
                    )
                except ValueError:
                    continue  # unrelated file
            elif name.startswith(clog):
                parts = name[len(clog):].split(".")
                if len(parts) != 2:
                    continue  # in-flight tmp file or unrelated
                try:
                    base, lend = int(parts[0]), int(parts[1])
                except ValueError:
                    continue
                if lend > base:
                    out.append(
                        _Seg(base, os.path.join(self.dir, name), lend)
                    )
        out.sort(key=lambda s: (s.base, s.logical_end is None,
                                -(s.logical_end or 0)))
        return out

    @staticmethod
    def _shadow(raw: List[_Seg]) -> List[_Seg]:
        """Resolve the reader view: a compacted segment shadows every
        segment whose base falls inside its [base, logical_end) range —
        the plain originals it folded (kept briefly during the atomic
        swap, or left by a crash mid-cleanup) and any older, narrower
        fold."""
        folds = [s for s in raw if s.logical_end is not None]
        view: List[_Seg] = []
        for s in raw:
            shadowed = any(
                f is not s
                and f.base <= s.base < f.logical_end
                and (s.logical_end is None or s.logical_end <= f.logical_end)
                for f in folds
            )
            if not shadowed:
                view.append(s)
        return view

    def _view(self) -> List[_Seg]:
        return self._shadow(self._scan())

    def _view_cached(self, refresh: bool = False) -> List[_Seg]:
        """Consumer-side segment view; one os.listdir only when the cache
        is cold, explicitly refreshed, or the topic has no known segments
        (a poll on the hot path must not list the whole journal dir)."""
        if refresh or not self._seg_cache:
            self._seg_cache = self._view()
        return self._seg_cache

    def _active_segment(self) -> Tuple[int, str]:
        """The append target: the highest-base plain segment, or a fresh
        plain segment at ``logical_end`` when the whole log is one fold.

        One os.stat of the directory validates a cached answer: a roll,
        fold or truncation by ANY process creates or removes a directory
        entry and therefore bumps the dir mtime, while plain appends do
        not — so a matching mtime proves the cached layout is current
        (the per-append os.listdir was a measured hot spot once the
        update plane put 30+ producer topics in one journal dir).  A
        fresh mtime is never cached: filesystem timestamps tick coarsely,
        and a concurrent roll inside the same tick would otherwise stay
        invisible forever."""
        try:
            dir_mtime = os.stat(self.dir).st_mtime_ns
        except OSError:
            dir_mtime = None
        cached = self._active_cache
        if cached is not None and dir_mtime is not None \
                and cached[0] == dir_mtime:
            return cached[1], cached[2]
        self._active_cache = None
        base, path = self._active_segment_scan()
        if dir_mtime is not None and \
                time.time_ns() - dir_mtime > 50_000_000:
            self._active_cache = (dir_mtime, base, path)
        return base, path

    def _active_segment_scan(self) -> Tuple[int, str]:
        view = self._view()
        if not view:
            return 0, self.path
        last = view[-1]
        if last.logical_end is not None:
            # fully-compacted log: appends restart a plain segment exactly
            # at the fold's logical end, keeping offsets contiguous
            return last.logical_end, os.path.join(
                self.dir, f"{self.topic}.log.{last.logical_end}"
            )
        return last.base, last.path

    # -- producer side -------------------------------------------------------

    def append(self, lines: Iterable[str], flush: bool = True) -> int:
        """Append lines; returns the end offset.  ``flush`` fsyncs — the
        analog of the producer's flushOnCheckpoint (at-least-once)."""
        with self._lock:
            base, path = self._active_segment()
            try:
                size = os.path.getsize(path)
            except FileNotFoundError:
                size = 0
            if (
                self.segment_bytes is not None
                and size >= self.segment_bytes
            ):
                # Seal the segment.  Two invariants are established here:
                # (1) durability — sync()/flush=True only reach the ACTIVE
                # segment, so the sealed one must be fsynced now or a crash
                # could drop its page-cache tail while later segments
                # survive; (2) newline termination — a torn tail from a
                # crashed producer can never complete once sealed, so it
                # is terminated into a malformed row the consumer's
                # skip-and-count policy handles, instead of wedging every
                # consumer at a line that never ends.
                with open(path, "rb+") as sf:
                    sf.seek(0, os.SEEK_END)
                    if sf.tell() > 0:
                        sf.seek(-1, os.SEEK_END)
                        if sf.read(1) != b"\n":
                            sf.write(b"\n")
                    sf.flush()
                    os.fsync(sf.fileno())
                    size = sf.tell()
                base = base + size
                path = os.path.join(
                    self.dir, f"{self.topic}.log.{base}"
                )
                self._apply_retention_locked()
            with open(path, "a") as f:
                for line in lines:
                    if "\n" in line:
                        raise ValueError("journal records are single lines")
                    f.write(line)
                    f.write("\n")
                f.flush()
                if flush:
                    os.fsync(f.fileno())
                return base + f.tell()

    def _apply_retention_locked(self) -> None:
        raw = self._scan()
        view = self._shadow(raw)
        # leftovers a fold superseded are garbage regardless of policy:
        # delete them (also finishes the cleanup a compactor crash left)
        visible = {s.path for s in view}
        for s in raw:
            if s.path not in visible:
                try:
                    os.remove(s.path)
                except OSError:
                    pass
        if self.retain_segments is None:
            return
        if any(s.logical_end is not None for s in view):
            # compacted prefix present: retention is "compacted prefix +
            # tail".  Blind deletion of sealed tail segments would strand
            # readers AND race the compactor that is about to fold them —
            # the compactor bounds disk by folding, not retention.
            return
        # +1: the about-to-be-created active segment counts toward the bound
        excess = len(view) + 1 - self.retain_segments
        for s in view[:max(excess, 0)]:
            try:
                os.remove(s.path)
            except OSError:
                pass

    def sync(self) -> None:
        """fsync the active segment without writing — the checkpoint-boundary
        flush for producers appending with ``flush=False``."""
        with self._lock:
            _, path = self._active_segment()
            try:
                with open(path, "a") as f:
                    os.fsync(f.fileno())
            except FileNotFoundError:
                pass

    # -- consumer side -------------------------------------------------------

    def start_offset(self) -> int:
        """Earliest retained offset (0 unless retention expired segments)."""
        view = self._view()
        return view[0].base if view else 0

    def end_offset(self) -> int:
        base, path = self._active_segment()
        try:
            return base + os.path.getsize(path)
        except FileNotFoundError:
            return base

    def aligned_end_offset(self) -> int:
        """End offset clamped to the last record boundary: a producer
        mid-append leaves a newline-less tail that ``end_offset`` counts
        but no reader may start inside (consumers seeded at ``latest``
        use this so their first poll is line-aligned)."""
        base, path = self._active_segment()
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                pos = size
                while pos > 0:
                    step = min(1 << 16, pos)
                    f.seek(pos - step)
                    chunk = f.read(step)
                    nl = chunk.rfind(b"\n")
                    if nl >= 0:
                        return base + pos - step + nl + 1
                    pos -= step
        except FileNotFoundError:
            pass
        return base

    def tail_line(self) -> Optional[str]:
        """The last COMPLETE record of the topic, or None when empty.

        The O(tail) watermark read of the update plane
        (``serve/update_plane.py``): recovery and progress polling need
        only the newest committed record, not a full replay.  Same
        reverse-scan idiom as ``aligned_end_offset``; a newline-less torn
        tail (producer mid-append / SIGKILLed) is skipped — by
        construction it was never committed."""
        for seg in reversed(self._view()):
            try:
                with open(seg.path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    pos = f.tell()
                    if pos == 0:
                        continue
                    buf = b""
                    while pos > 0:
                        step = min(1 << 16, pos)
                        f.seek(pos - step)
                        buf = f.read(step) + buf
                        pos -= step
                        # need the terminator of the last complete line AND
                        # the newline (or BOF) that precedes it
                        if buf.count(b"\n") >= 2:
                            break
            except (FileNotFoundError, OSError):
                continue
            last_nl = buf.rfind(b"\n")
            if last_nl < 0:
                continue  # only a torn tail in this segment: look earlier
            start = buf.rfind(b"\n", 0, last_nl) + 1
            return buf[start:last_nl].decode("utf-8")
        return None

    def read_bytes_from(
        self, offset: int, max_bytes: int = 1 << 24,
        on_truncated: str = "raise",
    ) -> Tuple[bytes, int]:
        """Poll the raw complete-lines byte chunk after ``offset`` —
        (chunk ending at its last newline, next_offset).  The zero-decode
        variant of ``read_from`` for native bulk ingest.

        An offset pointing at history that no longer exists byte-for-byte
        (expired by retention, or folded into a compacted prefix) raises
        ``OffsetTruncatedError`` so the caller can bootstrap from a
        snapshot instead of silently skipping rows.
        ``on_truncated="reset"`` opts back into the old
        ``auto.offset.reset=earliest`` behavior: resume at the earliest
        replayable offset, counting lost bytes in
        ``expired_bytes_skipped`` (a compacted-prefix restart is lossless
        and counts in ``compacted_rereads`` instead).

        A read that lands exactly on a compacted prefix base returns the
        WHOLE folded prefix in one chunk, ``max_bytes`` notwithstanding:
        intermediate positions inside a fold are not valid offsets (the
        fold is O(state), the same bound as a snapshot bulk-load).
        """
        if on_truncated not in ("raise", "reset"):
            raise ValueError("on_truncated must be raise|reset")
        try:
            out = self._try_read(offset, max_bytes, refresh=False)
            if out is not None and (out[0] or out[1] != offset):
                return out
            # nothing advanced with the cached layout: rescan once — a new
            # segment may have been rolled, retention may have moved the
            # earliest base, or a fold may have replaced the prefix — then
            # report whatever the fresh view yields
            out = self._try_read(offset, max_bytes, refresh=True)
            return out if out is not None else (b"", offset)
        except OffsetTruncatedError as e:
            if on_truncated != "reset":
                raise
            if e.lossless:
                self.compacted_rereads += 1
            else:
                self.expired_bytes_skipped += e.resume_offset - offset
            return self.read_bytes_from(
                e.resume_offset, max_bytes, on_truncated="reset"
            )

    def _try_read(
        self, offset: int, max_bytes: int, refresh: bool
    ) -> Optional[Tuple[bytes, int]]:
        segs = self._view_cached(refresh)
        if not segs:
            return None
        if offset < segs[0].base:
            if not refresh:
                return None  # stale cache must not fabricate a truncation
            raise OffsetTruncatedError(
                offset, segs[0].base, lossless=False,
                reason="below earliest retained segment",
            )
        seg = segs[0]
        for s in reversed(segs):
            if offset >= s.base:
                seg = s
                break
        if seg.logical_end is not None:
            return self._read_compacted(seg, offset, max_bytes, refresh)
        base, path = seg.base, seg.path
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(offset - base)
                chunk = f.read(max_bytes)
        except FileNotFoundError:  # expired/folded between scan and read
            return None
        sealed_end = next(
            (s.base for s in segs if s.base > base), None
        )  # this segment is sealed iff a later one exists
        if not chunk:
            if sealed_end is not None and offset >= base + size:
                # end of a sealed segment: roll into the next
                return self._try_read(sealed_end, max_bytes, False)
            return b"", offset
        last_nl = chunk.rfind(b"\n")
        if last_nl < 0:
            if sealed_end is not None and offset - base + len(chunk) >= size:
                # newline-less tail of a SEALED segment (e.g. sealed by an
                # external writer): it can never complete — skip it with a
                # counter rather than wedging at it forever.  (Rotation in
                # append() newline-terminates before sealing, so this is
                # the defensive path.)
                self.torn_bytes_skipped += len(chunk)
                return self._try_read(sealed_end, max_bytes, False)
            return b"", offset
        complete = chunk[: last_nl + 1]
        return complete, offset + len(complete)

    def _read_compacted(
        self, seg: _Seg, offset: int, max_bytes: int, refresh: bool
    ) -> Optional[Tuple[bytes, int]]:
        assert seg.logical_end is not None
        if offset >= seg.logical_end:
            # at/past the fold's logical end with no later segment visible
            # (the tail normally starts exactly there): nothing to read yet
            return b"", offset
        if offset != seg.base:
            # A byte offset strictly inside the folded range indexes the
            # OLD byte stream; the fold has a different physical layout,
            # so the position is untranslatable.  Restarting at the base
            # re-reads the fold — a last-writer-wins superset of what the
            # reader already applied — hence lossless.
            if not refresh:
                return None
            raise OffsetTruncatedError(
                offset, seg.base, lossless=True,
                reason="inside compacted prefix",
            )
        try:
            with open(seg.path, "rb") as f:
                content = f.read()
        except FileNotFoundError:  # superseded by a newer fold mid-read
            return None
        if not content:
            # everything in the prefix was superseded: continue at the tail
            return self._try_read(seg.logical_end, max_bytes, False)
        return content, seg.logical_end

    def read_from(
        self, offset: int, max_bytes: int = 1 << 24,
        on_truncated: str = "raise",
    ) -> Tuple[List[str], int]:
        """Poll records after `offset`; returns (lines, next_offset).

        Only complete lines are returned; a torn tail (producer mid-append)
        stays unconsumed until its newline lands.  Truncated offsets raise
        ``OffsetTruncatedError`` (see ``read_bytes_from``).
        """
        complete, next_offset = self.read_bytes_from(
            offset, max_bytes, on_truncated=on_truncated
        )
        if not complete:
            return [], next_offset
        return complete.decode("utf-8").splitlines(), next_offset

    def read_lines(self) -> List[str]:
        """Every complete line of the topic in offset order, from the
        earliest retained offset (a compacted prefix reads as its folded
        rows; a tail without its newline is not yet a record)."""
        out: List[str] = []
        off = self.start_offset()
        while True:
            lines, nxt = self.read_from(off, on_truncated="reset")
            if not lines and nxt == off:
                return out
            out.extend(lines)
            off = nxt
