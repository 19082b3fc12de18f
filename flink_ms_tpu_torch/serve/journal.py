"""The model journal's writer: a subset of ``flink_ms_tpu/serve/journal.py``.

A topic is an append-only log of text lines under a journal directory.
The port writes only its first segment, ``<topic>.log`` (base offset 0),
whose offsets are byte positions in that file: ``Journal(journal_dir,
topic)`` with ``append`` and ``sync``, with the on-disk format unchanged,
so the JAX package's readers (its consumer, its autopilot's
``_read_journal_lines``) read what the port writes.  ``read_lines`` reads
that segment back whole.  Segment rolling, retention, compaction and
offset reads are not ported (ROADMAP.md, Queue 1, item 'Serving job').
"""

from __future__ import annotations

import os
import threading
from typing import Iterable, List


class Journal:
    """One topic inside a journal directory."""

    def __init__(self, journal_dir: str, topic: str):
        if not topic or "/" in topic or topic.startswith("."):
            raise ValueError(f"invalid topic name: {topic!r}")
        self.dir = journal_dir
        self.topic = topic
        os.makedirs(journal_dir, exist_ok=True)
        self.path = os.path.join(journal_dir, f"{topic}.log")  # base-0 segment
        self._lock = threading.Lock()

    def append(self, lines: Iterable[str], flush: bool = True) -> int:
        """Append lines; returns the end offset.  ``flush`` fsyncs (the
        producer's flushOnCheckpoint, at-least-once)."""
        with self._lock:
            with open(self.path, "a") as f:
                for line in lines:
                    if "\n" in line:
                        raise ValueError("journal records are single lines")
                    f.write(line)
                    f.write("\n")
                f.flush()
                if flush:
                    os.fsync(f.fileno())
                return f.tell()

    def sync(self) -> None:
        """fsync the segment without writing: the checkpoint flush for
        producers appending with ``flush=False``."""
        with self._lock:
            try:
                with open(self.path, "a") as f:
                    os.fsync(f.fileno())
            except FileNotFoundError:
                pass

    def read_lines(self) -> List[str]:
        """Every complete line of the topic, in offset order (a tail
        without its newline is not yet a record)."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return []
        return data[:data.rfind(b"\n") + 1].decode().splitlines()
