"""Last-writer-wins journal compaction: the Kafka compacted-topic property
the reference's model transport relies on, on the segmented journal.

Own copy of ``flink_ms_tpu/serve/compact.py``: the same key extraction,
fold and CLI, so a topic either package folds holds the same bytes and
replays to the same table in either package's job.  The journal itself is
format-agnostic, so key semantics live here: a fold pass reads every SEALED
segment, keeps only the LAST row per key (plus every malformed row
verbatim, so the consumer's skip-and-count parity is preserved exactly),
and hands the folded bytes back to ``Journal.compact_prefix`` for the
atomic segment swap.  Replaying (compacted prefix + tail) is
state-identical to replaying the full history: within the fold every key
carries its newest in-prefix value, and the untouched tail re-applies
anything newer in journal order.  Host code only: it does no device work.

Key extraction mirrors the chunk parser and per-row parsers byte for byte
(``core.formats.split_journal_chunk``, ``serve.consumer.parse_*_record``):

- ALS rows need >= 2 commas; key is ``"<id>-<T>"`` (first comma -> "-",
  key ends at the second comma).  Fewer commas = malformed -> kept.
- SVM rows split at the FIRST comma; a comma-less row IS its own key
  (``str.partition`` semantics) and is never malformed.

Knobs (all ``TPUMS_COMPACT_*``):

- ``TPUMS_COMPACT``            enable the background compactor in serving
                               jobs ("1"; default off)
- ``TPUMS_COMPACT_INTERVAL_S`` background fold cadence (default 30)
- ``TPUMS_COMPACT_MIN_SEGMENTS`` minimum sealed segments before a fold
                               pass bothers (default 2)

One compactor per journal directory: the fold/swap is crash-safe against
readers and the producer (atomic rename + shadowing), but two concurrent
compactors would duplicate work: the serving job runs the thread only on
worker 0 / replica 0 of a fleet, and an elastic worker also stands down
(``active_fn``) unless its topology generation is the group's ACTIVE one,
so a warming gen-g+1 fleet never folds the shared journal alongside the
still-active gen g.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core.formats import CHUNK_ALS, CHUNK_SVM
from .journal import Journal


def compact_interval_s() -> float:
    try:
        return max(
            float(os.environ.get("TPUMS_COMPACT_INTERVAL_S", 30.0)), 0.05
        )
    except ValueError:
        return 30.0


def compact_min_segments() -> int:
    try:
        return max(int(os.environ.get("TPUMS_COMPACT_MIN_SEGMENTS", 2)), 1)
    except ValueError:
        return 2


def compact_enabled() -> bool:
    return os.environ.get("TPUMS_COMPACT", "0") == "1"


# -- key extraction ----------------------------------------------------------

def als_key(line: str) -> Optional[str]:
    """``id,T,payload`` -> ``"id-T"``; None (malformed) below 2 commas."""
    i = line.find(",")
    if i < 0:
        return None
    jj = line.find(",", i + 1)
    if jj < 0:
        return None
    return f"{line[:i]}-{line[i + 1:jj]}"


def svm_key(line: str) -> Optional[str]:
    """``key,payload`` -> raw first token; a comma-less row is its own key
    (str.partition never fails a row)."""
    i = line.find(",")
    return line if i < 0 else line[:i]


_MODE_KEY_FNS: Dict[int, Callable[[str], Optional[str]]] = {
    CHUNK_ALS: als_key,
    CHUNK_SVM: svm_key,
}


def key_fn_for(parse_fn) -> Callable[[str], Optional[str]]:
    """Derive the per-line key extractor from a consumer parse function.

    Standard parsers advertise ``columnar_mode``.  Custom parsers fall
    back to calling ``parse_fn`` per line, treating a ValueError as
    malformed."""
    mode = getattr(parse_fn, "columnar_mode", None)
    if mode in _MODE_KEY_FNS:
        return _MODE_KEY_FNS[mode]

    def _kf(line: str) -> Optional[str]:
        try:
            parsed = parse_fn(line)
        except ValueError:
            return None
        return None if parsed is None else parsed[0]

    return _kf


# -- the fold ----------------------------------------------------------------

def fold_chunk(
    data: bytes, key_fn: Callable[[str], Optional[str]]
) -> Tuple[bytes, dict]:
    """Fold complete journal rows last-writer-wins per key.

    Keeps: the LAST occurrence of every key (in the position of that last
    occurrence, so per-key order is untouched) and every malformed row
    verbatim (the consumer skips-and-counts them; dropping any would break
    parse-error parity between compacted and full replay).  Empty lines
    are dropped — both ingest paths skip them silently."""
    text = data.decode("utf-8")
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    last: Dict[str, int] = {}
    keys: List[Optional[str]] = []
    for idx, line in enumerate(lines):
        stripped = line[:-1] if line.endswith("\r") else line
        if not stripped:
            keys.append(None)
            continue
        k = key_fn(stripped)
        keys.append(k)
        if k is not None:
            last[k] = idx
    kept: List[str] = []
    rows_in = 0
    malformed = 0
    for idx, line in enumerate(lines):
        stripped = line[:-1] if line.endswith("\r") else line
        if not stripped:
            continue  # empty line: state- and count-neutral
        rows_in += 1
        k = keys[idx]
        if k is None:
            malformed += 1
            kept.append(line)
        elif last[k] == idx:
            kept.append(line)
    out = ("\n".join(kept) + "\n").encode("utf-8") if kept else b""
    return out, {
        "rows_in": rows_in,
        "rows_out": len(kept),
        "rows_folded": rows_in - len(kept),
        "malformed_kept": malformed,
        "distinct_keys": len(last),
    }


def compact_journal(
    journal: Journal,
    parse_fn=None,
    key_fn: Optional[Callable[[str], Optional[str]]] = None,
    min_segments: Optional[int] = None,
) -> Optional[dict]:
    """One fold pass over the journal's sealed prefix.  Returns merged
    journal+fold stats, or None when there was nothing to fold."""
    if key_fn is None:
        if parse_fn is None:
            raise ValueError("compact_journal needs parse_fn or key_fn")
        key_fn = key_fn_for(parse_fn)
    if min_segments is None:
        min_segments = compact_min_segments()
    fold_stats: dict = {}

    def _fold(data: bytes) -> bytes:
        out, st = fold_chunk(data, key_fn)
        fold_stats.update(st)
        return out

    stats = journal.compact_prefix(_fold, min_segments=min_segments)
    if stats is None:
        return None
    stats.update(fold_stats)
    return stats


class CompactorThread(threading.Thread):
    """Background fold pass on a fixed cadence, stopping with its owner.

    Failures never propagate — a fold pass that loses a race (retention,
    a concurrent fold, the producer rotating) simply retries next tick.
    ``active_fn`` (checked fresh each tick) lets the owner stand the
    compactor down without stopping it: an elastic worker passes its
    am-I-the-active-generation check, so exactly one fleet folds the
    shared journal through a cutover."""

    def __init__(
        self,
        journal: Journal,
        parse_fn,
        interval_s: Optional[float] = None,
        min_segments: Optional[int] = None,
        stop_event: Optional[threading.Event] = None,
        active_fn: Optional[Callable[[], bool]] = None,
    ):
        super().__init__(name="journal-compactor", daemon=True)
        self.journal = journal
        self.key_fn = key_fn_for(parse_fn)
        self.interval_s = (
            compact_interval_s() if interval_s is None else interval_s
        )
        self.min_segments = (
            compact_min_segments() if min_segments is None else min_segments
        )
        # NOT self._stop: that would shadow threading.Thread's private
        # _stop() method and blow up inside Thread.join()
        self._stop_event = (
            stop_event if stop_event is not None else threading.Event()
        )
        self.active_fn = active_fn
        self.standdowns = 0
        self.passes = 0
        self.folds = 0
        self.rows_folded = 0
        self.bytes_reclaimed = 0
        self.last_stats: Optional[dict] = None
        self.last_error: Optional[str] = None

    def stop(self) -> None:
        self._stop_event.set()

    def run_once(self) -> Optional[dict]:
        self.passes += 1
        try:
            stats = compact_journal(
                self.journal, key_fn=self.key_fn,
                min_segments=self.min_segments,
            )
        except Exception as e:  # never kill the owner over a fold pass
            self.last_error = str(e)
            print(f"[compact] fold pass failed: {e}", file=sys.stderr)
            return None
        if stats is not None:
            self.folds += 1
            self.rows_folded += stats.get("rows_folded", 0)
            self.bytes_reclaimed += stats.get("bytes_reclaimed", 0)
            self.last_stats = stats
        return stats

    def run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            if self.active_fn is not None and not self.active_fn():
                # e.g. a warming elastic generation: the gen-g fleet is
                # still the journal's compactor; skip, re-check next tick
                self.standdowns += 1
                continue
            self.run_once()


def _main(argv=None) -> int:
    """``python -m flink_ms_tpu_torch.serve.compact --journalDir D --topic T
    [--mode als|svm] [--minSegments N]`` — one explicit fold pass.  The
    consumer's parsers key rows as ``als_key``/``svm_key`` do
    (``key_fn_for``), so the CLI takes the extractor directly and loads
    no torch."""
    from ..core.params import Params

    params = Params.from_args(sys.argv[1:] if argv is None else argv)
    journal = Journal(
        params.get_required("journalDir"), params.get_required("topic")
    )
    mode = params.get("mode", "als")
    t0 = time.perf_counter()
    stats = compact_journal(
        journal, key_fn=als_key if mode == "als" else svm_key,
        min_segments=params.get_int("minSegments", compact_min_segments()),
    )
    dt = time.perf_counter() - t0
    if stats is None:
        print("[compact] nothing to fold")
        return 0
    rate = stats["rows_in"] / dt if dt > 0 else 0.0
    print(
        f"[compact] folded {stats['segments_folded']} segments: "
        f"{stats['rows_in']} -> {stats['rows_out']} rows "
        f"({stats['bytes_reclaimed']} B reclaimed) in {dt:.3f}s "
        f"({rate:,.0f} rows/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(_main())
