"""Model loader: counterpart of ``ALSKafkaProducer`` / ``SVMKafkaProducer``.

Own copy of ``flink_ms_tpu/serve/producer.py``.  Streams model text files
(a file or a nested directory, ``TextInputFormat(nested=true)``) into a
journal topic with fsync'd appends (at-least-once, the analog of
``setFlushOnCheckpoint(true)``).  ``--flushInterval`` (ms, default 60000,
the reference's checkpoint interval) fsyncs the journal on that cadence
during the load; 0 keeps only the end-of-stream fsync.  ``--segmentBytes``
rolls the topic into sealed segments and ``--retainSegments`` deletes the
oldest beyond N.  One module serves both ALS and SVM:

    python -m flink_ms_tpu_torch.serve.als_producer --input model_dir \\
        --journalDir journal --topic als-model
"""

from __future__ import annotations

import sys
import time

from ..core import formats as F
from ..core.params import Params
from .journal import Journal

_BATCH = 10_000


def run(params: Params, label: str = "ALS") -> int:
    # optional Kafka-parity log bounding: --segmentBytes rolls the topic
    # into sealed segments, --retainSegments deletes the oldest beyond N
    seg = params.get_int("segmentBytes", 0) or None
    retain = params.get_int("retainSegments", 0) or None
    journal = Journal(
        params.get_required("journalDir"), params.get_required("topic"),
        segment_bytes=seg, retain_segments=retain,
    )
    input_path = params.get_required("input")
    flush_interval_s = params.get_int("flushInterval", 60_000) / 1000.0
    next_flush = time.monotonic() + flush_interval_s
    n = 0
    batch = []
    for line in F.iter_lines(input_path):
        batch.append(line)
        # the flush deadline is checked per line, not only when a 10k
        # batch fills: a source slower than _BATCH lines per interval must
        # still bound crash loss to one interval (flushOnCheckpoint parity)
        flush_now = flush_interval_s > 0 and time.monotonic() >= next_flush
        if len(batch) >= _BATCH or flush_now:
            journal.append(batch, flush=flush_now)
            if flush_now:
                next_flush = time.monotonic() + flush_interval_s
            n += len(batch)
            batch = []
    if batch:
        n += len(batch)
    journal.append(batch, flush=True)  # final fsync = the checkpoint flush
    print(f"[{label}] model-loading: {n} rows -> topic '{journal.topic}'")
    return n


def als_main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv), label="ALS")


def svm_main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv), label="SVM")
