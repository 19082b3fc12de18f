"""Serving job: counterpart of ``ALSKafkaConsumer`` / ``SVMKafkaConsumer``
(``ALSKafkaConsumer.java``, ``SVMKafkaConsumer.java``).

Own copy of the standalone job of ``flink_ms_tpu/serve/consumer.py``:

    journal topic  ->  poll  ->  parse rows  ->  keyed put into the sharded
    model table    ->  the table is queryable through the lookup server

with the reference's operational envelope:

- periodic checkpoints (``ALSKafkaConsumer.java:44-46``): between polls the
  consume loop writes (table, journal offset) through the state backend
  every ``checkpoint_interval_ms``, deferred while a replay backlog is live
  (every poll still moving at least half a chunk), but never past
  ``CHECKPOINT_MAX_DEFER_INTERVALS`` intervals;
- fixed-delay restart (3 attempts, 10 s, :48-51): the consume loop runs
  under a supervisor that restores the last checkpoint and replays the
  journal from its offset (at-least-once; duplicates are last-writer-wins);
- state backends (:53-65): ``memory`` (snapshots held in RAM), ``fs``
  (``ModelTable.snapshot`` directories under ``--checkpointDataUri``, the
  JAX package's files, so either package restores the other's) and
  ``rocksdb`` (the C++ persistent store of ``serve/native_store.py``, whose
  table is the store itself: a checkpoint is a flush and an offset marker;
  when the library cannot be built the job falls back to ``fs`` with a
  message, as the reference does);
- tables (``--table`` / ``TPUMS_TABLE``): ``dict`` (the in-RAM sharded
  ``ModelTable``, or the rocksdb backend's own table) or ``arena`` (the
  shared-memory ``serve/arena.py`` table under
  ``<journalDir>/<topic>.arena-<state>-w<i>of<n>-r<r>-g<g>``, which the
  native server and the snapshotter read in place).  Fleet members (a
  ``shard_filter``, ``replica_of``, ``topology_group`` or ``generation``)
  default to the arena unless ``TPUMS_TABLE=dict``; standalone jobs keep
  the dict table.  The job prints its table kind at start;
- ingest (``TPUMS_INGEST_MODE`` / ``--ingestMode``): ``columnar`` splits
  whole byte chunks with numpy and applies them with
  ``put_many_columns``; ``scalar`` parses line by line; ``auto`` picks
  columnar whenever the parser has a columnar mode; a rocksdb table with
  no change listeners takes the ``native`` path instead (one C++ call
  parses and stores a whole chunk, ``tpums_ingest_buf``);
- readiness: the job reports ``replaying`` until it has consumed the
  backlog that existed when it came up, then ``ready`` (HEALTH, and the
  registry entry it heartbeats every ``TPUMS_HEARTBEAT_S``);
- snapshots (``serve/snapshot.py``, on unless ``TPUMS_SNAPSHOTS=0`` or
  ``snapshots=False``, as in the reference): the job publishes a columnar
  snapshot of its table at ready and at checkpoints, once at least
  ``TPUMS_SNAPSHOT_MIN_BYTES`` (1 MiB) of journal landed since the last
  one; a (re)start lays the newest valid snapshot ahead of its checkpoint
  (or of offset 0) over the table and replays only the tail behind it
  (``bootstrap_source`` ``"snapshot"``);
- compaction (``serve/compact.py``, off unless ``TPUMS_COMPACT=1`` or
  ``compact=True``): a background thread folds the journal's sealed
  segments last-writer-wins on ``TPUMS_COMPACT_INTERVAL_S``; in a fleet
  only worker 0 of replica 0 runs it, and an elastic worker stands it down
  each tick unless its generation is the group's active one;
- the fleet (``serve/sharded.py``, ``ha.py``, ``elastic.py``): a parser
  with a ``shard_filter`` (``sharded_parse``) keeps only the rows its
  worker owns (``fnv1a(key) % N``, vectorised on the columnar path) and
  snapshots its slice; ``replica_of``/``replica_index`` register the job
  as a member of a replica set, and ``topology_group``/``generation`` as a
  worker of one topology generation, whose heartbeat re-reads the group's
  active generation into HEALTH's ``topology_gen``.

For the ALS state the lookup server's TOPK/TOPKV run on the device-resident
factor index of ``serve/topk.py`` on ``device`` (default ``cuda``; no
fallback: a job asking for CUDA on a host without it raises before any
socket opens).  ``topk_index=False`` (``--topkIndex false``) serves without
it and needs no device.  ``--nativeServer true`` serves from the C++ epoll
server instead, over the rocksdb store or the arena, which answers
TOPK/TOPKV on the host as the reference's does, and needs no device.

A geo-replication follower (a journal that ``serve/georepl.py``'s
replicator writes, with ``<topic>.georepl.json`` beside it) is served like
any journal: an ``st=1`` read answers the follower's staleness from that
record, and ``0.000`` on the home region.

Key derivation:
- ALS rows ``id,T,factors`` -> key ``"<id>-<T>"`` (ALSKafkaConsumer.java:75-82)
- SVM rows ``first,rest``   -> key = raw first CSV token (featureID or
  bucket, SVMKafkaConsumer.java:74-82)
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
import uuid
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core.formats import CHUNK_ALS, CHUNK_SVM, split_journal_chunk
from ..core.params import Params
from ..obs import metrics as obs_metrics
from ..obs import profiler as obs_profiler
from ..obs import tracing as obs_tracing
from . import registry
from . import snapshot as snapshot_mod
from .compact import CompactorThread, compact_enabled
from .journal import Journal, OffsetTruncatedError
from .server import LookupServer
from .table import ModelTable, _fnv1a_batch

ALS_STATE = "ALS_MODEL"
SVM_STATE = "SVM_MODEL"


def parse_als_record(line: str) -> Tuple[str, str]:
    id_, typ, payload = line.split(",", 2)
    return f"{id_}-{typ}", payload


def parse_svm_record(line: str) -> Tuple[str, str]:
    key, _, payload = line.partition(",")
    return key, payload


# columnar chunk-parse modes (core.formats.split_journal_chunk mirrors these
# parsers line for line).  A parse_fn without the attribute always takes the
# scalar per-line path.
parse_als_record.columnar_mode = CHUNK_ALS
parse_svm_record.columnar_mode = CHUNK_SVM
# native bulk-ingest modes (``tpums_ingest_buf`` mirrors the two parsers
# byte for byte)
parse_als_record.native_mode = 0
parse_svm_record.native_mode = 1


# ---------------------------------------------------------------------------
# state backends
# ---------------------------------------------------------------------------

class MemoryStateBackend:
    """Snapshots kept in process RAM: they survive consume-loop restarts
    inside the job and are lost with the process (MemoryStateBackend)."""

    kind = "memory"

    def __init__(self):
        self._snap: Optional[Tuple[int, List[dict]]] = None

    def snapshot(self, table: ModelTable, offset: int) -> None:
        if not hasattr(table, "_shards"):
            # arena table: the rows live in the mapped file and survive a
            # consume-loop restart on their own, so the offset marker is
            # the whole snapshot (replay from it is last-writer-wins)
            table.flush()
            self._snap = (offset, None)
            return
        with table._lock:
            self._snap = (offset, [dict(s) for s in table._shards])

    def restore(self, table: ModelTable) -> Optional[int]:
        if self._snap is None:
            return None
        offset, shards = self._snap
        if shards is None:
            return offset
        with table._lock:
            table._shards = [dict(s) for s in shards]
            table.version += 1
        return offset


class FsStateBackend:
    """Snapshot directories under the checkpoint URI (FsStateBackend)."""

    kind = "fs"

    def __init__(self, checkpoint_uri: str):
        self.dir = checkpoint_uri
        os.makedirs(self.dir, exist_ok=True)

    def snapshot(self, table: ModelTable, offset: int) -> None:
        table.snapshot(self.dir, offset)

    def restore(self, table: ModelTable) -> Optional[int]:
        return table.restore(self.dir)


def make_backend(kind: str, checkpoint_uri: Optional[str]):
    if kind == "memory":
        return MemoryStateBackend()
    if kind == "fs":
        if not checkpoint_uri:
            raise ValueError("fs state backend requires --checkpointDataUri")
        return FsStateBackend(checkpoint_uri)
    if kind == "rocksdb":
        if not checkpoint_uri:
            raise ValueError(
                "rocksdb state backend requires --checkpointDataUri")
        from .native_store import NativeStateBackend, StoreLockedError

        try:
            return NativeStateBackend(checkpoint_uri)
        except StoreLockedError:
            # another serving job owns this store: fs snapshots in the same
            # dir would silently fork the state
            raise
        except Exception as e:
            # no compiler or a failed build: fs snapshots still keep the
            # checkpoint contract
            print(f"[serve] native store unavailable ({e}); rocksdb mode "
                  "falling back to fs snapshots", file=sys.stderr)
            return FsStateBackend(checkpoint_uri)
    raise ValueError(
        f"unknown state backend: {kind} (use rocksdb|fs|memory)")


def _select_table(table: Optional[str], fleet: bool, backend) -> str:
    """``--table`` / ``TPUMS_TABLE``, else the default: the arena for a
    fleet member, unless the backend brings its own durable table
    (rocksdb), and the dict table for a standalone job."""
    if table is None:
        table = os.environ.get("TPUMS_TABLE")
    if table is None:
        table = ("arena" if fleet and not hasattr(backend, "make_table")
                 else "dict")
    if table not in ("dict", "arena"):
        raise ValueError("table must be dict|arena")
    return table


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------

class ServingJob:
    # a wall-clock checkpoint is deferred while a replay backlog is live
    # (every poll still moving >= half a chunk cap of bytes), but never past
    # this many checkpoint intervals: bounds the at-least-once replay debt
    # a crash mid-replay can accumulate
    CHECKPOINT_MAX_DEFER_INTERVALS = 5.0
    # one ingest poll's byte budget: caps how long one state-application
    # critical section can run
    CHUNK_CAP = 2 << 20

    def __init__(
        self,
        journal: Journal,
        state_name: str,
        parse_fn: Callable[[str], Tuple[str, str]],
        backend,
        n_shards: int = 8,
        checkpoint_interval_ms: int = 60_000,
        poll_interval_s: float = 0.1,
        host: str = "0.0.0.0",
        port: int = 6123,
        job_id: Optional[str] = None,
        restart_attempts: int = 3,
        restart_delay_s: float = 10.0,
        native_server: bool = False,
        start_from: str = "earliest",
        ingest_mode: Optional[str] = None,
        topk_index: bool = True,
        replica_of: Optional[str] = None,
        replica_index: Optional[int] = None,
        topology_group: Optional[str] = None,
        generation: Optional[int] = None,
        snapshots: Optional[bool] = None,
        snapshot_min_bytes: Optional[int] = None,
        compact: Optional[bool] = None,
        table: Optional[str] = None,
        device="cuda",
        clock: Callable[[], float] = time.time,
    ):
        if start_from not in ("earliest", "latest"):
            raise ValueError("start_from must be earliest|latest")
        if ingest_mode is None:
            ingest_mode = os.environ.get("TPUMS_INGEST_MODE", "auto")
        if ingest_mode not in ("auto", "columnar", "scalar"):
            raise ValueError("ingest_mode must be auto|columnar|scalar")
        _sf = getattr(parse_fn, "shard_filter", None)
        self.table_kind = _select_table(
            table, _sf is not None or replica_of is not None
            or topology_group is not None or generation is not None, backend)
        with_index = (state_name == ALS_STATE and topk_index
                      and not native_server)
        self.device = None
        if with_index:
            # torch loads with the index: a job without one (a proxy's
            # imports reach this module too) never imports it
            from ..parallel.mesh import resolve_device

            self.device = resolve_device(device)
        self.ingest_mode = ingest_mode
        self.journal = journal
        self.state_name = state_name
        self.host = host
        self.parse_fn = parse_fn
        self.backend = backend
        # snapshot-shipped bootstrap (serve/snapshot.py): a sharded worker
        # snapshots and restores its own slice; a standalone job owns the
        # whole key space, shard 0 of 1
        self._snap_owner = (int(_sf[0]), int(_sf[1])) if _sf else (0, 1)
        if self.table_kind == "arena":
            from .arena import ArenaModelTable

            # one writer per arena (flock): the dir names every axis a
            # fleet multiplies on over a shared journal
            arena_dir = os.path.join(
                journal.dir, "{}.arena-{}-w{}of{}-r{}-g{}".format(
                    journal.topic, state_name, self._snap_owner[0],
                    self._snap_owner[1], replica_index or 0,
                    generation or 0))
            self.table = ArenaModelTable(n_shards, dir=arena_dir)
        elif hasattr(backend, "make_table"):
            # the rocksdb backend's durable table
            self.table = backend.make_table(n_shards)
        else:
            self.table = ModelTable(n_shards)
        self.checkpoint_interval_s = checkpoint_interval_ms / 1000.0
        self.poll_interval_s = poll_interval_s
        self.job_id = job_id or uuid.uuid4().hex
        self.restart_attempts = restart_attempts
        self.restart_delay_s = restart_delay_s
        self._clock = clock
        # Kafka auto.offset.reset for a consumer with no checkpoint:
        # earliest replays the whole retained topic, latest serves only
        # rows published after the job came up (aligned to the last record
        # boundary).  A restored checkpoint always wins (start()).
        self.offset = (
            journal.aligned_end_offset() if start_from == "latest" else 0
        )
        # the supervised restart replays from here when no checkpoint
        # exists yet: a latest job must not replay the backlog it skipped
        self._seed_offset = self.offset
        self.parse_errors = 0
        # ingest-plane observability: which path ran last, how many rows /
        # chunks it applied, and the wall time inside state application
        self.ingest_path = "idle"
        self.ingest_rows = 0
        self.ingest_batches = 0
        self.ingest_apply_s = 0.0
        self.checkpoints = 0
        self.checkpoints_deferred = 0
        # the rocksdb table is its own durable O(state) artifact, so
        # snapshots apply to the dict and arena tables only
        if snapshots is None:
            snapshots = os.environ.get("TPUMS_SNAPSHOTS", "1") != "0"
        self._snapshots_on = bool(snapshots) and (
            hasattr(self.table, "_shards") or self.table_kind == "arena")
        self._snap_root = snapshot_mod.snapshot_root(journal.dir,
                                                     journal.topic)
        if snapshot_min_bytes is None:
            try:
                snapshot_min_bytes = int(
                    os.environ.get("TPUMS_SNAPSHOT_MIN_BYTES", 1 << 20))
            except ValueError:
                snapshot_min_bytes = 1 << 20
        self._snap_min_bytes = max(int(snapshot_min_bytes), 1)
        self._last_snap_offset = 0
        # background journal compactor (serve/compact.py), off by default.
        # The journal is shared, so exactly one member per fleet folds it:
        # worker 0 of replica 0 (a solo job qualifies); an elastic worker
        # also stands down per tick unless its generation is the group's
        # active one (_compactor_active)
        if compact is None:
            compact = compact_enabled()
        self._compact_on = (
            bool(compact)
            and self._snap_owner[0] == 0
            and replica_index in (None, 0)
        )
        self._compactor = None
        self.bootstrap_source = "replay"
        self.bootstrap_seconds: Optional[float] = None
        self._bootstrap_t0: Optional[float] = None
        reg = obs_metrics.get_registry()
        st = state_name
        self._obs_rows = reg.counter("tpums_ingest_rows_total", state=st)
        self._obs_batches = reg.counter(
            "tpums_ingest_batches_total", state=st)
        self._obs_parse_errors = reg.counter(
            "tpums_ingest_parse_errors_total", state=st)
        self._obs_apply = reg.histogram(
            "tpums_ingest_apply_seconds", state=st)
        self._obs_backlog = reg.gauge(
            "tpums_journal_backlog_bytes", state=st)
        self._obs_rows_per_s = reg.gauge("tpums_ingest_rows_per_s", state=st)
        self._obs_ckpt = reg.counter("tpums_checkpoints_total", state=st)
        self._obs_ckpt_deferred = reg.gauge(
            "tpums_checkpoints_deferred", state=st)
        self._obs_ready_flips = reg.counter(
            "tpums_ready_transitions_total", state=st)
        self._obs_restore_fail = reg.counter(
            "tpums_checkpoint_restore_failures_total", state=st)
        self._obs_bootstrap_s = reg.histogram(
            "tpums_bootstrap_seconds", state=st)
        self._obs_truncated = reg.counter(
            "tpums_journal_truncated_total", state=st)
        self._obs_snap_age = reg.gauge(
            "tpums_snapshot_age_seconds", state=st)
        self._obs_snap_pub = reg.counter(
            "tpums_snapshots_published_total", state=st)
        self._obs_snap_restore_fail = reg.counter(
            "tpums_snapshot_restore_failures_total", state=st)
        # HA plane (serve/ha.py): membership in a replica set, announced
        # through the registry so clients and supervisors resolve the set
        self.replica_of = replica_of
        self.replica_index = replica_index
        # elastic plane (serve/elastic.py): the worker's generation of its
        # topology group, and the group's ACTIVE generation as observed at
        # heartbeat time (HEALTH's topology_gen: the re-resolve hint)
        self.topology_group = topology_group
        self.generation = generation
        self._observed_topology_gen: Optional[int] = generation
        # readiness gate: False until the consume loop has replayed the
        # backlog that existed when it came up
        self._ready = threading.Event()
        self._hb_lock = threading.Lock()
        self._stopped = False
        self._stop = threading.Event()
        self._consumer_thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._last_checkpoint = 0.0
        self._ready_target = 0
        self._native_arena = None
        if native_server:
            # the C++ epoll data plane reads the rocksdb store, or maps the
            # arena read-only; TOPK/TOPKV score the "-I" rows on the host
            from .native_store import NativeLookupServer

            if self.table_kind == "arena":
                from .native_store import NativeArena

                self._native_arena = NativeArena(self.table.dir)
                serve_handle = self._native_arena
            elif hasattr(backend, "store"):
                serve_handle = backend.store
            else:
                raise ValueError(
                    "--nativeServer needs the native (rocksdb) store or the "
                    f"arena table, but the active backend is "
                    f"'{backend.kind}' with the {self.table_kind} table: "
                    "pass --stateBackend rocksdb or --table arena, and if "
                    "you did, the native store failed to load (see the "
                    "message above)")
            self.server = NativeLookupServer(
                serve_handle, state_name, job_id=self.job_id, host=host,
                port=port,
                topk_suffixes=("-I", "-U") if state_name == ALS_STATE
                else None)
        else:
            topk_handlers = {}
            if with_index:
                from .topk import make_als_topk_handler

                topk_handlers[state_name] = make_als_topk_handler(
                    self.table, device=self.device)
            self.server = LookupServer(
                {state_name: self.table},
                host=host,
                port=port,
                job_id=self.job_id,
                topk_handlers=topk_handlers,
                health_fn=self.health,
                staleness_fn=self._staleness,
            )
        self.port = self.server.port

    def _staleness(self):
        """Replication staleness for st=-opted reads: the follower
        replicator's journal-dir status record (serve/georepl.py), or None
        (-> 0.000 on the wire) when this journal is not a geo follower."""
        from . import georepl

        return georepl.staleness_of(self.journal.dir, self.journal.topic)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingJob":
        self._bootstrap_t0 = time.monotonic()
        restored = None
        try:
            restored = self.backend.restore(self.table)
        except Exception as e:
            # a corrupt checkpoint is a counted event, not a crash: the
            # bootstrap falls down the chain (snapshot, else full replay)
            self._obs_restore_fail.inc()
            print(
                f"[serve:{self.state_name}] checkpoint restore failed "
                f"({e}); falling back to snapshot/replay bootstrap",
                file=sys.stderr,
            )
        if restored is not None:
            self.offset = restored
            self.bootstrap_source = "checkpoint"
            print(
                f"[serve:{self.state_name}] restored {len(self.table)} rows, "
                f"journal offset {self.offset}",
                file=sys.stderr,
            )
        # snapshot overlay: a published snapshot AHEAD of the checkpoint
        # (or of offset 0) replaces that much replay with one columnar
        # bulk-load; the last-writer-wins overlay keeps a restored table
        # convergent
        info = self._try_snapshot_bootstrap(min_offset=self.offset + 1)
        if info is not None:
            self.offset = info["offset"]
            self._last_snap_offset = info["offset"]
            self.bootstrap_source = "snapshot"
            if info.get("age_s") is not None:
                self._obs_snap_age.set(info["age_s"])
            print(
                f"[serve:{self.state_name}] snapshot bootstrap: "
                f"{info['rows']} rows from {info['members']} member(s), "
                f"tail replay from offset {self.offset}",
                file=sys.stderr,
            )
        self.server.start()
        # continuous profiling is part of serving: the process-wide sampler
        # starts with the first job and is shared by all of them;
        # TPUMS_PROF=0 is the kill switch
        obs_profiler.ensure_started()
        print(f"[serve:{self.state_name}] table: {self.table_kind}",
              file=sys.stderr)
        # announce jobId -> endpoint so clients resolve this job without
        # explicit port wiring (QueryClientHelper.java:82-92), refreshed
        # within the heartbeat TTL
        self._heartbeat_now()
        self._consumer_thread = threading.Thread(
            target=self._supervised_consume, name="journal-consumer", daemon=True
        )
        self._consumer_thread.start()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="registry-heartbeat", daemon=True
        )
        self._hb_thread.start()
        if self._compact_on:
            # shares this job's stop event, so it stands down with stop()
            self._compactor = CompactorThread(
                self.journal, self.parse_fn, stop_event=self._stop,
                active_fn=self._compactor_active)
            self._compactor.start()
        return self

    # -- liveness / readiness ----------------------------------------------

    @property
    def ready(self) -> bool:
        """True once the consume loop has caught up with the journal end
        observed at (re)start."""
        return self._ready.is_set()

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        return self._ready.wait(timeout)

    def backlog_bytes(self) -> int:
        """Unconsumed journal bytes behind the producer's end offset."""
        try:
            return max(self.journal.end_offset() - self.offset, 0)
        except OSError:
            return 0

    def health(self) -> dict:
        """The HEALTH verb's payload (the key count is added server-side),
        the reference's keys."""
        ready = self.ready
        payload = {
            "state": self.state_name,
            "job_id": self.job_id,
            "ready": ready,
            "status": "ready" if ready else "replaying",
            "backlog_bytes": self.backlog_bytes(),
            "offset": self.offset,
            "ingest_path": self.ingest_path,
            "replica_of": self.replica_of,
            "replica": self.replica_index,
            "topology_group": self.topology_group,
            "generation": self.generation,
            "topology_gen": self._observed_topology_gen,
            "bootstrap_source": self.bootstrap_source,
            "bootstrap_seconds": self.bootstrap_seconds,
        }
        alerts = self._alert_hint()
        if alerts is not None:
            # the fields appear ONLY while a watcher's alert record is
            # fresh (and TPUMS_WATCH_HEALTH_HINT is not 0), so a fleet
            # without a watch loop keeps its HEALTH bytes unchanged
            payload["alerts_firing"] = alerts["firing"]
            payload["alerts_max_severity"] = alerts["max_severity"]
        return payload

    # HEALTH is a hot poll path (supervisors, elastic clients): the
    # registry's alert record is read at most once a second
    _ALERT_HINT_TTL_S = 1.0

    def _alert_hint(self) -> Optional[dict]:
        if os.environ.get("TPUMS_WATCH_HEALTH_HINT", "1") == "0":
            return None
        now = time.time()
        cached = getattr(self, "_alert_hint_cache", None)
        if cached is not None and now - cached[0] < self._ALERT_HINT_TTL_S:
            return cached[1]
        try:
            rec = registry.resolve_alerts()
        except Exception:  # noqa: BLE001 - a hint must never break HEALTH
            rec = None
        self._alert_hint_cache = (now, rec)
        return rec

    def _recover_truncated(self, err: OffsetTruncatedError) -> int:
        """The consume loop hit journal history that no longer exists byte
        for byte -> the offset to resume from.  The table stays convergent
        on every path (last-writer-wins re-application)."""
        self._obs_truncated.inc()
        if err.lossless:
            # a fold replaced bytes we were mid-way through: re-reading the
            # compacted prefix from its base is a last-writer-wins superset
            self.journal.compacted_rereads += 1
            print(
                f"[serve:{self.state_name}] journal compacted under us at "
                f"{err.offset}; re-reading fold from {err.resume_offset}",
                file=sys.stderr,
            )
            return err.resume_offset
        # rows below resume_offset are GONE (retention); only a snapshot
        # that reaches the retained region (offset >= resume_offset) covers
        # the hole with zero loss.  One below resume_offset must NOT be
        # resumed from: its offset points back into the hole, so the next
        # read would re-raise this same truncation forever
        info = self._try_snapshot_bootstrap(min_offset=err.resume_offset)
        if info is not None:
            self._last_snap_offset = max(
                self._last_snap_offset, info["offset"])
            print(
                f"[serve:{self.state_name}] offset {err.offset} expired; "
                f"snapshot covers through {info['offset']}",
                file=sys.stderr,
            )
            return info["offset"]
        # a snapshot strictly inside the hole can't be resumed from, but
        # bulk-loading it still narrows the loss: state through its offset
        # is covered, and only (snapshot offset, resume_offset) is gone
        info = self._try_snapshot_bootstrap(
            min_offset=err.offset + 1, max_offset=err.resume_offset)
        if info is not None:
            self._last_snap_offset = max(
                self._last_snap_offset, info["offset"])
        base = info["offset"] if info is not None else err.offset
        # resume with an explicit, counted gap
        lost = err.resume_offset - base
        self.journal.expired_bytes_skipped += lost
        print(
            f"[serve:{self.state_name}] offset {err.offset} expired; no "
            f"snapshot reaches retained offset {err.resume_offset}; "
            f"skipping {lost} lost bytes (state covered through {base})",
            file=sys.stderr,
        )
        return err.resume_offset

    # -- snapshot bootstrap / publication (serve/snapshot.py) --------------

    def _try_snapshot_bootstrap(
        self, min_offset: int = 0, max_offset: Optional[int] = None
    ) -> Optional[dict]:
        """Bulk-load the newest valid snapshot (fallback chain: bad
        checksum -> older snapshot -> None, and the caller replays the
        journal instead).  Corrupt members are counted in
        ``tpums_snapshot_restore_failures_total``."""
        if not self._snapshots_on:
            return None
        try:
            return snapshot_mod.bootstrap(
                self.table,
                self._snap_root,
                owner=self._snap_owner,
                min_offset=min_offset,
                max_offset=max_offset,
                on_corrupt=lambda m: self._obs_snap_restore_fail.inc(),
            )
        except Exception as e:
            # never let the bootstrap fast path kill a job that could have
            # replayed its way up instead
            print(
                f"[serve:{self.state_name}] snapshot bootstrap failed "
                f"({e}); replaying journal",
                file=sys.stderr,
            )
            return None

    def _maybe_publish_snapshot(self) -> None:
        """Publish a snapshot at the current (table, offset), between
        chunks (the same consistency point as a checkpoint), once at
        least ``snapshot_min_bytes`` of journal landed since the last
        one; one line on stderr gives its rows, offset and seconds."""
        if not self._snapshots_on or self.offset <= 0:
            return
        if self.offset - self._last_snap_offset < self._snap_min_bytes:
            return
        t0 = time.perf_counter()
        try:
            manifest = snapshot_mod.publish(
                self._snap_root,
                self.table,
                self.offset,
                shard=self._snap_owner[0],
                num_shards=self._snap_owner[1],
                group=self.topology_group,
                gen=self.generation,
                topic=self.journal.topic,
            )
        except Exception as e:
            print(
                f"[serve:{self.state_name}] snapshot publish failed ({e})",
                file=sys.stderr,
            )
            return
        print(
            f"[serve:{self.state_name}] snapshot published: "
            f"{manifest['rows']} rows at offset {self.offset} in "
            f"{time.perf_counter() - t0:.3f}s",
            file=sys.stderr,
        )
        self._last_snap_offset = self.offset
        self._obs_snap_pub.inc()
        self._obs_snap_age.set(0.0)
        obs_tracing.event(
            "snapshot_published", state=self.state_name, job_id=self.job_id,
            offset=self.offset, rows=manifest["rows"],
            shard=self._snap_owner[0], num_shards=self._snap_owner[1])

    def _heartbeat_now(self) -> None:
        # the lock makes read-ready + register atomic (readiness must be
        # monotone once flipped), and the stop check under it pairs with
        # the locked unregister in stop(): a ready-flip refresh must not
        # resurrect an entry a concurrent shutdown just removed
        with self._hb_lock:
            if self._stop.is_set():
                return
            registry.register(
                self.job_id, self.host, self.port, self.state_name,
                replica_of=self.replica_of, replica=self.replica_index,
                ready=self.ready, ttl_s=registry.replica_ttl_s(),
            )
        if self.topology_group:
            # one small registry read on the heartbeat cadence keeps the
            # generation-changed hint in HEALTH fresh after a cutover
            try:
                topo = registry.resolve_topology(self.topology_group)
                if topo is not None:
                    self._observed_topology_gen = int(topo["gen"])
            except Exception:
                pass
        set_health = getattr(self.server, "set_health", None)
        if set_health is not None:
            # native plane: the C++ server cannot call back into the job,
            # so HEALTH is pushed on the heartbeat cadence (the ready flip
            # heartbeats at once); the server adds the key count itself
            try:
                set_health(json.dumps(self.health()))
            except Exception:
                pass

    def _compactor_active(self) -> bool:
        """Per-tick compactor gate (``CompactorThread`` ``active_fn``):
        True when this worker's topology generation is the group's ACTIVE
        one, as observed at heartbeat time.  During an elastic cutover
        both gen g and the warming gen g+1 have a worker 0 on the shared
        journal; one compactor per journal holds through it.  Non-elastic
        jobs always qualify."""
        if self.topology_group is None or self.generation is None:
            return True
        obs = self._observed_topology_gen
        return obs is None or int(obs) == int(self.generation)

    def _heartbeat_loop(self) -> None:
        interval = registry.heartbeat_interval_s()
        while not self._stop.wait(interval):
            self._heartbeat_now()

    def stop(self) -> None:
        # idempotent: wait() calls stop() on every exit path
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        # join the heartbeat before unregistering, or an in-flight refresh
        # could resurrect the entry
        if self._hb_thread:
            self._hb_thread.join(timeout=5)
        with self._hb_lock:
            registry.unregister(self.job_id)
        if self._consumer_thread:
            self._consumer_thread.join(timeout=10)
        self.server.stop()
        if self._native_arena is not None:
            # after server.stop(): no reader thread may touch the mapping
            self._native_arena.close()
        consumer_done = (self._consumer_thread is None
                         or not self._consumer_thread.is_alive())
        if self.table_kind == "arena" and consumer_done:
            # releases the writer flock; a wedged consumer thread leaks
            # the mapping instead (the flock dies with the process)
            self.table.close()
        if hasattr(self.backend, "close"):
            # never free the native store under a running consumer thread
            # (use after free): a wedged thread leaks the handle instead
            if consumer_done:
                self.backend.close()
            else:
                print(f"[serve:{self.state_name}] consumer thread still "
                      "busy; leaving native store open", file=sys.stderr)

    def wait(self) -> None:
        """CLI foreground mode: SIGTERM becomes an orderly stop(), so the
        registry entry is released."""
        import signal

        try:
            signal.signal(signal.SIGTERM, lambda *_: self.stop())
        except ValueError:
            pass  # not the main thread: caller owns signal handling
        try:
            while not self._stop.is_set():
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        self.stop()

    # -- consume loop with fixed-delay restart -----------------------------

    def _supervised_consume(self) -> None:
        attempts = 0
        while not self._stop.is_set():
            try:
                self._consume_loop()
                return  # clean stop
            except Exception as e:
                attempts += 1
                obs_tracing.events_counter(
                    "consume_restart" if attempts <= self.restart_attempts
                    else "consume_giveup",
                    state=self.state_name, job_id=self.job_id,
                    attempt=attempts, error=str(e))
                if attempts > self.restart_attempts:
                    print(
                        f"[serve:{self.state_name}] giving up after "
                        f"{self.restart_attempts} restarts: {e}",
                        file=sys.stderr,
                    )
                    # a dead job must not stay resolvable
                    self._stop.set()
                    with self._hb_lock:
                        registry.unregister(self.job_id)
                    return
                print(
                    f"[serve:{self.state_name}] consume loop failed ({e}); "
                    f"restart {attempts}/{self.restart_attempts} in "
                    f"{self.restart_delay_s}s",
                    file=sys.stderr,
                )
                if self._stop.wait(self.restart_delay_s):
                    return
                try:
                    restored = self.backend.restore(self.table)
                    self.offset = (
                        restored if restored is not None else self._seed_offset
                    )
                except Exception as re:
                    # continue from the in-memory state (at-least-once
                    # replay keeps the table convergent)
                    self._obs_restore_fail.inc()
                    print(
                        f"[serve:{self.state_name}] checkpoint restore failed "
                        f"({re}); continuing from in-memory state at offset "
                        f"{self.offset}",
                        file=sys.stderr,
                    )

    def _begin_consume(self) -> None:
        """State of one run of the consume loop.  The readiness target is
        the journal end when the loop came up; a supervised restart inside
        a live process keeps ready set (the table stayed warm)."""
        self._last_checkpoint = self._clock()
        self._ready_target = self.journal.end_offset() if not self.ready else 0

    def _consume_loop(self) -> None:
        self._begin_consume()
        while not self._stop.is_set():
            if not self.consume_step():
                self._stop.wait(self.poll_interval_s)

    def consume_step(self) -> bool:
        """One poll of the journal: apply what it returns, flip readiness,
        take or defer a checkpoint.  -> whether the poll got any rows.
        ``_consume_loop`` calls it until stopped; a test may call it
        directly after ``_begin_consume``, with a fake ``clock``."""
        native_mode = getattr(self.parse_fn, "native_mode", None)
        columnar_mode = getattr(self.parse_fn, "columnar_mode", None)
        rows_before = self.ingest_rows
        errs_before = self.parse_errors
        t0 = time.perf_counter()
        try:
            if (native_mode is not None
                    and hasattr(self.table, "ingest_lines")
                    and not getattr(self.table, "_listeners", True)):
                # rocksdb table with no change listeners: one C++ call
                # parses, keys and stores the whole chunk (listeners such
                # as the top-k index force the Python paths, so they keep
                # seeing every key); the 2 MiB cap bounds how long it
                # holds the store mutex the native server's reads take
                self.ingest_path = "native"
                chunk, next_offset = self.journal.read_bytes_from(
                    self.offset, max_bytes=self.CHUNK_CAP
                )
                got_any = bool(chunk)
                if chunk:
                    rows, errs = self.table.ingest_lines(chunk, native_mode)
                    self.parse_errors += errs
                    self.ingest_rows += rows
                    self.ingest_batches += 1
            elif columnar_mode is not None and self.ingest_mode != "scalar":
                # numpy splits the whole byte chunk into key/value columns,
                # and listeners get ONE batched callback
                self.ingest_path = "columnar"
                chunk, next_offset = self.journal.read_bytes_from(
                    self.offset, max_bytes=self.CHUNK_CAP
                )
                got_any = bool(chunk)
                if chunk:
                    self._apply_chunk_columnar(chunk, columnar_mode)
                    self.ingest_batches += 1
            else:
                self.ingest_path = "scalar"
                lines, next_offset = self.journal.read_from(
                    self.offset, max_bytes=self.CHUNK_CAP
                )
                got_any = bool(lines)
                if lines:
                    self._apply_lines(lines)
                    self.ingest_batches += 1
        except OffsetTruncatedError as err:
            # our offset points at folded or expired history: recover and
            # poll again
            self.offset = self._recover_truncated(err)
            return True
        if got_any:
            dt = time.perf_counter() - t0
            self.ingest_apply_s += dt
            if obs_metrics.metrics_enabled():
                rows = self.ingest_rows - rows_before
                self._obs_rows.inc(rows)
                self._obs_batches.inc(1)
                self._obs_parse_errors.inc(self.parse_errors - errs_before)
                self._obs_apply.observe(dt)
                if dt > 0:
                    self._obs_rows_per_s.set(rows / dt)
        bytes_advanced = next_offset - self.offset
        self.offset = next_offset
        if got_any and obs_metrics.metrics_enabled():
            # only polls that ingested re-stat the journal: backlog moves
            # only when the producer appends
            self._obs_backlog.set(self.backlog_bytes())
        if not self._ready.is_set() and (
            not got_any or self.offset >= self._ready_target
        ):
            self._flip_ready()
        now = self._clock()
        if now - self._last_checkpoint >= self.checkpoint_interval_s:
            # a full-chunk poll means we're inside a replay backlog:
            # snapshotting now would stall ingest and commit an offset
            # we'll blow past within milliseconds; defer, bounded
            backlog = got_any and bytes_advanced >= self.CHUNK_CAP // 2
            overdue = now - self._last_checkpoint >= (
                self.checkpoint_interval_s
                * self.CHECKPOINT_MAX_DEFER_INTERVALS
            )
            if backlog and not overdue:
                self.checkpoints_deferred += 1
                self._obs_ckpt_deferred.set(self.checkpoints_deferred)
            else:
                self.backend.snapshot(self.table, self.offset)
                self._last_checkpoint = now
                self.checkpoints += 1
                self._obs_ckpt.inc()
                self._maybe_publish_snapshot()
        return got_any

    def _flip_ready(self) -> None:
        """Caught up with the backlog that existed at start: flip to ready
        and push the flag to the registry now."""
        self._ready.set()
        if self._bootstrap_t0 is not None:
            self.bootstrap_seconds = time.monotonic() - self._bootstrap_t0
            self._bootstrap_t0 = None
            self._obs_bootstrap_s.observe(self.bootstrap_seconds)
            obs_metrics.get_registry().counter(
                "tpums_bootstrap_total", state=self.state_name,
                kind=self.bootstrap_source).inc()
        self._heartbeat_now()
        self._obs_ready_flips.inc()
        obs_tracing.event(
            "ready", state=self.state_name, job_id=self.job_id,
            offset=self.offset, replica_of=self.replica_of,
            replica=self.replica_index,
            source=self.bootstrap_source)
        # a fresh snapshot right at ready makes the NEXT start's bootstrap
        # O(state) even before a checkpoint interval elapses (min-bytes
        # gated, so a snapshot-fed start that replayed a short tail won't
        # republish at once)
        self._maybe_publish_snapshot()

    def _apply_lines(self, lines) -> None:
        batch = []
        for line in lines:
            if not line:
                continue
            try:
                parsed = self.parse_fn(line)
            except ValueError:
                # skip-and-count a malformed row (SURVEY.md Appendix C)
                self.parse_errors += 1
                continue
            if parsed is None:
                continue  # a row another sharded worker owns
            batch.append(parsed)
        # one lock acquisition per slice, so a replay cannot starve queries
        # behind one multi-second critical section
        for s in range(0, len(batch), 10_000):
            self.table.put_many(batch[s:s + 10_000])
        self.ingest_rows += len(batch)

    def _apply_chunk_columnar(self, chunk: bytes, mode: int) -> None:
        """Vectorised read_from + _apply_lines: the same skipped rows,
        parse-error counts and last-writer-wins table.  The shard hashes
        ride along from the chunk parser."""
        keys, values, errs, hashes = split_journal_chunk(
            chunk, mode, with_hashes=True
        )
        self.parse_errors += errs
        shard_filter = getattr(self.parse_fn, "shard_filter", None)
        if shard_filter is not None and keys:
            # sharded worker: the vectorised ownership filter replaces the
            # per-row None checks of the scalar wrapper
            worker_index, num_workers = shard_filter
            if hashes is None:
                hashes = _fnv1a_batch(keys)
            mine = hashes % num_workers == worker_index
            if not mine.all():
                keys = np.asarray(keys, dtype=object)[mine].tolist()
                values = np.asarray(values, dtype=object)[mine].tolist()
                hashes = hashes[mine]
        for s in range(0, len(keys), 50_000):
            self.table.put_many_columns(
                keys[s:s + 50_000], values[s:s + 50_000],
                hashes=None if hashes is None else hashes[s:s + 50_000],
            )
        self.ingest_rows += len(keys)

    def ingest_stats(self) -> dict:
        """Ingest-plane counters for benches and monitoring."""
        return {
            "path": self.ingest_path,
            "rows": self.ingest_rows,
            "batches": self.ingest_batches,
            "apply_s": self.ingest_apply_s,
            "parse_errors": self.parse_errors,
            "checkpoints_deferred": self.checkpoints_deferred,
            "offset": self.offset,
        }


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def _resolve_journal_dir(params: Params) -> str:
    """``--journalDir``, or the reference's Kafka flags
    (``--bootstrap.servers``, ALSKafkaConsumer.java:30-35): a filesystem
    path there is the journal dir, and a broker address falls back to
    ``TPUMS_JOURNAL_DIR`` (default ``<tmpdir>/flink_ms_tpu_journal``)."""
    if params.has("journalDir"):
        return params.get_required("journalDir")
    bootstrap = params.get("bootstrap.servers")
    looks_like_path = bool(bootstrap) and "://" not in bootstrap and (
        os.path.isdir(bootstrap)
        or bootstrap.startswith(("/", "./", "../"))
    )
    if looks_like_path:
        print(
            f"[serve] mapping --bootstrap.servers {bootstrap} to the local "
            "journal directory",
            file=sys.stderr,
        )
        return bootstrap
    fallback = os.environ.get(
        "TPUMS_JOURNAL_DIR",
        os.path.join(tempfile.gettempdir(), "flink_ms_tpu_journal"),
    )
    if bootstrap:
        print(
            f"[serve] --bootstrap.servers {bootstrap} names a broker, not a "
            f"path; there is no Kafka here — journal dir: {fallback} "
            "(override with --journalDir or TPUMS_JOURNAL_DIR)",
            file=sys.stderr,
        )
        return fallback
    return params.get_required("journalDir")  # raises the canonical error


def _run_consumer_cli(params: Params, state_name: str, parse_fn) -> ServingJob:
    for ignored in ("zookeeper.connect", "group.id"):
        if params.has(ignored):
            # accepted for CLI parity; journal offsets replace ZooKeeper
            # coordination and consumer-group bookkeeping
            print(f"[serve] --{ignored} accepted and ignored", file=sys.stderr)
    # retrieval knobs ride the environment (the index reads them at
    # construction and in rebuilds); CLI flags win over an inherited env
    for flag, env in (("topkTier", "TPUMS_TOPK_TIER"),
                      ("topkSharded", "TPUMS_TOPK_SHARDED"),
                      ("annNlist", "TPUMS_ANN_NLIST"),
                      ("annNprobe", "TPUMS_ANN_NPROBE")):
        if params.has(flag):
            os.environ[env] = str(params.get(flag))
    journal = Journal(_resolve_journal_dir(params), params.get_required("topic"))
    backend = make_backend(
        params.get("stateBackend", "memory"), params.get("checkpointDataUri")
    )
    job = ServingJob(
        journal,
        state_name,
        parse_fn,
        backend,
        n_shards=params.get_int("shards", 8),
        checkpoint_interval_ms=params.get_int("checkPointInterval", 60_000),
        host=params.get("host", "0.0.0.0"),
        port=params.get_int("port", 6123),
        job_id=params.get("jobId"),
        native_server=params.get_bool("nativeServer", False),
        start_from=params.get("startFrom", "earliest"),
        ingest_mode=params.get("ingestMode"),
        topk_index=params.get_bool("topkIndex", True),
        snapshots=(
            params.get_bool("snapshots") if params.has("snapshots") else None
        ),
        snapshot_min_bytes=params.get_int("snapshotMinBytes"),
        compact=params.get_bool("compact") if params.has("compact") else None,
        table=params.get("table"),
        device=params.get("device", "cuda"),
    )
    print(
        f"[serve] {state_name} serving topic '{journal.topic}' on port "
        f"{job.port}, jobId={job.job_id}",
        flush=True,
    )
    return job.start()


def als_main(argv=None) -> None:
    params = Params.from_args(sys.argv[1:] if argv is None else argv)
    _run_consumer_cli(params, ALS_STATE, parse_als_record).wait()


def svm_main(argv=None) -> None:
    params = Params.from_args(sys.argv[1:] if argv is None else argv)
    _run_consumer_cli(params, SVM_STATE, parse_svm_record).wait()
