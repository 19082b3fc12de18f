"""Sharded online-update plane: co-located SGD workers that close the
train→serve→update loop at fleet scale.

Own copy of ``flink_ms_tpu/serve/update_plane.py``, with its arena path:
a worker co-located with an arena table swaps the updated rows in place
(``cas_many_columns`` against the values the batch read, then a re-put of
the rows whose CAS failed; ``TPUMS_ARENA_CAS=0`` re-puts every row), so
an update is queryable before the journal replays it.  The input logs,
apply logs, lease files and published rows are the reference's, byte for
byte: a plane of either package resumes the other's watermarks, and the
rows come from the port's ``SGDStep.process_batch`` (host float64, equal
to the reference's).

The reference's online path (``SGD.java``) is a single consumer doing two
queryable-state hops per rating against the fleet; our ``online/sgd.py``
keeps that shape (one MGET per batch) and tops out around ~13k ratings/s
regardless of how many serving shards exist.  This module turns the update
path into an O(shards) plane:

- **Producers** (`UpdatePlaneClient`) hash-route each rating by its
  user-key into one of P durable per-partition input logs
  (``<topic>.upd<p>``, plain journal topics), stamping a contiguous
  per-partition sequence number on every record.  P (default 16, knob
  ``TPUMS_UPDATE_PARTITIONS``) is chosen so that for any fleet size N that
  divides P, partition ``p`` is owned by shard ``p % N`` — and because the
  partition is itself ``fnv1a(user-key) % P``, every user in partition
  ``p`` hashes to serving shard ``p % N`` (``x % P % N == x % N`` whenever
  N | P).  Routing therefore stays aligned with the consumer's
  ``hash % N`` ingest filter across 1→2→4→…-shard topologies with no
  repartitioning.

- **UpdateWorkers** run co-located inside each serving worker process
  (``--updatePlane`` on the sharded worker CLI).  A worker claims the
  partitions it owns via ``flock``ed lease files — the kernel releases the
  lock on any process death, so a SIGKILLed worker's partitions are
  claimable by its sibling replica (or its respawned self) immediately,
  with no stale-lease heuristics.  For each claimed partition it tails the
  input log, batches ratings through the existing vectorized
  ``SGDStep.process_batch`` (v1/v0/bias parity preserved), reading the
  *owned* user vectors straight from the local live ``ModelTable`` (zero
  RPC) and only the cross-shard item vectors remotely — one coalesced MGET
  per batch through a TTL read-through cache.

- **Exactly-once accounting.**  Each applied batch commits ONE line to a
  per-partition apply log (``<topic>.applied<p>``)::

      <seq_from>\t<seq_to>\t<input_offset_after>\t<row|row|...>

  Journal records are single lines, so the commit is atomic under
  SIGKILL: a torn tail is invisible to readers and the batch deterministi-
  cally re-applies.  The emitted rows publish to the model journal *after*
  the commit; a crash inside that window is closed on the next lease
  acquisition by unconditionally re-publishing the LAST apply record's
  rows (idempotent — the serving table is last-writer-wins).  Recovery is
  a single ``tail_line()`` read: resume at ``seq_to``/``input_offset``,
  skip already-applied sequence numbers on replay.  ``audit_partitions``
  proves the property: the apply records' [seq_from, seq_to) ranges must
  exactly tile the submitted range — gaps are lost ratings, overlaps are
  double-applies.

- **Topology awareness.**  Workers carry their registry generation; when
  the serving job observes a newer published generation (a 2→4 cutover by
  ``serve/elastic.py``), the worker finishes its in-flight batch, releases
  its leases and exits — the new generation's workers, already spinning on
  the flocks, take over at the recorded watermarks.  No rating is lost or
  double-applied across the cutover, which the bench's reshard arm and
  ``CHAOS_MODE=update`` both gate on via the sequence audit.

Read-your-writes: each worker keeps an overlay of the rows it published
(so batch k+1 sees batch k's vectors without waiting for the serving
consumer to ingest them — the deterministic analog of the reference's
query-after-publish race), and a visibility probe thread measures the
publish→queryable latency of its own updates against the local table on
the shared ``LATENCY_BUCKETS_S`` ladder
(``tpums_update_visibility_seconds``).

Knobs (env, overridable per-ctor): ``TPUMS_UPDATE_PARTITIONS`` (16),
``TPUMS_UPDATE_BATCH`` (256), ``TPUMS_UPDATE_POLL_S`` (0.02),
``TPUMS_UPDATE_CACHE_TTL_S`` (0.05), ``TPUMS_UPDATE_DIM`` (4, cold-start
mean width), ``TPUMS_UPDATE_LR`` / ``TPUMS_UPDATE_USER_REG`` /
``TPUMS_UPDATE_ITEM_REG`` / ``TPUMS_UPDATE_VERSION`` (SGD hyperparams),
``TPUMS_SGD_BIAS`` (bias mode, shared with online/sgd.py).
"""

from __future__ import annotations

import fcntl
import os
import queue
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core import formats as F
from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from ..online.sgd import SGDStep
from .consumer import ALS_STATE
from .journal import Journal, OffsetTruncatedError
from .sharded import owner_of


# ---------------------------------------------------------------------------
# knobs + layout
# ---------------------------------------------------------------------------

def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def default_partitions() -> int:
    return max(1, _env_int("TPUMS_UPDATE_PARTITIONS", 16))


def partition_of(user: int, partitions: int) -> int:
    """Partition of a rating = hash of its USER key — the same FNV-1a the
    consumer's ``hash % N`` ingest filter uses, so partition ``p`` of P is
    owned by shard ``p % N`` for every N dividing P."""
    return owner_of(f"{user}-U", partitions)


def input_topic(topic: str, p: int) -> str:
    return f"{topic}.upd{p}"


def apply_topic(topic: str, p: int) -> str:
    return f"{topic}.applied{p}"


def lease_dir(journal_dir: str, topic: str) -> str:
    return os.path.join(journal_dir, f"{topic}.upd.leases")


def _publish_lock_path(journal_dir: str, topic: str) -> str:
    return os.path.join(journal_dir, f"{topic}.upd.publock")


class _PublishLock:
    """Cross-PROCESS append serialization for the shared model topic.

    Historically the model journal had one producer at a time; the update
    plane is the first place N processes append to it concurrently, and a
    buffered multi-write append could interleave torn lines between
    processes.  An flock around the append (journal's own lock already
    covers threads) restores single-writer framing."""

    def __init__(self, journal_dir: str, topic: str):
        self._path = _publish_lock_path(journal_dir, topic)
        self._lock = threading.Lock()
        self._fd: Optional[int] = None

    def __enter__(self):
        self._lock.acquire()
        if self._fd is None:
            self._fd = os.open(self._path, os.O_RDWR | os.O_CREAT, 0o644)
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        try:
            if self._fd is not None:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
        finally:
            self._lock.release()

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


# ---------------------------------------------------------------------------
# producer
# ---------------------------------------------------------------------------

class UpdatePlaneClient:
    """Rating producer: hash-routes submits into the per-partition input
    logs, stamping contiguous per-partition sequence numbers.

    Thread-safe.  Sequence numbers require a SINGLE producer process per
    partition at a time (the rehearsal engine, the chaos producer and the
    bench all share one client); the sequence resumes across restarts from
    the input log's tail line."""

    def __init__(self, journal_dir: str, topic: str,
                 partitions: Optional[int] = None):
        self.journal_dir = journal_dir
        self.topic = topic
        self.partitions = partitions or default_partitions()
        self._lock = threading.Lock()
        self._journals: Dict[int, Journal] = {}
        self._next_seq: Dict[int, int] = {}
        self.submitted = 0

    def _journal(self, p: int) -> Journal:
        j = self._journals.get(p)
        if j is None:
            j = Journal(self.journal_dir, input_topic(self.topic, p))
            tail = j.tail_line()
            self._next_seq[p] = (
                int(tail.split("\t", 1)[0]) + 1 if tail else 0
            )
            self._journals[p] = j
        return j

    def partition_of(self, user: int) -> int:
        return partition_of(user, self.partitions)

    def submit(self, user: int, item: int, rating: float) -> int:
        """Route one rating; returns its partition."""
        p = partition_of(user, self.partitions)
        with self._lock:
            j = self._journal(p)
            seq = self._next_seq[p]
            j.append([f"{seq}\t{user}\t{item}\t{rating!r}"], flush=False)
            self._next_seq[p] = seq + 1
            self.submitted += 1
        return p

    def submit_many(
        self, ratings: List[Tuple[int, int, float]], flush: bool = False
    ) -> int:
        by_p: Dict[int, List[Tuple[int, int, float]]] = {}
        for u, i, r in ratings:
            by_p.setdefault(partition_of(u, self.partitions), []).append(
                (u, i, r)
            )
        with self._lock:
            for p, rs in sorted(by_p.items()):
                j = self._journal(p)
                seq = self._next_seq[p]
                j.append(
                    [f"{seq + k}\t{u}\t{i}\t{r!r}"
                     for k, (u, i, r) in enumerate(rs)],
                    flush=flush,
                )
                self._next_seq[p] = seq + len(rs)
            self.submitted += len(ratings)
        return len(ratings)

    def totals(self) -> Dict[int, int]:
        """Per-partition submitted counts (next sequence numbers)."""
        with self._lock:
            return dict(self._next_seq)

    def sync(self) -> None:
        with self._lock:
            for j in self._journals.values():
                j.sync()


# ---------------------------------------------------------------------------
# watermarks + exactly-once audit
# ---------------------------------------------------------------------------

def submitted_watermarks(journal_dir: str, topic: str,
                         partitions: Optional[int] = None) -> Dict[int, int]:
    """Per-partition count of submitted ratings (tail sequence + 1)."""
    P = partitions or default_partitions()
    out: Dict[int, int] = {}
    for p in range(P):
        tail = Journal(journal_dir, input_topic(topic, p)).tail_line()
        out[p] = int(tail.split("\t", 1)[0]) + 1 if tail else 0
    return out


def applied_watermarks(journal_dir: str, topic: str,
                       partitions: Optional[int] = None) -> Dict[int, int]:
    """Per-partition applied watermark (``seq_to`` of the last commit)."""
    P = partitions or default_partitions()
    out: Dict[int, int] = {}
    for p in range(P):
        tail = Journal(journal_dir, apply_topic(topic, p)).tail_line()
        out[p] = int(tail.split("\t", 2)[1]) if tail else 0
    return out


def _read_all_lines(j: Journal) -> List[str]:
    out: List[str] = []
    off = j.start_offset()
    while True:
        lines, nxt = j.read_from(off, on_truncated="reset")
        if not lines and nxt == off:
            return out
        out.extend(lines)
        off = nxt


def audit_partitions(journal_dir: str, topic: str,
                     partitions: Optional[int] = None) -> dict:
    """Sequence-range audit of the whole plane: for each partition the
    apply records' [seq_from, seq_to) ranges must exactly tile the
    submitted [0, submitted) range.  ``gaps``/``lost`` count ratings never
    applied; ``duplicates`` count ratings covered by more than one commit
    (double-applied).  Meaningful after the plane has drained."""
    P = partitions or default_partitions()
    parts: Dict[int, dict] = {}
    tot = {"submitted": 0, "applied": 0, "duplicates": 0, "gaps": 0,
           "lost": 0}
    for p in range(P):
        submitted = 0
        max_seq = -1
        for ln in _read_all_lines(Journal(journal_dir, input_topic(topic, p))):
            try:
                s = int(ln.split("\t", 1)[0])
            except ValueError:
                continue
            submitted += 1
            if s > max_seq:
                max_seq = s
        ranges: List[Tuple[int, int]] = []
        for ln in _read_all_lines(Journal(journal_dir, apply_topic(topic, p))):
            fields = ln.split("\t", 3)
            try:
                a, b = int(fields[0]), int(fields[1])
            except (ValueError, IndexError):
                continue
            if b > a:
                ranges.append((a, b))
        ranges.sort()
        covered_end = 0
        applied = duplicates = gaps = 0
        for a, b in ranges:
            if a > covered_end:
                gaps += a - covered_end
                applied += b - a
                covered_end = b
            else:
                duplicates += min(b, covered_end) - a
                if b > covered_end:
                    applied += b - covered_end
                    covered_end = b
        lost = max(0, submitted - applied)
        rec = {
            "submitted": submitted,
            "applied": applied,
            "duplicates": duplicates,
            "gaps": gaps,
            "lost": lost,
            "contiguous_input": max_seq + 1 == submitted,
        }
        parts[p] = rec
        for k in tot:
            tot[k] += rec[k]
    tot["partitions"] = parts
    tot["clean"] = tot["duplicates"] == 0 and tot["lost"] == 0
    return tot


# ---------------------------------------------------------------------------
# visibility probe
# ---------------------------------------------------------------------------

class _VisibilityProbe(threading.Thread):
    """Measures read-your-writes latency: the worker enqueues (key,
    expected payload) right after publishing; this thread polls the LOCAL
    serving table until the row lands and observes publish→queryable
    seconds on the shared latency ladder.  Sheds to the newest probes
    under backlog — it measures, it never backpressures."""

    def __init__(self, table, hist, poll_s: float = 0.002,
                 timeout_s: float = 5.0):
        super().__init__(daemon=True, name="tpums-update-visprobe")
        self._table = table
        self._hist = hist
        self._poll_s = poll_s
        self._timeout_s = timeout_s
        self._q: "queue.Queue" = queue.Queue(maxsize=256)
        self._stop = threading.Event()
        self.observed = 0
        self.timeouts = 0
        self.shed = 0
        self.last_visibility_s: Optional[float] = None

    def enqueue(self, key: str, payload: str,
                tid: Optional[str] = None,
                psid: Optional[str] = None) -> None:
        try:
            self._q.put_nowait(
                (time.monotonic(), key, payload, tid, psid, time.time()))
        except queue.Full:
            self.shed += 1

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                t0, key, expected, tid, psid, t0_wall = self._q.get(
                    timeout=0.2)
            except queue.Empty:
                continue
            deadline = t0 + self._timeout_s
            hit = False
            while time.monotonic() < deadline and not self._stop.is_set():
                try:
                    if self._table.get(key) == expected:
                        hit = True
                        break
                except Exception:
                    break
                if self._q.qsize() > 64:
                    # deep backlog: shed this probe, keep up with the newest
                    self.shed += 1
                    break
                time.sleep(self._poll_s)
            if hit:
                dt = time.monotonic() - t0
                self.last_visibility_s = dt
                self._hist.observe(dt)
                self.observed += 1
                if tid:
                    # closes the apply -> publish -> visible chain: same
                    # tid, parented under the batch's apply span
                    obs_tracing.span_event(
                        "update_visible", tid=tid, psid=psid, t0=t0_wall,
                        dur_s=round(dt, 9), key=key)
            elif time.monotonic() >= deadline:
                self.timeouts += 1


# ---------------------------------------------------------------------------
# the co-located worker
# ---------------------------------------------------------------------------

class _Part:
    __slots__ = ("p", "in_j", "app_j", "fd", "next_seq", "in_off")

    def __init__(self, p, in_j, app_j, fd, next_seq, in_off):
        self.p = p
        self.in_j = in_j
        self.app_j = app_j
        self.fd = fd
        self.next_seq = next_seq
        self.in_off = in_off


class UpdateWorker:
    """Per-shard SGD update worker.

    Co-located mode (``job=`` a running ServingJob): owned user vectors
    read from the live local table, topology generation observed through
    the job's heartbeat.  Standalone mode (``table=`` or nothing): used by
    tests and the profile tool.  Either way the worker claims its owned
    partitions (``p % num_workers == worker_index``) via flock leases, so
    replicas of the same shard contend safely and exactly one applies."""

    def __init__(
        self,
        journal_dir: str,
        topic: str,
        worker_index: int,
        num_workers: int,
        *,
        job=None,
        table=None,
        client_factory: Optional[Callable[[], object]] = None,
        model_journal: Optional[Journal] = None,
        partitions: Optional[int] = None,
        batch_size: Optional[int] = None,
        poll_s: Optional[float] = None,
        cache_ttl_s: Optional[float] = None,
        learning_rate: Optional[float] = None,
        user_reg: Optional[float] = None,
        item_reg: Optional[float] = None,
        version: Optional[str] = None,
        update_bias: Optional[bool] = None,
        generation: Optional[int] = None,
        state: str = ALS_STATE,
        dim: Optional[int] = None,
        visibility_probe: bool = True,
    ):
        self.journal_dir = journal_dir
        self.topic = topic
        self.worker_index = worker_index
        self.num_workers = num_workers
        self._job = job
        self._table = table if table is not None else (
            getattr(job, "table", None) if job is not None else None
        )
        self.client_factory = client_factory
        self.partitions = partitions or default_partitions()
        self.batch_size = batch_size or max(
            1, _env_int("TPUMS_UPDATE_BATCH", 256))
        self.poll_s = poll_s if poll_s is not None else _env_float(
            "TPUMS_UPDATE_POLL_S", 0.02)
        self.cache_ttl_s = cache_ttl_s if cache_ttl_s is not None else (
            _env_float("TPUMS_UPDATE_CACHE_TTL_S", 0.05))
        self.lr = learning_rate if learning_rate is not None else (
            _env_float("TPUMS_UPDATE_LR", 0.1))
        self.user_reg = user_reg if user_reg is not None else (
            _env_float("TPUMS_UPDATE_USER_REG", 0.0))
        self.item_reg = item_reg if item_reg is not None else (
            _env_float("TPUMS_UPDATE_ITEM_REG", 0.0))
        self.version = version or os.environ.get("TPUMS_UPDATE_VERSION", "v1")
        self.update_bias = update_bias if update_bias is not None else (
            os.environ.get("TPUMS_SGD_BIAS", "").lower()
            in ("1", "true", "yes")
        )
        self.generation = generation
        self.state = state
        self.dim = dim or _env_int("TPUMS_UPDATE_DIM", 4)

        self._model_journal = model_journal or Journal(journal_dir, topic)
        self._pub_lock = _PublishLock(journal_dir, topic)
        self._lease_dir = lease_dir(journal_dir, topic)
        self._owned = [
            p for p in range(self.partitions)
            if p % num_workers == worker_index
        ]
        self._held: Dict[int, _Part] = {}
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._client = None
        self._client_retry_at = 0.0
        self._step: Optional[SGDStep] = None
        self._overlay: Dict[str, str] = {}
        self._cache: Dict[str, Tuple[Optional[str], float]] = {}
        self._last_reads: Dict[str, Optional[str]] = {}
        self._recording = False
        # co-located arena: swap factor bytes in place with a native CAS
        # against the value this batch READ, instead of re-putting whole
        # rows; a failed CAS (the value drifted under us) falls back to the
        # last-writer-wins re-put.  TPUMS_ARENA_CAS=0 keeps the re-put path
        self._cas_enabled = os.environ.get("TPUMS_ARENA_CAS", "1") != "0"
        self.stats = {
            "applied": 0, "batches": 0, "conflicts": 0, "replayed_rows": 0,
            "remote_keys": 0, "cache_hits": 0, "local_hits": 0,
            "published_rows": 0,
        }

        reg = obs_metrics.get_registry()
        self._c_updates = reg.counter(
            "tpums_update_updates_total", state=state)
        self._c_conflicts = reg.counter(
            "tpums_update_conflict_retries_total", state=state)
        self._c_batches = reg.counter(
            "tpums_update_batches_total", state=state)
        self._h_vis = reg.histogram(
            "tpums_update_visibility_seconds",
            bounds=obs_metrics.LATENCY_BUCKETS_S, state=state)
        self._probe: Optional[_VisibilityProbe] = None
        if visibility_probe and self._table is not None and hasattr(
                self._table, "get"):
            self._probe = _VisibilityProbe(self._table, self._h_vis)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "UpdateWorker":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"tpums-update-w{self.worker_index}",
        )
        if self._probe is not None:
            self._probe.start()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._probe is not None:
            self._probe.stop()

    @property
    def drained(self) -> bool:
        return self._drained.is_set()

    def wait_drained(self, timeout_s: float = 30.0) -> bool:
        return self._drained.wait(timeout_s)

    @property
    def held_partitions(self) -> List[int]:
        return sorted(self._held)

    # -- leases + recovery ---------------------------------------------------

    def _try_acquire(self, p: int) -> Optional[_Part]:
        os.makedirs(self._lease_dir, exist_ok=True)
        path = os.path.join(self._lease_dir, f"p{p}.lock")
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return None
        # owner info is observability only — the flock IS the lease, and
        # the kernel releases it the instant the holder dies
        try:
            os.ftruncate(fd, 0)
            os.write(fd, (
                f"pid={os.getpid()} worker={self.worker_index}"
                f" gen={self.generation}\n").encode())
        except OSError:
            pass
        in_j = Journal(self.journal_dir, input_topic(self.topic, p))
        app_j = Journal(self.journal_dir, apply_topic(self.topic, p))
        tail = app_j.tail_line()
        if tail:
            fields = tail.split("\t", 3)
            next_seq, in_off = int(fields[1]), int(fields[2])
            # close the commit→publish crash window: the last commit's
            # rows may never have reached the model journal — re-publish
            # them unconditionally (last-writer-wins makes this idempotent)
            rows = fields[3].split("|") if len(fields) > 3 and fields[3] \
                else []
            self._publish(rows)
            self.stats["replayed_rows"] += len(rows)
        else:
            next_seq, in_off = 0, in_j.start_offset()
        return _Part(p, in_j, app_j, fd, next_seq, in_off)

    def _acquire_owned(self) -> None:
        for p in self._owned:
            if p in self._held or self._stop.is_set():
                continue
            part = self._try_acquire(p)
            if part is not None:
                self._held[p] = part

    def _release_all(self) -> None:
        for part in self._held.values():
            try:
                os.close(part.fd)  # closes => kernel drops the flock
            except OSError:
                pass
        self._held.clear()

    # -- lookups -------------------------------------------------------------

    def _ensure_client(self):
        if self._client is not None:
            return self._client
        if self.client_factory is None:
            return None
        now = time.monotonic()
        if now < self._client_retry_at:
            return None
        try:
            self._client = self.client_factory()
        except Exception as e:
            print(f"[update-plane] client unavailable: {e}", file=sys.stderr)
            self._client_retry_at = now + 1.0
            return None
        return self._client

    def _drop_client(self) -> None:
        try:
            if self._client is not None and hasattr(self._client, "close"):
                self._client.close()
        except Exception:
            pass
        self._client = None
        self._client_retry_at = time.monotonic() + 0.5

    def _remote_fetch(self, keys: List[str]) -> List[Optional[str]]:
        cli = self._ensure_client()
        if cli is None:
            return [None] * len(keys)
        try:
            vals = cli.query_states(self.state, keys)
            self.stats["remote_keys"] += len(keys)
            return list(vals)
        except Exception as e:
            print(f"[update-plane] remote MGET failed for {len(keys)} keys:"
                  f" {e}", file=sys.stderr)
            self._drop_client()
            return [None] * len(keys)

    def _lookup_many(self, keys: List[str]) -> List[Optional[str]]:
        """Overlay (read-your-writes) → local live table for owned keys →
        TTL read-through cache → one coalesced remote MGET for the rest."""
        now = time.monotonic()
        out: List[Optional[str]] = [None] * len(keys)
        misses: List[Tuple[int, str]] = []
        for idx, key in enumerate(keys):
            ov = self._overlay.get(key)
            if ov is not None:
                out[idx] = ov
                continue
            if self._table is not None and owner_of(
                    key, self.num_workers) == self.worker_index:
                try:
                    payload = self._table.get(key)
                except Exception:
                    payload = None
                out[idx] = payload
                self.stats["local_hits"] += 1
                if self._recording:
                    self._last_reads[key] = payload
                continue
            ent = self._cache.get(key)
            if ent is not None and now - ent[1] <= self.cache_ttl_s:
                out[idx] = ent[0]
                self.stats["cache_hits"] += 1
                continue
            misses.append((idx, key))
        if misses:
            vals = self._remote_fetch([k for _, k in misses])
            if len(self._cache) > 16384:
                self._cache.clear()
            for (idx, key), v in zip(misses, vals):
                out[idx] = v
                self._cache[key] = (v, now)
        return out

    def _lookup_one(self, key: str) -> Optional[str]:
        return self._lookup_many([key])[0]

    def _ensure_step(self) -> SGDStep:
        if self._step is not None:
            return self._step
        zero = ";".join(["0.0"] * self.dim)
        user_mean = self._lookup_one("MEAN-U") or zero
        item_mean = self._lookup_one("MEAN-I") or zero
        self._step = SGDStep(
            self._lookup_one,
            user_mean,
            item_mean,
            learning_rate=self.lr,
            user_reg=self.user_reg,
            item_reg=self.item_reg,
            version=self.version,
            lookup_many=self._lookup_many,
            update_bias=self.update_bias,
        )
        return self._step

    # -- apply path ----------------------------------------------------------

    def _publish(self, rows: List[str]) -> None:
        if not rows:
            return
        with self._pub_lock:
            self._model_journal.append(rows, flush=False)
        self.stats["published_rows"] += len(rows)

    def _conflict_pass(self, batch, rows: List[str]) -> List[str]:
        """Optimistic concurrency for the LOCALLY read item vectors: if
        concurrent ingest changed an item row between our base read and
        the apply, recompute that item's ratings against the fresh vector
        and APPEND the rows — last-writer-wins makes the recomputed rows
        land.  Remote (cross-shard) conflicts are not detectable here and
        keep the reference's at-least-once LWW semantics."""
        if self._table is None or not self._last_reads:
            return rows
        extra: List[str] = []
        by_item: Optional[Dict[int, list]] = None
        checked = set()
        for _, item, _ in batch:
            key = f"{item}-I"
            if key in checked or key not in self._last_reads:
                continue
            checked.add(key)
            try:
                cur = self._table.get(key)
            except Exception:
                continue
            if cur == self._last_reads[key]:
                continue
            self._c_conflicts.inc()
            self.stats["conflicts"] += 1
            # make the recompute see the fresh row, not our stale copies
            self._overlay.pop(key, None)
            self._cache.pop(key, None)
            if by_item is None:
                by_item = {}
                for u2, i2, r2 in batch:
                    by_item.setdefault(i2, []).append((u2, i2, r2))
            self._recording = False
            try:
                step = self._ensure_step()
                for u2, i2, r2 in by_item.get(item, ()):
                    extra.extend(step.process(u2, i2, r2))
            finally:
                self._recording = True
        return rows + extra

    def _apply_batch(self, part: _Part, batch, seq_from: int,
                     in_off_after: int) -> None:
        # sampled trace root: apply -> publish -> visible is the update
        # plane's critical chain, and TPUMS_TRACE_SAMPLE decides which
        # batches leave spans behind
        tid = obs_tracing.sample_trace()
        apply_sid = obs_tracing.new_span_id() if tid else None
        t_apply0 = time.time()
        step = self._ensure_step()
        self._last_reads = {}
        self._recording = True
        try:
            rows = step.process_batch(batch)
        finally:
            self._recording = False
        rows = self._conflict_pass(batch, rows)
        seq_to = seq_from + len(batch)
        # ONE line = the atomic commit point (torn tails are invisible to
        # journal readers, so a SIGKILL mid-write re-applies the batch)
        part.app_j.append(
            [f"{seq_from}\t{seq_to}\t{in_off_after}\t" + "|".join(rows)],
            flush=False,
        )
        if tid:
            obs_tracing.span_event(
                "update_apply", tid=tid, sid=apply_sid, psid=None,
                t0=t_apply0, dur_s=round(time.time() - t_apply0, 9),
                worker=self.worker_index, updates=len(batch),
                rows=len(rows))
            t_pub0 = time.time()
        self._publish(rows)
        if tid:
            obs_tracing.span_event(
                "update_publish", tid=tid, psid=apply_sid, t0=t_pub0,
                dur_s=round(time.time() - t_pub0, 9),
                worker=self.worker_index, rows=len(rows))
        # co-located arena table: seqlock-update the shared rows in place
        # now, so update -> queryable stops round-tripping through the
        # journal (which stays the durability source: the consume loop's
        # later replay of these rows rewrites the same bytes).  Safe
        # because the worker holds the table object, and with it the
        # arena's writer flock, never a second mapping
        direct = getattr(self._table, "kind", "") == "arena"
        direct_keys: List[str] = []
        direct_vals: List[str] = []
        probe_key = probe_payload = None
        for row in rows:
            try:
                id_, typ, vec_s = row.split(",", 2)
            except ValueError:
                continue
            key = f"{id_}-{typ}"
            self._overlay[key] = vec_s
            if direct:
                direct_keys.append(key)
                direct_vals.append(vec_s)
            if typ == F.USER and owner_of(
                    key, self.num_workers) == self.worker_index:
                probe_key, probe_payload = key, vec_s
        if direct and direct_keys:
            if self._cas_enabled and hasattr(self._table,
                                             "cas_many_columns"):
                # expected = the value each update step READ; a mismatch
                # means another writer got there first and the journal's
                # replay is the truth: re-put only the failures
                expected = [self._last_reads.get(k) for k in direct_keys]
                failed = self._table.cas_many_columns(
                    direct_keys, expected, direct_vals)
                if failed:
                    self._table.put_many_columns(
                        [direct_keys[i] for i in failed],
                        [direct_vals[i] for i in failed])
            else:
                self._table.put_many_columns(direct_keys, direct_vals)
        if len(self._overlay) > 65536:
            self._overlay.clear()
        part.next_seq = seq_to
        part.in_off = in_off_after
        self._c_updates.inc(len(batch))
        self._c_batches.inc()
        self.stats["applied"] += len(batch)
        self.stats["batches"] += 1
        if self._probe is not None and probe_key is not None:
            self._probe.enqueue(probe_key, probe_payload,
                                tid=tid, psid=apply_sid)

    def _drain_part(self, part: _Part) -> bool:
        before = part.in_off
        try:
            lines, next_off = part.in_j.read_from(
                part.in_off, max_bytes=1 << 20)
        except OffsetTruncatedError as e:
            part.in_off = e.resume_offset
            return True
        if not lines:
            part.in_off = next_off
            return next_off != before
        off = part.in_off
        batch: List[Tuple[int, int, float]] = []
        batch_from = 0
        applied_any = False
        for ln in lines:
            line_end = off + len(ln.encode("utf-8")) + 1
            rec = None
            try:
                s_seq, s_u, s_i, s_r = ln.split("\t")
                rec = (int(s_seq), int(s_u), int(s_i), float(s_r))
            except ValueError:
                pass  # malformed row: skip-and-continue, like the consumer
            if rec is not None and rec[0] >= part.next_seq:
                seq = rec[0]
                if batch and seq != batch_from + len(batch):
                    # producer-side discontinuity: commit what we have so
                    # the apply record's range stays exact, then let the
                    # audit surface the gap
                    self._apply_batch(part, batch, batch_from, off)
                    applied_any = True
                    batch = []
                if not batch:
                    batch_from = seq
                batch.append(rec[1:])
                if len(batch) >= self.batch_size:
                    self._apply_batch(part, batch, batch_from, line_end)
                    applied_any = True
                    batch = []
            off = line_end
            if self._stop.is_set() and not batch:
                break
        if batch:
            self._apply_batch(part, batch, batch_from, off)
            applied_any = True
        if not applied_any:
            # everything in the chunk was replay/malformed: advance past it
            part.in_off = next_off
        return applied_any or part.in_off != before

    # -- topology ------------------------------------------------------------

    def _gen_superseded(self) -> bool:
        if self.generation is None:
            return False
        observed = None
        if self._job is not None:
            observed = getattr(self._job, "_observed_topology_gen", None)
        if observed is None:
            return False
        return observed > self.generation

    # -- main loop -----------------------------------------------------------

    def _run(self) -> None:
        last_acquire = -1.0
        try:
            while not self._stop.is_set():
                if self._gen_superseded():
                    # a newer generation was published: finish, release the
                    # leases and let its workers resume at our watermarks
                    break
                now = time.monotonic()
                if not self._held or now - last_acquire >= max(
                        self.poll_s, 0.05):
                    self._acquire_owned()
                    last_acquire = now
                progress = False
                for part in list(self._held.values()):
                    try:
                        progress |= self._drain_part(part)
                    except Exception as e:
                        # one poisoned partition must not kill the plane
                        print(f"[update-plane] partition {part.p} error:"
                              f" {e}", file=sys.stderr)
                    if self._stop.is_set():
                        break
                if not progress:
                    self._stop.wait(self.poll_s)
        finally:
            self._release_all()
            self._pub_lock.close()
            self._drop_client()
            self._drained.set()


# ---------------------------------------------------------------------------
# serving-worker attachment (the --updatePlane flag of serve/sharded.py)
# ---------------------------------------------------------------------------

def attach_update_worker(job, params, worker_index: int,
                         num_workers: int) -> UpdateWorker:
    """Build + start the co-located UpdateWorker for a serving worker
    process.  Remote (cross-shard) reads resolve through whatever fleet
    client the deployment shape provides: the elastic client when the
    worker runs under a topology group, the HA sharded client under a
    plain replicated job group, else no remote reads (mean fallback)."""
    topology_group = params.get("topologyGroup")
    job_group = params.get("jobGroup")

    def client_factory():
        if topology_group:
            from .elastic import ElasticClient
            return ElasticClient(
                topology_group, timeout_s=5.0, resolve_timeout_s=2.0)
        if job_group:
            from .ha import HAShardedClient
            return HAShardedClient(
                num_workers, job_group=job_group, timeout_s=5.0)
        return None

    worker = UpdateWorker(
        job.journal.dir,
        job.journal.topic,
        worker_index,
        num_workers,
        job=job,
        client_factory=client_factory,
        generation=params.get_int("topologyGen", None),
        partitions=params.get_int("updatePartitions", None),
        batch_size=params.get_int("updateBatch", None),
    )
    return worker.start()
