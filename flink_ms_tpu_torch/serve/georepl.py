"""Geo-distributed serving: multi-region journal replication,
region-local reads, and partition-tolerant failover.

Own copy of ``flink_ms_tpu/serve/georepl.py``: the same replicator, status
record (``<topic>.georepl.json``), geo topology record, write forwarder
and region controller, host code that owns no device.  A follower tree
the port writes is the reference's byte for byte (segments, folds,
snapshot copies), and a record either package publishes resolves in the
other.

The reference system serves one region; its Kafka bus and queryable-state
fleet share a failure domain.  Here a REGION is a (journal dir, registry
namespace) pair: the home region's journal is the source of truth, and a
per-region ``JournalReplicator`` pulls its byte stream — sealed segments,
compacted folds and live tail alike — through the journal's global-byte-
offset contract, so a follower journal is byte-for-byte offset-compatible
with home and every existing consumer (replay, snapshot bootstrap,
truncation recovery) works unchanged against it.

Replication model:

- The replicator reads ``read_bytes_from(offset)`` against the home
  journal and appends the raw chunk to the follower journal.  Because
  ``Journal.append`` derives offsets from file sizes, replaying the exact
  home byte stream keeps global offsets identical in both regions —
  consumer checkpoints and snapshot offsets are portable across regions.
- A compacted-prefix FOLD arrives as an offset jump (``next_offset >
  offset + len(chunk)``) and is mirrored as a follower
  ``<topic>.clog.<base>.<end>`` segment, so follower disk is bounded by
  the same compaction the home region runs.
- The REPLICATED OFFSET needs no side channel: the follower journal's
  ``aligned_end_offset()`` is itself the crash-safe resume point (bytes
  are fsynced before the offset advances).  A small status record
  (``<topic>.georepl.json``, tmp+rename) additionally carries lag and
  the last-caught-up timestamp — the staleness the wire surfaces.
- ``OffsetTruncatedError`` resumes through the same snapshot-cover path
  consumers use: a lossless fold restarts at the fold base; a
  LOSSY truncation copies home's covering snapshots into the follower's
  snapshot root and mirrors the truncation (drop the follower's stale
  prefix), so a follower consumer sees the identical typed error and
  recovers through its own snapshot bootstrap chain.

Failover (the elastic cutover protocol, one level up): the region
topology lives in a CAS-guarded registry topology record under group
``geo/<group>`` — ``{"geo": {"home", "regions": {region: {journal_dir}},
...}}``.  A ``RegionController`` in the follower region watches the home
fleet (watch-plane ``drop``-shape signal over the live home replica
count, confirmed by every home entry's heartbeat lease expiring) and
promotes: seal the replicated prefix -> CAS-publish the next region
topology generation with itself as home -> write forwarding re-points ->
reap the dead region's entries.  Write forwarding
(``GeoWriteForwarder``) is how SGD/UPDATE traffic reaches the home
region from anywhere: it resolves the home journal dir through the geo
record and re-points automatically when the generation moves.

Knobs: ``TPUMS_GEO_REGION`` (ambient region for registry scoping),
``TPUMS_GEO_POLL_S`` (replicator poll cadence), ``TPUMS_GEO_MAX_BYTES``
(pull chunk bound), ``TPUMS_GEO_DETECT_MISSES`` (consecutive empty
home scans before failover).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

from ..obs import tracing as obs_tracing
from ..obs.metrics import get_registry
from . import registry
from .journal import Journal, OffsetTruncatedError

__all__ = [
    "JournalReplicator", "RegionController", "GeoWriteForwarder",
    "geo_group", "publish_region_topology", "resolve_region_topology",
    "home_region", "region_journal_dir", "staleness_of", "home_drop_rule",
]

_GEN_SEP = "@g"  # mirrors serve/elastic.GEN_SEP (no import: georepl must
# not drag the whole elastic/client stack into the replicator process)


def _poll_s() -> float:
    try:
        return max(float(os.environ.get("TPUMS_GEO_POLL_S", 0.05)), 0.005)
    except ValueError:
        return 0.05


def _max_bytes() -> int:
    try:
        return max(int(os.environ.get("TPUMS_GEO_MAX_BYTES", 1 << 22)), 1024)
    except ValueError:
        return 1 << 22


# ---------------------------------------------------------------------------
# region topology record — the CAS-published "which region is home" truth
# ---------------------------------------------------------------------------

def geo_group(group: str) -> str:
    """The registry group carrying a serving group's REGION topology.
    Distinct from the group's (per-region) shard topology record; never
    region-qualified — it is the one record all regions share."""
    return f"geo/{group}"


def publish_region_topology(
    group: str,
    home: str,
    regions: Dict[str, dict],
    *,
    topic: Optional[str] = None,
    expect_gen: Optional[int] = None,
    controller: Optional[str] = None,
    extra: Optional[dict] = None,
) -> dict:
    """CAS-publish the group's region topology -> record.

    ``regions`` maps region name -> ``{"journal_dir": ...}``.  Reuses the
    elastic plane's topology record (generation counter, bounded history,
    ``TopologyConflict`` on a lost CAS), so failover is the same protocol
    as a cutover: plan against generation G, publish expecting G."""
    if home not in regions:
        raise ValueError(f"home region {home!r} not in regions "
                         f"{sorted(regions)}")
    geo = {"home": home, "regions": {
        r: dict(v) for r, v in regions.items()}}
    if extra:
        geo.update(extra)
    record_extra = {"geo": geo}
    if topic is not None:
        record_extra["topic"] = topic
    return registry.publish_topology(
        geo_group(registry.qualify_group(group)), shards=1, replicas=1,
        expect_gen=expect_gen, controller=controller, extra=record_extra,
    )


def resolve_region_topology(group: str, strict: bool = False
                            ) -> Optional[dict]:
    """The group's active region topology record, or None."""
    return registry.resolve_topology(
        geo_group(registry.qualify_group(group)), strict=strict)


def home_region(group: str) -> Optional[str]:
    rec = resolve_region_topology(group)
    return (rec.get("geo") or {}).get("home") if rec else None


def region_journal_dir(group: str, region: Optional[str] = None
                       ) -> Optional[str]:
    """A region's journal dir per the geo record (default: the home
    region's — where writes must land)."""
    rec = resolve_region_topology(group)
    if rec is None:
        return None
    geo = rec.get("geo") or {}
    r = region if region is not None else geo.get("home")
    return ((geo.get("regions") or {}).get(r) or {}).get("journal_dir")


# ---------------------------------------------------------------------------
# per-read staleness — what the wire's ``st=`` field reports
# ---------------------------------------------------------------------------

def _status_path(journal_dir: str, topic: str) -> str:
    return os.path.join(journal_dir, f"{topic}.georepl.json")


_STALENESS_CACHE: Dict[str, tuple] = {}
_STALENESS_TTL_S = 0.1


def staleness_of(journal_dir: str, topic: str) -> Optional[float]:
    """Seconds the (journal_dir, topic) pair trails its home region, or
    None when the journal is not a replication follower (the home region
    itself, or any pre-geo deployment).  This is the value a follower
    server stamps on ``st=``-tagged replies.

    Derived from the replicator's status record: zero while the last
    status write says caught-up and the record itself is fresh;
    otherwise the time since the replicator last drained home to its
    end — which keeps GROWING if the replicator is partitioned or dead,
    exactly the semantics a client weighing a stale read needs.  Cached
    ~100ms so the read path does not stat per request."""
    path = _status_path(journal_dir, topic)
    now = time.time()
    hit = _STALENESS_CACHE.get(path)
    if hit is not None and now - hit[0] < _STALENESS_TTL_S:
        return hit[1]
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        rec = None
    value: Optional[float] = None
    if isinstance(rec, dict) and "caught_up_ts" in rec:
        caught_up = float(rec["caught_up_ts"])
        written = float(rec.get("ts", caught_up))
        fresh_s = 10 * float(rec.get("poll_s", _poll_s()) or _poll_s())
        if rec.get("caught_up") and now - written < fresh_s:
            value = 0.0
        else:
            value = max(now - caught_up, 0.0)
    _STALENESS_CACHE[path] = (now, value)
    return value


# ---------------------------------------------------------------------------
# the journal replicator — one leased follower per (region, topic)
# ---------------------------------------------------------------------------

class ReplicatorBusy(RuntimeError):
    """Another live replicator holds this (region, topic) lease."""


class JournalReplicator:
    """Async puller mirroring one home topic into a follower journal dir.

    Single-writer per (region, topic): guarded by a registry controller
    lease on ``georepl/<region>/<topic>`` so two replicator processes
    cannot interleave appends into one follower journal.  Crash-safe by
    construction — the follower's own ``aligned_end_offset()`` is the
    resume point, and every append is fsynced before the in-memory
    offset advances."""

    def __init__(
        self,
        home_dir: str,
        follower_dir: str,
        topic: str,
        region: str,
        *,
        poll_s: Optional[float] = None,
        max_bytes: Optional[int] = None,
        lease: bool = True,
    ):
        if os.path.abspath(home_dir) == os.path.abspath(follower_dir):
            raise ValueError("follower journal dir must differ from home")
        self.home = Journal(home_dir, topic)
        self.follower = Journal(follower_dir, topic)
        self.topic = topic
        self.region = region
        self.poll_s = _poll_s() if poll_s is None else poll_s
        self.max_bytes = _max_bytes() if max_bytes is None else max_bytes
        self.lease_group = f"georepl/{region}/{topic}"
        self._lease_token: Optional[str] = None
        if lease:
            self._lease_token = registry.acquire_controller_lease(
                self.lease_group)
            if self._lease_token is None:
                raise ReplicatorBusy(
                    f"replicator lease busy: {self.lease_group}")
        self.offset = self.follower.aligned_end_offset()
        self.partitioned = False  # chaos fault injection: drop the link
        self.lost_bytes = 0
        self.compacted_rereads = 0
        self.folds_mirrored = 0
        self.snapshots_copied = 0
        self.bytes_replicated = 0
        self._caught_up_ts = time.time()
        self._caught_up = False
        self._status_written = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._obs_lag_bytes = reg.gauge(
            "tpums_georepl_lag_bytes", topic=topic, region=region)
        self._obs_lag_seconds = reg.gauge(
            "tpums_georepl_lag_seconds", topic=topic, region=region)
        self._obs_bytes = reg.counter(
            "tpums_georepl_bytes_total", topic=topic, region=region)

    # -- one pull ----------------------------------------------------------

    def step(self) -> int:
        """One replication poll -> bytes applied to the follower."""
        if self.partitioned:
            # fault injection: the link is down, so whatever we believed
            # about being caught up stops being true NOW — staleness must
            # grow from the last genuinely-caught-up instant
            self._caught_up = False
            self._publish_lag(time.time())
            return 0
        try:
            chunk, nxt = self.home.read_bytes_from(
                self.offset, self.max_bytes)
        except OffsetTruncatedError as err:
            self._recover(err)
            return 0
        now = time.time()
        if not chunk and nxt == self.offset:
            self._caught_up = True
            self._caught_up_ts = now
            self._publish_lag(now)
            return 0
        if nxt > self.offset + len(chunk):
            # compacted-prefix fold: the home read jumped to the fold's
            # logical end — mirror it as a follower clog segment so the
            # offset space stays identical
            self._mirror_fold(chunk, self.offset, nxt)
        else:
            self._append(chunk, self.offset)
        self.offset = nxt
        self.bytes_replicated += len(chunk)
        self._obs_bytes.inc(len(chunk))
        self._caught_up = False
        self._publish_lag(now)
        return len(chunk)

    def _append(self, chunk: bytes, at: int) -> None:
        j = self.follower
        with j._lock:
            base, path = j._active_segment_scan()
            try:
                size = os.path.getsize(path)
            except FileNotFoundError:
                size = 0
            if base + size != at:
                # fresh follower starting behind a truncated home, or the
                # restart after a lossy hole: open a segment exactly at
                # ``at`` so global offsets keep matching home
                path = os.path.join(j.dir, f"{j.topic}.log.{at}")
            with open(path, "ab") as f:
                f.write(chunk)
                f.flush()
                os.fsync(f.fileno())
            j._seg_cache = None
            j._active_cache = None

    def _mirror_fold(self, chunk: bytes, base: int, logical_end: int
                     ) -> None:
        j = self.follower
        final = os.path.join(
            j.dir, f"{j.topic}.clog.{base}.{logical_end}")
        tmp = f"{final}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        with j._lock:
            # delete the follower originals the fold now shadows (same
            # cleanup a home append performs after a compactor swap)
            j._apply_retention_locked()
            j._seg_cache = None
            j._active_cache = None
        self.folds_mirrored += 1

    def _recover(self, err: OffsetTruncatedError) -> None:
        """Resume through the consumers' snapshot-cover path, mirrored to the
        follower's disk instead of a consumer's table."""
        if err.lossless:
            # fold behind us: restart at the fold base re-reads an LWW
            # superset of what the follower already holds — converges
            self.compacted_rereads += 1
            self.offset = err.resume_offset
            return
        # LOSSY: home retention expired [offset, resume).  Copy home's
        # snapshots across so follower consumers can bootstrap over the
        # hole, then mirror the truncation itself: drop the follower's
        # stale prefix so a replaying follower consumer gets the SAME
        # typed OffsetTruncatedError + snapshot recovery it would at home.
        self.snapshots_copied += self._copy_snapshots()
        with self.follower._lock:
            for seg in self.follower._scan():
                try:
                    os.remove(seg.path)
                except OSError:
                    pass
            self.follower._seg_cache = None
            self.follower._active_cache = None
        lost = max(err.resume_offset - self.offset, 0)
        self.lost_bytes += lost
        obs_tracing.events_counter(
            "georepl_truncated", topic=self.topic, region=self.region,
            lost_bytes=lost)
        self.offset = err.resume_offset

    def _copy_snapshots(self) -> int:
        """Copy home snapshot members absent from the follower's snapshot
        root -> count copied.  tmp-dir + rename per member, so a reader
        never sees a member without its MANIFEST; foreign-topology
        families copy the same way (resolution happens at bootstrap)."""
        from . import snapshot as snapshot_mod

        src_root = snapshot_mod.snapshot_root(self.home.dir, self.topic)
        dst_root = snapshot_mod.snapshot_root(self.follower.dir, self.topic)
        try:
            names = os.listdir(src_root)
        except OSError:
            return 0
        os.makedirs(dst_root, exist_ok=True)
        copied = 0
        for name in names:
            src = os.path.join(src_root, name)
            dst = os.path.join(dst_root, name)
            if not name.startswith("snap-") or not os.path.isdir(src) \
                    or os.path.isdir(dst):
                continue
            tmp = os.path.join(dst_root, f".georepl-{os.getpid()}-{name}")
            shutil.rmtree(tmp, ignore_errors=True)
            try:
                shutil.copytree(src, tmp, copy_function=self._copy_member)
                os.rename(tmp, dst)
                copied += 1
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
        return copied

    @staticmethod
    def _copy_member(src: str, dst: str) -> None:
        """Arena members (sparse mmap images) ship reflink/hole-aware so a
        mostly-empty slab costs its resident bytes, not its capacity;
        everything else takes the ordinary copy."""
        if src.endswith(".dat"):
            from .arena import clone_file

            clone_file(src, dst)
        else:
            shutil.copy2(src, dst)

    # -- lag + status record ----------------------------------------------

    def lag_bytes(self) -> int:
        return max(self.home.end_offset() - self.offset, 0)

    def lag_seconds(self, now: Optional[float] = None) -> float:
        if self._caught_up:
            return 0.0
        return max((time.time() if now is None else now)
                   - self._caught_up_ts, 0.0)

    def _publish_lag(self, now: float) -> None:
        lag_b = self.lag_bytes()
        lag_s = self.lag_seconds(now)
        self._obs_lag_bytes.set(lag_b)
        self._obs_lag_seconds.set(lag_s)
        # throttled status record: the staleness_of() read side
        if now - self._status_written < 2 * self.poll_s:
            return
        path = _status_path(self.follower.dir, self.topic)
        rec = {
            "kind": "georepl", "topic": self.topic, "region": self.region,
            "home_dir": self.home.dir, "offset": self.offset,
            "lag_bytes": lag_b, "caught_up": self._caught_up,
            "caught_up_ts": self._caught_up_ts, "ts": now,
            "poll_s": self.poll_s,
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, path)
            self._status_written = now
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # -- lifecycle ---------------------------------------------------------

    def run_until_caught_up(self, timeout_s: float = 30.0) -> int:
        """Drive ``step`` until the follower drains home (tests/bootstrap)
        -> total bytes replicated this call."""
        deadline = time.time() + timeout_s
        total = 0
        while True:
            n = self.step()
            total += n
            if n == 0 and self._caught_up:
                return total
            if time.time() > deadline:
                raise TimeoutError(
                    f"replicator not caught up within {timeout_s}s "
                    f"(offset={self.offset})")

    def start(self) -> "JournalReplicator":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"tpums-georepl-{self.region}-{self.topic}")
        self._thread.start()
        return self

    def _run(self) -> None:
        last_refresh = 0.0
        while not self._stop.is_set():
            now = time.time()
            if self._lease_token is not None and \
                    now - last_refresh >= registry.heartbeat_interval_s():
                last_refresh = now
                if not registry.refresh_controller_lease(
                        self.lease_group, self._lease_token):
                    # lease lost: another replicator owns the follower now
                    obs_tracing.events_counter(
                        "georepl_lease_lost", topic=self.topic,
                        region=self.region)
                    self._lease_token = None
                    return
            try:
                n = self.step()
            except OSError:
                n = 0  # home dir unreachable (partition/death): keep lag
                self._publish_lag(time.time())
            if n == 0:
                self._stop.wait(self.poll_s)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self.follower.sync()
        if self._lease_token is not None:
            registry.release_controller_lease(
                self.lease_group, self._lease_token)
            self._lease_token = None


# ---------------------------------------------------------------------------
# write forwarding — SGD/UPDATE traffic always lands in the home region
# ---------------------------------------------------------------------------

class GeoWriteForwarder:
    """Region-agnostic rating producer: routes submits into the HOME
    region's update-plane input logs, re-pointing automatically when the
    region topology generation moves (failover).  The follower region
    never applies writes locally — it receives them back through journal
    replication, which is what keeps the two regions' byte streams (and
    therefore offsets and LWW outcomes) identical."""

    def __init__(self, group: str, topic: str, *,
                 partitions: Optional[int] = None,
                 refresh_s: Optional[float] = None):
        self.group = registry.qualify_group(group)
        self.topic = topic
        self.partitions = partitions
        self.refresh_s = (registry.heartbeat_interval_s()
                          if refresh_s is None else refresh_s)
        self.forwarded = 0
        self.repoints = 0
        self._gen: Optional[int] = None
        self._inner = None
        self._last_refresh = 0.0
        self._lock = threading.Lock()
        self._refresh(force=True)
        if self._inner is None:
            raise RuntimeError(
                f"no region topology published for {self.group!r}")

    def home(self) -> Optional[str]:
        rec = resolve_region_topology(self.group)
        return (rec.get("geo") or {}).get("home") if rec else None

    def _refresh(self, force: bool = False) -> None:
        now = time.time()
        if not force and self._inner is not None and \
                now - self._last_refresh < self.refresh_s:
            return
        self._last_refresh = now
        rec = resolve_region_topology(self.group)
        if rec is None:
            return  # keep forwarding to the last known home
        gen = int(rec.get("gen", 0))
        if gen == self._gen and self._inner is not None:
            return
        geo = rec.get("geo") or {}
        jdir = ((geo.get("regions") or {}).get(geo.get("home")) or {}
                ).get("journal_dir")
        if not jdir:
            return
        from .update_plane import UpdatePlaneClient

        self._inner = UpdatePlaneClient(
            jdir, self.topic, partitions=self.partitions)
        if self._gen is not None:
            self.repoints += 1
            obs_tracing.events_counter(
                "georepl_forwarder_repoint", group=self.group,
                home=geo.get("home") or "", gen=gen)
        self._gen = gen

    def submit(self, user: int, item: int, rating: float) -> int:
        with self._lock:
            self._refresh()
            p = self._inner.submit(user, item, rating)
        self.forwarded += 1
        return p

    def submit_many(self, ratings, flush: bool = False) -> int:
        with self._lock:
            self._refresh()
            n = self._inner.submit_many(ratings, flush=flush)
        self.forwarded += len(ratings)
        return n

    def sync(self) -> None:
        with self._lock:
            if self._inner is not None:
                self._inner.sync()


# ---------------------------------------------------------------------------
# region failover — the elastic cutover protocol, one level up
# ---------------------------------------------------------------------------

def home_drop_rule(group: str, region: str,
                   window_s: float = 60.0) -> "object":
    """A watch-plane ``drop``-shape rule over the home region's live
    replica count (the series ``RegionController`` exports): fires when
    the count falls below its window peak — the same signal shape
    ``default_rules`` uses for single-region replica loss."""
    from ..obs.rules import Rule

    return Rule(
        name=f"georepl_home_drop_{region}", kind="threshold",
        series="tpums_georepl_home_replicas", labels={"region": region},
        mode="drop", window_s=window_s, op=">=", value=1.0,
        for_s=0.0, severity="page",
        description=f"home region {region!r} live replica count fell "
                    f"below its {window_s:.0f}s peak")


class RegionController:
    """Watches the home region from a follower and promotes on death.

    Detection is two-signal by design: the DROP shape (live home replica
    count below its recent peak — fast, catches a SIGKILL'd fleet) must
    be confirmed by lease expiry (every home worker entry's heartbeat
    contract lapsed — slow, rules out a scrape blip), held for
    ``detect_misses`` consecutive polls.  Promotion reuses the elastic
    cutover protocol: single-writer lease on the geo group, seal, CAS
    publish, re-point, drain."""

    def __init__(
        self,
        group: str,
        topic: str,
        region: str,
        *,
        replicator: Optional[JournalReplicator] = None,
        detect_misses: Optional[int] = None,
        poll_s: Optional[float] = None,
    ):
        self.group = registry.qualify_group(group)
        self.topic = topic
        self.region = region
        self.replicator = replicator
        if detect_misses is None:
            try:
                detect_misses = int(os.environ.get(
                    "TPUMS_GEO_DETECT_MISSES", 2))
            except ValueError:
                detect_misses = 2
        self.detect_misses = max(int(detect_misses), 1)
        self.poll_s = (registry.heartbeat_interval_s()
                       if poll_s is None else poll_s)
        self.misses = 0
        self.promoted: Optional[dict] = None
        self.events: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- detection ---------------------------------------------------------

    def _home_live_replicas(self, home: str) -> int:
        """Live (heartbeat-fresh) worker entries in the home region's
        namespace for this group.  ``list_jobs`` already applies the
        heartbeat-lease liveness judgment, so a count of zero means
        every home entry's lease has expired — not merely that a scrape
        went quiet."""
        scoped = registry.qualify_region(self.group, home)
        n = 0
        for e in registry.list_jobs(gc=False):
            rid = e.get("replica_of") or e.get("job_id") or ""
            if rid == scoped or rid.startswith(f"{scoped}{_GEN_SEP}") \
                    or rid.startswith(f"{scoped}/"):
                n += 1
        return n

    def run_once(self) -> Optional[dict]:
        """One watch tick -> the failover record when this tick promoted,
        else None."""
        rec = resolve_region_topology(self.group)
        if rec is None:
            return None
        geo = rec.get("geo") or {}
        home = geo.get("home")
        if home is None or home == self.region:
            self.misses = 0
            return None
        live = self._home_live_replicas(home)
        get_registry().gauge(
            "tpums_georepl_home_replicas", region=home).set(live)
        if live > 0:
            self.misses = 0
            return None
        self.misses += 1
        if self.misses < self.detect_misses:
            return None
        return self.failover(
            expect_gen=int(rec.get("gen", 0)),
            reason=f"home {home!r} dead: zero live replicas for "
                   f"{self.misses} polls (lease expiry confirmed)")

    # -- promotion ---------------------------------------------------------

    def failover(self, expect_gen: Optional[int] = None,
                 reason: str = "manual") -> Optional[dict]:
        """Promote THIS region to home -> the new geo record, or None
        when another controller won the race (lease busy / CAS lost)."""
        rec = resolve_region_topology(self.group)
        if rec is None:
            raise RuntimeError(f"no region topology for {self.group!r}")
        geo = rec.get("geo") or {}
        old_home = geo.get("home")
        if old_home == self.region:
            return None  # already home
        ggroup = geo_group(self.group)
        token = registry.acquire_controller_lease(ggroup)
        if token is None:
            return None  # another region's controller is mid-promotion
        t0 = time.time()
        try:
            # re-check under the lease: the record may have moved while
            # we queued for it
            rec = resolve_region_topology(self.group)
            if rec is None:
                return None
            geo = dict(rec.get("geo") or {})
            if geo.get("home") == self.region:
                return None
            # 1. seal the replicated prefix: stop pulling, fsync, and
            # record exactly how far the promoted journal got
            sealed = None
            if self.replicator is not None:
                self.replicator.stop()
                sealed = self.replicator.follower.aligned_end_offset()
            # 2. CAS-publish the next region topology generation
            geo["home"] = self.region
            geo["failover"] = {
                "from": old_home, "to": self.region, "at": t0,
                "sealed_offset": sealed, "reason": reason,
            }
            try:
                new_rec = registry.publish_topology(
                    ggroup, shards=1, replicas=1,
                    expect_gen=(int(rec.get("gen", 0))
                                if expect_gen is None else expect_gen),
                    extra={"geo": geo, "topic": self.topic},
                )
            except registry.TopologyConflict:
                return None  # lost the CAS: someone else promoted
            # 3. write forwarding re-points by polling the new generation
            # (GeoWriteForwarder._refresh); nothing to push here.
            # 4. drain: reap the dead home region's registry entries
            reaped = registry.gc_region_entries(old_home) if old_home \
                else 0
            took_s = time.time() - t0
            ev = obs_tracing.event(
                "region_failover", group=self.group, topic=self.topic,
                from_region=old_home or "", to_region=self.region,
                gen=new_rec["gen"], sealed_offset=sealed,
                reaped=reaped, took_s=round(took_s, 4), reason=reason)
            get_registry().counter(
                "tpums_georepl_failovers_total", group=self.group).inc()
            get_registry().gauge(
                "tpums_georepl_failover_s", group=self.group).set(took_s)
            self.events.append(ev)
            self.promoted = new_rec
            return new_rec
        finally:
            registry.release_controller_lease(ggroup, token)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RegionController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"tpums-regionctl-{self.region}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if self.run_once() is not None:
                    return  # promoted: this controller's watch is done
            except Exception:
                pass  # registry blips must not kill the watchdog
            self._stop.wait(self.poll_s)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
