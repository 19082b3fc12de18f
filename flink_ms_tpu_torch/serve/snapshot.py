"""Durable columnar snapshots of the serving table: the O(state) bootstrap
that replaces O(history) journal replay when a serving job (re)starts.

Own copy of ``flink_ms_tpu/serve/snapshot.py``: the same directory layout,
manifest keys, column files and checksum, so a snapshot either package
publishes bootstraps a job of the other.  A snapshot is a columnar dump of
one job's table at an exact journal offset:

    <journal_dir>/<topic>.snapshots/
        snap-<num_shards>-<shard>-<offset>-<ns>/
            keys.txt        newline-delimited key column
            vals.txt        newline-delimited value column (line-aligned)
            MANIFEST.json   {format, topology_group, gen, shard,
                             num_shards, offset, rows, checksum, ts}

The two-file columnar layout lets restore go straight through
``ModelTable.put_many_columns``.  ``checksum`` is a crc32 over both column
files; restore verifies it before loading, and a mismatch raises
``SnapshotCorruptError`` so the caller falls down the chain: bad checksum
-> older snapshot -> full journal replay.  Publication is crash-safe:
columns are written into a tmp dir, fsynced, and renamed.

Resolution for a bootstrapping job (owner = ``(shard, num_shards)``,
``(0, 1)`` for a standalone job): the newest valid snapshot with exactly
the job's identity, else the newest complete FAMILY (one snapshot per
shard of some source ``num_shards``), bulk-loaded with a hash%N ownership
filter per member and replayed from the family's minimum member offset.

Manifests are also registered through ``serve/registry.py`` (best-effort
``kind="snapshot"`` records).  An arena table (``serve/arena.py``)
publishes the ``arena/1`` format instead: one quiesced copy (or, with
``TPUMS_ARENA_PUBLISH=link``, a hard link) of its mapped file, read back
row by row through ``iter_arena_file``; either package bootstraps from the
other's.
"""

from __future__ import annotations

import json
import os
import sys
import time
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

SNAP_FORMAT = "tsv-columns/1"
# O(state) arena snapshots (serve/arena.py): one reflink/extent copy of the
# live mapped arena file instead of a serialize, with no checksum pass (rows
# are seqlock-framed and self-describing; load verifies the row count)
ARENA_FORMAT = "arena/1"
_MANIFEST = "MANIFEST.json"
_ARENA = "arena.dat"
_KEYS = "keys.txt"
_VALS = "vals.txt"


class SnapshotCorruptError(RuntimeError):
    """A snapshot member failed checksum/shape verification."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"snapshot {path} corrupt: {detail}")
        self.path = path
        self.detail = detail


def snapshot_root(journal_dir: str, topic: str) -> str:
    return os.path.join(journal_dir, f"{topic}.snapshots")


def snapshot_keep() -> int:
    try:
        return max(int(os.environ.get("TPUMS_SNAPSHOT_KEEP", 2)), 1)
    except ValueError:
        return 2


def _columns_checksum(keys_b: bytes, vals_b: bytes) -> int:
    return zlib.crc32(vals_b, zlib.crc32(keys_b))


# -- publication -------------------------------------------------------------

def publish(
    root: str,
    table,
    offset: int,
    *,
    shard: int = 0,
    num_shards: int = 1,
    group: Optional[str] = None,
    gen: Optional[int] = None,
    topic: Optional[str] = None,
    keep: Optional[int] = None,
) -> dict:
    """Write one snapshot artifact for (table, offset); returns the
    manifest (with its ``path``).  The caller guarantees the table is
    consistent with ``offset`` (the consume loop publishes between
    chunks, exactly like checkpoints).  An arena table (anything with
    ``quiesce_copy``) publishes the O(state) ``arena/1`` format; dict
    tables publish the portable columnar format."""
    if hasattr(table, "quiesce_copy"):
        return _publish_arena(
            root, table, offset, shard=shard, num_shards=num_shards,
            group=group, gen=gen, topic=topic, keep=keep)
    with table._lock:
        shards_copy = [dict(s) for s in table._shards]
    keys: List[str] = []
    vals: List[str] = []
    for s in shards_copy:
        keys.extend(s.keys())
        vals.extend(s.values())
    keys_b = ("\n".join(keys) + "\n").encode("utf-8") if keys else b""
    vals_b = ("\n".join(vals) + "\n").encode("utf-8") if vals else b""
    manifest = {
        "format": SNAP_FORMAT,
        "topology_group": group,
        "gen": gen,
        "shard": int(shard),
        "num_shards": int(num_shards),
        "offset": int(offset),
        "rows": len(keys),
        "checksum": _columns_checksum(keys_b, vals_b),
        "ts": time.time(),
    }
    name = f"snap-{num_shards}-{shard}-{offset}-{time.time_ns()}"
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp-{name}-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    for fname, data in ((_KEYS, keys_b), (_VALS, vals_b)):
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(root, name)
    os.rename(tmp, final)
    manifest["path"] = final
    _register(manifest, topic=topic)
    _prune(root, num_shards, shard, keep=snapshot_keep() if keep is None
           else keep)
    return manifest


def _publish_arena(
    root: str,
    table,
    offset: int,
    *,
    shard: int,
    num_shards: int,
    group: Optional[str],
    gen: Optional[int],
    topic: Optional[str],
    keep: Optional[int],
) -> dict:
    """Quiesce-and-copy publish: the arena file IS the artifact.  Same
    crash-safe tmp-dir + rename dance as the columnar writer; the copy is
    a reflink where the filesystem supports it (O(1)), else a hole-aware
    extent copy (O(resident))."""
    t0 = time.monotonic()
    name = f"snap-{num_shards}-{shard}-{offset}-{time.time_ns()}"
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp-{name}-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    geom = table.quiesce_copy(os.path.join(tmp, _ARENA))
    manifest = {
        "format": ARENA_FORMAT,
        "topology_group": group,
        "gen": gen,
        "shard": int(shard),
        "num_shards": int(num_shards),
        "offset": int(offset),
        "rows": int(geom["rows"]),
        # no content checksum: rows are seqlock-framed/self-describing and
        # the loader verifies the decoded row count against ``rows``
        "checksum": 0,
        "arena": geom,
        "ts": time.time(),
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(root, name)
    os.rename(tmp, final)
    manifest["path"] = final
    try:
        from ..obs.metrics import get_registry

        get_registry().gauge("tpums_arena_publish_seconds").set(
            time.monotonic() - t0)
    except Exception:
        pass
    _register(manifest, topic=topic)
    _prune(root, num_shards, shard, keep=snapshot_keep() if keep is None
           else keep)
    return manifest


def _register(manifest: dict, topic: Optional[str]) -> None:
    """Best-effort ``kind="snapshot"`` registry record for observability
    (the bootstrap path resolves from the data dirs, which survive a wiped
    registry)."""
    try:
        from . import registry

        registry.publish_snapshot(
            registry.snapshot_scope(
                manifest.get("topology_group"), topic,
                manifest["num_shards"], manifest["shard"],
            ),
            manifest,
        )
    except Exception:
        pass


def _prune(root: str, num_shards: int, shard: int, keep: int) -> None:
    import shutil

    all_ms = list_manifests(root)  # oldest-first
    mine = [
        m for m in all_ms
        if m["num_shards"] == num_shards and m["shard"] == shard
    ]
    mine.sort(key=lambda m: (m["offset"], m["ts"]))
    removed = set()
    for old in mine[:-keep]:
        shutil.rmtree(old["path"], ignore_errors=True)
        removed.add(old["path"])
    # foreign-topology leftovers: after a reshard nobody publishes under
    # the OLD num_shards anymore, so its family would outlive every
    # identity-scoped prune above.  Once a COMPLETE family of the publisher's (current) topology exists,
    # any foreign snapshot at or below that family's replay offset is
    # strictly superseded for every bootstrapper (exact or resharded:
    # resolve() always prefers the higher-offset plan) — reclaim it.
    newest_cur: dict = {}
    for m in all_ms:
        if m["num_shards"] == num_shards and m["path"] not in removed:
            newest_cur[m["shard"]] = m  # oldest-first scan: newest wins
    if set(newest_cur.keys()) < set(range(num_shards)):
        return
    floor = min(m["offset"] for m in newest_cur.values())
    for m in all_ms:
        if m["num_shards"] != num_shards and m["offset"] <= floor:
            shutil.rmtree(m["path"], ignore_errors=True)


# -- discovery / verification ------------------------------------------------

def list_manifests(root: str) -> List[dict]:
    """Well-formed manifests under ``root`` (each with its ``path``),
    oldest-first by offset.  Unreadable or misshapen entries are skipped —
    checksum verification happens at load time, not here."""
    out: List[dict] = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return out
    for name in names:
        if not name.startswith("snap-"):
            continue
        path = os.path.join(root, name)
        try:
            with open(os.path.join(path, _MANIFEST)) as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(m, dict) or m.get("format") not in (
                SNAP_FORMAT, ARENA_FORMAT):
            continue
        try:
            m["offset"] = int(m["offset"])
            m["shard"] = int(m["shard"])
            m["num_shards"] = int(m["num_shards"])
            m["rows"] = int(m["rows"])
            m["checksum"] = int(m["checksum"])
        except (KeyError, TypeError, ValueError):
            continue
        m["path"] = path
        out.append(m)
    out.sort(key=lambda m: (m["offset"], m.get("ts", 0.0)))
    return out


def read_columns(manifest: dict) -> Tuple[List[str], List[str]]:
    """Read and VERIFY one snapshot's column files; raises
    ``SnapshotCorruptError`` on checksum/shape mismatch.  An ``arena/1``
    member decodes its seqlock-framed rows (self-describing; verification
    is the decoded row count), so the loader downstream is format-blind."""
    path = manifest["path"]
    if manifest.get("format") == ARENA_FORMAT:
        from .arena import iter_arena_file

        keys = []
        vals = []
        try:
            for k, v in iter_arena_file(os.path.join(path, _ARENA)):
                keys.append(k)
                vals.append(v)
        except (OSError, ValueError) as e:
            raise SnapshotCorruptError(path, f"unreadable arena: {e}")
        # a link-published member shares the live inode: upserts after
        # publish may ADD rows (never remove — LWW, no deletes), so the
        # structural floor is >=; copy members are point-in-time, ==
        linked = (manifest.get("arena") or {}).get("publish") == "link"
        ok = (len(keys) >= manifest["rows"] if linked
              else len(keys) == manifest["rows"])
        if not ok:
            raise SnapshotCorruptError(
                path,
                f"row count mismatch: {len(keys)} decoded, manifest says "
                f"{manifest['rows']}",
            )
        return keys, vals
    try:
        with open(os.path.join(path, _KEYS), "rb") as f:
            keys_b = f.read()
        with open(os.path.join(path, _VALS), "rb") as f:
            vals_b = f.read()
    except OSError as e:
        raise SnapshotCorruptError(path, f"unreadable columns: {e}")
    if _columns_checksum(keys_b, vals_b) != manifest["checksum"]:
        raise SnapshotCorruptError(path, "checksum mismatch")
    # exact mirror of the writer's '"\n".join(col) + "\n"' encoding: split
    # on \n ONLY and drop the one trailing empty element.  splitlines()
    # would also break on \x85/\u2028/\u2029/\v/\f, which are legal INSIDE
    # a key or value (the ingest paths split raw bytes on \n alone) — that
    # skew fails the row-count check below on every restore
    keys = keys_b.decode("utf-8").split("\n")[:-1] if keys_b else []
    vals = vals_b.decode("utf-8").split("\n")[:-1] if vals_b else []
    if len(keys) != len(vals) or len(keys) != manifest["rows"]:
        raise SnapshotCorruptError(
            path,
            f"row count mismatch: {len(keys)} keys / {len(vals)} values, "
            f"manifest says {manifest['rows']}",
        )
    return keys, vals


# -- bootstrap resolution ----------------------------------------------------

def resolve(
    root: str,
    *,
    owner: Optional[Tuple[int, int]] = None,
    min_offset: Optional[int] = None,
    max_offset: Optional[int] = None,
    exclude: Sequence[str] = (),
) -> Optional[dict]:
    """Pick the best bootstrap plan: ``{"offset", "members", "exact"}``.

    ``owner`` is the bootstrapping worker's ``(shard, num_shards)``;
    ``exclude`` holds snapshot paths already found corrupt (the fallback
    chain).  Returns None when nothing usable exists — the caller falls
    back to full journal replay."""
    ms = [
        m for m in list_manifests(root)
        if m["path"] not in exclude
        and (min_offset is None or m["offset"] >= min_offset)
        and (max_offset is None or m["offset"] <= max_offset)
    ]
    if not ms:
        return None
    candidates: List[dict] = []
    if owner is not None:
        shard, num_shards = owner
        exact = [
            m for m in ms
            if m["num_shards"] == num_shards and m["shard"] == shard
        ]
        if exact:
            best = exact[-1]  # list_manifests sorts oldest-first
            candidates.append(
                {"offset": best["offset"], "members": [best], "exact": True}
            )
    # complete families: one (latest) member per shard of a source N.
    # Needed when the worker's sharding differs (or no owner was given) —
    # covering the whole key space takes all N source slices.
    by_n: dict = {}
    for m in ms:
        by_n.setdefault(m["num_shards"], {})[m["shard"]] = m  # newest wins
    for n, shards in by_n.items():
        if set(shards.keys()) != set(range(n)):
            continue
        members = [shards[s] for s in range(n)]
        candidates.append(
            {
                "offset": min(m["offset"] for m in members),
                "members": members,
                "exact": False,
            }
        )
    if not candidates:
        return None
    # highest replay-from offset wins; an exact-identity plan beats a
    # family at the same offset (one file, no filtering)
    candidates.sort(key=lambda p: (p["offset"], p["exact"]))
    return candidates[-1]


def load_plan(
    table,
    plan: dict,
    *,
    owner: Optional[Tuple[int, int]] = None,
) -> int:
    """Bulk-load a plan's members through ``put_many_columns``; returns
    rows loaded.  Raises ``SnapshotCorruptError`` on any bad member (the
    caller excludes it and re-resolves — last-writer-wins re-loading makes
    a partially-applied plan harmless)."""
    from .table import _fnv1a_batch

    rows = 0
    for m in plan["members"]:
        keys, vals = read_columns(m)
        if not keys:
            continue
        hashes = None
        if owner is not None and not (
            plan["exact"]
            and m["num_shards"] == owner[1]
            and m["shard"] == owner[0]
        ):
            shard, num_shards = owner
            hashes = _fnv1a_batch(keys)
            mine = hashes % num_shards == shard
            if not bool(mine.all()):
                import numpy as np

                keys = np.asarray(keys, dtype=object)[mine].tolist()
                vals = np.asarray(vals, dtype=object)[mine].tolist()
                hashes = hashes[mine]
        table.put_many_columns(keys, vals, hashes=hashes)
        rows += len(keys)
    return rows


def bootstrap(
    table,
    root: str,
    *,
    owner: Optional[Tuple[int, int]] = None,
    min_offset: Optional[int] = None,
    max_offset: Optional[int] = None,
    on_corrupt: Optional[Callable[[dict], None]] = None,
) -> Optional[dict]:
    """The full fallback chain: newest valid snapshot -> older snapshot ->
    None (caller replays the journal).  Returns
    ``{"offset", "rows", "members", "age_s"}`` on success."""
    exclude: set = set()
    while True:
        plan = resolve(
            root, owner=owner, min_offset=min_offset,
            max_offset=max_offset, exclude=exclude,
        )
        if plan is None:
            return None
        try:
            rows = load_plan(table, plan, owner=owner)
        except SnapshotCorruptError as e:
            bad = next(
                (m for m in plan["members"] if m["path"] == e.path),
                plan["members"][0],
            )
            exclude.add(bad["path"])
            if on_corrupt is not None:
                try:
                    on_corrupt(bad)
                except Exception:
                    pass
            print(f"[snapshot] {e}; trying older", file=sys.stderr)
            continue
        newest_ts = max(
            (m.get("ts", 0.0) for m in plan["members"]), default=0.0
        )
        return {
            "offset": plan["offset"],
            "rows": rows,
            "members": len(plan["members"]),
            "exact": plan["exact"],
            "age_s": max(time.time() - newest_ts, 0.0) if newest_ts else None,
        }
