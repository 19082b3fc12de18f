"""Job location registry: the jobId -> endpoint resolution the reference
gets from its JobManager (``QueryClientHelper.java:82-92,121``).

Own copy of the endpoint part of ``flink_ms_tpu/serve/registry.py``.  The
registry is a directory (``TPUMS_REGISTRY_DIR``, else
``<tmpdir>/flink_ms_tpu_registry``, the JAX package's default): every
serving job writes ``<jobId>.json`` (host, port, state, pid, and a
heartbeat it refreshes every ``TPUMS_HEARTBEAT_S`` within a TTL of
``TPUMS_REPLICA_TTL_S``) on start and removes it on stop, and clients
resolve ``--jobId`` through it when no explicit ``--jobManagerPort`` is
given.  The entries are the JAX package's, so a client of either package
resolves a job of either package by id.  Readers treat an entry whose pid
is gone (on this host) or whose heartbeat is past its TTL as dead and reap
it.

Replica sets (the fleet, ``serve/ha.py``): a replicated shard worker
registers with ``replica_of`` (the logical shard group id, e.g.
``"mysvc/shard-0"``), ``replica`` (its index in the set) and ``ready``
(False while it is still replaying the journal); ``resolve_replicas``
returns the live members of a group.

Topology records (``serve/elastic.py``): a job GROUP's active shape lives
in one ``kind="topology"`` record, ``(gen, shards, replicas)`` plus a
bounded history of superseded generations, published atomically (tmp +
rename under a short-lived lock file) and CAS-guarded (``expect_gen``; a
lost race raises ``TopologyConflict``).  ``gc_generation_entries`` reaps
dead worker entries of superseded generations.  A controller LEASE
(``acquire_controller_lease``) makes rescaling single-writer per group; a
dead holder's lease is stolen under a link-based steal lock.  Tenants are
a name prefix on group ids (``qualify_group``, ``TPUMS_TENANT``), listed
by ``list_tenants``/``list_tenant_jobs`` and reaped one tenant at a time
by ``gc_tenant_entries``, which cannot reach another tenant's entries.

Push epochs (``next_push_epoch``), snapshot records (``publish_snapshot``)
and the alert records a watcher publishes (``publish_alerts`` with a TTL,
``resolve_alerts``, ``drop_alerts``) are the reference's records in the
reference's files.  Every record and lease either package writes is read
and honoured by the other.  Region namespaces (``qualify_region``,
``TPUMS_GEO_REGION``, ``list_regions``, ``gc_region_entries``) and the
edge proxies' group (``edge_group``) name the reference's records, so a
geo record or a proxy entry of one package resolves in the other.
Registration is best-effort: registry I/O failures never take down a
serving job, but a topology publish raises (a controller must know its
cutover failed).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, Optional, Tuple

from ..core.params import Params


def registry_dir() -> str:
    return os.environ.get("TPUMS_REGISTRY_DIR") or os.path.join(
        tempfile.gettempdir(), "flink_ms_tpu_registry"
    )


def heartbeat_interval_s() -> float:
    """Registry heartbeat cadence (``TPUMS_HEARTBEAT_S``, default 1 s)."""
    try:
        return max(float(os.environ.get("TPUMS_HEARTBEAT_S", 1.0)), 0.05)
    except ValueError:
        return 1.0


def replica_ttl_s() -> float:
    """Staleness TTL for heartbeat-bearing entries (``TPUMS_REPLICA_TTL_S``,
    default 5x the heartbeat interval).  The TTL must comfortably exceed
    the heartbeat cadence or a GC'd entry flaps on every scheduler hiccup."""
    try:
        v = os.environ.get("TPUMS_REPLICA_TTL_S")
        if v is not None:
            return max(float(v), 0.1)
    except ValueError:
        pass
    return 5.0 * heartbeat_interval_s()


def _load_json_retry(path: str, strict: bool = False):
    """Shared torn-read guard for every registry file read.

    Writers are atomic (tmp + rename/link), but a reader can still open a
    file mid-replacement on filesystems whose rename visibility is not a
    single point (NFS attribute caching, overlayfs copy-up), or catch a
    non-registry writer mid-write.  A JSON decode failure is therefore
    ambiguous: torn-mid-write or an actual corpse.  ONE short re-read
    disambiguates — a concurrent writer's rename lands within the backoff,
    so a live record is never judged dead off a single torn read.  A
    missing file stays an immediate None (no entry is not a torn entry).

    ``strict=True`` (the elastic client's topology refresh) re-raises the
    final failure instead of returning None, so callers can tell "no
    record" from "the registry is unreadable right now"."""
    last_err: Optional[Exception] = None
    for attempt in (0, 1):
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            last_err = e
            if attempt == 0:
                time.sleep(0.002)
    if strict and last_err is not None:
        raise last_err
    return None


def _read_entry(path: str):
    """-> (the entry file's JSON or None, the clock read BEFORE the file
    was opened).  A heartbeat is judged against the time its file was
    opened, never a later one: a read that waits (every file operation on
    the host held up while other processes sync large files, or the
    reader descheduled between the read and its clock) cannot age an
    entry whose writer keeps it fresh, and so cannot reap a live member's
    entry.  A lapsed heartbeat is seen as late as the read's own wait at
    most."""
    now = time.time()
    return _load_json_retry(path), now


def _entry_path(job_id: str) -> str:
    # jobIds are caller-chosen strings: sanitize for the filesystem, and
    # append a short digest of the RAW id so distinct ids can never map to
    # one file (sanitizing alone would let "als/prod" overwrite or delete
    # "als_prod"'s live registration)
    import hashlib

    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in job_id)
    digest = hashlib.sha1(job_id.encode("utf-8")).hexdigest()[:8]
    return os.path.join(registry_dir(), f"{safe[:80]}-{digest}.json")


def register(
    job_id: str,
    host: str,
    port: int,
    state_name: str,
    *,
    replica_of: Optional[str] = None,
    replica: Optional[int] = None,
    ready: Optional[bool] = None,
    ttl_s: Optional[float] = None,
) -> None:
    """Record a serving job's endpoint (atomic write; best-effort).

    Re-registering IS the heartbeat: a writer that passed ``ttl_s`` calls
    this again on its heartbeat cadence (full-entry atomic rewrite — no
    read-modify-write race with a concurrent reaper)."""
    try:
        os.makedirs(registry_dir(), exist_ok=True)
        path = _entry_path(job_id)
        tmp = f"{path}.{os.getpid()}.tmp"
        import socket

        entry = {
            "job_id": job_id, "host": host, "port": int(port),
            "state": state_name, "pid": os.getpid(),
            # pid_host scopes the pid-liveness check: on a shared-FS
            # registry a pid is only meaningful on the machine that
            # recorded it (a wildcard bind says nothing about where)
            "pid_host": socket.gethostname(),
        }
        if replica_of is not None:
            entry["replica_of"] = replica_of
        if replica is not None:
            entry["replica"] = int(replica)
        if ready is not None:
            entry["ready"] = bool(ready)
        if ttl_s is not None:
            entry["ttl_s"] = float(ttl_s)
            entry["heartbeat"] = time.time()
        with open(tmp, "w") as f:
            json.dump(entry, f)
        os.replace(tmp, path)
    except OSError:
        pass


def unregister(job_id: str) -> None:
    try:
        os.unlink(_entry_path(job_id))
    except OSError:
        pass


def entry_is_dead(entry: dict, now: Optional[float] = None) -> bool:
    """True when this entry's job is provably gone: a locally-recorded pid
    that no longer exists, or a heartbeat contract (``ttl_s``) the writer
    has broken.  Entries without either signal are presumed alive."""
    pid = entry.get("pid")
    if isinstance(pid, int) and _pid_is_ours_and_dead(entry):
        return True
    ttl = entry.get("ttl_s")
    hb = entry.get("heartbeat")
    if isinstance(ttl, (int, float)) and isinstance(hb, (int, float)):
        if (time.time() if now is None else now) - hb > ttl:
            return True
    return False


def _reap_if_unchanged(path: str, entry: dict) -> Optional[dict]:
    """GC a dead entry, guarding the reap TOCTOU: a supervisor may have
    re-registered the job at this path since our read — only unlink if the
    file still carries the same (pid, heartbeat) we judged dead.  Returns
    the FRESH entry when one replaced the dead one, else None."""
    current, now = _read_entry(path)
    if current is None:
        return None
    if (
        isinstance(current, dict)
        and current.get("pid") == entry.get("pid")
        and current.get("heartbeat") == entry.get("heartbeat")
    ):
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    if isinstance(current, dict) and "port" in current \
            and not entry_is_dead(current, now):
        return current
    return None


def resolve(job_id: str) -> Optional[dict]:
    """-> the registered entry for job_id, or None.

    A SIGKILL'd ServingJob never runs its unregister cleanup, so an entry
    recorded by THIS machine (pid_host matches) whose pid is dead — or any
    entry whose heartbeat contract has lapsed — is treated as no-entry
    (and reaped): clients then fall back to the explicit-port defaults
    instead of getting connection-refused on a stale endpoint.  Entries
    recorded elsewhere (shared-FS registry) are never pid-checked: the pid
    is meaningless across machines; their TTL still applies."""
    path = _entry_path(job_id)
    entry, now = _read_entry(path)
    if not isinstance(entry, dict) or "port" not in entry:
        return None
    if entry_is_dead(entry, now):
        return _reap_if_unchanged(path, entry)
    return entry


def list_jobs(gc: bool = True) -> List[dict]:
    """Every live entry in the registry (GC'ing dead ones on the way,
    unless ``gc=False``).  The ops/discovery surface: replica resolution,
    supervisors, and the chaos harness all build on this scan."""
    out: List[dict] = []
    try:
        names = os.listdir(registry_dir())
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(registry_dir(), name)
        entry, now = _read_entry(path)
        if not isinstance(entry, dict) or "port" not in entry:
            continue
        if entry_is_dead(entry, now):
            if gc:
                fresh = _reap_if_unchanged(path, entry)
                if fresh is not None:
                    out.append(fresh)
            continue
        out.append(entry)
    return out


def resolve_replicas(replica_of: str) -> List[dict]:
    """Live members of a replica group, sorted by replica index.  Entries
    whose ``ready`` flag is False are included (callers that must not send
    traffic to a replaying replica filter on ``ready`` themselves; a
    supervisor needs to see them to NOT respawn them)."""
    members = [
        e for e in list_jobs() if e.get("replica_of") == replica_of
    ]
    members.sort(key=lambda e: (e.get("replica", 0), e.get("job_id", "")))
    return members


# ---------------------------------------------------------------------------
# tenant namespaces: a tenant is a NAME PREFIX on group ids (``acme::als``),
# inherited by every id derived from the group
# ---------------------------------------------------------------------------

TENANT_SEP = "::"


def default_tenant() -> Optional[str]:
    """The ambient tenant (``TPUMS_TENANT``), or None for the shared
    (un-prefixed) namespace."""
    t = os.environ.get("TPUMS_TENANT", "").strip()
    return t or None


def qualify_group(group: str, tenant: Optional[str] = None) -> str:
    """Tenant-scope a group name -> ``<tenant>::<group>``.

    ``tenant=None`` uses the ambient ``TPUMS_TENANT``; an explicit empty
    string pins the shared namespace regardless of environment.  Already
    qualified names pass through unchanged (idempotent)."""
    if TENANT_SEP in group:
        return group
    t = default_tenant() if tenant is None else (tenant.strip() or None)
    if not t:
        return group
    if TENANT_SEP in t or "/" in t or "\t" in t or "\n" in t:
        raise ValueError(f"bad tenant name: {t!r}")
    return f"{t}{TENANT_SEP}{group}"


def split_tenant(name: str) -> Tuple[Optional[str], str]:
    """``"acme::als@g3/shard-0"`` -> ("acme", "als@g3/shard-0");
    un-prefixed names -> (None, name)."""
    if TENANT_SEP in name:
        t, _, base = name.partition(TENANT_SEP)
        return (t or None), base
    return None, name


def tenant_of(name: str) -> Optional[str]:
    return split_tenant(name)[0]


def _entry_tenant(entry: dict) -> Optional[str]:
    return tenant_of(entry.get("replica_of") or entry.get("job_id") or "")


def list_tenants() -> List[str]:
    """Tenants with any registry presence (live worker entries or
    topology records), sorted.  The shared namespace is not a tenant and
    is never listed."""
    seen = set()
    for e in list_jobs(gc=False):
        t = _entry_tenant(e)
        if t:
            seen.add(t)
    try:
        names = os.listdir(registry_dir())
    except OSError:
        names = []
    for name in names:
        if not name.endswith(".topo.json"):
            continue
        rec = _read_record(os.path.join(registry_dir(), name), "topology")
        if rec:
            t = tenant_of(rec.get("group") or "")
            if t:
                seen.add(t)
    return sorted(seen)


def list_tenant_jobs(tenant: Optional[str], gc: bool = True) -> List[dict]:
    """Live entries belonging to one tenant's namespace (``tenant=None``
    selects the shared namespace)."""
    return [e for e in list_jobs(gc=gc) if _entry_tenant(e) == tenant]


def gc_tenant_entries(tenant: str) -> int:
    """Reap DEAD worker entries of ONE tenant -> count reaped.  Only
    entries whose identifiers carry ``<tenant>::`` are reachable: other
    tenants and the shared namespace are structurally out of reach.  Scans
    the raw registry dir, as ``gc_generation_entries`` does."""
    if not tenant:
        raise ValueError("gc_tenant_entries needs a tenant name")
    reaped = 0
    try:
        names = os.listdir(registry_dir())
    except OSError:
        return 0
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(registry_dir(), name)
        entry, now = _read_entry(path)
        if not isinstance(entry, dict) or "port" not in entry:
            continue
        if _entry_tenant(entry) != tenant:
            continue
        if entry_is_dead(entry, now) and \
                _reap_if_unchanged(path, entry) is None:
            reaped += 1
    return reaped


# ---------------------------------------------------------------------------
# region namespaces (the geo-distributed plane, serve/georepl.py)
# ---------------------------------------------------------------------------

# A region is the OUTERMOST name prefix on group/job identifiers:
# ``eu@@acme::als`` is region "eu"'s view of tenant "acme"'s serving group
# "als".  Same discipline as tenant namespaces, one level further out:
# every id derived from a region-qualified group — worker job ids, replica
# groups, generation groups, topology records, controller leases, snapshot
# scopes, alert scopes — inherits the prefix, so a follower fleet in one
# region shares zero registry records with the home fleet, and region GC
# structurally cannot touch another region's entries.

REGION_SEP = "@@"


def default_region() -> Optional[str]:
    """The ambient region (``TPUMS_GEO_REGION``), or None for the
    unscoped namespace — single-region deployments' default."""
    r = os.environ.get("TPUMS_GEO_REGION", "").strip()
    return r or None


def qualify_region(name: str, region: Optional[str] = None) -> str:
    """Region-scope a group/job name -> ``<region>@@<name>``.

    ``region=None`` uses the ambient ``TPUMS_GEO_REGION``; an explicit
    empty string pins the unscoped namespace regardless of environment.
    Already region-qualified names pass through unchanged (idempotent).
    Applied OUTSIDE tenant qualification: ``eu@@acme::als``."""
    if REGION_SEP in name:
        return name
    r = default_region() if region is None else (region.strip() or None)
    if not r:
        return name
    if (REGION_SEP in r or TENANT_SEP in r or "/" in r
            or "\t" in r or "\n" in r):
        raise ValueError(f"bad region name: {r!r}")
    return f"{r}{REGION_SEP}{name}"


def split_region(name: str) -> Tuple[Optional[str], str]:
    """``"eu@@acme::als@g3/shard-0"`` -> ("eu", "acme::als@g3/shard-0");
    unscoped names -> (None, name)."""
    if REGION_SEP in name:
        r, _, base = name.partition(REGION_SEP)
        return (r or None), base
    return None, name


def region_of(name: str) -> Optional[str]:
    return split_region(name)[0]


def _entry_region(entry: dict) -> Optional[str]:
    return region_of(entry.get("replica_of") or entry.get("job_id") or "")


def list_regions() -> List[str]:
    """Regions with any registry presence (live worker entries or topology
    records), sorted.  The unscoped namespace is not a region."""
    seen = set()
    for e in list_jobs(gc=False):
        r = _entry_region(e)
        if r:
            seen.add(r)
    try:
        names = os.listdir(registry_dir())
    except OSError:
        names = []
    for name in names:
        if not name.endswith(".topo.json"):
            continue
        rec = _read_record(os.path.join(registry_dir(), name), "topology")
        if rec:
            r = region_of(rec.get("group") or "")
            if r:
                seen.add(r)
    return sorted(seen)


def list_region_jobs(region: Optional[str], gc: bool = True) -> List[dict]:
    """Live entries belonging to one region's namespace (``region=None``
    selects the unscoped namespace)."""
    return [e for e in list_jobs(gc=gc) if _entry_region(e) == region]


# ---------------------------------------------------------------------------
# edge-proxy namespace (serve/edge.py)
# ---------------------------------------------------------------------------

EDGE_PREFIX = "edge/"


def edge_group(group: str, region: Optional[str] = None) -> str:
    """The registry replica-group carrying a serving group's EDGE PROXY
    endpoints — ``edge/<region>@@<tenant>::<group>``.

    Proxies register under it with ``replica_of=edge_group(g)`` (one
    entry per proxy, ``replica=<index>``) and re-register on the
    heartbeat cadence like any worker, so ``resolve_replicas`` is the
    one discovery path clients, smokes and the scraper all share.
    Distinct from the group's shard topology record: the edge tier is
    stateless and has no generations — proxies follow the data plane's
    topology record, they never appear in it."""
    return f"{EDGE_PREFIX}{qualify_region(qualify_group(group), region)}"


def gc_region_entries(region: str) -> int:
    """Reap DEAD worker entries of ONE region -> count reaped.  Same
    structural-isolation statement as ``gc_tenant_entries``: only entries
    whose identifiers carry ``<region>@@`` are reachable."""
    if not region:
        raise ValueError("gc_region_entries needs a region name")
    reaped = 0
    try:
        names = os.listdir(registry_dir())
    except OSError:
        return 0
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(registry_dir(), name)
        entry, now = _read_entry(path)
        if not isinstance(entry, dict) or "port" not in entry:
            continue
        if _entry_region(entry) != region:
            continue
        if entry_is_dead(entry, now) and \
                _reap_if_unchanged(path, entry) is None:
            reaped += 1
    return reaped


def _pid_is_ours_and_dead(entry: dict) -> bool:
    import socket

    if entry.get("pid_host") != socket.gethostname():
        return False  # recorded by another machine (or a pre-pid_host
        # entry): liveness is unknowable here, keep the entry
    try:
        os.kill(entry["pid"], 0)
    except ProcessLookupError:
        return True
    except OSError:
        pass  # EPERM etc.: the process exists, just not ours
    return False


# ---------------------------------------------------------------------------
# group records: one file per (group, kind), read-modify-write under a lock
# ---------------------------------------------------------------------------

def _group_path(group: str, suffix: str) -> str:
    import hashlib

    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in group)
    digest = hashlib.sha1(group.encode("utf-8")).hexdigest()[:8]
    return os.path.join(registry_dir(), f"{safe[:80]}-{digest}.{suffix}")


def _read_record(path: str, kind: str, strict: bool = False
                 ) -> Optional[dict]:
    record = _load_json_retry(path, strict=strict)
    if not isinstance(record, dict) or record.get("kind") != kind:
        return None
    return record


class _GroupLock:
    """Short-lived O_EXCL lock file serializing read-modify-write of one
    group's records.  A lock older than ``stale_s`` is presumed abandoned
    (its holder crashed between create and unlink) and broken."""

    def __init__(self, path: str, timeout_s: float = 2.0,
                 stale_s: float = 5.0):
        self.path = path + ".lock"
        self.timeout_s = timeout_s
        self.stale_s = stale_s

    def __enter__(self):
        deadline = time.time() + self.timeout_s
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                return self
            except FileExistsError:
                try:
                    if time.time() - os.path.getmtime(self.path) > self.stale_s:
                        os.unlink(self.path)
                        continue
                except OSError:
                    continue  # holder released between stat and unlink
                if time.time() > deadline:
                    raise TimeoutError(
                        f"group lock busy: {self.path}") from None
                time.sleep(0.01)

    def __exit__(self, *exc):
        try:
            os.unlink(self.path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# topology records + controller lease (the elastic plane, serve/elastic.py)
# ---------------------------------------------------------------------------

TOPOLOGY_HISTORY = 8  # superseded generations kept in the record


class TopologyConflict(RuntimeError):
    """A CAS publish lost: the group's generation moved under the caller."""


def _topology_path(group: str) -> str:
    # distinct suffix so a JOB registered under the group's name can never
    # collide with the group's topology record
    return _group_path(group, "topo.json")


def resolve_topology(group: str, strict: bool = False) -> Optional[dict]:
    """The group's active topology record ``{gen, shards, replicas, ...}``,
    or None when no generation was ever published.  ``strict=True`` raises
    the underlying ``OSError``/``ValueError`` when the record exists but
    cannot be read."""
    return _read_record(_topology_path(group), "topology", strict=strict)


def publish_topology(
    group: str,
    shards: int,
    replicas: int = 1,
    *,
    expect_gen: Optional[int] = None,
    controller: Optional[str] = None,
    extra: Optional[dict] = None,
) -> dict:
    """Atomically publish the group's next topology generation -> record.

    The new generation is always ``current + 1`` (1 for a fresh group).
    ``expect_gen`` is the CAS guard: if another writer advanced the record
    since the caller planned against ``expect_gen``, this raises
    ``TopologyConflict`` instead of overwriting the newer topology.  The
    superseded generation joins a bounded ``history``.  ``extra`` adds
    record fields (it cannot shadow the protocol fields).  NOT
    best-effort: I/O failures raise."""
    if shards < 1 or replicas < 1:
        raise ValueError("need shards >= 1 and replicas >= 1")
    os.makedirs(registry_dir(), exist_ok=True)
    path = _topology_path(group)
    import socket

    with _GroupLock(path):
        current = _read_record(path, "topology")
        cur_gen = int(current["gen"]) if current else 0
        if expect_gen is not None and cur_gen != int(expect_gen):
            raise TopologyConflict(
                f"group {group!r} is at generation {cur_gen}, "
                f"publisher expected {expect_gen}"
            )
        history = list(current.get("history", ())) if current else []
        if current:
            superseded = {
                "gen": current["gen"], "shards": current["shards"],
                "replicas": current["replicas"],
                "published_at": current.get("published_at"),
            }
            if "model" in current:
                superseded["model"] = current["model"]
            history.append(superseded)
            history = history[-TOPOLOGY_HISTORY:]
        record = {
            "kind": "topology", "group": group, "gen": cur_gen + 1,
            "shards": int(shards), "replicas": int(replicas),
            "published_at": time.time(),
            "controller": controller
            or f"{socket.gethostname()}:{os.getpid()}",
            "history": history,
        }
        if extra:
            for k, v in extra.items():
                record.setdefault(k, v)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
    return record


def drop_topology(group: str) -> None:
    """Remove the group's topology record (teardown; best-effort)."""
    try:
        os.unlink(_topology_path(group))
    except OSError:
        pass


def generation_of(entry: dict, group: str, gen_sep: str = "@g"
                  ) -> Optional[int]:
    """Parse the topology generation out of a worker entry's shard-group id
    (``<group>@g<gen>/shard-<i>``); None for entries outside ``group``."""
    replica_of = entry.get("replica_of") or ""
    prefix = f"{group}{gen_sep}"
    if not replica_of.startswith(prefix):
        return None
    gen_s = replica_of[len(prefix):].split("/", 1)[0]
    try:
        return int(gen_s)
    except ValueError:
        return None


def gc_generation_entries(group: str, active_gen: int) -> int:
    """Reap DEAD worker entries of generations < ``active_gen`` -> count.

    Live old-generation workers are left alone: a cutover drains them
    deliberately.  Scans the raw registry dir (``list_jobs`` filters dead
    entries out of its result whether or not it GCs them)."""
    reaped = 0
    try:
        names = os.listdir(registry_dir())
    except OSError:
        return 0
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(registry_dir(), name)
        entry, now = _read_entry(path)
        if not isinstance(entry, dict) or "port" not in entry:
            continue
        gen = generation_of(entry, group)
        if gen is None or gen >= active_gen:
            continue
        if entry_is_dead(entry, now) and \
                _reap_if_unchanged(path, entry) is None:
            reaped += 1
    return reaped


def _controller_path(group: str) -> str:
    return _group_path(group, "ctl.json")


def acquire_controller_lease(group: str, ttl_s: Optional[float] = None
                             ) -> Optional[str]:
    """Try to become the group's single scaling controller -> lease token,
    or None while another live controller holds the lease.

    The holder refreshes within ``ttl_s`` (default: the replica TTL) or is
    presumed dead, and a dead holder's lease (pid gone, or heartbeat
    lapsed) is stolen under a link-based steal lock, so two stealers
    cannot both win one corpse.  Acquisition links a complete tmp file
    into place, so the lease appears atomically with its contents."""
    import socket
    import uuid

    os.makedirs(registry_dir(), exist_ok=True)
    path = _controller_path(group)
    token = uuid.uuid4().hex
    entry = {
        "kind": "controller", "group": group, "token": token,
        "pid": os.getpid(), "pid_host": socket.gethostname(),
        "heartbeat": time.time(),
        "ttl_s": replica_ttl_s() if ttl_s is None else float(ttl_s),
    }
    data = json.dumps(entry)
    tmp = f"{path}.{os.getpid()}.{token[:8]}.tmp"
    try:
        with open(tmp, "w") as f:
            f.write(data)
        try:
            os.link(tmp, path)
            return token
        except FileExistsError:
            pass
        current = _read_record(path, "controller")
        if current is not None and not entry_is_dead(current):
            return None
        # an unreadable record or a dead holder's lease: exactly ONE
        # claimant recovers it, under a steal lock that goes stale after
        # the lease TTL if its claimant died mid-steal
        lock = f"{path}.steal"
        try:
            os.link(tmp, lock)
        except FileExistsError:
            try:
                if time.time() - os.stat(lock).st_mtime > entry["ttl_s"]:
                    os.unlink(lock)
            except OSError:
                pass
            return None
        try:
            check = _read_record(path, "controller")
            if check is not None and not entry_is_dead(check):
                return None
            os.replace(tmp, path)
            return token
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass
    except OSError:
        return None
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def refresh_controller_lease(group: str, token: str) -> bool:
    """Heartbeat the lease -> True while this token still holds it."""
    path = _controller_path(group)
    current = _read_record(path, "controller")
    if current is None or current.get("token") != token:
        return False
    current["heartbeat"] = time.time()
    tmp = f"{path}.{os.getpid()}.hb.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(current, f)
        os.replace(tmp, path)
    except OSError:
        return False
    return True


def release_controller_lease(group: str, token: str) -> None:
    """Drop the lease iff this token still holds it (best-effort)."""
    path = _controller_path(group)
    current = _read_record(path, "controller")
    if current is not None and current.get("token") == token:
        try:
            os.unlink(path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# push-plane subscription epochs (serve/push.py)
# ---------------------------------------------------------------------------

def _push_epoch_path(scope: str) -> str:
    return _group_path(f"pushes/{scope}", "push.json")


def next_push_epoch(scope: str) -> int:
    """Atomically claim the scope's next subscription epoch -> int >= 1.

    Every push engine claims one epoch when it is built and mints
    subscription ids as ``<epoch>-<n>``, so ids stay unique across
    restarts: a RESUME that reaches an engine which never saw the
    subscription answers with a fresh id and a snapshot, never the old id
    with a colliding sequence space."""
    path = _push_epoch_path(scope)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _GroupLock(path):
        current = _read_record(path, "push_epoch")
        epoch = (int(current["epoch"]) if current else 0) + 1
        record = {"kind": "push_epoch", "scope": scope, "epoch": epoch,
                  "claimed_at": time.time(), "pid": os.getpid()}
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
    return epoch


# ---------------------------------------------------------------------------
# snapshot manifests (serve/snapshot.py publishes)
# ---------------------------------------------------------------------------

def snapshot_scope(
    group: Optional[str], topic: Optional[str], num_shards: int, shard: int
) -> str:
    """One registry record per (group-or-topic, sharding, shard): the
    LATEST published snapshot for that slice."""
    return f"snap/{group or topic or 'default'}/{num_shards}/{shard}"


def _snapshot_path(scope: str) -> str:
    return _group_path(scope, "snap.json")


def publish_snapshot(scope: str, manifest: dict) -> None:
    """Register the slice's latest snapshot manifest.  Best-effort by
    design: bootstrap resolves snapshots from the data dirs (which survive
    a wiped registry); this record only feeds observability."""
    os.makedirs(registry_dir(), exist_ok=True)
    path = _snapshot_path(scope)
    record = {"kind": "snapshot", "scope": scope,
              "published_at": time.time(), "manifest": dict(manifest)}
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def resolve_snapshot(scope: str) -> Optional[dict]:
    """The slice's latest registered snapshot manifest, or None."""
    record = _read_record(_snapshot_path(scope), "snapshot")
    return record.get("manifest") if record else None

# ---------------------------------------------------------------------------
# alert records: a watcher publishes them; HEALTH hints, the autopilot's
# drift step and the fleet signals read them.  Each record carries its own
# TTL, so a dead watcher's last word expires.
# ---------------------------------------------------------------------------

def _alerts_path(scope: str) -> str:
    return _group_path(f"alerts/{scope}", "alerts.json")


def publish_alerts(scope: str, summary: dict, ttl_s: float = 15.0) -> None:
    """Publish a watcher's alert summary (``RulesEngine.summary()`` shape:
    ``{"firing", "max_severity", "max_severity_level", "alerts"}``) under
    ``scope`` (a group name, or ``"fleet"`` for a whole-fleet watcher).
    Best-effort, like the snapshot records."""
    os.makedirs(registry_dir(), exist_ok=True)
    path = _alerts_path(scope)
    record = {"kind": "alerts", "scope": scope,
              "published_at": time.time(), "ttl_s": float(ttl_s),
              "summary": dict(summary)}
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def drop_alerts(scope: str) -> None:
    """Remove a scope's alert record (watcher teardown; best-effort)."""
    try:
        os.unlink(_alerts_path(scope))
    except OSError:
        pass


def resolve_alerts(scope: Optional[str] = None) -> Optional[dict]:
    """The current alert summary: one scope's fresh record, or, with no
    scope, every fresh record merged (firing counts sum, severities take
    the max).  Expired records are GC'd on the way past.  None when no
    watcher has published anything fresh."""
    if scope is not None:
        record = _read_record(_alerts_path(scope), "alerts")
        if record is None:
            return None
        if time.time() - record.get("published_at", 0) > \
                record.get("ttl_s", 15.0):
            drop_alerts(scope)
            return None
        return record.get("summary")
    merged: Optional[dict] = None
    try:
        names = os.listdir(registry_dir())
    except OSError:
        return None
    now = time.time()
    for fname in names:
        if not fname.startswith("alerts_") or \
                not fname.endswith(".alerts.json"):
            continue
        path = os.path.join(registry_dir(), fname)
        record = _read_record(path, "alerts")
        if record is None:
            continue
        if now - record.get("published_at", 0) > record.get("ttl_s", 15.0):
            try:
                os.unlink(path)
            except OSError:
                pass
            continue
        s = record.get("summary", {})
        if merged is None:
            merged = {"firing": 0, "max_severity": None,
                      "max_severity_level": 0, "alerts": []}
        merged["firing"] += int(s.get("firing", 0))
        merged["alerts"].extend(s.get("alerts", []))
        if s.get("max_severity_level", 0) > merged["max_severity_level"]:
            merged["max_severity_level"] = s["max_severity_level"]
            merged["max_severity"] = s.get("max_severity")
    return merged


def merge_endpoint(entry: Optional[dict], explicit_host: Optional[str],
                   default_host: str = "localhost",
                   default_port: int = 6123) -> Tuple[str, int]:
    """Merge a registry entry with a caller-supplied host into (host, port).

    The single place that encodes the precedence both client surfaces
    (flag-based CLIs and positional REPLs) share: an explicit host always
    wins; a registered wildcard bind (0.0.0.0) is reached via the explicit
    host or loopback default; no entry means the reference defaults."""
    host = explicit_host or default_host
    if entry is None:
        return host, default_port
    reg_host = entry.get("host") or ""
    if explicit_host is None and reg_host and reg_host != "0.0.0.0":
        host = reg_host
    return host, int(entry["port"])


def resolve_endpoint(params: Params, default_port: int = 6123
                     ) -> Tuple[str, int]:
    """(host, port) for a client CLI, with JobManager-style jobId routing.

    Precedence mirrors the reference's surface: an EXPLICIT
    ``--jobManagerPort`` wins (direct wiring always works); otherwise
    ``--jobId`` resolves through the registry like ``getKvState(jobId,...)``
    through the JobManager; otherwise the reference's defaults
    (localhost:6123)."""
    explicit_host = (
        params.get("jobManagerHost") if params.has("jobManagerHost") else None
    )
    if params.has("jobManagerPort"):
        return (explicit_host or "localhost",
                params.get_int("jobManagerPort", default_port))
    job_id = params.get("jobId")
    entry = resolve(job_id) if job_id else None
    return merge_endpoint(entry, explicit_host, default_port=default_port)
