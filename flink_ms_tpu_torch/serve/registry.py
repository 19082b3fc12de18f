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

Tenants, regions, topology records, controller leases, push epochs,
snapshot and alert records are not ported yet: they belong to the fleet,
the push plane and the rest of ``obs/`` (ROADMAP.md, Queue 1).
Registration is best-effort: registry I/O failures never take down a
serving job.
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


def _load_json_retry(path: str):
    """Shared torn-read guard for every registry file read.

    Writers are atomic (tmp + rename/link), but a reader can still open a
    file mid-replacement on filesystems whose rename visibility is not a
    single point (NFS attribute caching, overlayfs copy-up), or catch a
    non-registry writer mid-write.  A JSON decode failure is therefore
    ambiguous: torn-mid-write or an actual corpse.  ONE short re-read
    disambiguates — a concurrent writer's rename lands within the backoff,
    so a live record is never judged dead off a single torn read.  A
    missing file stays an immediate None (no entry is not a torn entry)."""
    for attempt in (0, 1):
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            if attempt == 0:
                time.sleep(0.002)
    return None


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
    current = _load_json_retry(path)
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
            and not entry_is_dead(current):
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
    entry = _load_json_retry(path)
    if not isinstance(entry, dict) or "port" not in entry:
        return None
    if entry_is_dead(entry):
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
        entry = _load_json_retry(path)
        if not isinstance(entry, dict) or "port" not in entry:
            continue
        if entry_is_dead(entry):
            if gc:
                fresh = _reap_if_unchanged(path, entry)
                if fresh is not None:
                    out.append(fresh)
            continue
        out.append(entry)
    return out


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
# topology records + controller lease (the elastic plane, serve/elastic.py)
# ---------------------------------------------------------------------------

TOPOLOGY_HISTORY = 8  # superseded generations kept in the record


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
