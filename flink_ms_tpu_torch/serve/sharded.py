"""Multi-process sharded serving: N worker processes each own a hash slice
of the queryable state, with client-side key routing.

Own copy of ``flink_ms_tpu/serve/sharded.py``: the same routing function,
client, worker CLI flags, registry entries, journal topics and wire bytes,
so a client of either package reaches workers of either package.  This is
the scale-out dimension of the reference's serving plane
(``keyBy(0).asQueryableState`` across TaskManager subtasks,
``ALSKafkaConsumer.java:85-92``), made explicit:

- every worker consumes the SAME journal topic but keeps only the keys
  with ``fnv1a(key) % num_workers == worker_index`` (the stable hash the
  table uses for its own shards, ``table.py``);
- the client routes each key to its owning worker with the same hash;
- top-k fans out: the user's factor row is fetched from its owner, then a
  ``TOPKV`` scores every worker's catalog slice on that worker's device
  (its own ``DeviceFactorIndex``, ``serve/topk.py``) and the client merges
  the per-worker top-k with a stable sort on the score, in worker order.

Failure semantics: queries for keys owned by a dead worker raise
``ConnectionError`` while every other worker keeps serving; a restarted
worker restores its checkpoint and replays the journal from its offset.

Worker CLI (one process per worker; ``--replicaIndex``/``--jobGroup`` mark
membership in an HA replica set, ``serve/ha.py``)::

    python -m flink_ms_tpu_torch.serve.sharded --workerIndex 0 \\
        --numWorkers 3 --journalDir DIR --topic T --stateBackend fs \\
        --checkpointDataUri DIR2 [--device cuda|cpu] [--svm true] \\
        [--portFile P] [--replicaIndex 0 --jobGroup G] [--updatePlane true]

Every worker of an ALS fleet holds its own CUDA context on ``--device``
(default ``cuda``; no fallback: a worker that cannot reach CUDA exits,
and the launcher raises with its exit code).  Fleet members take the
arena table (``serve/consumer.py``; ``TPUMS_TABLE=dict`` opts out), and
``--nativeServer true`` serves each worker's slice from the C++ epoll
plane, as in the reference.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, List, Optional, Sequence, Tuple

from ..core.params import Params
from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from .client import QueryClient
from .consumer import (
    ALS_STATE,
    SVM_STATE,
    ServingJob,
    make_backend,
    parse_als_record,
    parse_svm_record,
)
from .journal import Journal
from .table import _fnv1a


def owner_of(key: str, num_workers: int) -> int:
    """The worker owning `key` — the one routing function shared by
    ingest filtering and client routing."""
    return _fnv1a(key) % num_workers


def sharded_parse(
    parse_fn: Callable[[str], Tuple[str, str]],
    worker_index: int,
    num_workers: int,
) -> Callable[[str], Optional[Tuple[str, str]]]:
    """Wrap a record parser so rows owned by other workers are skipped
    (the consume loop treats a None parse as not-mine, not an error)."""

    def parse(line: str) -> Optional[Tuple[str, str]]:
        key, value = parse_fn(line)
        if owner_of(key, num_workers) != worker_index:
            return None
        return key, value

    # advertise the wrapped parser's columnar mode plus the ownership
    # predicate so the consume loop's columnar path can split the chunk
    # with numpy and apply the SAME filter vectorized (consumer.py
    # _apply_chunk_columnar); the closure above stays the scalar fallback
    columnar_mode = getattr(parse_fn, "columnar_mode", None)
    if columnar_mode is not None:
        parse.columnar_mode = columnar_mode
        parse.shard_filter = (worker_index, num_workers)
    return parse


class ShardedQueryClient:
    """Routes queries across the worker endpoints by key hash.

    ``endpoints`` is the ordered (host, port) list — index == workerIndex.
    GET/MGET go straight to the owner; TOPK resolves the user's factors
    from their owner, then fans ``TOPKV`` to every worker and merges.
    """

    def __init__(
        self,
        endpoints: Sequence[Tuple[str, int]],
        timeout_s: float = 5.0,
        job_id: Optional[str] = None,
        seq_fanout_keys: int = 8,
        proto: Optional[str] = None,
    ):
        if not endpoints:
            raise ValueError("need at least one endpoint")
        # MGETs below this many total keys skip the thread pool and run
        # their per-owner sub-requests sequentially (see query_states)
        self.seq_fanout_keys = seq_fanout_keys
        from concurrent.futures import ThreadPoolExecutor

        # proto (serve/proto.py: tab|b2|auto; None defers to TPUMS_PROTO)
        # applies to every per-worker connection uniformly
        self._clients = [
            QueryClient(host, port, timeout_s=timeout_s, job_id=job_id,
                        proto=proto)
            for host, port in endpoints
        ]
        # persistent pool: spinning an executor up per query costs more
        # than the fan-out round trips it parallelizes.  One slot per
        # worker; per-worker QueryClients are each used by at most one
        # in-flight future at a time (futures are joined before return).
        self._pool = ThreadPoolExecutor(max_workers=len(self._clients))

    @property
    def num_workers(self) -> int:
        return len(self._clients)

    def owner(self, key: str) -> int:
        return owner_of(key, self.num_workers)

    def _count_error(self, verb: str) -> None:
        # no failover here: a raise IS client-visible — attribute it per
        # verb (same series the HA client's terminal failures land in)
        obs_metrics.get_registry().counter(
            "tpums_client_errors_total", verb=verb).inc()

    def query_state(self, name: str, key: str) -> Optional[str]:
        try:
            return self._clients[self.owner(key)].query_state(name, key)
        except (ConnectionError, OSError, TimeoutError):
            self._count_error("GET")
            raise

    def query_states(self, name: str, keys) -> list:
        """Batched lookups: one MGET per worker that owns any of the keys,
        issued CONCURRENTLY (latency ~ slowest worker, not the sum),
        results reassembled in request order."""
        keys = list(keys)
        out: List[Optional[str]] = [None] * len(keys)
        by_owner: dict = {}
        for pos, key in enumerate(keys):
            by_owner.setdefault(self.owner(key), []).append(pos)
        if len(by_owner) == 1 or len(keys) < self.seq_fanout_keys:
            # single owner, or a tiny request: pool dispatch overhead
            # exceeds the worker service time it would parallelize
            # (profiled, scripts/shard_profile.py: 2-key MGET p50 0.104 ms
            # pooled vs 0.041 ms sequential — per-worker service is
            # ~0.02 ms) — issue the sub-MGETs serially on this thread
            try:
                for w, positions in by_owner.items():
                    for p, v in zip(positions,
                                    self._clients[w].query_states(
                                        name,
                                        [keys[p] for p in positions])):
                        out[p] = v
            except (ConnectionError, OSError, TimeoutError):
                self._count_error("MGET")
                raise
            return out
        from concurrent.futures import wait as _futures_wait

        # capture the submitting request's trace context: pool threads
        # don't inherit thread-locals, and a traced fan-out must stamp
        # every shard leg with the same tid (obs/tracing.py); the
        # ``tid/sid`` composite parents each leg under the caller's
        # open span
        tid = obs_tracing.current_context()
        futures = {
            w: self._pool.submit(
                obs_tracing.call_with_trace, tid,
                self._clients[w].query_states,
                name, [keys[p] for p in positions],
            )
            for w, positions in by_owner.items()
        }
        # join EVERY future before propagating any failure: an orphaned
        # in-flight future would race the next query on its worker's
        # lock-free QueryClient socket and cross-wire replies
        _futures_wait(list(futures.values()))
        try:
            for w, positions in by_owner.items():
                for p, v in zip(positions, futures[w].result()):
                    out[p] = v
        except (ConnectionError, OSError, TimeoutError):
            self._count_error("MGET")
            raise
        return out

    def topk(self, name: str, user_id: str, k: int):
        """Fan-out top-k: returns the merged [(item, score)] best-k across
        every worker's catalog slice (scored concurrently), or None if the
        user is unknown.  Server-side, each worker's TOPKV lands in its
        cross-request microbatcher, so concurrent fan-outs from many
        clients share device dispatches per worker."""
        out = self.topk_many(name, [user_id], k)[0]
        return out

    def topk_many(self, name: str, user_ids: Sequence[str], k: int) -> list:
        """Bulk fan-out top-k for many users in one sweep: ONE MGET per
        owning worker resolves every user's factor row, then each worker
        scores ALL the query vectors through a single pipelined TOPKV
        stream (``topk_by_vector_pipelined``).  Arriving back-to-back on
        one connection, the vectors coalesce in the worker's microbatcher
        into batched device dispatches — the whole sweep costs each worker
        ~ceil(B / max_batch) catalog passes instead of B.

        Returns one merged best-k list per user id, in order; None per
        unknown user."""
        user_ids = list(user_ids)
        payloads = self.query_states(name, [f"{u}-U" for u in user_ids])
        known = [i for i, p in enumerate(payloads) if p is not None]
        out: list = [None] * len(user_ids)
        if not known:
            return out
        vecs = [payloads[i] for i in known]
        from concurrent.futures import wait as _futures_wait

        with obs_tracing.span("fanout", op="topk_many",
                              shards=self.num_workers,
                              queries=len(known), k=k):
            # capture inside the span so each shard leg parents under it
            ctx = obs_tracing.current_context()
            futs = [
                self._pool.submit(
                    obs_tracing.call_with_trace, ctx,
                    c.topk_by_vector_pipelined, name, vecs, k)
                for c in self._clients
            ]
            _futures_wait(futs)  # join all before any result() can raise
            try:
                per_worker = [f.result() for f in futs]
            except (ConnectionError, OSError, TimeoutError):
                self._count_error("TOPKV")
                raise
        for j, i in enumerate(known):
            merged: List[Tuple[str, float]] = []
            for worker_results in per_worker:
                merged.extend(worker_results[j])
            merged.sort(key=lambda it: -it[1])
            out[i] = merged[:k]
        return out

    def ping_all(self) -> List[str]:
        return [c.ping() for c in self._clients]

    def total_count(self, name: str) -> int:
        """Combined key count across every worker's slice (shards are
        disjoint by construction, so the sum is the table size)."""
        return sum(c.count(name) for c in self._clients)

    def close(self) -> None:
        # every query path joins its futures before returning, so nothing
        # is in flight here; wait=True keeps that invariant explicit
        self._pool.shutdown(wait=True)
        for c in self._clients:
            c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# worker-process lifecycle (harness/ops helpers around the CLI below)
# ---------------------------------------------------------------------------

def spawn_worker_procs(
    num_workers: int,
    journal_dir: str,
    topic: str,
    port_dir: str,
    state_backend: str = "memory",
    host: str = "127.0.0.1",
    extra_args: Sequence[str] = (),
    timeout_s: float = 120.0,
    env: Optional[dict] = None,
    device: str = "cuda",
) -> Tuple[list, List[int]]:
    """Spawn one ``python -m flink_ms_tpu_torch.serve.sharded`` process per
    shard, each on ``device``, and wait for every port file ->
    (procs, ports).

    One owner for the spawn/port-wait/cleanup dance the bench and the
    profiling harness both need: a worker that dies raises (rc included),
    a worker that hangs past ``timeout_s`` raises instead of spinning, a
    partial spawn is torn down before the exception propagates, and the
    child PYTHONPATH gets this repo PREPENDED (not clobbered — the caller
    may rely on an existing PYTHONPATH for its own deps).

    The parent environment is inherited wholesale, which is the knob
    path for the per-worker retrieval plane: ``TPUMS_TOPK_TIER`` /
    ``TPUMS_TOPK_SHARDED`` / ``TPUMS_ANN_NLIST`` / ``TPUMS_ANN_NPROBE``
    set on the launcher reach every shard worker's
    ``DeviceFactorIndex`` (each worker holds only its catalog slice, so
    its index sizes its own mesh/ANN tiers from its slice)."""
    import subprocess
    import time

    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    base_env = dict(os.environ if env is None else env)
    prior = base_env.get("PYTHONPATH", "")
    base_env["PYTHONPATH"] = repo + (os.pathsep + prior if prior else "")
    procs: list = []
    try:
        port_files = []
        for widx in range(num_workers):
            pf = os.path.join(port_dir, f"shard-port-{widx}.json")
            if os.path.exists(pf):
                os.unlink(pf)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "flink_ms_tpu_torch.serve.sharded",
                 "--workerIndex", str(widx), "--numWorkers", str(num_workers),
                 "--device", str(device),
                 "--journalDir", journal_dir, "--topic", topic,
                 "--stateBackend", state_backend, "--host", host,
                 "--port", "0", "--portFile", pf, *extra_args],
                env=base_env, cwd=repo,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            ))
            port_files.append(pf)
        ports = []
        deadline = time.time() + timeout_s
        for p, pf in zip(procs, port_files):
            while not (os.path.exists(pf) and os.path.getsize(pf) > 0):
                if p.poll() is not None:
                    raise RuntimeError(
                        f"shard worker died rc={p.returncode}"
                    )
                if time.time() > deadline:
                    raise RuntimeError(
                        f"shard worker port wait exceeded {timeout_s:.0f}s"
                    )
                time.sleep(0.05)
            with open(pf) as f:
                ports.append(json.load(f)["port"])
        return procs, ports
    except Exception:
        stop_worker_procs(procs)
        raise


def stop_worker_procs(procs) -> None:
    """Terminate-then-kill every worker process (idempotent, exception-safe
    — callers put this in a ``finally``)."""
    for p in procs:
        try:
            p.terminate()
        except Exception:
            pass
    for p in procs:
        try:
            p.wait(timeout=10)
        except Exception:
            try:
                p.kill()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# worker CLI
# ---------------------------------------------------------------------------

def run_worker(params: Params) -> ServingJob:
    worker_index = params.get_int("workerIndex")
    num_workers = params.get_int("numWorkers")
    if worker_index is None or num_workers is None:
        raise ValueError("--workerIndex and --numWorkers are required")
    if not (0 <= worker_index < num_workers):
        raise ValueError("need 0 <= workerIndex < numWorkers")
    svm = params.get_bool("svm", False)
    state_name = SVM_STATE if svm else ALS_STATE
    base_parse = parse_svm_record if svm else parse_als_record

    journal = Journal(
        params.get_required("journalDir"), params.get_required("topic")
    )
    # HA replica-set membership (serve/ha.py): a replicated worker carries
    # its replica index and the logical shard-group id it serves, so the
    # registry can resolve the whole set and the supervisor can respawn
    # exactly the member that died
    replica_index = params.get_int("replicaIndex", None)
    job_group = params.get("jobGroup")
    replica_of = None
    if job_group or replica_index is not None:
        group = job_group or "sharded"
        replica_of = f"{group}/shard-{worker_index}"
    # elastic plane (serve/elastic.py): workers of topology generation g of
    # group G run under the generation-suffixed jobGroup "G@g<g>" (so all
    # the per-generation registry machinery above applies unchanged) and
    # additionally carry the BASE group + generation for the HEALTH hint
    topology_group = params.get("topologyGroup")
    topology_gen = params.get_int("topologyGen", None)
    # each worker checkpoints its own slice: separate subdir per index
    # (and per replica — set members must never share a checkpoint dir) so
    # restarts restore the right partition
    uri = params.get("checkpointDataUri")
    if uri:
        uri = f"{uri.rstrip('/')}/worker-{worker_index}"
        if replica_index is not None:
            uri = f"{uri}-r{replica_index}"
    backend = make_backend(params.get("stateBackend", "memory"), uri)
    default_job_id = (
        f"{job_group or 'sharded'}:s{worker_index}r{replica_index}"
        if replica_index is not None else f"worker-{worker_index}"
    )
    job = ServingJob(
        journal,
        state_name,
        sharded_parse(base_parse, worker_index, num_workers),
        backend,
        n_shards=params.get_int("shards", 8),
        checkpoint_interval_ms=params.get_int("checkPointInterval", 60_000),
        # --pollInterval: journal poll cadence in seconds.  The update
        # plane's read-your-writes latency rides on this (publish →
        # ingest → queryable), so update-heavy fleets run it much tighter
        # than the 100ms default
        poll_interval_s=params.get_float("pollInterval", 0.1),
        host=params.get("host", "0.0.0.0"),
        port=params.get_int("port", 0),
        job_id=params.get("jobId", default_job_id),
        # the C++ epoll plane per shard (over --stateBackend rocksdb or the
        # arena): point lookups and host-scored TOPKV from the worker's slice
        native_server=params.get_bool("nativeServer", False),
        ingest_mode=params.get("ingestMode"),
        replica_of=replica_of,
        replica_index=replica_index,
        topology_group=topology_group,
        generation=topology_gen,
        # snapshot-first bootstrap + background compactor knobs (defaults
        # come from TPUMS_SNAPSHOTS / TPUMS_COMPACT when flags are absent)
        snapshots=(
            params.get_bool("snapshots") if params.has("snapshots") else None
        ),
        snapshot_min_bytes=params.get_int("snapshotMinBytes"),
        compact=params.get_bool("compact") if params.has("compact") else None,
        device=params.get("device", "cuda"),
    ).start()
    print(
        f"[serve:sharded] worker {worker_index}/{num_workers}"
        + (f" replica {replica_index}" if replica_index is not None else "")
        + f" ({state_name}) on port {job.port}",
        file=sys.stderr,
    )
    # --updatePlane: co-locate the sharded online-SGD update worker with
    # this serving shard (serve/update_plane.py).  Lazy import — the plane
    # pulls in the SGD/metrics stack the plain serving path doesn't need.
    if params.get_bool("updatePlane", False):
        from . import update_plane
        job._update_worker = update_plane.attach_update_worker(
            job, params, worker_index, num_workers
        )
    port_file = params.get("portFile")
    if port_file:
        # atomic publish: launchers poll on file size, a plain write lets
        # them read a partial JSON document
        tmp_pf = port_file + ".tmp"
        with open(tmp_pf, "w") as f:
            json.dump(
                {"port": job.port, "workerIndex": worker_index,
                 "replicaIndex": replica_index, "jobId": job.job_id}, f
            )
        os.replace(tmp_pf, port_file)
    return job


def main(argv=None) -> None:
    job = run_worker(Params.from_args(sys.argv[1:] if argv is None else argv))
    job.wait()


if __name__ == "__main__":
    main()
