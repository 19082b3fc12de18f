"""Online SGD model updater: counterpart of ``SGD`` (v1) and ``SGDV0``
(``SGD.java``, ``SGDV0.java``); own copy of ``flink_ms_tpu/online/sgd.py``.

Its rows equal the JAX package's byte for byte for the same lookups: the
update is numpy float64 arithmetic on the host, as the reference's, and
needs no device.

Streaming job that closes the serve→update loop: ratings stream in from a
file/directory source (once or continuously — SGD.java:49-64), each rating
queries the live served factors (falling back to the MEAN cold-start
vectors — :142-151, :219-234), applies a biased SGD step, and emits updated
``id,U|I,f;...`` rows back into the model journal, which the serving job
then folds into the queryable state (the closed loop of SURVEY.md §3.4).

Both reference semantics are implemented behind ``--version``:

- ``v1`` (SGD.java:191-216, default): user and item factor updates are both
  computed from the OLD vectors; rows are emitted even when they contain
  NaN (detection is log-only — :230).
- ``v0`` (SGDV0.java:188-226): in-place sequential update — the item update
  sees the already-updated user vector — and NaN rows are dropped, not
  emitted.

Update rule (k factors, learning rate γ, per-side regularization λu/λi):

    err  = r − u·v
    u'   = u + γ (err · v − λu · u)        [v1: v is old; v0: same]
    v'   = v + γ (err · u − λi · v)        [v1: u is old; v0: u' (updated)]
    bias updates are computed but not persisted (reference TODOs at
    SGD.java:209,232 — preserved as-is for parity by DEFAULT).

Bias mode (``--updateBias`` / ``TPUMS_SGD_BIAS=1``): finishes the
reference's TODO.  The LAST element of each factor row is its bias term;
prediction and updates become

    err  = r − (u[:-1]·v[:-1] + bu + bi)
    u'   = factor rule above on u[:-1]/v[:-1]
    bu'  = bu + γ (err − λu · bu)          [bi' symmetric with λi]

and the updated biases persist in the emitted rows.  Flag OFF (the
default) is byte-identical to the historical unbiased behavior —
regression-pinned in the JAX package's tests.

Quirk fix (SURVEY.md Appendix C #8): a query-transport error in the
reference leaves an Optional null and NPEs the task; here it falls back to
the mean vector and logs, keeping the stream alive.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core import formats as F
from ..core.params import Params, field_delimiter_from
from ..serve.client import QueryClient
from ..serve.consumer import ALS_STATE
from ..serve.journal import Journal
from ..serve.registry import resolve_endpoint


class SGDStep:
    def __init__(
        self,
        lookup: Callable[[str], Optional[str]],
        user_mean: str,
        item_mean: str,
        learning_rate: float = 0.1,
        user_reg: float = 0.0,
        item_reg: float = 0.0,
        version: str = "v1",
        lookup_many: Optional[Callable[[List[str]], List[Optional[str]]]] = None,
        update_bias: bool = False,
    ):
        if version not in ("v1", "v0"):
            raise ValueError("version must be v1 or v0")
        self.lookup = lookup
        # batched lookup (the MGET verb): both factor queries of a rating in
        # ONE round trip, vs the reference's two hops (SGD.java:172-173)
        self.lookup_many = lookup_many
        self.user_mean = user_mean
        self.item_mean = item_mean
        self.lr = learning_rate
        self.user_reg = user_reg
        self.item_reg = item_reg
        self.version = version
        self.update_bias = update_bias
        self.nan_records = 0
        self.vectorized_chunks = 0  # observability / test hook

    def _vec(self, id_: int, suffix: str, payload: Optional[str],
             mean: str) -> np.ndarray:
        if payload is None:
            payload = mean
        vec = np.asarray([float(t) for t in payload.split(";") if t])
        if np.isnan(vec).any():
            print(f"NaN detected for: {id_}{suffix}")
        return vec

    def _factors(self, id_: int, suffix: str, mean: str) -> np.ndarray:
        key = f"{id_}{suffix}"
        try:
            payload = self.lookup(key)
        except Exception as e:
            print(f"query failed for {key}: {e}", file=sys.stderr)
            payload = None
        return self._vec(id_, suffix, payload, mean)

    def _update(self, u: np.ndarray, v: np.ndarray, rating: float):
        if not self.update_bias:
            err = rating - float(u @ v)
            u_new = u + self.lr * (err * v - self.user_reg * u)
            if self.version == "v1":
                v_new = v + self.lr * (err * u - self.item_reg * v)
            else:  # v0: item step sees the already-updated user vector
                v_new = v + self.lr * (err * u_new - self.item_reg * v)
            return u_new, v_new
        # biased step: the last element of each row is its bias term
        uf, bu = u[:-1], float(u[-1])
        vf, bi = v[:-1], float(v[-1])
        err = rating - (float(uf @ vf) + bu + bi)
        uf_new = uf + self.lr * (err * vf - self.user_reg * uf)
        bu_new = bu + self.lr * (err - self.user_reg * bu)
        if self.version == "v1":
            vf_new = vf + self.lr * (err * uf - self.item_reg * vf)
        else:
            vf_new = vf + self.lr * (err * uf_new - self.item_reg * vf)
        bi_new = bi + self.lr * (err - self.item_reg * bi)
        return (np.concatenate([uf_new, [bu_new]]),
                np.concatenate([vf_new, [bi_new]]))

    def _emit(self, user: int, item: int, u_new, v_new):
        """-> (rows to emit, [(key, vec)] that became visible).

        v1 emits even if NaN (log-only detection, SGD.java:230); v0 drops
        NaN rows, so the served state — and a batch's carry-forward
        cache — keeps the old vector for them."""
        rows, visible = [], []
        user_row = F.format_als_row(user, F.USER, u_new)
        item_row = F.format_als_row(item, F.ITEM, v_new)
        for row, key, vec, side in (
            (user_row, f"{user}-U", u_new, "user"),
            (item_row, f"{item}-I", v_new, "item"),
        ):
            if self.version != "v1" and "nan" in row.lower():
                self.nan_records += 1
                print(f"NaN in {side}Record{row}")
                continue
            rows.append(row)
            visible.append((key, vec))
        return rows, visible

    def process(self, user: int, item: int, rating: float) -> List[str]:
        if self.lookup_many is not None:
            keys = [f"{user}-U", f"{item}-I"]
            try:
                pu, pi = self.lookup_many(keys)
            except Exception as e:
                print(f"query failed for {keys}: {e}", file=sys.stderr)
                pu = pi = None
            u = self._vec(user, "-U", pu, self.user_mean)
            v = self._vec(item, "-I", pi, self.item_mean)
        else:
            u = self._factors(user, "-U", self.user_mean)
            v = self._factors(item, "-I", self.item_mean)
        u_new, v_new = self._update(u, v, rating)
        rows, _ = self._emit(user, item, u_new, v_new)
        return rows

    def process_batch(
        self, ratings: List[Tuple[int, int, float]]
    ) -> List[str]:
        """Process a chunk of ratings with ONE lookup round trip.

        All distinct factor keys of the chunk are fetched in a single
        MGET; each rating is then processed *sequentially* against a
        local carry-forward cache (later ratings see the vectors earlier
        ratings in the chunk produced).  In the closed loop this is the
        same dataflow as per-rating mode — there the update only becomes
        visible to the next rating once the serving job happens to ingest
        the emitted row, a race the local cache resolves deterministically
        in favor of always-visible.  v0's drop-NaN rule keeps the OLD
        vector in the cache for dropped rows, exactly like a row that was
        never emitted.  Emission order (user row then item row, rating
        order) is preserved."""
        if self.lookup_many is None:
            out: List[str] = []
            for user, item, rating in ratings:
                out.extend(self.process(user, item, rating))
            return out
        ukeys = [f"{u}-U" for u, _, _ in ratings]
        ikeys = [f"{i}-I" for _, i, _ in ratings]
        keys: List[str] = []
        seen = set()
        for uk, ik in zip(ukeys, ikeys):
            for key in (uk, ik):
                if key not in seen:
                    seen.add(key)
                    keys.append(key)
        try:
            payloads = self.lookup_many(keys)
        except Exception as e:
            # a failed chunk fetch must not cold-start the WHOLE chunk
            # (batchSize x the per-rating blast radius): fall back to
            # per-rating processing, which contains any further failure
            # to that one rating's two rows
            print(f"batch query failed for {len(keys)} keys, falling back "
                  f"to per-rating lookups: {e}", file=sys.stderr)
            out = []
            for user, item, rating in ratings:
                out.extend(self.process(user, item, rating))
            return out
        cache: Dict[str, np.ndarray] = {}
        for key, payload in zip(keys, payloads):
            mean = self.user_mean if key.endswith("-U") else self.item_mean
            id_, suffix = key[:-2], key[-2:]
            cache[key] = self._vec(id_, suffix, payload, mean)

        # greedy duplicate-free runs: the chunk splits wherever a user or
        # item repeats; within a run every rating's update is independent,
        # so it computes as a handful of (B, k) matrix ops instead of ~10
        # tiny numpy calls per rating (the measured cost after MGET
        # batching).  Carry-forward across run boundaries goes through the
        # cache, exactly where the sequential path would have written it,
        # so the split points never change the emitted bytes.
        out: List[str] = []
        n = len(ratings)
        start = 0
        while start < n:
            seen_u: set = set()
            seen_i: set = set()
            end = start
            while end < n:
                user, item, _ = ratings[end]
                if user in seen_u or item in seen_i:
                    break
                seen_u.add(user)
                seen_i.add(item)
                end += 1
            run = ratings[start:end]
            start = end
            if len(run) >= 2 and self._apply_run_vectorized(run, cache, out):
                continue
            for user, item, rating in run:
                u_new, v_new = self._update(
                    cache[f"{user}-U"], cache[f"{item}-I"], rating
                )
                rows, visible = self._emit(user, item, u_new, v_new)
                out.extend(rows)
                cache.update(visible)
        return out

    def _apply_run_vectorized(
        self,
        run: List[Tuple[int, int, float]],
        cache: Dict[str, np.ndarray],
        out: List[str],
    ) -> bool:
        """Apply one duplicate-free run as (B, k) matrix ops, emitting
        into ``out`` and folding the new vectors back into ``cache`` for
        the following runs.  Returns False on ragged factor widths (the
        caller then takes the scalar path for the run)."""
        try:
            U = np.stack([cache[f"{u}-U"] for u, _, _ in run])
            V = np.stack([cache[f"{i}-I"] for _, i, _ in run])
        except ValueError:
            return False
        r = np.asarray([rr for _, _, rr in run], np.float64)
        # per-row BLAS dots, not one einsum: the last-ulp of the
        # reduction must match the per-rating path exactly so
        # --batchSize N and --batchSize 1 emit byte-identical
        # rows (the broadcast update arithmetic below is
        # elementwise and therefore already bitwise-identical)
        if self.update_bias:
            Uf, bu = U[:, :-1], U[:, -1]
            Vf, bi = V[:, :-1], V[:, -1]
            err = r - (np.fromiter(
                (float(u @ v) for u, v in zip(Uf, Vf)),
                np.float64, len(run),
            ) + bu + bi)
            Uf_new = Uf + self.lr * (
                err[:, None] * Vf - self.user_reg * Uf)
            bu_new = bu + self.lr * (err - self.user_reg * bu)
            base = Uf if self.version == "v1" else Uf_new
            Vf_new = Vf + self.lr * (
                err[:, None] * base - self.item_reg * Vf)
            bi_new = bi + self.lr * (err - self.item_reg * bi)
            U_new = np.concatenate([Uf_new, bu_new[:, None]], axis=1)
            V_new = np.concatenate([Vf_new, bi_new[:, None]], axis=1)
        else:
            err = r - np.fromiter(
                (float(u @ v) for u, v in zip(U, V)),
                np.float64, len(run),
            )
            U_new = U + self.lr * (
                err[:, None] * V - self.user_reg * U)
            base = U if self.version == "v1" else U_new
            V_new = V + self.lr * (
                err[:, None] * base - self.item_reg * V)
        self.vectorized_chunks += 1
        for (user, item, _), un, vn in zip(run, U_new, V_new):
            rows, visible = self._emit(user, item, un, vn)
            out.extend(rows)
            cache.update(visible)
        return True


# ---------------------------------------------------------------------------
# streaming file source (TextInputFormat nested + PROCESS_ONCE/CONTINUOUSLY)
# ---------------------------------------------------------------------------

def stream_ratings(
    path: str,
    mode: str,
    interval_ms: int,
    delimiter: str,
    stop: Optional[Callable[[], bool]] = None,
    idle_sentinel: bool = False,
) -> Iterator[Optional[Tuple[int, int, float]]]:
    """Yield (user, item, rating) from a file/nested-dir source.  ``once``
    processes the current contents and returns; ``continuous`` re-polls
    every ``interval_ms``, picking up appended lines and new files.
    ``idle_sentinel`` yields one ``None`` before each poll sleep so a
    batching consumer can flush a partial batch instead of holding it
    while the source idles."""
    if mode not in ("continuous", "once"):
        raise ValueError("Invalid mode. Specify --mode [continuous|once] ")
    consumed: Dict[str, int] = {}
    while True:
        for fp in _files_under(path):
            pos = consumed.get(fp, 0)
            try:
                size = os.path.getsize(fp)
                if size < pos:  # truncated/rewritten: reprocess from start
                    pos = 0
                if size == pos:
                    continue
                with open(fp, "r") as f:
                    f.seek(pos)
                    chunk = f.read()
            except OSError:
                continue
            if mode == "once":
                # the file is complete: a missing trailing newline must not
                # drop the final record (PROCESS_ONCE parity)
                complete = chunk
                consumed[fp] = pos + len(chunk.encode("utf-8"))
            else:
                # continuous tailing: hold a torn final line until its
                # newline lands
                last_nl = chunk.rfind("\n")
                if last_nl < 0:
                    continue
                complete = chunk[: last_nl + 1]
                consumed[fp] = pos + len(complete.encode("utf-8"))
            for line in complete.splitlines():
                line = line.strip()
                if not line:
                    continue
                toks = line.split(delimiter)
                yield int(toks[0]), int(toks[1]), float(toks[2])
        if mode == "once":
            return
        if stop is not None and stop():
            return
        if idle_sentinel:
            yield None
        time.sleep(interval_ms / 1000.0)


def _files_under(path: str) -> List[str]:
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for name in sorted(files):
                if not name.startswith(".") and not name.startswith("_"):
                    out.append(os.path.join(root, name))
        return sorted(out)
    return [path] if os.path.exists(path) else []


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run(params: Params, stop: Optional[Callable[[], bool]] = None) -> int:
    """Returns the number of ratings processed."""
    mode = params.get_required("mode")
    output_mode = params.get_required("outputMode")
    delimiter = field_delimiter_from(params, default="tab")

    # --group names an elastic topology group: the consumer then rides
    # ElasticClient's replica failover and generation swap, so a lone SGD
    # job survives a fleet rescale or failover.  --jobId keeps the single
    # endpoint path.
    group = params.get("group")
    if group:
        from ..serve.elastic import ElasticClient
        client = ElasticClient(
            group, timeout_s=params.get_int("queryTimeout", 5)
        )
    else:
        sgd_host, sgd_port = resolve_endpoint(params)  # jobId -> registry
        client = QueryClient(
            host=sgd_host,
            port=sgd_port,
            timeout_s=params.get_int("queryTimeout", 5),
            job_id=params.get_required("jobId"),
        )
    out_f = None
    try:
        def lookup(key: str) -> Optional[str]:
            return client.query_state(ALS_STATE, key)

        def lookup_many(keys: List[str]) -> List[Optional[str]]:
            return client.query_states(ALS_STATE, keys)

        # mean vectors are loaded once at job start (SGD.java:142-151)
        user_mean = _mean_or_flag(lookup, "MEAN-U", params.get("userMean"))
        item_mean = _mean_or_flag(lookup, "MEAN-I", params.get("itemMean"))
        if user_mean is None or item_mean is None:
            raise RuntimeError("Unable to load User mean or item mean factors.")

        step = SGDStep(
            lookup,
            user_mean,
            item_mean,
            learning_rate=params.get_float("learningRate", 0.1),
            user_reg=params.get_float("userRegularization", 0.0),
            item_reg=params.get_float("itemRegularization", 0.0),
            version=params.get("version", "v1"),
            # one MGET round trip per rating unless explicitly disabled
            # (--batchedLookups false restores strict per-key parity mode)
            lookup_many=(
                lookup_many if params.get_bool("batchedLookups", True) else None
            ),
            # --updateBias / TPUMS_SGD_BIAS=1: persist the bias updates the
            # reference computes and drops (last vector element = bias)
            update_bias=params.get_bool(
                "updateBias",
                os.environ.get("TPUMS_SGD_BIAS", "").lower()
                in ("1", "true", "yes"),
            ),
        )

        if output_mode in ("kafka", "journal"):
            journal = Journal(
                params.get_required("journalDir"), params.get_required("topic")
            )
            # default: fsync per update (strictest).  --flushEveryUpdate
            # false matches the reference's at-least-once semantics more
            # closely (flushOnCheckpoint = flush at checkpoint boundaries,
            # ALSKafkaProducer.java:35-37): rows reach the OS on every
            # append, fsync happens at end of run via Journal.sync
            flush_every = params.get_bool("flushEveryUpdate", True)

            def emit(rows: List[str]) -> None:
                journal.append(rows, flush=flush_every)

        elif output_mode == "hdfs":
            out_path = params.get_required("outputPath")
            d = os.path.dirname(os.path.abspath(out_path))
            os.makedirs(d, exist_ok=True)
            out_f = open(out_path, "w")

            def emit(rows: List[str]) -> None:
                for row in rows:
                    out_f.write(row + "\n")
                out_f.flush()

        else:
            raise ValueError("outputMode must be kafka|journal|hdfs")

        # --batchSize > 1: chunk the stream, one MGET per chunk, sequential
        # carry-forward semantics per rating (see SGDStep.process_batch).
        # Default 1 = strict per-rating parity with SGD.java.
        batch_size = params.get_int("batchSize", 1)
        n = 0
        pending: List[Tuple[int, int, float]] = []

        def flush() -> None:
            nonlocal n
            if not pending:
                return
            emit(step.process_batch(pending))
            n += len(pending)
            pending.clear()

        for rec in stream_ratings(
            params.get_required("input"),
            mode,
            params.get_int("interval", 60_000),
            delimiter,
            stop=stop,
            idle_sentinel=batch_size > 1,
        ):
            if rec is None:  # source idle: don't hold a partial batch
                flush()
                continue
            if batch_size <= 1:
                emit(step.process(*rec))
                n += 1
                continue
            pending.append(rec)
            if len(pending) >= batch_size:
                flush()
        flush()
        if output_mode in ("kafka", "journal"):
            journal.sync()  # checkpoint-boundary durability for flush=False
    finally:
        client.close()
        if out_f is not None:
            out_f.close()
    print(f"[ALS] online-updates using SGD: processed {n} ratings")
    return n


def _mean_or_flag(lookup, key: str, flag_value: Optional[str]) -> Optional[str]:
    try:
        payload = lookup(key)
    except Exception:
        payload = None
    return payload if payload is not None else flag_value


def main(argv=None) -> None:
    run(Params.from_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
