"""Text-format contracts of the port (SURVEY.md Appendix B).

Own copy of ``flink_ms_tpu/core/formats.py``: ratings CSV in,
``id,U|I,f1;f2;...;fk`` factor rows and ``MEAN,U|I,...`` cold-start rows
out; LibSVM in, ``featureIndex,weight`` or range-partitioned
``bucket,idx:w;...`` rows out; the serving job's columnar journal-chunk
parser; and the load harnesses' latency CSVs.  The lines are
byte-identical to the JAX package's, so files written by either package
are read by the other.

All readers accept a file path or a directory (Flink jobs with parallelism > 1
write directories of part files).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

USER = "U"
ITEM = "I"
MEAN_ID = "MEAN"


def iter_lines(path: str) -> Iterator[str]:
    """Yield non-empty lines from a file, or from every file under a
    directory (recursive, sorted for determinism)."""
    for fp in _enumerate_files(path):
        with open(fp, "r") as f:
            for line in f:
                line = line.rstrip("\n").rstrip("\r")
                if line:
                    yield line


def _enumerate_files(path: str) -> List[str]:
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for name in files:
                if name.startswith(".") or name.startswith("_"):
                    continue
                out.append(os.path.join(root, name))
        return sorted(out)
    return [path]


def write_lines(path: str, lines: Iterable[str]) -> None:
    """Overwrite `path` with the given lines (WriteMode.OVERWRITE parity)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for line in lines:
            f.write(line)
            f.write("\n")


def read_ratings(
    path: str,
    field_delimiter: str = ",",
    ignore_first_line: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read ``user,item,rating`` rows -> (users:int64, items:int64, ratings:f64).

    Mirrors ``env.readCsvFile[(Int, Int, Double)]`` at ALSImpl.scala:29-32
    (comma or tab delimiter, optional header skip).
    """
    users: List[int] = []
    items: List[int] = []
    ratings: List[float] = []
    for fp in _enumerate_files(path):
        with open(fp, "r") as f:
            # Flink's CsvInputFormat skips the first line of EVERY file when
            # ignoreFirstLine is set (each split re-skips at splitStart==0)
            skip = ignore_first_line
            for line in f:
                if skip:
                    skip = False
                    continue
                line = line.strip()
                if not line:
                    continue
                parts = line.split(field_delimiter)
                users.append(int(parts[0]))
                items.append(int(parts[1]))
                ratings.append(float(parts[2]))
    return (
        np.asarray(users, dtype=np.int64),
        np.asarray(items, dtype=np.int64),
        np.asarray(ratings, dtype=np.float64),
    )


def write_ratings(
    path: str,
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    field_delimiter: str = ",",
) -> None:
    write_lines(
        path,
        (
            f"{int(u)}{field_delimiter}{int(i)}{field_delimiter}{_fmt(r)}"
            for u, i, r in zip(users, items, ratings)
        ),
    )


@dataclass
class SparseData:
    """CSR sparse labeled data parsed from LibSVM (indices stored 0-based)."""

    labels: np.ndarray      # (n,) float64
    indptr: np.ndarray      # (n+1,) int64
    indices: np.ndarray     # (nnz,) int64, 0-based
    values: np.ndarray      # (nnz,) float64
    n_features: int

    @property
    def n_examples(self) -> int:
        return int(self.labels.shape[0])

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.values[s:e]


def read_libsvm(path: str, n_features: int = 0) -> SparseData:
    """Parse LibSVM ``label idx:val ...`` with 1-based indices
    (``env.readLibSVM`` at SVMImpl.scala:21 [dep])."""
    labels: List[float] = []
    indptr: List[int] = [0]
    indices: List[int] = []
    values: List[float] = []
    max_idx = -1
    for line in iter_lines(path):
        # strip LibSVM comments
        hash_pos = line.find("#")
        if hash_pos >= 0:
            line = line[:hash_pos]
        parts = line.split()
        if not parts:
            continue
        labels.append(float(parts[0]))
        for tok in parts[1:]:
            idx_s, val_s = tok.split(":")
            idx = int(idx_s) - 1  # 1-based on disk -> 0-based in memory
            if idx < 0:
                raise ValueError(f"LibSVM index must be >= 1, got {idx + 1}")
            indices.append(idx)
            values.append(float(val_s))
            if idx > max_idx:
                max_idx = idx
        indptr.append(len(indices))
    nf = max(n_features, max_idx + 1)
    return SparseData(
        labels=np.asarray(labels, dtype=np.float64),
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=np.asarray(indices, dtype=np.int64),
        values=np.asarray(values, dtype=np.float64),
        n_features=nf,
    )


def format_svm_flat_rows(weights: np.ndarray) -> Iterator[str]:
    """``featureIndex,weight`` with 1-based indices (SVMImpl.scala:33-35,45)."""
    for i, w in enumerate(np.asarray(weights).ravel()):
        yield f"{i + 1},{_fmt(w)}"


def format_svm_range_rows(weights: np.ndarray, range_: int) -> Iterator[str]:
    """``bucket,idx:w;idx:w;...`` with bucket = (1-based idx) / range
    (SVMImpl.scala:40-46,63-71).  Buckets ascend, and indices ascend within
    a bucket."""
    w = np.asarray(weights).ravel()
    buckets: Dict[int, List[str]] = {}
    for i, v in enumerate(w):
        idx1 = i + 1
        buckets.setdefault(idx1 // range_, []).append(f"{idx1}:{_fmt(v)}")
    for b in sorted(buckets):
        yield f"{b}," + ";".join(buckets[b])


def parse_svm_flat_row(line: str) -> Tuple[int, float]:
    idx_s, w_s = line.split(",", 1)
    return int(idx_s), float(w_s)


def parse_svm_range_row(line: str) -> Tuple[int, List[Tuple[int, float]]]:
    """Parse ``bucket,idx:w;idx:w;...`` (RangePartitionSVMPredict.java:80-101)."""
    bucket_s, payload = line.split(",", 1)
    idx, w = parse_svm_range_payload(payload)
    return int(bucket_s), list(zip(idx.tolist(), w.tolist()))


def read_svm_model(path: str, n_features: int = 0,
                   partitioned: bool = False) -> np.ndarray:
    """Read flat (``featureIndex,weight``) or range-partitioned
    (``bucket,idx:w;...``) SVM rows into a dense 0-based float64 weight
    vector of at least ``n_features`` entries."""
    entries: List[Tuple[int, float]] = []
    for line in iter_lines(path):
        if partitioned:
            _, es = parse_svm_range_row(line)
            entries.extend(es)
        else:
            entries.append(parse_svm_flat_row(line))
    nf = max([n_features] + [i for i, _ in entries])
    w = np.zeros(nf, dtype=np.float64)
    for idx1, v in entries:
        w[idx1 - 1] = v
    return w


def sort_dedup_last(idx: np.ndarray, w: np.ndarray) -> Tuple[np.ndarray,
                                                             np.ndarray]:
    """Ascending-sort (idx, w) pairs, resolving duplicate ids LAST-wins —
    the dict-based parse semantics every range-plane consumer has (stable
    sort keeps input order within a run of equal ids, so the last element
    of each run is the last occurrence)."""
    order = np.argsort(idx, kind="stable")
    si, sw = idx[order], w[order]
    if si.size:
        keep = np.concatenate([si[1:] != si[:-1], [True]])
        si, sw = si[keep], sw[keep]
    return si, sw


def gather_sorted(ref_idx: np.ndarray, ref_w: np.ndarray,
                  fids) -> Tuple[np.ndarray, np.ndarray]:
    """Weights for `fids` out of an ascending (ref_idx, ref_w) table.

    -> (weights aligned with ``fids``, boolean hit mask); misses carry
    weight 0.  One place owns the clamp-then-mask searchsorted subtlety
    for every range-plane consumer (client cache, DOT merged index)."""
    fa = np.asarray(fids, np.int64)
    if ref_idx.size == 0 or fa.size == 0:
        return np.zeros(fa.size, np.float64), np.zeros(fa.size, bool)
    pos = np.minimum(np.searchsorted(ref_idx, fa), ref_idx.size - 1)
    hit = ref_idx[pos] == fa
    out = np.where(hit, ref_w[pos], 0.0)
    return out, hit


class RangePayloadCache:
    """Payload-keyed cache of parsed+sorted range rows.

    A range-partitioned query touches most buckets every time (70 random
    features over ~48 buckets), and bucket payloads change only when the
    model is republished — so the ~0.3 ms C-parse of a ~2000-token payload
    dominates steady-state query latency.  Keying on the payload STRING
    (not the bucket id) makes the cache trivially coherent: a republished
    bucket arrives as a different string and misses.  Bounded FIFO;
    thread-safe (the DOT merged-index rebuild runs on server handler
    threads, any number of which may share one cache)."""

    def __init__(self, max_entries: int = 1024):
        import threading

        self.max_entries = max_entries
        self._cache: dict = {}
        self._lock = threading.Lock()

    def lookup(self, payload: str) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ascending index array, matching weight array)."""
        with self._lock:
            hit = self._cache.get(payload)
        if hit is not None:
            return hit
        entry = sort_dedup_last(*parse_svm_range_payload(payload))
        with self._lock:
            while len(self._cache) >= self.max_entries and self._cache:
                self._cache.pop(next(iter(self._cache)))
            self._cache[payload] = entry
        return entry

    def gather(self, payload: str, fids) -> Tuple[np.ndarray, np.ndarray]:
        """Weights for the requested feature ids (see gather_sorted)."""
        ref_idx, ref_w = self.lookup(payload)
        return gather_sorted(ref_idx, ref_w, fids)


def parse_svm_range_payload(payload: str) -> Tuple[np.ndarray, np.ndarray]:
    """``idx:w;idx:w;...`` -> (int index array, float weight array).

    Fast path parses the whole payload with numpy's C float parser (the
    range-serving client reads ~1000-pair payloads per bucket on every
    query, where per-token ``float()`` dominated the measured latency).
    The ``idx:w;idx:w`` structure is validated EXACTLY first — colon and
    semicolon byte positions must strictly alternate — so a corrupted row
    ("1;2", "1:2:3;4") is never silently re-paired; it takes the per-token
    path and raises there, same as before the fast path existed."""
    stripped = payload.rstrip(";")
    if not stripped:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    try:
        buf = np.frombuffer(stripped.encode("ascii"), np.uint8)
        cpos = np.nonzero(buf == ord(":"))[0]
        spos = np.nonzero(buf == ord(";"))[0]
        structured = (
            cpos.size == spos.size + 1
            and (cpos[:-1] < spos).all()
            and (spos < cpos[1:]).all()
        )
        if structured:
            # the index regions must be INTEGER-shaped bytes, not merely
            # integer-valued floats: "3.0:w" or "3e0:w" must fail here and
            # raise on the per-token int() path below, exactly like the
            # exact path always did.  Region [start, colon) is
            # clean iff it contains only digits/sign — checked in one
            # cumulative-sum pass, no per-token work.
            digit = (buf >= ord("0")) & (buf <= ord("9"))
            sign = (buf == ord("-")) | (buf == ord("+"))
            bad = np.concatenate([[0], np.cumsum(~(digit | sign))])
            starts = np.concatenate([[0], spos + 1])
            if (bad[cpos] == bad[starts]).all():
                flat = np.array(
                    stripped.replace(":", ";").split(";"), dtype=np.float64
                )
                idx = flat[0::2]
                idx_i = idx.astype(np.int64)
                if (idx_i == idx).all():
                    return idx_i, flat[1::2]
    except Exception:
        pass  # non-ascii / non-numeric: the exact path decides below
    idxs, ws = [], []
    for tok in _split_semis(payload):
        idx_s, w_s = tok.split(":")
        idxs.append(int(idx_s))
        ws.append(float(w_s))
    return np.asarray(idxs, np.int64), np.asarray(ws, np.float64)


def format_als_row(id_: object, factor_type: str, factors: Sequence[float]) -> str:
    """``OutputFactor.toString`` parity (ALSImpl.scala:83-85)."""
    if isinstance(factors, np.ndarray):
        factors = factors.tolist()
    return f"{id_},{factor_type},{';'.join([_fmt(f) for f in factors])}"


def parse_als_row(line: str) -> Tuple[str, str, np.ndarray]:
    """Parse ``id,U|I,f1;f2;...`` -> (id, type, factors).  Id kept as a string
    because the serving key space is stringly typed ("MEAN" included) —
    ALSKafkaConsumer.java:75-82."""
    id_, typ, payload = line.split(",", 2)
    return id_, typ, np.asarray(
        [float(t) for t in _split_semis(payload)], dtype=np.float64
    )


def write_als_model(path: str, ids: Sequence[object], factor_type: str,
                    factors: np.ndarray) -> None:
    write_lines(
        path,
        (format_als_row(i, factor_type, row) for i, row in zip(ids, np.asarray(factors))),
    )


def read_als_model(path: str) -> Tuple[List[str], List[str], np.ndarray]:
    """Read a model file/dir -> (ids, types, factors matrix).  All rows must
    share one factor dimensionality."""
    ids: List[str] = []
    types: List[str] = []
    rows: List[np.ndarray] = []
    for line in iter_lines(path):
        i, t, v = parse_als_row(line)
        ids.append(i)
        types.append(t)
        rows.append(v)
    if not rows:
        return [], [], np.zeros((0, 0), dtype=np.float64)
    return ids, types, np.stack(rows)


def format_mean_row(factor_type: str, mean: Sequence[float]) -> str:
    """``MEAN,U|I,f1;...`` (ALSMeanVector.scala:35)."""
    return format_als_row(MEAN_ID, factor_type, mean)


# ---------------------------------------------------------------------------
# columnar journal-chunk parsing (the serving ingest hot path)
# ---------------------------------------------------------------------------

# chunk-parse modes of the per-row parsers in serve/consumer.py
CHUNK_ALS = 0  # ``id,T,payload``  -> key "id-T", value payload
CHUNK_SVM = 1  # ``key,payload``   -> key raw first token, value rest


def _fnv1a_ranges(buf: "np.ndarray", starts: "np.ndarray",
                  ends: "np.ndarray") -> Optional["np.ndarray"]:
    """Vectorized 32-bit FNV-1a over byte ranges of ``buf`` — the same
    hash ``serve.table._fnv1a`` computes over each key's utf-8 bytes, but
    straight from the chunk buffer: no per-key ``str.encode`` calls.
    Returns None when a range is oversized (caller falls back to the
    per-key path)."""
    n = len(starts)
    if n == 0:
        return np.empty(0, np.uint32)
    lens = (ends - starts).astype(np.int64)
    L = int(lens.max())
    if L > 256:
        return None  # degenerate key; don't build an (n, L) buffer for it
    h = np.full(n, 0x811C9DC5, np.uint32)
    if L == 0:
        return h
    padded = np.zeros((n, L), np.uint8)
    total = int(lens.sum())
    row = np.repeat(np.arange(n), lens)
    col = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    padded[row, col] = buf[np.repeat(starts, lens) + col]
    prime = np.uint32(0x01000193)
    for j in range(L):
        hx = (h ^ padded[:, j]) * prime
        h = np.where(j < lens, hx, h)
    return h


def split_journal_chunk(data: bytes, mode: int, with_hashes: bool = False):
    """Columnar parse of a whole journal byte chunk -> (keys, values,
    parse_errors), or with ``with_hashes`` -> (keys, values, parse_errors,
    hashes) where ``hashes`` is the per-key uint32 FNV-1a array (the shard
    routing hash, computed from the chunk bytes with zero per-key Python
    work) or None when the chunk had degenerate keys.

    The scalar ingest path pays one ``str.split`` + f-string + exception
    frame per row; at 1M-row replays that Python loop IS the ingest
    bottleneck.  This parser instead locates every newline and comma with
    numpy byte scans, rewrites the key/value separators in ONE buffer
    pass, and materializes all key/value strings with a single C-level
    ``str.split`` — per-row Python work is zero.

    Semantics are pinned byte-identical to the per-row parsers
    (``parse_als_record`` / ``parse_svm_record``, tests assert parity):

    - ALS rows need >= 2 commas; the first comma becomes the "-" of the
      ``<id>-<T>`` key, the payload may itself contain commas.  Rows with
      fewer commas count as parse errors (skip-and-count).
    - SVM rows split at the FIRST comma; a row with no comma yields
      (row, "") and is NOT an error (str.partition semantics).
    - empty lines are skipped silently; a trailing "\\r" (CRLF input) is
      stripped like ``str.splitlines`` does.
    """
    if mode not in (CHUNK_ALS, CHUNK_SVM):
        raise ValueError(f"unknown chunk mode: {mode}")
    if not data:
        return ([], [], 0, None) if with_hashes else ([], [], 0)
    if data[-1:] != b"\n":
        data = data + b"\n"  # journal chunks end at a newline; be defensive
    buf = np.frombuffer(data, np.uint8)
    nl = np.nonzero(buf == ord("\n"))[0]
    starts = np.empty_like(nl)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl.copy()  # exclusive end of line content
    # CRLF tolerance, matching splitlines() on the scalar path
    cr = buf[np.maximum(ends - 1, 0)] == ord("\r")
    cr &= ends > starts
    ends = ends - cr
    nonempty = ends > starts
    cpos = np.nonzero(buf == ord(","))[0]
    if len(cpos) == 0:
        # no commas anywhere: ALS -> all nonempty lines are errors; SVM ->
        # every nonempty line is (line, "")
        if mode == CHUNK_ALS:
            errs = int(nonempty.sum())
            return ([], [], errs, None) if with_hashes else ([], [], errs)
        text = data.decode("utf-8")
        keys = [ln for ln in text.splitlines() if ln]
        values = [""] * len(keys)
        if with_hashes:
            hashes = _fnv1a_ranges(buf, starts[nonempty], ends[nonempty])
            return keys, values, 0, hashes
        return keys, values, 0
    j1 = np.searchsorted(cpos, starts)
    safe1 = np.minimum(j1, len(cpos) - 1)
    c1 = cpos[safe1]
    has1 = (j1 < len(cpos)) & (c1 < ends)
    out = buf.copy()
    errors = 0
    loners = None
    if mode == CHUNK_ALS:
        j2 = j1 + 1
        safe2 = np.minimum(j2, len(cpos) - 1)
        c2 = cpos[safe2]
        has2 = has1 & (j2 < len(cpos)) & (c2 < ends)
        keep_line = nonempty & has2
        errors = int((nonempty & ~has2).sum())
        out[c1[keep_line]] = ord("-")   # "id,T" -> "id-T"
        out[c2[keep_line]] = ord("\n")  # key/value separator
        key_ends = c2  # key is "id-T": start of line .. second comma
    else:
        keep_line = nonempty  # str.partition never fails a row
        out[c1[nonempty & has1]] = ord("\n")
        # comma-less SVM rows yield (row, "") — they get an extra "\n"
        # spliced in after the mask pass so the key/value alternation
        # holds WITHOUT reordering (last-writer-wins depends on order)
        loners = np.nonzero(nonempty & ~has1)[0]
        key_ends = np.where(has1, c1, ends)
    no_loners = loners is None or len(loners) == 0
    if bool(keep_line.all()) and not bool(cr.any()):
        # clean chunk (the overwhelmingly common case): every byte is
        # kept, so skip the O(bytes) mask build and boolean gather
        kept_arr = out
        if not no_loners:
            kept_arr = np.insert(
                kept_arr, nl[loners] + 1, np.uint8(ord("\n"))
            )
    else:
        # drop malformed/empty lines (and CR bytes) in one mask pass
        line_lens = nl - starts + 1
        mask = np.repeat(keep_line, line_lens)
        mask[ends[cr]] = False
        kept_arr = out[mask]
        if not no_loners:
            # position just past each loner's newline in the kept stream
            cum = np.cumsum(mask)
            kept_arr = np.insert(
                kept_arr, cum[nl[loners]], np.uint8(ord("\n"))
            )
    # decode + split ONCE: parts alternate key, value, key, value, ...
    kept = kept_arr.tobytes()
    if kept:
        parts = kept.decode("utf-8").split("\n")
        parts.pop()  # buffer ends with "\n" -> one trailing empty
        keys, values = parts[0::2], parts[1::2]
    else:
        keys, values = [], []
    if not with_hashes:
        return keys, values, errors
    # per-key shard hashes straight from the (rewritten) chunk bytes, in
    # kept-line order — the key bytes ARE each key string's utf-8 bytes
    hashes = _fnv1a_ranges(out, starts[keep_line], key_ends[keep_line])
    return keys, values, errors, hashes


# ---------------------------------------------------------------------------
# latency CSVs (load-harness output contracts)
# ---------------------------------------------------------------------------

def format_als_latency_row(user: int, item: int, prediction: float, ms: float) -> str:
    """``uId,iId,prediction,ms`` (ALSPredictRandom.java:94)."""
    return f"{user},{item},{_fmt(prediction)},{_fmt_ms(ms)}"


def format_svm_latency_row(query_id: int, n_features: int, prediction: float,
                           ms: float) -> str:
    """``qId,nFeatures,prediction,ms`` (SVMPredictRandom.java:91)."""
    return f"{query_id},{n_features},{_fmt(prediction)},{_fmt_ms(ms)}"


# ---------------------------------------------------------------------------

def _split_semis(payload: str) -> List[str]:
    """Split on ';' with Java String.split semantics: trailing empty tokens
    are dropped, but interior empties ('1.0;;2.0') are kept so the float
    parse raises instead of silently shortening the vector."""
    toks = payload.split(";")
    while toks and toks[-1] == "":
        toks.pop()
    return toks


def _fmt(v: float) -> str:
    """Float -> shortest round-trip decimal (close analog of Java
    Double.toString for the value ranges these models produce)."""
    return repr(float(v))


def _fmt_ms(ms: float) -> str:
    # the reference logs integral milliseconds (System.currentTimeMillis diff)
    return str(int(round(ms)))
