"""Text-format contracts of the training paths (SURVEY.md Appendix B).

Own copy of the subset of ``flink_ms_tpu/core/formats.py`` that ALS and
SVM training read and write: ratings CSV in, ``id,U|I,f1;f2;...;fk``
factor rows out; LibSVM in, ``featureIndex,weight`` or range-partitioned
``bucket,idx:w;...`` rows out.  The lines are byte-identical to the JAX
package's, so files written by either package are read by the other.

All readers accept a file path or a directory (Flink jobs with parallelism > 1
write directories of part files).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np

USER = "U"
ITEM = "I"


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
    """Parse ``bucket,idx:w;idx:w;...`` (RangePartitionSVMPredict.java:80-101)
    token by token; a malformed pair raises."""
    bucket_s, payload = line.split(",", 1)
    entries = []
    for tok in _split_semis(payload):
        idx_s, w_s = tok.split(":")
        entries.append((int(idx_s), float(w_s)))
    return int(bucket_s), entries


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
