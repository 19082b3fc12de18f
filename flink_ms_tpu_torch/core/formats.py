"""Text-format contracts of the ALS training path (SURVEY.md Appendix B).

Own copy of the subset of ``flink_ms_tpu/core/formats.py`` that ALS
training reads and writes: ratings CSV in, ``id,U|I,f1;f2;...;fk`` factor
rows out.  The lines are byte-identical to the JAX package's, so files
written by either package are read by the other.

All readers accept a file path or a directory (Flink jobs with parallelism > 1
write directories of part files).
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Sequence, Tuple

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
