"""Sharded model table: string keys (``"<id>-U"``, ``"<id>-I"``, feature
ids, bucket ids) to row payloads, last writer wins per key.

Own copy of ``flink_ms_tpu/serve/table.py``, the counterpart of the
reference's queryable keyed ``ValueState`` (``ALSKafkaConsumer.java:85-92``).
Keys are hash-partitioned into shards by a stable FNV-1a, as Flink routes
keys to operator subtasks; ``put_many_columns`` is the serving job's
columnar ingest, and change listeners (the top-k index) get one batched
callback per chunk.

Snapshots are plain ``key\tvalue`` TSV per shard plus a JSON manifest with
the journal offset, written exactly as the JAX package writes them, so a
checkpoint written by either package restores in the other.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MANIFEST = "MANIFEST.json"


def _fnv1a(s: str) -> int:
    """Stable 32-bit FNV-1a — shard routing must not depend on Python's
    per-process hash randomization."""
    h = 0x811C9DC5
    for ch in s.encode("utf-8"):
        h ^= ch
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def _fnv1a_batch(keys) -> "np.ndarray":
    """Vectorized FNV-1a over a batch of keys (uint32 wrap = the & mask).

    Byte-identical to ``_fnv1a`` per key; the per-character loop runs over
    the LONGEST key only, with shorter keys masked out — ~10x less Python
    bytecode per key at ingest batch sizes.  Returns uint32 hashes."""
    bs = [k.encode("utf-8") for k in keys]
    n = len(bs)
    L = max((len(b) for b in bs), default=0)
    if L == 0:
        return np.full(n, 0x811C9DC5, np.uint32)
    if L > 256:
        # one oversized key must only cost itself, not an (n, L) buffer
        # and an L-deep masked loop for the whole batch
        return np.fromiter(
            (_fnv1a(k) for k in keys), np.uint32, n
        )
    buf = np.zeros((n, L), np.uint8)
    lens = np.fromiter((len(b) for b in bs), np.int64, n)
    flat = np.frombuffer(b"".join(bs), np.uint8)
    # scatter each key's bytes into its padded row
    row = np.repeat(np.arange(n), lens)
    col = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
    buf[row, col] = flat
    h = np.full(n, 0x811C9DC5, np.uint32)
    prime = np.uint32(0x01000193)
    for j in range(L):
        active = j < lens
        hx = (h ^ buf[:, j]) * prime
        h = np.where(active, hx, h)
    return h


class ModelTable:
    def __init__(self, n_shards: int = 8):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self._shards: List[Dict[str, str]] = [dict() for _ in range(n_shards)]
        self._lock = threading.RLock()
        self.puts = 0  # ingest counter (observability)
        # bumped on EVERY mutation (put, put_many, restore) — derived
        # read-side caches (e.g. the DOT merged range index) key on it
        self.version = 0
        self._listeners: List = []  # change listeners (e.g. the top-k index)
        # parallel list: optional batched callbacks, one entry per listener
        # (None = fall back to per-key fn inside put_many)
        self._batch_listeners: List = []

    def add_change_listener(self, fn, batch_fn=None) -> None:
        """Register fn(key) to be called on every put.  Callbacks run on
        the writer thread under the table lock — keep them O(1) (the top-k
        index just records the key in its dirty set).

        ``batch_fn(keys)``, when given, replaces the per-key calls for
        batched ingest (``put_many``/``put_many_columns``): ONE callback
        per chunk instead of one per row, so a listener can take its own
        lock once per chunk (the top-k index's dirty set)."""
        with self._lock:
            self._listeners.append(fn)
            self._batch_listeners.append(batch_fn)

    def shard_of(self, key: str) -> int:
        return _fnv1a(key) % self.n_shards

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._shards[self.shard_of(key)][key] = value
            self.puts += 1
            self.version += 1
            for fn in self._listeners:
                fn(key)

    def put_many(self, pairs) -> None:
        """Batched ingest: one lock acquisition and one vectorized hash
        pass per batch — the ingest hot path (at 1M-row replays the
        per-key Python FNV loop was the measured pipeline bottleneck)."""
        pairs = list(pairs)
        if not pairs:
            return
        self.put_many_columns([k for k, _ in pairs], [v for _, v in pairs])

    def put_many_columns(self, keys, values, hashes=None) -> None:
        """Columnar batched ingest: keys/values as parallel sequences.

        The per-row Python work of ``put_many`` (tuple unpack, per-key
        dict insert bytecode, per-key listener call) is replaced by a
        stable shard-sort and ONE ``dict.update`` per touched shard, plus
        one batched listener notification per chunk — the whole row loop
        runs in C.  Last-writer-wins order is preserved: the sort is
        stable, so within a shard duplicates keep input order.

        ``hashes``, when given, is the per-key uint32 FNV-1a array (the
        columnar chunk parser computes it from the raw bytes, skipping
        the per-key encode of ``_fnv1a_batch``); it must match
        ``_fnv1a(key)`` per key."""
        n = len(keys)
        if n == 0:
            return
        if not isinstance(keys, list):
            keys = list(keys)
        if n < 32:
            # tiny batch: the argsort/array machinery costs more than the
            # plain loop it replaces
            shard_ids = (
                _fnv1a_batch(keys) if hashes is None else hashes
            ) % self.n_shards
            with self._lock:
                for key, value, sid in zip(keys, values, shard_ids):
                    self._shards[sid][key] = value
                self.puts += n
                self.version += 1
                self._notify_locked(keys)
            return
        shard_ids = (
            _fnv1a_batch(keys) if hashes is None else hashes
        ) % self.n_shards
        order = np.argsort(shard_ids, kind="stable")
        ks = np.asarray(keys, dtype=object)[order]
        vs = np.asarray(values, dtype=object)[order]
        bounds = np.searchsorted(
            shard_ids[order], np.arange(self.n_shards + 1)
        )
        with self._lock:
            for sid in range(self.n_shards):
                s, e = bounds[sid], bounds[sid + 1]
                if s < e:
                    self._shards[sid].update(
                        zip(ks[s:e].tolist(), vs[s:e].tolist())
                    )
            self.puts += n
            self.version += 1
            self._notify_locked(keys)

    def _notify_locked(self, keys) -> None:
        for fn, batch_fn in zip(self._listeners, self._batch_listeners):
            if batch_fn is not None:
                batch_fn(keys)
            else:
                for key in keys:
                    fn(key)

    def get(self, key: str) -> Optional[str]:
        return self._shards[self.shard_of(key)].get(key)

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def items(self) -> Iterator[Tuple[str, str]]:
        with self._lock:
            snap = [dict(s) for s in self._shards]
        for s in snap:
            yield from s.items()

    # -- snapshot / restore -------------------------------------------------

    def snapshot(self, checkpoint_dir: str, offset: int) -> str:
        """Write a consistent (table, journal offset) snapshot; returns the
        checkpoint path.  Atomic via tmp-dir + rename; a ``latest`` pointer
        file names the newest complete checkpoint."""
        with self._lock:
            shards_copy = [dict(s) for s in self._shards]
        chk_id = f"chk-{int(time.time() * 1000)}"
        tmp = os.path.join(checkpoint_dir, f".tmp-{chk_id}")
        os.makedirs(tmp, exist_ok=True)
        for idx, shard in enumerate(shards_copy):
            with open(os.path.join(tmp, f"shard-{idx}.tsv"), "w") as f:
                for k, v in shard.items():
                    f.write(f"{k}\t{v}\n")
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(
                {"offset": offset, "n_shards": self.n_shards, "ts": time.time()}, f
            )
        final = os.path.join(checkpoint_dir, chk_id)
        os.rename(tmp, final)
        with open(os.path.join(checkpoint_dir, "latest.tmp"), "w") as f:
            f.write(chk_id)
        os.replace(
            os.path.join(checkpoint_dir, "latest.tmp"),
            os.path.join(checkpoint_dir, "latest"),
        )
        self._prune(checkpoint_dir, keep=2)
        return final

    @staticmethod
    def _prune(checkpoint_dir: str, keep: int) -> None:
        chks = sorted(
            d for d in os.listdir(checkpoint_dir) if d.startswith("chk-")
        )
        for old in chks[:-keep]:
            import shutil

            shutil.rmtree(os.path.join(checkpoint_dir, old), ignore_errors=True)

    def restore(self, checkpoint_dir: str) -> Optional[int]:
        """Load the latest complete checkpoint; returns the journal offset,
        or None if no checkpoint exists."""
        latest_file = os.path.join(checkpoint_dir, "latest")
        if not os.path.exists(latest_file):
            return None
        with open(latest_file) as f:
            chk_id = f.read().strip()
        chk = os.path.join(checkpoint_dir, chk_id)
        with open(os.path.join(chk, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest["n_shards"] != self.n_shards:
            raise ValueError(
                f"checkpoint has {manifest['n_shards']} shards, table has "
                f"{self.n_shards}"
            )
        with self._lock:
            for idx in range(self.n_shards):
                shard: Dict[str, str] = {}
                path = os.path.join(chk, f"shard-{idx}.tsv")
                if os.path.exists(path):
                    with open(path) as f:
                        for line in f:
                            line = line.rstrip("\n")
                            if not line:
                                continue
                            k, _, v = line.partition("\t")
                            shard[k] = v
                self._shards[idx] = shard
            self.version += 1
        return int(manifest["offset"])
