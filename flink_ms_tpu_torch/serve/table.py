"""Sharded model table: string keys (``"<id>-U"``, ``"<id>-I"``) to row
payloads (``"f1;f2;..."``), last writer wins per key.

Own copy of ``ModelTable`` from ``flink_ms_tpu/serve/table.py``: the
put/get surface and the change listeners the top-k index hangs on.  Keys
are hash-partitioned into shards by a stable FNV-1a, as Flink routes keys
to operator subtasks.  Snapshots, restore and the columnar ingest are not
ported yet (ROADMAP.md, Queue 1, item 'Serving job').
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple


def _fnv1a(s: str) -> int:
    """Stable 32-bit FNV-1a: shard routing must not depend on Python's
    per-process hash randomization."""
    h = 0x811C9DC5
    for ch in s.encode("utf-8"):
        h ^= ch
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


class ModelTable:
    def __init__(self, n_shards: int = 8):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self._shards: List[Dict[str, str]] = [dict() for _ in range(n_shards)]
        self._lock = threading.RLock()
        self.puts = 0  # ingest counter
        self._listeners: List = []
        # one optional batched callback per listener (None: the per-key
        # callback runs for each key of a batch)
        self._batch_listeners: List = []

    def add_change_listener(self, fn, batch_fn=None) -> None:
        """Register fn(key), called on every put on the writer thread under
        the table lock, so it must stay O(1) (the top-k index records the
        key in its dirty set).  ``batch_fn(keys)``, when given, replaces the
        per-key calls for ``put_many``: one callback per batch."""
        with self._lock:
            self._listeners.append(fn)
            self._batch_listeners.append(batch_fn)

    def shard_of(self, key: str) -> int:
        return _fnv1a(key) % self.n_shards

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._shards[self.shard_of(key)][key] = value
            self.puts += 1
            for fn in self._listeners:
                fn(key)

    def put_many(self, pairs) -> None:
        """Batched ingest: one lock acquisition and one listener
        notification per batch; later pairs win over earlier ones."""
        pairs = list(pairs)
        if not pairs:
            return
        keys = [k for k, _ in pairs]
        shard_ids = [self.shard_of(k) for k in keys]
        with self._lock:
            for (key, value), sid in zip(pairs, shard_ids):
                self._shards[sid][key] = value
            self.puts += len(pairs)
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
