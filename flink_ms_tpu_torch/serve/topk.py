"""Top-k recommendation serving from the live model table, on one device
or row-sharded over several.

Counterpart of ``flink_ms_tpu/serve/topk.py``.  A device-resident mirror of
the item-factor matrix answers TOPK with one matrix product and a top-k
(``topk_lowest_first``), and the index is maintained incrementally: the
table pushes changed keys into the index's dirty set
(``add_change_listener``), and at query time

- rows already in the index are rewritten in place on the device (an
  ``index_copy_`` of the changed rows only), so a streaming online-SGD
  load never forces a full rebuild on the query path;
- new item ids start ONE background rebuild thread while queries keep
  answering from the current, briefly stale, index; the rebuilt matrix is
  swapped in when its upload has finished.

Past ``TPUMS_ANN_MIN_ROWS`` rows (``TPUMS_TOPK_TIER=auto``, the default) or
always (``ivf``), the rebuild also trains the IVF tier (``serve/ann.py``)
and queries probe its lists and re-rank the shortlist exactly against the
same resident matrix, while the build-time recall probe holds
``TPUMS_ANN_RECALL_MIN``; ``exact`` never builds it.

The index lives on ``device`` (default ``"cuda"``, no fallback: without
CUDA it raises unless given ``"cpu"``).  ``TPUMS_TOPK_PLATFORM=cpu`` pins it
to the CPU, an operator's explicit choice as in the reference.

The row-sharded exact tier (``ShardedMatrix``) spreads the catalog over
the index's shard devices, which the handler sets to the process's
visible GPUs when there is more than one: row slice s lives on device s,
each slice is scored against the whole query frame, and the per-slice
top-k partials merge on the first device.  ``TPUMS_TOPK_SHARDED``:
``auto`` (default) shards from ``TPUMS_TOPK_SHARD_MIN_ROWS`` rows (100,000)
up, and on GPUs only a catalog larger than half of one card; ``1`` shards
at any size, ``0`` never; with one device every value serves the
single-device tier, as in the reference.

Every device-to-host copy of a query result passes through ``_to_host``,
and only (B, k) arrays do: the catalog never leaves the device.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..parallel.mesh import resolve_device, row_bucket
from .table import ModelTable


def _tier_mode() -> str:
    """TPUMS_TOPK_TIER: ``exact`` | ``ivf`` | ``auto`` (default).  Unknown
    values degrade to ``auto`` (exact until the catalog is big enough AND
    the measured recall holds the gate)."""
    tier = os.environ.get("TPUMS_TOPK_TIER", "auto").strip().lower()
    return tier if tier in ("exact", "ivf", "auto") else "auto"


def _target_device(device="cuda") -> torch.device:
    """The device the index lives on: ``device`` as ``resolve_device``
    checks it, unless ``TPUMS_TOPK_PLATFORM=cpu`` pins the index to the
    CPU."""
    if os.environ.get("TPUMS_TOPK_PLATFORM", "") == "cpu":
        return torch.device("cpu")
    return resolve_device(device)


def _sync(dev: torch.device) -> None:
    """Wait until the work queued on ``dev``'s current stream is done."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


_warm_lock = threading.Lock()
_warmed: dict = {}   # device -> its warm-up thread (None while it starts)

# the longest an index's close waits for its background threads
_QUIESCE_S = 30.0


def _warm_ops(dev: torch.device) -> None:
    """The index's three operations (a matrix product, the top-k, a row
    copy) at a tiny shape on ``dev``, then a wait for them."""
    m = torch.zeros((8, 4), device=dev)
    topk_lowest_first(torch.zeros((2, 4), device=dev) @ m.T, 2)
    m.index_copy_(0, torch.zeros(1, dtype=torch.long, device=dev),
                  torch.ones((1, 4), device=dev))
    _sync(dev)


def _warm_async(dev: torch.device) -> None:
    """Pay the CUDA context and cuBLAS start-up off the query path, once per
    process and card.  The context is made here, on the caller's thread:
    torch's lazy CUDA init holds the GIL while it runs, so on a daemon
    thread it would hold back a serving job's registry heartbeat once the
    job has registered (the index is built before that).  The daemon
    thread then runs the index's three operations (a matrix product, the
    top-k, a row copy) at a tiny shape; those release the GIL."""
    if dev.type != "cuda":
        return
    with _warm_lock:
        if dev in _warmed:
            return
        _warmed[dev] = None
    torch.cuda.init()

    def warm():
        try:
            _warm_ops(dev)
        except Exception as e:  # pragma: no cover - best-effort warm-up
            print(f"[topk] CUDA warm-up failed: {e}", file=sys.stderr)

    t = threading.Thread(target=warm, name="topk-cuda-warm", daemon=True)
    with _warm_lock:
        _warmed[dev] = t
    t.start()


# rows parsed by one ``_parse_block``: each block's join, split and float
# parse is one C call that holds the GIL throughout, so the block bounds
# how long an index build can hold back the process's other threads (its
# registry heartbeat first: at the served model's width one unblocked
# parse held it past a 1.5 s replica TTL, and the member was respawned)
_PARSE_BLOCK_ROWS = 1024


def _parse_block(payloads: List[str], width: int) -> np.ndarray:
    """``width``-token ``f1;f2;...`` payloads -> (n, width) float32, parsed
    by numpy's float parser as float64 first; ValueError when a token is
    not a number or the count comes up short."""
    flat = np.array(";".join(payloads).split(";"), dtype=np.float64)
    if flat.size != len(payloads) * width:
        raise ValueError("short parse")
    return flat.reshape(len(payloads), width).astype(np.float32)


_FRAME_FLOOR = 8


def _frame_rows(b: int) -> int:
    """Rows a frame of b queries is padded to on the exact tier: the next
    power of two, at least ``_FRAME_FLOOR`` (so a whole number of
    ``_FRAME_FLOOR``-row blocks)."""
    return max(_FRAME_FLOOR, 1 << (b - 1).bit_length())


def _score_frame(q: torch.Tensor, m: torch.Tensor,
                 n_queries: int) -> torch.Tensor:
    """``(q @ m.T)[:n_queries]`` for a frame padded to ``_frame_rows``
    rows, computed so that a query gets the same score bits whatever frame
    it rides in.  The card's matrix library picks its kernel by the
    product's shape, so there every product has exactly ``_FRAME_FLOOR``
    rows, one per block of the frame.  CPU torch also rounds a row by its
    place in the product (its kernels' register tiles), so there each
    query is scored at row 0 of a product of its own: ``_FRAME_FLOOR``
    copies of it, as a lone query's frame is padded."""
    if q.device.type == "cpu":
        parts = [(q[s:s + 1].repeat(_FRAME_FLOOR, 1) @ m.T)[:1]
                 for s in range(n_queries)]
    else:
        parts = [q[s:s + _FRAME_FLOOR] @ m.T
                 for s in range(0, q.shape[0], _FRAME_FLOOR)]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out[:n_queries]


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The ONE funnel through which query results reach the host (and the
    copy that waits for the device).  Only (B, k) arrays pass through it;
    the tests spy on it to prove no catalog-sized array ever does."""
    return x.cpu().numpy()


def _flip(bits: torch.Tensor) -> torch.Tensor:
    """Map float32 bit patterns (as int32) to int32 keys in the floats'
    total order, or keys back to bit patterns (the map is its own
    inverse): a negative float's magnitude bits are reversed, so -0.0
    sorts just below +0.0 and NaNs sit at the ends by sign."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_lowest_first(scores: torch.Tensor, k: int):
    """``lax.top_k``'s choice and order over the last axis of a (B, n)
    float32 tensor -> (values (B, k) float32, indices (B, k) int64).

    Values descend in the floats' total order (XLA's: +0.0 above -0.0),
    and among equal values the lower index comes first, including WHICH
    of several rows tied at the k-th value get in.  ``torch.topk``
    promises neither, so its selection is reordered, and rows whose tie at
    the k-th value straddles the cut (more candidates at or above it than
    k; the one host read of this function finds them) are rebuilt from
    the lowest tied indices.  Overwrites ``scores`` with its keys."""
    keys = scores.view(torch.int32)
    keys ^= (keys >> 31) & 0x7FFFFFFF  # _flip, in place
    kv, idx = torch.topk(keys, k, dim=1)
    idx, perm = idx.sort(dim=1)
    kv = kv.gather(1, perm)
    kv, perm = kv.sort(dim=1, descending=True, stable=True)
    idx = idx.gather(1, perm)
    if k:
        kth = kv[:, -1:]
        for r in torch.nonzero((keys >= kth).sum(1) > k).flatten().tolist():
            row, t = keys[r], kth[r, 0]
            above = torch.nonzero(row > t).flatten()
            tied = torch.nonzero(row == t).flatten()[:k - above.numel()]
            sel = torch.cat([above, tied])  # ascending within each part
            sel = sel.sort().values
            sk, perm = row[sel].sort(descending=True, stable=True)
            kv[r], idx[r] = sk, sel[perm]
    return _flip(kv).view(torch.float32), idx


# score bias stamped on pad rows, so they can never win a top-k over any
# real row; float32-safe margin below any realistic factor dot product
_PAD_SCORE = -1e30


class ShardedMatrix:
    """The factor matrix of the sharded exact tier: rows padded to
    ``row_bucket(n, D)`` and cut into D equal slices, slice s on
    ``devices[s]`` with a bias that is ``_PAD_SCORE`` on its pad rows
    (``flink_ms_tpu/serve/topk.py:476-510``).  Row i of the catalog is row
    i % per of slice i // per."""

    def __init__(self, rows: np.ndarray, devices):
        rows = np.asarray(rows, dtype=np.float32)
        n, k = rows.shape
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.n_pad = row_bucket(n, len(self.devices))
        self.per = self.n_pad // len(self.devices)
        self.shape = (self.n_pad, k)
        self.slices, self.bias = [], []
        for s, dev in enumerate(self.devices):
            real = rows[s * self.per:(s + 1) * self.per]
            m = torch.zeros((self.per, k), dtype=torch.float32)
            m[:len(real)] = torch.from_numpy(real)
            b = torch.zeros(self.per, dtype=torch.float32)
            b[len(real):] = _PAD_SCORE
            self.slices.append(m.to(dev))
            self.bias.append(b.to(dev))
        for dev in set(self.devices):
            _sync(dev)

    def index_copy_(self, dim: int, pos: torch.Tensor, vec: torch.Tensor):
        """Rewrite catalog rows in place, each in the slice that owns it."""
        pos, vec = pos.cpu(), vec.cpu()
        owner = pos // self.per
        for s in torch.unique(owner).tolist():
            sel = owner == s
            self.slices[s].index_copy_(
                dim, (pos[sel] % self.per).to(self.devices[s]),
                vec[sel].to(self.devices[s]))
        return self

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        """Catalog rows by global index, on the first device: each slice
        gathers the rows it owns (the IVF tier's re-rank reads so)."""
        idx = idx.to(self.device)
        owner = (idx // self.per)[..., None]
        out = torch.zeros((*idx.shape, self.shape[1]), dtype=torch.float32,
                          device=self.device)
        for s, (m, dev) in enumerate(zip(self.slices, self.devices)):
            part = m[(idx % self.per).to(dev)].to(self.device)
            out = torch.where(owner == s, part, out)
        return out

    def topk(self, q: torch.Tensor, n_queries: int, k: int):
        """The exact top-k of the first ``n_queries`` rows of the frame
        ``q`` -> (scores, global row ids) on the first device.  Each slice
        scores the frame (one matrix product, as the reference's ``q @
        m.T``), takes its own top ``min(k, per)`` and offsets the ids to
        global rows; the partials, laid side by side slice-major as the
        reference's ``moveaxis`` lays them, merge in one more top-k, so
        ties resolve as ``lax.top_k`` resolves them over that
        concatenation (``flink_ms_tpu/serve/topk.py:217-265``)."""
        k_local = min(k, self.per)
        scores, ids = [], []
        for s, (m, b, dev) in enumerate(zip(self.slices, self.bias,
                                            self.devices)):
            part = _score_frame(q.to(dev), m, n_queries) + b[None, :]
            v, i = topk_lowest_first(part, k_local)
            scores.append(v.to(self.device))
            ids.append((i + s * self.per).to(self.device))
        v, j = topk_lowest_first(torch.cat(scores, dim=1), k)
        return v, torch.cat(ids, dim=1).gather(1, j)


class DeviceFactorIndex:
    def __init__(self, table: ModelTable, factor_suffix: str = "-I",
                 engine: Optional[str] = None, device="cuda",
                 shard_devices=None):
        """``shard_devices``: the devices the sharded exact tier spreads
        the catalog over (None or one device: never sharded)."""
        if engine not in (None, "torch"):
            raise ValueError(
                f"top-k engine {engine!r}: the port has one engine, 'torch' "
                "(a matrix product and a top-k)")
        self.device = _target_device(device)
        self._shard_devices = ([torch.device(d) for d in shard_devices]
                               if shard_devices else None)
        self._shard_mode = os.environ.get("TPUMS_TOPK_SHARDED", "auto")
        self._shard_min_rows = int(
            os.environ.get("TPUMS_TOPK_SHARD_MIN_ROWS", 100_000))
        self.table = table
        self.suffix = factor_suffix
        self.engine = "torch"
        _warm_async(self.device)
        self._lock = threading.Lock()
        self._ids: List[str] = []
        self._id_pos: dict = {}   # id -> row index in the device matrix
        self._matrix: Optional[torch.Tensor] = None  # (n, k) on self.device
        self._n_real = 0
        self._k_real = 0  # factor width
        self._built_once = False
        # tier knobs, read once per index; the background rebuild
        # re-evaluates the SIZE threshold at each swap
        self.tier = _tier_mode()
        self._ann_min_rows = int(
            os.environ.get("TPUMS_ANN_MIN_ROWS", 200_000))
        self._ann_recall_min = float(
            os.environ.get("TPUMS_ANN_RECALL_MIN", 0.95))
        self._ann = None         # serve.ann.IVFIndex when the tier is built
        # health: rebuild rate, dirty backlog depth, and how stale the
        # serving matrix is relative to the oldest unabsorbed update
        # (per-process series: a fleet sum of stalenesses means nothing)
        reg = obs_metrics.get_registry()
        self._obs_rebuilds = reg.counter("tpums_topk_rebuilds_total")
        self._obs_dirty_depth = reg.gauge("tpums_topk_dirty_depth")
        self._obs_staleness = reg.gauge(
            "tpums_topk_index_staleness_seconds", pid=str(os.getpid()))
        self._obs_ann_recall = reg.gauge(
            "tpums_ann_recall_probe", pid=str(os.getpid()))
        self._oldest_dirty_ts: Optional[float] = None
        # dirty-key plumbing: the table's writer thread appends, the query
        # path drains.  Tables without listener support fall back to
        # counter-triggered full rebuilds.
        self._dirty_lock = threading.Lock()
        self._dirty: set = set()
        # rows of replay-scale batches pending a full rebuild: a count,
        # not keys (the rebuild snapshots the whole table anyway)
        self._replay_backlog = 0
        self._rebuild_thread: Optional[threading.Thread] = None
        self._closed = False   # close(): no rebuild starts after it
        self._counter_mode = not hasattr(table, "add_change_listener")
        self._built_at = -1
        if not self._counter_mode:
            table.add_change_listener(self._on_put, self._on_put_many)
        # per-query work bound: at most this many dirty rows are parsed and
        # copied on the query path; a larger backlog (a writer outrunning
        # the queries) is absorbed by ONE background rebuild instead
        self.apply_cap = int(os.environ.get("TPUMS_TOPK_APPLY_CAP", 1024))
        self.rebuild_backlog = 8 * self.apply_cap
        # keys already peek-applied while the current rebuild runs: an
        # unchanged backlog must not be re-parsed on every query
        self._peek_applied: set = set()
        self.full_builds = 0       # observability / test hooks
        self.inplace_updates = 0

    # -- change tracking ----------------------------------------------------

    def _on_put(self, key: str) -> None:  # writer thread, table lock held
        if key.endswith(self.suffix) and not key.startswith("MEAN"):
            with self._dirty_lock:
                self._dirty.add(key)
                if self._oldest_dirty_ts is None:
                    self._oldest_dirty_ts = time.time()

    def _on_put_many(self, keys) -> None:  # writer thread, table lock held
        """Batched change notification, the dirty lock taken once per
        batch.  A batch past the rebuild threshold records only its COUNT:
        the next query starts one background rebuild, whose table snapshot
        absorbs every row."""
        if len(keys) >= self.rebuild_backlog:
            with self._dirty_lock:
                self._replay_backlog += len(keys)
                if self._oldest_dirty_ts is None:
                    self._oldest_dirty_ts = time.time()
            return
        suffix = self.suffix
        relevant = [
            k for k in keys
            if k.endswith(suffix) and not k.startswith("MEAN")
        ]
        if relevant:
            with self._dirty_lock:
                self._dirty.update(relevant)
                if self._oldest_dirty_ts is None:
                    self._oldest_dirty_ts = time.time()

    def _drain_dirty(self, limit: Optional[int] = None) -> set:
        with self._dirty_lock:
            if limit is None or len(self._dirty) <= limit:
                dirty, self._dirty = self._dirty, set()
                if not self._replay_backlog:
                    self._oldest_dirty_ts = None
                return dirty
            dirty = set()
            while len(dirty) < limit:
                dirty.add(self._dirty.pop())
            # leftovers keep the backlog timestamp, which can only
            # overstate the staleness
            return dirty

    # -- building -----------------------------------------------------------

    def _snapshot_rows(self):
        """-> (ids, rows ndarray (n, width), width).

        The width is the MODAL separator count across the snapshot, so a
        single truncated or over-long payload is dropped rather than
        poisoning the build, and rows are filtered by token count before
        the reshape, so it can never misalign them.  The width-consistent
        payloads are joined and parsed by numpy's float parser, in blocks
        of ``_PARSE_BLOCK_ROWS`` rows (each block's parse holds the GIL,
        so a build never holds it for long); a non-numeric token makes a
        block's parse come up short or raise, and the per-row path then
        drops those rows."""
        ids, payloads = [], []
        for key, payload in self.table.items():
            if not key.endswith(self.suffix) or key.startswith("MEAN"):
                continue
            ids.append(key[: -len(self.suffix)])
            payloads.append(payload.rstrip(";"))
        if not ids:
            return [], np.zeros((0, 0), np.float32), None
        counts = np.fromiter(
            (p.count(";") + 1 for p in payloads),
            dtype=np.int64, count=len(payloads),
        )
        width = int(np.bincount(counts).argmax())
        keep = counts == width
        if not keep.all():
            ids = [i for i, k in zip(ids, keep) if k]
            payloads = [p for p, k in zip(payloads, keep) if k]
        if not ids or width <= 0:
            return [], np.zeros((0, 0), np.float32), None
        try:
            return ids, np.concatenate([
                _parse_block(payloads[at:at + _PARSE_BLOCK_ROWS], width)
                for at in range(0, len(payloads), _PARSE_BLOCK_ROWS)]), width
        except ValueError:
            pass
        # robust path: per-row parse, drop rows with non-numeric tokens
        out_ids, rows = [], []
        for id_, payload in zip(ids, payloads):
            try:
                vec = [float(t) for t in payload.split(";") if t]
            except ValueError:
                continue
            if len(vec) != width:
                continue
            out_ids.append(id_)
            rows.append(vec)
        return out_ids, np.asarray(rows, dtype=np.float32), width

    def _shards_if_sharding(self, rows: np.ndarray):
        """The devices to shard over, or None for the single-device layout
        (``flink_ms_tpu/serve/topk.py:461-475``).  On GPUs ``auto`` also
        needs a catalog that one card cannot hold with room to spare: the
        slices are scored one after another, so the sharded tier serves
        slower than one card while the catalog fits there (PERF.md §5).
        ``1`` forces it at any size."""
        devices = self._shard_devices
        if self._shard_mode == "0" or devices is None or len(devices) < 2:
            return None
        if self._shard_mode == "1":
            return devices
        if len(rows) < self._shard_min_rows:
            return None
        if devices[0].type == "cuda" and \
                rows.nbytes <= _card_bytes(devices[0]) // 2:
            return None
        return devices

    def _pack(self, rows: np.ndarray) -> torch.Tensor:
        """A copy of the rows on the index device, finished when this
        returns: the rebuild thread swaps it in for queries that may run on
        another thread, and in-place row updates must never write into the
        caller's array (a CPU ``.to`` would share it)."""
        matrix = torch.from_numpy(np.asarray(rows, dtype=np.float32)).to(
            self.device, copy=True)
        _sync(self.device)
        return matrix

    def _maybe_build_ann(self, matrix):
        """The IVF tier for this catalog (the resident matrix, or host rows
        that the build uploads to the index device), or None when the tier
        knob or the size threshold says exact only.  Runs OFF the index
        lock on the rebuild path; a failed build serves the exact tier
        rather than poisoning the swap."""
        tier = self.tier
        n = matrix.shape[0]
        if tier == "exact" or n == 0:
            return None
        if tier == "auto" and n < self._ann_min_rows:
            return None
        try:
            from .ann import IVFIndex

            ann = IVFIndex.build(matrix, device=self.device)
        except Exception as e:
            print(f"[topk] IVF build failed (serving exact): {e}",
                  file=sys.stderr)
            return None
        self._obs_ann_recall.set(ann.recall_probe)
        if tier == "auto" and ann.recall_probe < self._ann_recall_min:
            # the recall contract failed on THIS catalog's geometry: auto
            # serves exact (a forced ivf tier serves anyway, the gauge
            # shows the miss)
            print(
                f"[topk] IVF recall probe {ann.recall_probe:.3f} < "
                f"{self._ann_recall_min} gate; serving exact",
                file=sys.stderr,
            )
            return None
        return ann

    def _assemble(self, ids, rows, width) -> dict:
        """The expensive half of a (re)build, device upload and IVF
        training, safe to run OFF the index lock; ``_swap_locked``
        installs the result."""
        matrix = ann = None
        if len(rows):
            shards = self._shards_if_sharding(rows)
            if shards is None:
                matrix = self._pack(rows)
                ann = self._maybe_build_ann(matrix)
            else:
                matrix = ShardedMatrix(rows, shards)
                # the IVF tier trains on the index device; its re-rank
                # reads the slices (ShardedMatrix.__getitem__)
                ann = self._maybe_build_ann(rows)
        return {
            "ids": ids, "id_pos": {id_: i for i, id_ in enumerate(ids)},
            "n_real": len(ids), "k_real": width, "matrix": matrix,
            "ann": ann,
        }

    def _swap_locked(self, a: dict) -> None:
        """Install an assembled index state (under self._lock)."""
        self._ids = a["ids"]
        self._id_pos = a["id_pos"]
        self._n_real = a["n_real"]
        self._k_real = a["k_real"]
        self._matrix = a["matrix"]
        self._ann = a["ann"]
        self._built_once = True
        self.full_builds += 1
        self._obs_rebuilds.inc()
        self._peek_applied.clear()

    def _build_locked(self) -> None:
        """Full build, called under self._lock."""
        # keys changed while we snapshot stay dirty for the next query
        self._drain_dirty()
        with self._dirty_lock:
            self._replay_backlog = 0  # full build absorbs the replay rows
        ids, rows, width = self._snapshot_rows()
        self._swap_locked(self._assemble(ids, rows, width))

    def bulk_load(self, ids, rows) -> None:
        """Install a pre-parsed catalog directly: a full build whose table
        snapshot parsed to exactly ``(ids, rows)``.  Stands up 1M-10M-row
        catalogs without 10M payload strings in the table; later table
        updates flow through the dirty set as usual (an unknown id
        triggers a rebuild that reads the TABLE, so a bulk-loaded catalog
        absent from the table reverts: a load ramp, not a second source of
        truth)."""
        rows = np.asarray(rows, dtype=np.float32)
        if rows.ndim != 2 or len(ids) != rows.shape[0]:
            raise ValueError("bulk_load needs ids aligned with (n, k) rows")
        with self._lock:
            self._drain_dirty()
            with self._dirty_lock:
                self._replay_backlog = 0
            self._swap_locked(
                self._assemble(list(ids), rows,
                               rows.shape[1] if rows.size else None))

    def _apply_updates_locked(self, dirty: set, allow_rebuild: bool = True) -> None:
        """In-place device update of already-indexed rows; new ids start
        one background rebuild and stay invisible (stale index) until it
        lands.  The payloads of the batch are joined and parsed by ONE
        numpy pass; per-row ``float()`` runs only for payloads with empty or
        non-numeric tokens."""
        suffix = self.suffix
        suffix_len = len(suffix)
        k_real = self._k_real
        candidates_pos, candidates_payload = [], []
        slow: list = []  # (pos, payload) needing the per-row parse
        structural = False
        for key in dirty:
            if not key.endswith(suffix) or key.startswith("MEAN"):
                continue  # foreign key from an unfiltered replay batch
            payload = self.table.get(key)
            if payload is None:
                continue
            pos = self._id_pos.get(key[:-suffix_len])
            if pos is None:
                structural = True  # new item: needs rebuild
                continue
            p = payload.rstrip(";")
            if p.count(";") + 1 == k_real and p:
                candidates_pos.append(pos)
                candidates_payload.append(p)
            else:
                slow.append((pos, payload))
        updates_pos, updates_vec = [], []
        if candidates_pos:
            try:
                flat = np.array(
                    ";".join(candidates_payload).split(";"), dtype=np.float32
                )
                updates_pos = candidates_pos
                updates_vec = flat.reshape(len(candidates_pos), k_real)
            except ValueError:
                # an empty/garbled token somewhere in the batch: re-route
                # every candidate through the exact per-row path
                slow.extend(zip(candidates_pos, candidates_payload))
                updates_pos, updates_vec = [], []
        if slow:
            updates_pos = list(updates_pos)
            updates_vec = (
                [v for v in updates_vec] if len(updates_vec) else []
            )
            for pos, payload in slow:
                vec = [float(t) for t in payload.split(";") if t]
                if len(vec) != k_real:
                    structural = True  # width change: needs rebuild
                    continue
                updates_pos.append(pos)
                updates_vec.append(vec)
        if len(updates_pos) and self._matrix is not None:
            self._scatter_rows_locked(updates_pos, updates_vec)
            self.inplace_updates += len(updates_pos)
        if structural and allow_rebuild:
            self._start_rebuild_locked()

    def _scatter_rows_locked(self, updates_pos, updates_vec) -> None:
        """Copy the changed rows into the device matrix in place.  The
        positions come from a set of keys, so they are unique; the copy is
        queued on the stream every query of this index uses, behind the
        reads of earlier queries and ahead of later ones."""
        pos = torch.from_numpy(np.asarray(updates_pos, dtype=np.int64))
        vec = torch.from_numpy(np.asarray(updates_vec, dtype=np.float32))
        self._matrix.index_copy_(0, pos.to(self.device),
                                 vec.to(self.device))

    def _start_rebuild_locked(self) -> None:
        if self._closed:
            # no thread of the index may outlive its close: a closed
            # index rebuilds in the caller's thread
            self._build_locked()
            return
        if self._rebuild_thread is not None and self._rebuild_thread.is_alive():
            return  # one rebuild in flight; later dirt re-triggers after swap

        def rebuild():
            drained = set()
            replay_snap = 0
            try:
                # drain BEFORE the snapshot: every drained key's latest
                # value is then in the snapshot, while keys put during the
                # snapshot re-enter the dirty set and survive the swap
                # (queries peek, never drain, while this thread is alive)
                drained = self._drain_dirty()
                with self._dirty_lock:
                    replay_snap = self._replay_backlog
                    self._replay_backlog = 0
                ids, rows, width = self._snapshot_rows()
                # upload and IVF training run OFF the index lock: queries
                # keep answering from the current index meanwhile
                assembled = self._assemble(ids, rows, width)
                with self._lock:
                    self._swap_locked(assembled)
            except Exception as e:
                # the drained updates must not be lost: put them back so
                # the next query re-applies them (and the structural keys
                # re-trigger a rebuild)
                with self._dirty_lock:
                    self._dirty |= drained
                    self._replay_backlog += replay_snap
                with self._lock:
                    self._peek_applied.clear()
                print(f"[topk] background rebuild failed: {e}",
                      file=sys.stderr)

        self._rebuild_thread = threading.Thread(
            target=rebuild, name="topk-rebuild", daemon=True
        )
        self._rebuild_thread.start()

    def close(self) -> None:
        """Quiesce the index's background work before its process ends:
        no rebuild starts from here on, and a running one and the card's
        warm-up are waited for, within one deadline.  Each is a daemon
        thread inside torch calls, and one still inside a call when the
        interpreter ends aborts the process (SIGABRT, "terminate called
        without an active exception") as the call returns.  The index
        still answers queries; a rebuild they need runs in their
        thread."""
        with self._lock:
            self._closed = True
            threads = [self._rebuild_thread]
        with _warm_lock:
            threads += list(_warmed.values())
        threads = [t for t in threads if t is not None
                   and t is not threading.current_thread()]
        deadline = time.monotonic() + _QUIESCE_S
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        late = [t.name for t in threads if t.is_alive()]
        if late:
            print(f"[topk] index close: {late} still running after "
                  f"{_QUIESCE_S}s", file=sys.stderr)

    # -- querying -----------------------------------------------------------

    def _observe_health(self) -> None:
        """Publish the dirty backlog depth and how long the oldest
        unabsorbed update has waited."""
        with self._dirty_lock:
            depth = len(self._dirty) + self._replay_backlog
            oldest = self._oldest_dirty_ts
        self._obs_dirty_depth.set(depth)
        self._obs_staleness.set(
            max(time.time() - oldest, 0.0) if oldest is not None else 0.0)

    def _maintain_locked(self) -> None:
        """Index maintenance shared by the single and batched query paths
        (under self._lock): (re)build on first use or counter tick, then
        drain or peek the dirty set.  A batched query pays this ONCE for the
        whole batch."""
        self._observe_health()
        if self._counter_mode:
            if self.table.puts != self._built_at:
                built_at = self.table.puts
                self._build_locked()
                self._built_at = built_at
        elif not self._built_once:
            self._build_locked()
        else:
            rebuilding = (
                self._rebuild_thread is not None
                and self._rebuild_thread.is_alive()
            )
            with self._dirty_lock:
                backlog = len(self._dirty)
            if rebuilding:
                # PEEK, don't drain: a key drained now but missing from
                # the in-flight rebuild's snapshot would lose its update
                # at swap time.  Applying from the live table is
                # idempotent, so re-applying after the swap is safe; keys
                # applied once during THIS rebuild are skipped (cleared at
                # swap), so an unchanged backlog is free.
                with self._dirty_lock:
                    dirty = set(itertools.islice(
                        (key for key in self._dirty
                         if key not in self._peek_applied),
                        self.apply_cap,
                    ))
                if dirty:
                    self._apply_updates_locked(dirty, allow_rebuild=False)
                    self._peek_applied |= dirty
            elif self._replay_backlog or backlog > self.rebuild_backlog:
                # the writer outruns the queries (or a replay-scale batch
                # was counted): one background rebuild absorbs the backlog
                self._start_rebuild_locked()
            else:
                dirty = self._drain_dirty(limit=self.apply_cap)
                if dirty:
                    self._apply_updates_locked(dirty, allow_rebuild=True)

    @property
    def prefers_frames(self) -> bool:
        """True when the index's query path is the batched frame path (the
        IVF tier or the sharded one): the batcher then routes even a lone
        query through ``topk_many``."""
        return self._ann is not None or isinstance(self._matrix,
                                                   ShardedMatrix)

    def _dispatch_frame_locked(self, q: np.ndarray, k_eff: int):
        """One device dispatch for a ``(B, n_factors)`` query frame ->
        ``(scores, idx)`` host arrays (B, k_eff): the IVF tier when built
        (a probe of its lists and an exact re-rank of the shortlist against
        the SAME resident matrix), else the exact scan.

        The exact scan pads the frame to ``_frame_rows(B)`` rows by
        repeating its first row and scores the real rows only, through
        ``_score_frame``: a matrix product's rounding can depend on its
        row count and on a row's place in it, so the products are cut so
        that a batched reply equals the reply the query gets alone, bit
        for bit."""
        n_queries = q.shape[0]
        if self._ann is not None:
            qd = torch.from_numpy(q).to(self.device)
            scores, idx = self._ann.search(self._matrix, qd, k_eff)
        else:
            pad = _frame_rows(n_queries) - n_queries
            if pad:
                q = np.concatenate(
                    [q, np.broadcast_to(q[:1], (pad, q.shape[1]))])
            qd = torch.from_numpy(q).to(self.device)
            if isinstance(self._matrix, ShardedMatrix):
                scores, idx = self._matrix.topk(qd, n_queries, k_eff)
            else:
                scores, idx = topk_lowest_first(
                    _score_frame(qd, self._matrix, n_queries), k_eff)
        return _to_host(scores), _to_host(idx)

    def _format_rows(self, scores, idx, n_rows: int):
        """(B, k) score/index arrays -> B result lists of (id, score).
        Negative indices are empty IVF shortlist slots (the probed lists
        held fewer than k rows); they are dropped."""
        ids = self._ids
        return [
            [
                (ids[int(i)], float(s))
                for i, s in zip(idx[b], scores[b])
                if i >= 0
            ]
            for b in range(n_rows)
        ]

    def topk(self, user_factors: np.ndarray, k: int) -> List[Tuple[str, float]]:
        with self._lock:
            self._maintain_locked()
            if self._matrix is None:
                return []
            k_eff = min(k, self._n_real)
            q = np.array(user_factors, dtype=np.float32)
            if q.shape[0] != self._k_real:
                raise ValueError(
                    f"query has {q.shape[0]} factors, index has {self._k_real}"
                )
            scores, idx = self._dispatch_frame_locked(q[None, :], k_eff)
            return self._format_rows(scores, idx, 1)[0]

    def topk_many(
        self, queries: np.ndarray, k: int
    ) -> List[List[Tuple[str, float]]]:
        """Batched top-k: ONE device dispatch scores every row of the
        ``(B, n_factors)`` query matrix against the catalog, which is read
        once for the whole batch, and the fixed cost of a dispatch is paid
        once (the cross-request batching lever, ``microbatch.py``).

        Row i equals ``topk(queries[i], k)`` over the same index state:
        maintenance runs once up front for the whole batch, so batched
        queries see streaming updates as single queries do."""
        with self._lock:
            self._maintain_locked()
            q = np.atleast_2d(np.array(queries, dtype=np.float32))
            n_queries = q.shape[0]
            if self._matrix is None:
                return [[] for _ in range(n_queries)]
            if q.shape[1] != self._k_real:
                raise ValueError(
                    f"queries have {q.shape[1]} factors, index has "
                    f"{self._k_real}"
                )
            k_eff = min(k, self._n_real)
            scores, idx = self._dispatch_frame_locked(q, k_eff)
            return self._format_rows(scores, idx, n_queries)

    def warm_batch_shapes(self, k: int, max_batch: int = 32) -> None:
        """Run the batched path once at every power-of-two batch size up
        to ``max_batch`` for the given ``k``, so that no live dispatch pays
        a first call's set-up (the allocator's blocks for its outputs, the
        matrix library's start-up at that shape)."""
        with self._lock:
            self._maintain_locked()
            if self._matrix is None:
                return
            width = self._k_real
        b = 1
        while b <= max_batch:
            self.topk_many(np.zeros((b, width), dtype=np.float32), k)
            b *= 2


class ALSTopkHandler:
    """Lookup-server top-k handlers over a table's item factors.

    ``__call__`` answers the TOPK verb (the user's factors come from the
    same table, key ``<id>-U``); ``by_vector`` answers TOPKV (the caller
    supplies the query factors).  Scoring goes through the cross-request
    batcher (``microbatch.TopKBatcher``) unless ``TPUMS_TOPK_BATCH=0``;
    ``batching`` can be flipped live."""

    def __init__(self, table: ModelTable, batcher=None, device="cuda",
                 shard_devices=None):
        self.table = table
        self.index = DeviceFactorIndex(table, "-I", device=device,
                                       shard_devices=shard_devices)
        if batcher is None:
            from .microbatch import TopKBatcher, batching_enabled

            if batching_enabled():
                batcher = TopKBatcher(self.index)
        self.batcher = batcher
        self.batching = batcher is not None

    def __call__(self, user_id: str, k: int) -> Optional[str]:  # TOPK verb
        payload = self.table.get(f"{user_id}-U")
        if payload is None:
            return None
        return self.by_vector(payload, k)

    def by_vector(self, factors_payload: str, k: int) -> str:  # TOPKV verb
        return self.submit_query("TOPKV", factors_payload, k)()

    def submit_query(self, verb: str, query_arg: str, k: int,
                     burst: int = 1):
        """Enqueue one TOPK/TOPKV query NOW; returns a zero-argument
        callable resolving to the wire payload (``item:score;...``), or
        None for an unknown user.  The split lets a server submit every
        query of a pipelined burst before waiting on any result; ``burst``
        > 1 keeps burst members off the batcher's idle inline path.  Parse
        errors raise here, at submit time."""
        if verb == "TOPK":
            payload = self.table.get(f"{query_arg}-U")
            if payload is None:
                return lambda: None
        else:
            payload = query_arg
        vec = np.array(
            [t for t in payload.split(";") if t], dtype=np.float32
        )
        if self.batching and self.batcher is not None:
            pending = self.batcher.submit(vec, k, allow_inline=(burst <= 1))
            resolver = lambda: _format_topk(pending.wait())  # noqa: E731
            # the server's trace epilogue reads the batcher's span fields
            # (queue wait, batch size, device time) off the resolver
            resolver.pending = pending
            return resolver
        return lambda: _format_topk(self.index.topk(vec, k))

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()
        self.index.close()


def _format_topk(results) -> str:
    return ";".join(f"{item}:{score}" for item, score in results)


def _card_bytes(device: torch.device) -> int:
    """The memory of one card."""
    return torch.cuda.get_device_properties(device).total_memory


def visible_gpus(device="cuda") -> Optional[list]:
    """The shard devices of an index on ``device``: every visible GPU when
    there is more than one, else None (one device has nothing to shard
    over, as the reference's ``_index_mesh``)."""
    dev = _target_device(device)
    if dev.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_als_topk_handler(table: ModelTable, device="cuda") -> ALSTopkHandler:
    """Handler for the lookup-server TOPK/TOPKV commands, its index on
    ``device`` and row-sharded over the visible GPUs when there is more
    than one and ``TPUMS_TOPK_SHARDED`` asks for it (``auto``: a catalog
    larger than half of one card)."""
    return ALSTopkHandler(table, device=device,
                          shard_devices=visible_gpus(device))
