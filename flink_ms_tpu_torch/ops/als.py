"""Blocked alternating least squares on CUDA cards, one block per rank.

Counterpart of ``flink_ms_tpu/ops/als.py``.  Each half-sweep solves the
per-ID regularized normal equations

    (Y_Ωuᵀ Y_Ωu + λ·reg_u·I) x_u = Y_Ωuᵀ r_u

as a batched Cholesky solve over the degree-bucketed layout that
``prepare_blocked`` builds.  The host layout is the reference's, copied as
numpy and equal to it array for array at any block count D.  The sweep
runs in torch on D ranks (``parallel/distributed.py``, one process per
GPU), rank d holding block d of both factor tables.  Per half-sweep each
rank obtains the opposite table by one collective: a full-table
``all_gather`` (the reference's ``all_gather``), or the routed exchange,
one ``all_to_all`` of the rows its ratings reference
(``build_routing``); the implicit mode's YᵀY is an ``all_reduce`` of the
local products (the reference's ``psum``).  Outside a process group D = 1
and the table is its own exchange.  Two CUDA kernels carry every
half-sweep of every rank on the card, in the unfused and the fused mode
alike:

- ``ops/gather_assembly.py`` — the fused gather + assembly of each bucket
  (the reference's Pallas ``fused_bucket_assembly``);
- ``ops/cholesky.py`` — the batched SPD solve (the reference's Pallas
  solver, its default on the TPU).

On CPU tensors each kernel's wrapper runs its plain torch version, which
is how the tests hold the port against the reference.  The port has no
selection between a kernel and a library path: the reference's
FLINK_MS_ALS_SOLVER and FLINK_MS_ALS_ASSEMBLY are not read.

Supports the two training modes of the reference: explicit feedback with
weighted-λ (ALS-WR) or plain λ, and implicit feedback
(Hu-Koren-Volinsky) with A_u = YᵀY + Σ α·r_ui·y_i y_iᵀ + λ·I.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel import distributed as pdist
from ..parallel.mesh import local_device, num_blocks, resolve_device
from .cholesky import cholesky_solve_batched
from .gather_assembly import fused_bucket_assembly

# ---------------------------------------------------------------------------
# config + host-side problem layout (copied from the reference, numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """Mirrors the reference's surfaced parameters (ALSImpl.scala:35-49) plus
    the implicit-feedback mode.  Products run in full f32 (TF32 is off, see
    ``ops/__init__.py``), the reference's ``assembly_precision="highest"``.

    ``exchange_dtype``: the dtype the opposite factor table is cast to
    before the gather.  None = full precision; "auto" resolves to full
    precision off the TPU (``resolve_exchange``), so on CUDA too;
    "bfloat16" halves the bytes the gather reads, and the normal equations
    still accumulate in ``dtype``."""

    num_factors: int = 10
    iterations: int = 10
    lambda_: float = 0.9
    seed: int = 42
    implicit: bool = False
    alpha: float = 40.0          # implicit confidence scale, c = 1 + alpha*r
    weighted_reg: bool = True    # ALS-WR: lambda * n_u (FlinkML semantics)
    dtype: torch.dtype = torch.float32
    exchange_dtype: Optional[str] = "auto"


_MIN_BUCKET_W = 8  # smallest rating-list pad width


@dataclasses.dataclass
class SideLayout:
    """Degree-bucketed layout of one orientation (user- or item-major).

    Entities of a block are grouped by degree class; class j pads every
    member's rating list to ``widths[j]`` columns.  The factor table lives
    in *slot order* — ``perm`` maps dense entity index to its global slot
    ``block * per_block + local`` — so bucket outputs are contiguous rows
    and the solve writes factors with no scatter.
    """

    per_block: int            # slots per block (Σ_j rows[j] + 1 — the last
    #                           slot of every block is a guaranteed dummy)
    n_rows: int               # real entity count
    perm: np.ndarray          # (n_rows,) dense index -> global slot
    widths: Tuple[int, ...]   # pad width per bucket, descending
    rows: Tuple[int, ...]     # rows per bucket per block
    idx: list                 # per bucket: (D, rows[j], widths[j]) int32,
    #                           opposite-side global slot of each rating;
    #                           pads point at the opposite side's zero dummy
    val: list                 # per bucket: ratings, pad entries 0
    count: np.ndarray         # (D, per_block) degree per slot (0 for dummies)


@dataclasses.dataclass
class BlockedProblem:
    """Ratings re-laid-out for D blocks (host-side, numpy)."""

    n_blocks: int
    user_ids: np.ndarray      # (n_users,) raw ids, sorted
    item_ids: np.ndarray      # (n_items,) raw ids, sorted
    nnz: int
    u: SideLayout             # user-major (solves user factors)
    i: SideLayout             # item-major (solves item factors)
    # exchange plans per (D, mode), cached by _exchange_plan
    routing: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_users(self) -> int:
        return int(self.user_ids.shape[0])

    @property
    def n_items(self) -> int:
        return int(self.item_ids.shape[0])


def _dense_ids(arr: np.ndarray):
    """``np.unique(arr, return_inverse=True)`` with an O(n) fast path for
    small non-negative integer ids (a presence bitmap + cumsum)."""
    if np.issubdtype(arr.dtype, np.integer) and arr.size:
        mx = int(arr.max())
        if int(arr.min()) >= 0 and mx <= max(4 * arr.size, 1 << 20):
            present = np.zeros(mx + 1, dtype=bool)
            present[arr] = True
            ids = np.nonzero(present)[0]
            lookup = np.cumsum(present) - 1
            return ids, lookup[arr]
    return np.unique(arr, return_inverse=True)


def _bucket_ratio() -> float:
    """FLINK_MS_ALS_BUCKET_RATIO, validated (default 1.5)."""
    raw = os.environ.get("FLINK_MS_ALS_BUCKET_RATIO", "1.5")
    try:
        ratio = float(raw)
    except ValueError:
        raise ValueError(
            f"FLINK_MS_ALS_BUCKET_RATIO={raw!r} is not a number"
        ) from None
    if not math.isfinite(ratio) or not (1.05 <= ratio <= 16.0):
        raise ValueError(
            f"FLINK_MS_ALS_BUCKET_RATIO={raw!r} must be a finite value in "
            "[1.05, 16]"
        )
    return ratio


def _side_order(row_idx: np.ndarray, n_rows: int, n_blocks: int,
                ratio: Optional[float] = None):
    """Degree-sorted block layout of one side -> (deg, block_of, bucket_of,
    perm, widths, rows, per_block).

    Entities are split into D contiguous dense-index blocks, then within
    each block ordered by degree descending so each degree bucket is a
    contiguous slot range.  Bucket widths form a geometric ladder from
    ``_MIN_BUCKET_W`` up to the maximum degree, each rung rounded up to a
    multiple of 8.
    """
    dense_pb = -(-n_rows // n_blocks)  # dense entities per block (ceil)
    deg = np.bincount(row_idx, minlength=n_rows).astype(np.int64)
    block_of = np.arange(n_rows) // dense_pb
    # within-block order: degree desc, dense index as tiebreak
    order = np.lexsort((np.arange(n_rows), -deg, block_of))
    if ratio is None:
        ratio = _bucket_ratio()
    max_deg = max(int(np.max(deg)), 1)
    ladder = [_MIN_BUCKET_W]
    while ladder[-1] < max_deg:
        nxt = int(-(-int(ladder[-1] * ratio) // 8) * 8)  # round up to 8
        if nxt <= ladder[-1]:
            nxt = ladder[-1] + 8
        ladder.append(nxt)
    widths_all = np.array(ladder[::-1])  # descending
    # bucket of an entity = smallest rung >= its degree
    asc = widths_all[::-1]
    pos = np.searchsorted(asc, np.maximum(deg, 1), side="left")
    bucket_of = len(widths_all) - 1 - pos
    # per (block, bucket) entity counts -> static rows per bucket = max over blocks
    counts_bb = np.zeros((n_blocks, len(widths_all)), dtype=np.int64)
    np.add.at(counts_bb, (block_of, bucket_of), 1)
    rows_per_bucket = counts_bb.max(axis=0)
    keep = rows_per_bucket > 0
    widths = tuple(int(x) for x in widths_all[keep])
    rows = tuple(int(x) for x in rows_per_bucket[keep])
    # remap bucket ids to the kept, descending-width list
    remap = np.cumsum(keep) - 1
    bucket_of = remap[bucket_of]
    offsets = np.concatenate([[0], np.cumsum(rows)])  # slot offset per bucket
    # +1: the last slot of every block is a guaranteed dummy — its factor
    # row is zero for the life of the fit (zero at init, kept zero by the
    # count==0 mask in _solve_factors), and the OPPOSITE side's pad gathers
    # point at it
    per_block = int(offsets[-1]) + 1
    # rank of each entity within its (block, bucket), following `order`
    sorted_b = block_of[order]
    sorted_j = bucket_of[order]
    key = sorted_b * len(widths) + sorted_j
    starts = np.searchsorted(key, np.arange(n_blocks * len(widths) + 1))
    rank = np.arange(n_rows) - starts[key]
    perm_sorted = sorted_b * per_block + offsets[sorted_j] + rank
    perm = np.empty(n_rows, dtype=np.int64)
    perm[order] = perm_sorted
    return deg, block_of, bucket_of, perm, widths, rows, per_block


def _fill_side(
    row_idx, col_idx, vals, n_rows, n_blocks, side_order, opp_perm,
    opp_pad_slot, dtype
) -> SideLayout:
    """Build one side's bucketed arrays from its ``_side_order`` result.
    ``opp_perm`` maps the opposite side's dense indices to its global
    slots; ``opp_pad_slot`` is an opposite-side slot whose factor row is
    guaranteed zero — pad entries gather it, so no mask array exists."""
    deg, block_of, bucket_of, perm, widths, rows, per_block = side_order
    nb = len(widths)
    idx = [
        np.full((n_blocks, rows[j], widths[j]), opp_pad_slot, np.int32)
        for j in range(nb)
    ]
    val = [np.zeros((n_blocks, rows[j], widths[j]), dtype) for j in range(nb)]
    count = np.zeros((n_blocks, per_block), dtype)

    # ratings sorted by owning entity, then by opposite slot (ascending
    # gather addresses); one argsort of a fused (row << 32 | col) key
    col_global = opp_perm[col_idx].astype(np.int64)
    if n_rows < (1 << 31) and col_global.size and int(col_global.max()) < (1 << 32):
        key = (row_idx.astype(np.uint64) << np.uint64(32)) | col_global.astype(
            np.uint64
        )
        order_r = np.argsort(key)
    else:  # pragma: no cover - beyond any realistic id space
        order_r = np.lexsort((col_global, row_idx))
    ent_start = np.searchsorted(row_idx[order_r], np.arange(n_rows + 1))
    col_sorted = col_global[order_r]
    val_sorted = vals[order_r]

    local = perm - block_of * per_block  # slot within block
    offsets = np.concatenate([[0], np.cumsum(rows)])
    count[(block_of, local)] = deg.astype(dtype)

    for j in range(nb):
        sel = np.nonzero(bucket_of == j)[0]  # dense entity ids in bucket j
        if len(sel) == 0:
            continue
        lens = deg[sel]
        total = int(lens.sum())
        if total == 0:
            continue
        # ragged fill: src positions into the entity-sorted rating arrays,
        # dst positions into the flattened (D*rows_j, w_j) bucket arrays
        rep_starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        intra = np.arange(total) - np.repeat(rep_starts, lens)
        src = np.repeat(ent_start[sel], lens) + intra
        flat_row = block_of[sel] * rows[j] + (local[sel] - offsets[j])
        dst = np.repeat(flat_row * widths[j], lens) + intra
        idx[j].reshape(-1)[dst] = col_sorted[src]
        val[j].reshape(-1)[dst] = val_sorted[src]
    return SideLayout(
        per_block=per_block,
        n_rows=n_rows,
        perm=perm,
        widths=widths,
        rows=rows,
        idx=idx,
        val=val,
        count=count,
    )


def prepare_blocked(
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    n_blocks: int,
    dtype=np.float32,
    bucket_ratio: Optional[float] = None,
) -> BlockedProblem:
    """Build the blocked layout: dense-reindex raw ids, split entities into
    D contiguous blocks, degree-sort within blocks, and emit the bucketed
    pad layout per block in both orientations.  ``bucket_ratio`` pins the
    width-ladder growth factor (default: FLINK_MS_ALS_BUCKET_RATIO, 1.5)."""
    users = np.asarray(users)
    items = np.asarray(items)
    ratings = np.asarray(ratings, dtype=np.float64)
    if users.shape[0] == 0:
        raise ValueError("empty ratings input")

    user_ids, u_idx = _dense_ids(users)
    item_ids, i_idx = _dense_ids(items)

    # each side's idx arrays point at the OPPOSITE side's slots, so both
    # perms must exist before either fill
    ratio = bucket_ratio if bucket_ratio is not None else _bucket_ratio()
    u_order = _side_order(u_idx, len(user_ids), n_blocks, ratio)
    i_order = _side_order(i_idx, len(item_ids), n_blocks, ratio)
    u_perm, i_perm = u_order[3], i_order[3]
    # pad gathers target the opposite side's dummy (last slot of block 0)
    u_pad_slot = u_order[6] - 1
    i_pad_slot = i_order[6] - 1
    u_side = _fill_side(
        u_idx, i_idx, ratings, len(user_ids), n_blocks, u_order, i_perm,
        i_pad_slot, dtype
    )
    i_side = _fill_side(
        i_idx, u_idx, ratings, len(item_ids), n_blocks, i_order, u_perm,
        u_pad_slot, dtype
    )
    return BlockedProblem(
        n_blocks=n_blocks,
        user_ids=user_ids,
        item_ids=item_ids,
        nnz=int(len(ratings)),
        u=u_side,
        i=i_side,
    )


# ---------------------------------------------------------------------------
# routed factor exchange (the reference's block routing tables,
# ALSImpl.scala:39-41 [dep]: blocks exchange only the factor rows their
# ratings reference, not the whole opposite table); copied, numpy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoutedSide:
    """Routed-exchange plan for one half-sweep.

    Replaces the full-table ``all_gather`` (every rank receives the whole
    opposite table, (D-1)·opp_pb rows, whatever it needs) with need-list
    routing: block d receives only the opposite rows its ratings
    reference, through one ``all_to_all`` of (D, r_max, k) send buffers.
    The receive volume, D·r_max rows a rank, shrinks as D grows (per-block
    nnz drops, so need-lists thin out); the all_gather's stays about
    constant.
    """

    send_idx: np.ndarray   # (D, D, r_max) int32: LOCAL factor rows source
    #                        block s sends to destination d; the diagonal
    #                        (s == d) and pad entries point at s's
    #                        guaranteed-zero dummy slot — self-owned rows
    #                        never ride the collective
    idx: list              # per bucket: (D, rows_j, w_j) int32 into the
    #                        received table: off-block slots at
    #                        s*r_max + pos, self-owned slots at
    #                        D*r_max + local (the appended own shard)
    r_max: int             # max OFF-DIAGONAL route length (self excluded)
    recv_rows: int         # D*r_max + opp_pb (routed table incl. own shard)
    net_rows: int          # (D-1)*r_max — rows that cross between ranks


def build_routing(side: SideLayout, opp: SideLayout,
                  n_blocks: int) -> RoutedSide:
    """Host-side routing tables: per destination block, the sorted unique
    opposite slots its ratings reference, split by owning source block.
    Self-owned rows are read straight from the local shard (appended after
    the exchanged stack), so the collective carries off-block needs only.
    A pure layout transform: the gathered VALUES equal the gather path's
    (same rows, same per-rating order), so routed and gathered sweeps
    agree bit for bit."""
    D = n_blocks
    opp_pb = opp.per_block
    pad_local = opp_pb - 1  # every block's last slot is a guaranteed dummy
    routes = [[None] * D for _ in range(D)]  # [src][dst] -> local rows
    r_max = 1
    for d in range(D):
        parts = [b[d].ravel() for b in side.idx]
        need = np.unique(np.concatenate(parts)) if parts else np.empty(
            0, np.int64)
        src = need // opp_pb
        loc = need % opp_pb
        for s in range(D):
            if s == d:
                continue  # self-owned rows come from the local shard
            routes[s][d] = loc[src == s]  # sorted (need is sorted)
            r_max = max(r_max, len(routes[s][d]))
    send_idx = np.full((D, D, r_max), pad_local, np.int32)
    for s in range(D):
        for d in range(D):
            if s == d:
                continue
            r = routes[s][d]
            send_idx[s, d, : len(r)] = r
    self_base = D * r_max  # own shard appended after the exchanged stack
    remapped = []
    for b in side.idx:
        out = np.empty_like(b)
        for d in range(D):
            g = b[d].astype(np.int64)
            s = g // opp_pb
            loc = g % opp_pb
            pos = np.empty_like(loc)
            for sb in range(D):
                m = s == sb
                if not m.any():
                    continue
                if sb == d:
                    # net of the s*r_max term added below
                    pos[m] = self_base + loc[m] - sb * r_max
                else:
                    pos[m] = np.searchsorted(routes[sb][d], loc[m])
            out[d] = (s * r_max + pos).astype(np.int32)
        remapped.append(out)
    return RoutedSide(send_idx=send_idx, idx=remapped, r_max=r_max,
                      recv_rows=D * r_max + opp_pb,
                      net_rows=(D - 1) * r_max)


_EXCHANGE_MODE_ENV = "FLINK_MS_ALS_EXCHANGE_MODE"


def _exchange_mode_choice() -> str:
    mode = os.environ.get(_EXCHANGE_MODE_ENV, "auto")
    if mode not in ("auto", "gather", "routed"):
        raise ValueError(
            f"{_EXCHANGE_MODE_ENV}={mode!r} must be auto|gather|routed"
        )
    return mode


def _exchange_plan(problem: BlockedProblem, D: int) -> dict:
    """-> {"u": RoutedSide|None, "i": RoutedSide|None} for D blocks (None
    = full-table all_gather for that half-sweep).

    "auto" routes a half-sweep only when its need-lists receive fewer rows
    than the all_gather would; the dense regime (ML-20M: every block
    references nearly the whole item catalog) skips the routing build on
    an nnz-density estimate.  Each half-sweep decides on its own.  Plans
    are cached on the problem; the primary rank prints the decision with
    the rows a rank receives either way.  D = 1 never routes."""
    choice = _exchange_mode_choice()
    key = (D, choice)
    if key in problem.routing:
        return problem.routing[key]
    say = print if pdist.is_primary() else (lambda *a: None)
    plan = {}
    for name, side, opp in (
        ("u", problem.u, problem.i),
        ("i", problem.i, problem.u),
    ):
        gather_rows = (D - 1) * opp.per_block
        if D == 1 or choice == "gather":
            plan[name] = None
            continue
        if choice == "auto" and problem.nnz / D >= 2.0 * opp.per_block * D:
            # each block's ratings reference ~the whole opposite catalog
            # (need saturates at 1-e^-x): routing can't beat the gather,
            # so the host-side build is skipped
            say(
                f"[als] {name}-sweep exchange: gather ({gather_rows} "
                f"rows/rank; need-lists saturated at nnz/D="
                f"{problem.nnz // D} vs {opp.per_block * D} opposite slots)"
            )
            plan[name] = None
            continue
        routed = build_routing(side, opp, D)
        # the all_to_all moves (D-1)*r_max rows a rank against the
        # gather's (D-1)*opp_pb: route when the need-lists are thinner
        # by a margin (for the extra take and concatenation)
        if choice == "routed" or routed.r_max < 0.8 * opp.per_block:
            say(
                f"[als] {name}-sweep exchange: routed all_to_all — "
                f"{routed.net_rows} rows/rank vs {gather_rows} "
                f"all_gather (r_max={routed.r_max}, table "
                f"{routed.recv_rows} rows)"
            )
            plan[name] = routed
        else:
            say(
                f"[als] {name}-sweep exchange: gather ({gather_rows} "
                f"rows/rank; routed would move {routed.net_rows})"
            )
            plan[name] = None
    problem.routing[key] = plan
    return plan


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

# upper bound on one bucket's transient (the plain version's r·w·k gather
# at the table's dtype, and the fused solve's systems); a bucket above it
# assembles in row chunks so the device holds one chunk's worth at a time
_ASSEMBLY_CHUNK_ENV = "FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES"


def _assembly_chunk_bytes() -> int:
    return int(os.environ.get(_ASSEMBLY_CHUNK_ENV, 2 << 30))


def _bucket_normal_eqs(y_all, idx, val, implicit, alpha, dtype, post=None,
                       extra=None, out=None):
    """One bucket's (A, b): gather the opposite factors for each row's
    rating list and contract over the rating axis.

    No mask arrays exist: pad entries gather the opposite side's dummy
    slot, whose factor row is zero, so every pad term vanishes.

    ``post`` (fused mode): a per-chunk (A, b, extra_chunk, in_scan=bool) ->
    x stage applied to each row chunk, so the bucket's (rows, k, k) normal
    equations never exist beyond one chunk; ``in_scan`` is true for the
    chunked case (the reference's ``lax.map`` body).  ``extra`` is a
    (rows, ...) operand sliced alongside idx/val (the per-slot counts).
    Chunks split the row axis only, so per-row arithmetic is unchanged.
    Every chunk goes through ``fused_bucket_assembly``: the kernel on the
    card, its plain version on the CPU.  ``out=(A, b)`` (unfused only):
    (rows, k, k) and (rows, k) views the chunks are assembled into, and
    which are returned."""

    def compute(idx_c, val_c, extra_c, in_scan=False, out_c=None):
        A, b = fused_bucket_assembly(y_all, idx_c, val_c, dtype,
                                     implicit=implicit, alpha=alpha,
                                     out=out_c)
        if post is None:
            return A, b
        return post(A, b, extra_c, in_scan=in_scan)

    r, w = idx.shape
    k = y_all.shape[1]
    itemsize = torch.finfo(dtype).bits // 8
    # peak transient per row: the plain version (CPU tensors) gathers at
    # the table's width, plus the same-size weighted copy in implicit mode;
    # the kernel keeps its gather on chip, so an unfused bucket on the card
    # is never cut
    row_bytes = 0 if y_all.is_cuda else \
        w * k * (y_all.element_size() + (itemsize if implicit else 0))
    if post is not None:
        # the fused solve holds the chunk's (C, k, k) system plus
        # factorization intermediates in the same budget
        row_bytes += 3 * k * k * itemsize
    limit = _assembly_chunk_bytes()
    if r * row_bytes <= limit:
        return compute(idx, val, extra, out_c=out)
    C = max(min(int(limit // max(row_bytes, 1)), r), 1)
    if post is None:
        if out is None:
            out = (torch.empty((r, k, k), dtype=dtype, device=y_all.device),
                   torch.empty((r, k), dtype=dtype, device=y_all.device))
        for s in range(0, r, C):
            compute(idx[s:s + C], val[s:s + C], None, in_scan=True,
                    out_c=(out[0][s:s + C], out[1][s:s + C]))
        return out
    return torch.cat([
        compute(idx[s:s + C], val[s:s + C],
                None if extra is None else extra[s:s + C], in_scan=True)
        for s in range(0, r, C)
    ])


def _assemble_normal_eqs(y_all, buckets, implicit, alpha, dtype):
    """A = Σ w·y yᵀ and b = Σ t·y per slot, bucket by bucket.

    y_all:   (n_slots, k) opposite-side factor table
    buckets: list of (idx, val) with shapes (rows_j, w_j), rows covering
             contiguous slot ranges
    returns A (per_block, k, k), b (per_block, k) in slot order, the last
    slot (the block's dummy) a zero system.  Each bucket is assembled
    straight into its rows of the two tensors, so no copy joins them."""
    k = y_all.shape[1]
    n = sum(int(idx.shape[0]) for idx, _ in buckets) + 1
    A = torch.empty((n, k, k), dtype=dtype, device=y_all.device)
    b = torch.empty((n, k), dtype=dtype, device=y_all.device)
    off = 0
    for idx, val in buckets:
        rows = int(idx.shape[0])
        _bucket_normal_eqs(y_all, idx, val, implicit, alpha, dtype,
                           out=(A[off:off + rows], b[off:off + rows]))
        off += rows
    # one zero system for the guaranteed dummy last slot; count==0
    # regularization keeps it PD and the solve masks its result to zero
    A[-1].zero_()
    b[-1].zero_()
    return A, b


def _fused_solve() -> bool:
    """FLINK_MS_ALS_FUSED=1: solve each bucket chunk right after its
    assembly, so the (per_block, k, k) normal equations never exist whole."""
    return os.environ.get("FLINK_MS_ALS_FUSED", "0") == "1"


def resolve_exchange(exchange_dtype: Optional[str]) -> Optional[torch.dtype]:
    """The dtype the factor table is cast to before the gather: "auto"
    resolves to full precision (None), as the reference does everywhere but
    on the TPU; an explicit name ("bfloat16") is that torch dtype."""
    if exchange_dtype in (None, "auto"):
        return None
    dt = getattr(torch, str(exchange_dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"exchange_dtype={exchange_dtype!r} is not a float "
                         "dtype name")
    return dt


def _solve_factors(A, b, counts, lam, weighted_reg, in_scan=False):
    """Batched Cholesky solve of (A + λ·reg·I) x = b with empty rows masked.
    Adds the regularizer to A's diagonal in place (A is the sweep's own
    freshly assembled tensor), which saves an (n, k, k) copy."""
    reg = counts if weighted_reg else torch.ones_like(counts)
    # empty rows (dummy slots / ids with no ratings): identity system so
    # Cholesky stays PD, then a zero result
    diag = lam * reg + torch.where(counts > 0, 0.0, 1.0).to(counts.dtype)
    A.diagonal(dim1=-2, dim2=-1).add_(diag[:, None])
    # in_scan: the reference's fused per-chunk call site, which forces the
    # batch-major Pallas entry; both layouts reach one kernel here
    x = cholesky_solve_batched(A, b, layout="batch_major" if in_scan else None)
    return torch.where((counts > 0)[:, None], x, 0.0)


def _flat_side_args(side: SideLayout, dtype, d: int = 0, routed=None):
    """Device-arg flattening of block d of one side: bucket (idx, val)
    pairs then the count; a routed half-sweep swaps the idx arrays for
    their received-table remapping and appends its send plan."""
    out = []
    for j in range(len(side.widths)):
        idx = routed.idx[j] if routed is not None else side.idx[j]
        out += [idx[d], side.val[j][d].astype(dtype)]
    out.append(side.count[d].astype(dtype))
    if routed is not None:
        out.append(routed.send_idx[d])
    return out


def _make_sweep(problem: BlockedProblem, config: ALSConfig):
    """The full fit as a function ``fit_fn(iterations, uf, itf, *flat) ->
    (uf, itf)`` over this rank's blocks: per iteration the user
    half-sweep, then the item one.  In a process group every half-sweep
    exchanges through a collective, a group of one included."""
    k = config.num_factors
    lam = config.lambda_
    implicit = config.implicit
    alpha = config.alpha
    weighted = config.weighted_reg and not implicit
    dtype = config.dtype
    exchange_dtype = resolve_exchange(config.exchange_dtype)
    plan = _exchange_plan(problem, problem.n_blocks)
    grouped = pdist.in_group()

    def exchange(y_send, send_idx):
        """The opposite table this rank's buckets index: every block
        (all_gather, rank order = block order), or the routed rows each
        source block sends here followed by the rank's own block."""
        if send_idx is not None:
            picked = y_send[send_idx.long()]  # (D, r_max, k)
            recv = torch.empty_like(picked)
            torch.distributed.all_to_all_single(recv, picked)
            return torch.cat([recv.reshape(-1, k), y_send])
        return pdist.gather_blocks(y_send) if grouped else y_send

    def half_sweep(y_tab, flat, routed):
        # y_tab: (opp_pb, k) this rank's block of the opposite factors
        if routed:
            *bucket_args, counts, send_idx = flat
        else:
            (*bucket_args, counts), send_idx = flat, None
        # cast BEFORE the collective: the exchange moves the narrow type
        y_send = y_tab if exchange_dtype is None else y_tab.to(exchange_dtype)
        y_all = exchange(y_send, send_idx)
        buckets = [
            (bucket_args[2 * j], bucket_args[2 * j + 1])
            for j in range(len(bucket_args) // 2)
        ]
        yty = None
        if implicit:
            yty = y_tab.T @ y_tab
            if grouped:
                pdist.all_reduce_sum(yty)
        if _fused_solve():
            # per-bucket fused assembly+solve: bucket outputs are contiguous
            # slot ranges, so each bucket's factor rows are solved straight
            # out of its assembly chunks; the dummy last slot gets its zero
            # row appended explicitly
            def solve_chunk(A, bb, cnt, in_scan=False):
                if yty is not None:
                    A = A + yty[None, :, :]
                return _solve_factors(A, bb, cnt, lam, weighted,
                                      in_scan=in_scan)

            xs = []
            off = 0
            for idx_b, val_b in buckets:
                rows_j = idx_b.shape[0]
                xs.append(_bucket_normal_eqs(
                    y_all, idx_b, val_b, implicit, alpha, dtype,
                    post=solve_chunk, extra=counts[off:off + rows_j],
                ))
                off += rows_j
            xs.append(torch.zeros((1, k), dtype=dtype, device=y_tab.device))
            return torch.cat(xs)
        A, b = _assemble_normal_eqs(y_all, buckets, implicit, alpha, dtype)
        if implicit:
            A += yty[None, :, :]
        return _solve_factors(A, b, counts, lam, weighted)

    n_u_args = 2 * len(problem.u.widths) + 1 + (plan["u"] is not None)

    def fit_fn(iterations, uf, itf, *flat):
        u_flat, i_flat = flat[:n_u_args], flat[n_u_args:]
        for _ in range(int(iterations)):
            uf = half_sweep(itf, u_flat, plan["u"] is not None)
            itf = half_sweep(uf, i_flat, plan["i"] is not None)
        return uf, itf

    return fit_fn


# ---------------------------------------------------------------------------
# iteration-boundary staging (the reference's setTemporaryPath,
# ALSImpl.scala:42-44): the factors go to disk at every iteration boundary,
# and a rerun resumes from the latest matching snapshot
# ---------------------------------------------------------------------------

_STAGE_RE = re.compile(r"^iter_(\d+)\.npz$")


def _staging_meta(problem: BlockedProblem, config: ALSConfig, init) -> dict:
    """Identity of a training run, key for key and value for value the
    JAX package's (``flink_ms_tpu/ops/als.py`` ``_staging_meta``), so a
    snapshot written by either package resumes in the other.  A snapshot
    from other data, another config, dtype or starting point is not
    resumed.

    ``init`` is None for a start drawn from ``config.seed`` (``"seed"``),
    else the SHA-1 of the init pair's bytes.  The two packages draw a
    seeded start differently (threefry against ``torch.Generator``), yet
    their metas agree: the snapshot, not the seed, is the state, so a
    seed-started run of one package resumes in the other from the saved
    factors.  The port's products are full f32, the reference's
    ``assembly_precision="highest"``; ``"auto"`` exchange resolves to full
    precision (None) off the TPU."""
    if init is None:
        init_id = "seed"
    else:
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(init[0]).tobytes())
        h.update(np.ascontiguousarray(init[1]).tobytes())
        init_id = h.hexdigest()
    # the rating data itself: same-shaped fresh data retrains
    hd = hashlib.sha1()
    for a in ([problem.u.perm, problem.user_ids, problem.item_ids]
              + problem.u.idx + problem.u.val):
        hd.update(np.ascontiguousarray(a).tobytes())
    exchange = config.exchange_dtype
    return {
        "data": hd.hexdigest(),
        "num_factors": config.num_factors,
        "lambda": config.lambda_,
        "implicit": config.implicit,
        "alpha": config.alpha,
        "weighted_reg": config.weighted_reg,
        "assembly_precision": "highest",
        "exchange_dtype": None if exchange in (None, "auto") else exchange,
        "seed": config.seed,
        "dtype": str(_np_dtype(config.dtype)),
        "init": init_id,
        "n_users": problem.n_users,
        "n_items": problem.n_items,
        "nnz": problem.nnz,
        "n_blocks": problem.n_blocks,
    }


def save_staged(path: str, iteration: int, uf: np.ndarray, itf: np.ndarray,
                meta: dict, keep: int = 2) -> str:
    """Atomically write one iteration snapshot under `path`
    (``iter_%05d.npz``: a ``.tmp`` file, then ``os.replace``).

    The staging dir is scratch space for the current run, so everything
    outside the trailing `keep` window ending at `iteration` is pruned,
    stale higher-numbered snapshots of a longer run and orphaned ``.tmp``
    files of a killed write included."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"iter_{iteration:05d}.npz")
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, user_factors=uf, item_factors=itf,
                 meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    os.replace(tmp, out)
    for name in os.listdir(path):
        m = _STAGE_RE.match(name)
        if m and iteration - keep < int(m.group(1)) <= iteration:
            continue
        if not (m or name.endswith(".npz.tmp")):
            continue
        try:
            os.remove(os.path.join(path, name))
        except OSError:
            pass
    return out


def load_staged(path: str, meta: dict, max_iteration: Optional[int] = None):
    """Latest matching snapshot -> (iteration, uf, itf) as numpy, else None.
    Corrupt or mismatching snapshots are skipped, newest first; snapshots
    beyond `max_iteration` are ignored, so a rerun with fewer iterations
    does not return an over-trained model."""
    if not os.path.isdir(path):
        return None
    snaps = sorted(
        (int(m.group(1)), m.string) for m in
        (_STAGE_RE.match(n) for n in os.listdir(path)) if m
    )
    for iteration, name in reversed(snaps):
        if max_iteration is not None and iteration > max_iteration:
            continue
        try:
            with np.load(os.path.join(path, name)) as z:
                saved = json.loads(bytes(z["meta"]).decode())
                # the reference's snapshots from before these two fields
                saved.setdefault("assembly_precision", "highest")
                saved.setdefault("exchange_dtype", None)
                if saved != meta:
                    continue
                return iteration, z["user_factors"], z["item_factors"]
        except Exception:
            continue
    return None


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ALSModel:
    """Trained factors with the raw-id mapping (dense row i of
    `user_factors` belongs to `user_ids[i]`).  The factors are tensors on
    the device the model was trained on or placed on."""

    user_ids: np.ndarray
    item_ids: np.ndarray
    user_factors: torch.Tensor  # (n_users, k)
    item_factors: torch.Tensor  # (n_items, k)

    @property
    def num_factors(self) -> int:
        return int(self.user_factors.shape[1])


def model_from_arrays(user_ids, item_ids, user_factors, item_factors,
                      device="cuda") -> ALSModel:
    """The port's ``ALSModel`` from the JAX package's ``ALSModel`` fields as
    numpy arrays, with the factors on `device`."""
    dev = resolve_device(device)
    return ALSModel(
        user_ids=np.asarray(user_ids),
        item_ids=np.asarray(item_ids),
        user_factors=torch.from_numpy(np.ascontiguousarray(user_factors)).to(dev),
        item_factors=torch.from_numpy(np.ascontiguousarray(item_factors)).to(dev),
    )


def init_factors(n: int, k: int, generator: torch.Generator,
                 dtype=torch.float32) -> torch.Tensor:
    """Uniform(0,1)/sqrt(k) init, drawn on the host from `generator`.  The
    reference draws threefry bits, which torch cannot reproduce; parity is
    equal-or-better RMSE at equal iterations, and the tests inject
    ``init=`` to compare factors."""
    return torch.rand((n, k), generator=generator, dtype=dtype) / math.sqrt(k)


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _pad_factors(problem: BlockedProblem, k: int, dtype, uf_raw, itf_raw):
    """Dense-id (n_users, k)/(n_items, k) factors -> the slot layout of all
    D blocks, (D·per_block, k); dummy slots stay zero."""
    D = problem.n_blocks
    uf0 = np.zeros((problem.u.per_block * D, k), dtype=dtype)
    uf0[problem.u.perm] = uf_raw
    itf0 = np.zeros((problem.i.per_block * D, k), dtype=dtype)
    itf0[problem.i.perm] = itf_raw
    return uf0, itf0


def _block_of(problem: BlockedProblem, padded, d: int):
    """Block d's rows of the padded (user, item) tables."""
    (uf0, itf0), u_pb, i_pb = padded, problem.u.per_block, problem.i.per_block
    return uf0[d * u_pb:(d + 1) * u_pb], itf0[d * i_pb:(d + 1) * i_pb]


def compile_fit(
    problem: BlockedProblem,
    config: ALSConfig,
    device="cuda",
    init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """-> (fit_fn, dev_args): the sweep plus this rank's device-resident
    inputs, block d = its rank.  ``fit_fn(iterations, *dev_args)`` returns
    the rank's (user, item) factor blocks in slot order as device tensors
    and leaves ``dev_args`` as they were.  ``als_fit`` drives this;
    benchmarks call ``fit_fn`` directly so host-to-device copies stay out
    of the timed region.  Every rank must call it (the exchange plan is
    built on every rank alike)."""
    dev = local_device(device)
    D = num_blocks()
    if problem.n_blocks != D:
        raise ValueError(
            f"problem laid out for {problem.n_blocks} blocks, mesh has {D} "
            f"rank(s): prepare_blocked(..., n_blocks={D})"
        )
    d = pdist.rank()
    k = config.num_factors
    np_dtype = _np_dtype(config.dtype)
    if init is None:
        # every rank draws the whole seeded start and keeps its rows, so D
        # does not change the init
        gen = torch.Generator().manual_seed(config.seed)
        init = (
            init_factors(problem.n_users, k, gen, config.dtype).numpy(),
            init_factors(problem.n_items, k, gen, config.dtype).numpy(),
        )
    host = list(_block_of(problem, _pad_factors(problem, k, np_dtype,
                                                init[0], init[1]), d))
    plan = _exchange_plan(problem, D)
    for name, side in (("u", problem.u), ("i", problem.i)):
        host += _flat_side_args(side, np_dtype, d, routed=plan[name])
    dev_args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in host]
    return _make_sweep(problem, config), dev_args


def warm_start_factors(
    user_ids: np.ndarray,
    item_ids: np.ndarray,
    prev_user: Dict[int, np.ndarray],
    prev_item: Dict[int, np.ndarray],
    k: int,
    seed: int = 42,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Align a previously trained model onto a NEW problem's id space ->
    ``(init_user_factors, init_item_factors)`` in dense-id order.  Rows for
    ids the previous model knows are carried over; new ids get the cold
    ``init_factors`` draw (so a wholly new window is a cold start, not
    zeros)."""
    user_ids = np.asarray(user_ids)
    item_ids = np.asarray(item_ids)
    gen = torch.Generator().manual_seed(seed)
    uf = init_factors(len(user_ids), k, gen).numpy().astype(dtype)
    itf = init_factors(len(item_ids), k, gen).numpy().astype(dtype)
    for ids, table, out in ((user_ids, prev_user, uf),
                            (item_ids, prev_item, itf)):
        for row, id_ in enumerate(ids):
            vec = table.get(int(id_))
            if vec is not None and len(vec) == k:
                out[row] = np.asarray(vec, dtype=dtype)
    return uf, itf


def als_fit(
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    config: ALSConfig,
    device="cuda",
    problem: Optional[BlockedProblem] = None,
    init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    init_user_factors: Optional[np.ndarray] = None,
    init_item_factors: Optional[np.ndarray] = None,
    temporary_path: Optional[str] = None,
    step_timer=None,
) -> ALSModel:
    """Train ALS factors for the given rating triples on `device`.

    In a process group (``parallel/distributed.py``) every rank calls this
    with the same inputs; rank d trains block d, and every rank returns
    the whole model, gathered in block order.  Outside one, D = 1.

    `init`, when given, is (user_factors (n_users, k), item_factors
    (n_items, k)) in dense-id order — the same numpy pair the JAX
    ``als_fit`` takes, which pins the starting point.

    `init_user_factors` / `init_item_factors`: the warm-start override
    (given together, exclusive with `init`), as built by
    ``warm_start_factors``.  A zero-iteration warm-started fit returns the
    init verbatim (modulo dtype).

    `temporary_path` (the reference's setTemporaryPath): run the
    iterations one at a time, copy the factors to the host at every
    iteration boundary and write them there as a snapshot
    (``save_staged``), and resume from the latest matching snapshot if
    one exists (``load_staged``), printing
    ``[ALS] staging: resuming from iteration N (<path>)``.  Over ranks,
    rank 0 alone reads and writes snapshots: it broadcasts the resume
    point and the resumed factors, and writes after every rank joined the
    iteration's gather.

    `step_timer`: optional ``utils.profiling.StepTimer``; in staged mode
    each iteration (the sweep, the copy to the host and the snapshot
    write) is timed as one step."""
    dev = local_device(device)
    if problem is None:
        problem = prepare_blocked(users, items, ratings, num_blocks())
    k = config.num_factors
    np_dtype = _np_dtype(config.dtype)
    if (init_user_factors is None) != (init_item_factors is None):
        raise ValueError(
            "init_user_factors and init_item_factors must be given together"
        )
    if init_user_factors is not None:
        if init is not None:
            raise ValueError(
                "init and init_user_factors/init_item_factors are mutually "
                "exclusive"
            )
        uf_w = np.asarray(init_user_factors, dtype=np_dtype)
        itf_w = np.asarray(init_item_factors, dtype=np_dtype)
        if uf_w.shape != (problem.n_users, k) or \
                itf_w.shape != (problem.n_items, k):
            raise ValueError(
                f"warm-start shapes {uf_w.shape}/{itf_w.shape} do not match "
                f"problem ({problem.n_users}, {k})/({problem.n_items}, {k})"
            )
        init = (uf_w, itf_w)
    fit_fn, dev_args = compile_fit(problem, config, dev, init=init)
    u_perm = torch.from_numpy(problem.u.perm).to(dev)
    i_perm = torch.from_numpy(problem.i.perm).to(dev)

    def to_dense(uf, itf):
        # every block, in block order, then dense-id order: in a process
        # group a collective that every rank joins
        return (pdist.gather_blocks(uf)[u_perm],
                pdist.gather_blocks(itf)[i_perm])

    if temporary_path is None:
        user_factors, item_factors = to_dense(
            *fit_fn(config.iterations, *dev_args))
    else:
        meta = _staging_meta(problem, config, init)
        grouped = pdist.in_group()
        # one writer: rank 0's snapshot is the resume point of every rank
        # (local scans of per-host disks could disagree, and a divergent
        # start would desynchronise the collectives below)
        snap = load_staged(temporary_path, meta,
                           max_iteration=config.iterations) \
            if pdist.is_primary() else None
        start = 0 if snap is None else snap[0]
        if grouped:
            start = int(pdist.broadcast_one_to_all(np.int64(start)))
            if start > 0:
                snap = (start, *(
                    pdist.broadcast_one_to_all(
                        snap[1 + j].astype(np_dtype) if snap is not None
                        else np.zeros((n, k), np_dtype))
                    for j, n in enumerate((problem.n_users,
                                           problem.n_items))))
        if start > 0:
            # operational marker: a genuine resume and a cold rerun leave
            # the same staging dir behind, so the line tells them apart
            print(f"[ALS] staging: resuming from iteration {start} "
                  f"({temporary_path})", flush=True)
            padded = _pad_factors(problem, k, np_dtype, snap[1], snap[2])
            dev_args[0], dev_args[1] = (
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in _block_of(problem, padded, pdist.rank()))
        uf, itf = dev_args[0], dev_args[1]
        # the loop carries its own factor tables from here on
        dev_args[0] = dev_args[1] = None
        timer = step_timer if step_timer is not None \
            else contextlib.nullcontext()
        for it in range(start, config.iterations):
            with timer:
                uf, itf = fit_fn(1, uf, itf, *dev_args[2:])
                user_factors, item_factors = to_dense(uf, itf)
                if pdist.is_primary():
                    # the one device-to-host copy of each table per
                    # iteration, after every rank joined the gather
                    save_staged(temporary_path, it + 1,
                                user_factors.cpu().numpy(),
                                item_factors.cpu().numpy(), meta)
        if start == config.iterations:  # fully resumed: nothing left to run
            user_factors, item_factors = to_dense(uf, itf)
    return ALSModel(
        user_ids=problem.user_ids,
        item_ids=problem.item_ids,
        user_factors=user_factors,
        item_factors=item_factors,
    )


def model_to_host(model: ALSModel) -> tuple:
    """(user_ids, item_ids, user_factors, item_factors), all numpy: the
    model in the form a rank of ``parallel.distributed.launch_local``
    hands back."""
    return (model.user_ids, model.item_ids,
            model.user_factors.cpu().numpy(),
            model.item_factors.cpu().numpy())


def als_fit_host(*args, **kwargs):
    """``model_to_host(als_fit(*args, **kwargs))``."""
    return model_to_host(als_fit(*args, **kwargs))


# ---------------------------------------------------------------------------
# prediction / evaluation
# ---------------------------------------------------------------------------

def _predict_chunk_rows() -> int:
    # bounds the two (chunk, k) gather transients on the device
    return int(os.environ.get("FLINK_MS_PREDICT_CHUNK", 4_000_000))


def predict(model: ALSModel, users: np.ndarray, items: np.ndarray,
            device="cuda") -> np.ndarray:
    """Batched scores for raw (user, item) id pairs, computed on `device`
    in fixed-size chunks; unknown ids score 0 (callers substitute the MEAN
    cold-start vector — SGD.java:219-234)."""
    dev = resolve_device(device)
    users = np.asarray(users)
    items = np.asarray(items)
    u_idx = np.searchsorted(model.user_ids, users)
    u_idx_c = np.clip(u_idx, 0, len(model.user_ids) - 1)
    u_ok = model.user_ids[u_idx_c] == users
    i_idx = np.searchsorted(model.item_ids, items)
    i_idx_c = np.clip(i_idx, 0, len(model.item_ids) - 1)
    i_ok = model.item_ids[i_idx_c] == items
    uf = model.user_factors.to(dev)
    itf = model.item_factors.to(dev)
    n = len(u_idx_c)
    C = _predict_chunk_rows()
    preds = np.empty(n, _np_dtype(uf.dtype))
    for s in range(0, n, C):
        e = min(s + C, n)
        uc = torch.from_numpy(u_idx_c[s:e]).to(dev)
        ic = torch.from_numpy(i_idx_c[s:e]).to(dev)
        preds[s:e] = (uf[uc] * itf[ic]).sum(dim=-1).cpu().numpy()
    return np.where(u_ok & i_ok, preds, 0.0)


def rmse(model: ALSModel, users, items, ratings, device="cuda") -> float:
    p = predict(model, np.asarray(users), np.asarray(items), device=device)
    err = np.asarray(ratings, dtype=np.float64) - p
    return float(np.sqrt(np.mean(err * err)))
