"""Fused gather + normal-equation assembly of one ALS degree bucket: the
CUDA kernel and its plain version.

Counterpart of ``flink_ms_tpu/ops/gather_assembly.py`` (the Pallas kernel
``fused_bucket_assembly``, ``:97``).  The kernel is
``csrc/gather_assembly.cu``: a group of threads owns one bucket row and
loops over its whole rating list, gathers the factor rows with ``cp.async``
into a ring in shared memory two chunks ahead, and keeps one register tile
of A's lower triangle per thread, so the (r, w, k) gather never reaches
device memory.  ``assembly_plan`` picks the tile size and the group for
each k on the host, and ``slot_table`` lays the table out as the kernel
stages it, where the tests reach both.

The reference cuts a large factor table into at most four VMEM slices and
gates the kernel on that (``use_fused_gather``, ``:77-94``); that is a
budget of the TPU's on-chip memory.  The card reads the table through its
50 MB L2, so the port has no slices and no gate: on the card every
bucket of the sweep goes to the kernel.

``fused_bucket_assembly`` launches the kernel for CUDA tensors and runs
``bucket_assembly_plain`` for CPU tensors; nothing falls back from one to
the other.  Both write into ``out=(A, b)`` views when given, so a sweep
assembles every bucket straight into one system tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import _build

MAX_K = 128

LAUNCHES = 0  # kernel launches made by fused_bucket_assembly

# The kernel's pipeline (csrc/gather_assembly.cu): 8-rating chunks in a
# three-stage data ring and a four-stage ring of slots and weights per
# bucket row, and the limits a plan must keep.
CHUNK, STAGES, META_STAGES = 8, 3, 4
TILE_SIZES = (4, 8, 10)
BLOCK_THREADS = 128     # threads a block aims at
MAX_THREADS = 256       # the kernel's __launch_bounds__ at ts = 4 (128 above)
SMEM_LIMIT = 232_448    # opt-in shared memory of one block on an H100


@dataclasses.dataclass(frozen=True)
class AssemblyPlan:
    """How the kernel runs one k: ``ts`` x ``ts`` register tiles of A's
    lower triangle, one per thread, ``g`` threads per bucket row,
    ``rows_per_block`` rows per block, ``smem_bytes`` of shared memory per
    block."""

    ts: int
    g: int
    rows_per_block: int
    smem_bytes: int


def tile_count(k: int, ts: int) -> int:
    nt = -(-k // ts)
    return nt * (nt + 1) // 2


def group_size(tiles: int) -> int:
    """Threads per bucket row: 8 or 16 (rows share a warp), else whole
    warps."""
    for g in (8, 16, 32):
        if tiles <= g:
            return g
    return 32 * -(-tiles // 32)


def slot_elems(ts: int, esize: int) -> int:
    """Elements of one tile slot: ts elements padded to 16 bytes."""
    return -(-ts * esize // 16) * 16 // esize


def group_smem_bytes(k: int, ts: int, esize: int) -> int:
    """One row's shared memory: the data ring (table rows in the slot
    layout), the slot and weight rings, 16 bytes of scratch and b padded
    to 16 bytes (csrc/gather_assembly.cu group_smem_bytes)."""
    return (STAGES * CHUNK * -(-k // ts) * slot_elems(ts, esize) * esize
            + META_STAGES * CHUNK * (8 + 4) + 16 + -(-k // 4) * 16)


def slot_table(y_all: torch.Tensor, ts: int) -> torch.Tensor:
    """The factor table in the kernel's tile-slot layout: each row cut into
    ceil(k/ts) tiles of ts elements, each tile padded with zeros to a
    16-byte slot, so that every row is whole 16-byte pieces that land in
    shared memory as the kernel reads them.  (S, k) -> (S, nt * slot)."""
    S, k = y_all.shape
    nt = -(-k // ts)
    slot = slot_elems(ts, y_all.element_size())
    out = y_all.new_zeros((S, nt, slot))
    padded = torch.nn.functional.pad(y_all, (0, nt * ts - k))
    out[:, :, :ts] = padded.view(S, nt, ts)
    return out.view(S, nt * slot)


def _issue_cost(ts: int, g: int) -> float:
    """Warp instructions per rating: ts^2 multiply-adds, ts for b on the
    diagonal tiles, the two vector loads and the loop, over 32/g rows
    per warp."""
    loads = ts // 4 + (ts % 4 != 0)
    return g / 32 * (ts * ts + ts + 2 * loads + 8)


def assembly_plan(k: int, esize: int = 4) -> AssemblyPlan:
    """The kernel's plan for width k and a table of ``esize``-byte
    elements: the tile size of least issue cost, the smallest group that
    gives every tile a thread, and about 128 threads per block."""
    if not (1 <= k <= MAX_K):
        raise ValueError(f"the CUDA assembly takes 1 <= k <= {MAX_K}, got {k}")
    ts = min(TILE_SIZES,
             key=lambda t: (_issue_cost(t, group_size(tile_count(k, t))), t))
    g = group_size(tile_count(k, ts))
    rows = max(1, BLOCK_THREADS // g)
    return AssemblyPlan(ts, g, rows, rows * group_smem_bytes(k, ts, esize))


def bucket_assembly_plain(y_all, idx, val, out_dtype=torch.float32,
                          implicit=False, alpha=40.0, out=None):
    """-> (A (r, k, k), b (r, k)) by ``index_select`` + ``einsum``, the
    arithmetic of ``_bucket_normal_eqs.compute``
    (``flink_ms_tpu/ops/als.py:607-625``).  Gathered rows are cast to
    ``out_dtype`` before the contraction.  With ``out=(A, b)`` the result
    is copied into those tensors, which are returned."""
    r, w = idx.shape
    k = y_all.shape[1]
    y = torch.index_select(y_all, 0, idx.reshape(-1)).reshape(r, w, k)
    y = y.to(out_dtype)
    if implicit:
        wt = (alpha * val).to(out_dtype)        # pads: val 0 -> weight 0
        t = (1.0 + alpha * val).to(out_dtype)   # pads: y row is zero
        A = torch.einsum("rwk,rwl->rkl", y * wt[..., None], y)
    else:
        A = torch.einsum("rwk,rwl->rkl", y, y)
        t = val.to(out_dtype)                   # pads: val 0
    b = torch.einsum("rwk,rw->rk", y, t)
    if out is None:
        return A, b
    out[0].copy_(A)
    out[1].copy_(b)
    return out


def _check(y_all, idx, val) -> None:
    if y_all.dim() != 2 or idx.dim() != 2 or val.shape != idx.shape:
        raise ValueError(
            f"expected y_all (S, k), idx and val (r, w); got "
            f"{tuple(y_all.shape)}, {tuple(idx.shape)}, {tuple(val.shape)}"
        )
    if not (y_all.device == idx.device == val.device):
        raise ValueError(
            f"y_all on {y_all.device}, idx on {idx.device}, val on {val.device}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")


def _check_out(out, r, k, dtype, device) -> None:
    A, b = out
    if tuple(A.shape) != (r, k, k) or tuple(b.shape) != (r, k):
        raise ValueError(f"out must be A ({r}, {k}, {k}) and b ({r}, {k}); "
                         f"got {tuple(A.shape)} and {tuple(b.shape)}")
    if A.dtype != dtype or b.dtype != dtype:
        raise TypeError(f"out must be {dtype}, got {A.dtype} and {b.dtype}")
    if A.device != device or b.device != device:
        raise ValueError(f"out on {A.device} and {b.device}, not {device}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("out must be contiguous (row slices of a "
                         "contiguous tensor are)")


def fused_bucket_assembly(y_all, idx, val, out_dtype=torch.float32,
                          implicit=False, alpha=40.0, out=None):
    """-> (A (r, k, k), b (r, k)) for one bucket.

    Explicit:  A = Σ y yᵀ,          b = Σ r·y
    Implicit:  A = Σ alpha·r·y yᵀ,  b = Σ (1+alpha·r)·y
    with y = y_all[idx] cast to ``out_dtype``; pads point at the table's
    zero dummy slot with r = 0 and add nothing.  CUDA tensors go to the
    kernel (y_all f32 or bf16, idx int32, val f32, out f32, k <= 128); CPU
    tensors to ``bucket_assembly_plain``.  ``out=(A, b)``: contiguous
    tensors of those shapes and ``out_dtype`` (row slices of a larger
    system tensor) to write into and return."""
    _check(y_all, idx, val)
    if out is not None:
        _check_out(out, idx.shape[0], y_all.shape[1], out_dtype, y_all.device)
    if y_all.device.type == "cpu":
        return bucket_assembly_plain(y_all, idx, val, out_dtype, implicit,
                                     alpha, out=out)
    if y_all.device.type != "cuda":
        raise ValueError(f"unsupported device {y_all.device}")
    return _launch(y_all, idx, val, out_dtype, implicit, alpha, out)


def _launch(y_all, idx, val, out_dtype, implicit, alpha, out):
    global LAUNCHES
    S, k = y_all.shape
    r, w = idx.shape
    if y_all.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA assembly takes an f32 or bf16 table, "
                        f"got {y_all.dtype}")
    if val.dtype != torch.float32:
        raise TypeError(f"the CUDA assembly takes f32 val, got {val.dtype}")
    if out_dtype != torch.float32:
        raise TypeError(f"the CUDA assembly writes float32, not {out_dtype}")
    if not (1 <= k <= MAX_K):
        raise ValueError(f"the CUDA assembly takes 1 <= k <= {MAX_K}, got {k}")
    if r >= 1 << 31 or S >= 1 << 31:
        raise ValueError(f"the CUDA assembly takes fewer than 2^31 rows and "
                         f"table slots, got {r} and {S}")
    if implicit and not math.isfinite(alpha):
        # pads are skipped as exact zeros, which needs alpha * 0 == 0
        raise ValueError(f"the CUDA assembly takes a finite alpha, got {alpha}")
    if not (y_all.is_contiguous() and idx.is_contiguous()
            and val.is_contiguous()):
        raise ValueError("the CUDA assembly takes contiguous y_all, idx, val")
    if out is None:
        out = (torch.empty((r, k, k), dtype=torch.float32, device=y_all.device),
               torch.empty((r, k), dtype=torch.float32, device=y_all.device))
    A, b = out
    if r == 0:
        return A, b
    plan = assembly_plan(k, y_all.element_size())
    y_slots = slot_table(y_all, plan.ts)  # a fresh, 16-byte aligned copy
    lib = _library()
    with torch.cuda.device(y_all.device):
        stream = torch.cuda.current_stream(y_all.device).cuda_stream
        err = lib.gather_assembly_f32(
            y_slots.data_ptr(), int(y_all.dtype == torch.bfloat16), S, k,
            idx.data_ptr(), val.data_ptr(), r, w, int(bool(implicit)),
            float(alpha), A.data_ptr(), b.data_ptr(), plan.ts, plan.g,
            plan.rows_per_block, stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_assembly_f32 launch failed: CUDA error "
                           f"{err} (r={r}, w={w}, k={k}, {plan})")
    LAUNCHES += 1
    return A, b


def _library() -> ctypes.CDLL:
    lib = _build.load("gather_assembly")
    # c_void_p for every pointer and the stream: an undeclared argument
    # would pass as a 32-bit int and cut the pointer
    lib.gather_assembly_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gather_assembly_f32.restype = ctypes.c_int
    return lib
