"""Fused gather + normal-equation assembly of one ALS degree bucket: the
CUDA kernel and its plain version.

Counterpart of ``flink_ms_tpu/ops/gather_assembly.py`` (the Pallas kernel
``fused_bucket_assembly``, ``:97``).  The kernel is
``csrc/gather_assembly.cu``: one block per bucket row loops over the row's
whole rating list, gathers factor rows through L2 into shared memory and
keeps its share of A in registers, so the (r, w, k) gather never reaches
device memory.

The reference cuts a large factor table into at most four VMEM slices and
gates the kernel on that (``use_fused_gather``, ``:77-94``); that is a
budget of the TPU's on-chip memory.  The card reads the table through its
50 MB L2, so the port has no slices and no gate: on the card every
bucket of the sweep goes to the kernel.

``fused_bucket_assembly`` launches the kernel for CUDA tensors and runs
``bucket_assembly_plain`` for CPU tensors; nothing falls back from one to
the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_K = 128

LAUNCHES = 0  # kernel launches made by fused_bucket_assembly


def bucket_assembly_plain(y_all, idx, val, out_dtype=torch.float32,
                          implicit=False, alpha=40.0):
    """-> (A (r, k, k), b (r, k)) by ``index_select`` + ``einsum``, the
    arithmetic of ``_bucket_normal_eqs.compute``
    (``flink_ms_tpu/ops/als.py:607-625``).  Gathered rows are cast to
    ``out_dtype`` before the contraction."""
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
    return A, b


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


def fused_bucket_assembly(y_all, idx, val, out_dtype=torch.float32,
                          implicit=False, alpha=40.0):
    """-> (A (r, k, k), b (r, k)) for one bucket.

    Explicit:  A = Σ y yᵀ,          b = Σ r·y
    Implicit:  A = Σ alpha·r·y yᵀ,  b = Σ (1+alpha·r)·y
    with y = y_all[idx] cast to ``out_dtype``; pads point at the table's
    zero dummy slot with r = 0 and add nothing.  CUDA tensors go to the
    kernel (y_all f32 or bf16, idx int32, val f32, out f32, k <= 128); CPU
    tensors to ``bucket_assembly_plain``."""
    _check(y_all, idx, val)
    if y_all.device.type == "cpu":
        return bucket_assembly_plain(y_all, idx, val, out_dtype, implicit,
                                     alpha)
    if y_all.device.type != "cuda":
        raise ValueError(f"unsupported device {y_all.device}")
    return _launch(y_all, idx, val, out_dtype, implicit, alpha)


def _launch(y_all, idx, val, out_dtype, implicit, alpha):
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
    if r >= 1 << 31:
        raise ValueError(f"the CUDA assembly takes fewer than 2^31 rows, got {r}")
    if not (y_all.is_contiguous() and idx.is_contiguous()
            and val.is_contiguous()):
        raise ValueError("the CUDA assembly takes contiguous y_all, idx, val")
    A = torch.empty((r, k, k), dtype=torch.float32, device=y_all.device)
    b = torch.empty((r, k), dtype=torch.float32, device=y_all.device)
    if r == 0:
        return A, b
    lib = _library()
    with torch.cuda.device(y_all.device):
        stream = torch.cuda.current_stream(y_all.device).cuda_stream
        err = lib.gather_assembly_f32(
            y_all.data_ptr(), int(y_all.dtype == torch.bfloat16), S, k,
            idx.data_ptr(), val.data_ptr(), r, w, int(bool(implicit)),
            float(alpha), A.data_ptr(), b.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_assembly_f32 launch failed: CUDA error "
                           f"{err} (r={r}, w={w}, k={k})")
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
        ctypes.c_void_p,
    ]
    lib.gather_assembly_f32.restype = ctypes.c_int
    return lib
