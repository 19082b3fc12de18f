"""Batched SPD solve x = A⁻¹b: the CUDA kernel and its plain version.

Counterpart of ``flink_ms_tpu/ops/cholesky_pallas.py``.  Its two Pallas
kernels, ``_solve_kernel`` (lane-major operands, ``:40``) and
``_solve_kernel_batch_major`` (``:97``), compute the same function; the
operand layout was a concern of the TPU's lanes.  On Hopper both are one
CUDA kernel on batch-major operands, ``csrc/cholesky_solve.cu``, and
``layout`` stays an argument so that both call sites of the reference (the
straight-line solve and the fused per-chunk solve) keep their shape.  Up to
k = 64 a warp holds its system in registers at k padded to a multiple of 4
while the next one streams into shared memory; wider systems are factored
in shared memory (``solve_plan``).

``cholesky_solve_batched`` launches the kernel for CUDA tensors and runs
``cholesky_solve_plain`` for CPU tensors; nothing falls back from one to
the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAYOUTS = ("lane_major", "batch_major")
MAX_K = 128
MAX_REG_K = 64      # widest system the register path holds


def solve_plan(k: int) -> int:
    """The kernel's padded width for k: the register path's KP (k rounded
    up to a multiple of 4, one template per KP), or 0 for the
    shared-memory path above k = 64."""
    if not (1 <= k <= MAX_K):
        raise ValueError(f"the CUDA solve takes 1 <= k <= {MAX_K}, got {k}")
    return 0 if k > MAX_REG_K else -(-k // 4) * 4

LAUNCHES = 0  # kernel launches made by cholesky_solve_batched
BATCH_MAJOR_LAUNCHES = 0  # of them, through the batch-major entry


def cholesky_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: right-looking Cholesky by k
    rank-1 downdates, then forward and back substitution, vectorized over
    the batch (``_chol_solve_unrolled``, ``flink_ms_tpu/ops/als.py:713-748``).
    Each downdate touches only the trailing submatrix, the only entries
    later steps read, so every value used is computed as in the reference.
    A (n, k, k), b (n, k) -> x (n, k)."""
    n, k = b.shape
    M = A.clone()
    L = torch.zeros_like(A)
    for j in range(k):
        d = torch.rsqrt(M[:, j, j])
        col = M[:, j:, j] * d[:, None]  # rows >= j of column j of L
        L[:, j:, j] = col
        M[:, j + 1:, j + 1:] -= col[:, 1:, None] * col[:, None, 1:]
    # forward solve L z = b, running accumulator acc = Σ_p L[:, p]·z_p
    acc = torch.zeros_like(b)
    zs = []
    for j in range(k):
        z = (b[:, j] - acc[:, j]) / L[:, j, j]
        zs.append(z)
        acc = acc + L[:, :, j] * z[:, None]
    # back solve Lᵀ x = z, folding row j of L into the entries above it
    acc = torch.zeros_like(b)
    xs = [None] * k
    for j in reversed(range(k)):
        x = (zs[j] - acc[:, j]) / L[:, j, j]
        xs[j] = x
        acc = acc + L[:, j, :] * x[:, None]
    return torch.stack(xs, dim=-1)


def _check(A: torch.Tensor, b: torch.Tensor, layout) -> None:
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r} must be one of {LAYOUTS} or None")
    if A.dim() != 3 or b.dim() != 2 or A.shape[1] != A.shape[2] \
            or A.shape[0] != b.shape[0] or A.shape[2] != b.shape[1]:
        raise ValueError(
            f"expected A (n, k, k) and b (n, k), got {tuple(A.shape)} and "
            f"{tuple(b.shape)}"
        )
    if A.device != b.device:
        raise ValueError(f"A on {A.device} but b on {b.device}")
    if A.dtype != b.dtype:
        raise ValueError(f"A is {A.dtype} but b is {b.dtype}")


def cholesky_solve_batched(A: torch.Tensor, b: torch.Tensor,
                           layout=None) -> torch.Tensor:
    """Batched SPD solve A x = b.  A (n, k, k), b (n, k) -> x (n, k).

    CUDA tensors go to the kernel (f32, contiguous, 1 <= k <= 128); CPU
    tensors to ``cholesky_solve_plain``.  ``layout`` ("lane_major",
    "batch_major" or None) names the reference's entry point; both reach
    the same kernel."""
    _check(A, b, layout)
    if A.device.type == "cpu":
        return cholesky_solve_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    return _launch(A, b, layout)


def _launch(A: torch.Tensor, b: torch.Tensor, layout) -> torch.Tensor:
    global LAUNCHES, BATCH_MAJOR_LAUNCHES
    n, k = b.shape
    if A.dtype != torch.float32:
        raise TypeError(f"the CUDA solve takes float32, got {A.dtype}")
    kp = solve_plan(k)
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("the CUDA solve takes contiguous A and b")
    x = torch.empty_like(b)
    if n == 0:
        return x
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.cholesky_solve_f32(A.data_ptr(), b.data_ptr(),
                                     x.data_ptr(), n, k, kp, stream)
    if err != 0:
        raise RuntimeError(f"cholesky_solve_f32 launch failed: CUDA error "
                           f"{err} (n={n}, k={k})")
    LAUNCHES += 1
    BATCH_MAJOR_LAUNCHES += int(layout == "batch_major")
    return x


def _library() -> ctypes.CDLL:
    lib = _build.load("cholesky_solve")
    # c_void_p for every pointer and the stream: an undeclared argument
    # would pass as a 32-bit int and cut the pointer
    lib.cholesky_solve_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.cholesky_solve_f32.restype = ctypes.c_int
    return lib
