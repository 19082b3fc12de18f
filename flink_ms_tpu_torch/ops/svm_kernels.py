"""The two CUDA kernels of the CoCoA round boundary and their plain
versions.

Counterpart of ``flink_ms_tpu/ops/svm_kernels.py`` (the Pallas kernels
``margin_gather``, ``:44``, and ``scatter_add_dw``, ``:86``).  Once per
round the gram engine reads the weight vector for every row's margin and
writes the round's Δw = XᵀΔα back; both are irregular passes over the whole
(C, H, L) sparse layout (49,315,840 entries at the RCV1 shape) and nothing
else of the round touches the (d,) weights.

- ``margin_gather`` — ``csrc/svm_margin_gather.cu``: one warp per row, w
  read through L2;
- ``scatter_add_dw`` — ``csrc/svm_scatter_add.cu``: a (d,) accumulator in
  shared memory per block when it fits, global atomics above that.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; nothing falls back from one to the other, and no
variable selects between them (the reference's ``FLINK_MS_SVM_WX0``,
``FLINK_MS_SVM_DW=pallas`` and ``FLINK_MS_SVM_KERNEL_TILE`` are not read).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches made by each wrapper
LAUNCHES = {"margin_gather": 0, "scatter_add_dw": 0}


def margin_gather_plain(w, idx, val):
    """(w[idx] * val).sum(-1): the reference's ``take`` + einsum
    (``flink_ms_tpu/ops/svm.py:463-465``)."""
    g = torch.index_select(w, 0, idx.reshape(-1)).reshape(idx.shape)
    return (g * val).sum(-1)


def scatter_add_plain(idx, contrib, d):
    """zeros(d).index_add_(idx, contrib): the reference's unsorted
    ``.at[idx].add`` (``flink_ms_tpu/ops/svm.py:494-497``)."""
    out = torch.zeros(d, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, idx.reshape(-1), contrib.reshape(-1))


def _check_pair(name, idx, vals) -> None:
    if idx.dim() < 1 or vals.shape != idx.shape:
        raise ValueError(f"{name}: expected idx and values of one shape, "
                         f"got {tuple(idx.shape)} and {tuple(vals.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if idx.device != vals.device:
        raise ValueError(f"{name}: idx on {idx.device}, values on "
                         f"{vals.device}")


def _on_card(name, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _check_kernel_args(name, *tensors) -> None:
    for t in tensors[1:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32 values, "
                            f"got {t.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


def margin_gather(w, idx, val):
    """wx0 (...) = Σ_l w[idx[..., l]] * val[..., l]: at the gram engine's
    (C, H, L) layout, the (C, H) round-start margins.  CUDA tensors go to
    the kernel (w f32 (d,), idx int32, val f32); CPU tensors to
    ``margin_gather_plain``."""
    _check_pair("margin_gather", idx, val)
    if w.dim() != 1 or w.device != idx.device:
        raise ValueError(f"margin_gather: expected w (d,) on {idx.device}, "
                         f"got {tuple(w.shape)} on {w.device}")
    if not _on_card("margin_gather", w):
        return margin_gather_plain(w, idx, val)
    _check_kernel_args("margin_gather", idx, w, val)
    L = idx.shape[-1]
    out = torch.empty(idx.shape[:-1], dtype=torch.float32, device=w.device)
    rows = out.numel()
    lib = _margin_library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.margin_gather_f32(w.data_ptr(), w.numel(), idx.data_ptr(),
                                    val.data_ptr(), rows, L, out.data_ptr(),
                                    stream)
    if err != 0:
        raise RuntimeError(f"margin_gather_f32 launch failed: CUDA error "
                           f"{err} (rows={rows}, L={L}, d={w.numel()})")
    LAUNCHES["margin_gather"] += 1
    return out


def scatter_add_dw(idx, contrib, d):
    """dw (d,) = Σ contrib over the entries whose idx is f, for every
    feature f: the round's Δw = XᵀΔα before the 1/λn.  CUDA tensors go to
    the kernel (idx int32, contrib f32, out f32); CPU tensors to
    ``scatter_add_plain``."""
    _check_pair("scatter_add_dw", idx, contrib)
    d = int(d)
    if d < 0:
        raise ValueError(f"scatter_add_dw: d must be >= 0, got {d}")
    if not _on_card("scatter_add_dw", contrib):
        return scatter_add_plain(idx, contrib, d)
    _check_kernel_args("scatter_add_dw", idx, contrib)
    out = torch.empty(d, dtype=torch.float32, device=contrib.device)
    n = idx.numel()
    lib = _scatter_library()
    with torch.cuda.device(contrib.device):
        stream = torch.cuda.current_stream(contrib.device).cuda_stream
        err = lib.scatter_add_f32(idx.data_ptr(), contrib.data_ptr(), n, d,
                                  out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_f32 launch failed: CUDA error {err} "
                           f"(n={n}, d={d})")
    LAUNCHES["scatter_add_dw"] += 1
    return out


def scatter_shared_max_d(device=None) -> int:
    """The largest d whose accumulator ``scatter_add_dw``'s kernel keeps in
    shared memory on the current CUDA device; above it the kernel adds
    straight into device memory."""
    lib = _scatter_library()
    max_d = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = lib.scatter_add_shared_max_d(ctypes.byref(max_d))
    if err != 0:
        raise RuntimeError(f"scatter_add_shared_max_d failed: CUDA error "
                           f"{err}")
    return int(max_d.value)


# c_void_p for every pointer and the stream: an undeclared argument would
# pass as a 32-bit int and cut the pointer
_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong


def _margin_library() -> ctypes.CDLL:
    lib = _build.load("svm_margin_gather")
    lib.margin_gather_f32.argtypes = [_PTR, _LL, _PTR, _PTR, _LL,
                                      ctypes.c_int, _PTR, _PTR]
    lib.margin_gather_f32.restype = ctypes.c_int
    return lib


def _scatter_library() -> ctypes.CDLL:
    lib = _build.load("svm_scatter_add")
    lib.scatter_add_f32.argtypes = [_PTR, _PTR, _LL, _LL, _PTR, _PTR]
    lib.scatter_add_f32.restype = ctypes.c_int
    lib.scatter_add_shared_max_d.argtypes = [ctypes.POINTER(_LL)]
    lib.scatter_add_shared_max_d.restype = ctypes.c_int
    return lib
