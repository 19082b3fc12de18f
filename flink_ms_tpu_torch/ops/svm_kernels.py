"""The two CUDA kernels of the CoCoA round boundary and their plain
versions.

Counterpart of ``flink_ms_tpu/ops/svm_kernels.py`` (the Pallas kernels
``margin_gather``, ``:44``, and ``scatter_add_dw``, ``:86``).  Once per
round the gram engine reads the weight vector for every row's margin and
writes the round's Δw = XᵀΔα back; both are irregular passes over the whole
(C, H, L) sparse layout (49,315,840 entries at the RCV1 shape) and nothing
else of the round touches the (d,) weights.

- ``margin_gather`` — ``csrc/svm_margin_gather.cu``: persistent warps
  stream tiles of whole rows as 16-byte vectors and gather from a copy of
  w in shared memory (through L1 when w does not fit); ``margin_plan``
  sizes the tiles and the grid;
- ``scatter_add_dw`` — ``csrc/svm_scatter_add.cu``: one block per SM
  folds 16-byte vectors of the entries into a (d,) accumulator in shared
  memory when it fits, global atomics above that; ``scatter_plan`` picks
  the branch and the grid.  With ``row_scale`` (the gram engine's Δα)
  each entry's contribution is formed in the kernel, so the (C, H, L)
  contribution tensor is never built.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; nothing falls back from one to the other, and no
variable selects between them (the reference's ``FLINK_MS_SVM_WX0``,
``FLINK_MS_SVM_DW=pallas`` and ``FLINK_MS_SVM_KERNEL_TILE`` are not read).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build

# kernel launches made by each wrapper, the scatter-add's two forms
# apart: "scatter_add_dw" on a contribution (the TPU kernel's function),
# "scatter_add_dw[row_scale]" with a row scale
LAUNCHES = {"margin_gather": 0, "scatter_add_dw": 0,
            "scatter_add_dw[row_scale]": 0}

# The launch plans are made here alone: the C entries take the branch,
# the grid, the block size and the margin gather's tile rows as given, and
# the kernels read their block size from the launch.
SCATTER_SHARED_THREADS = 1024  # one block per SM
SCATTER_GLOBAL_THREADS = 256
MARGIN_THREADS = 1024          # one block of 32 warps per SM
MARGIN_LINE = 32 * 4           # a warp's line: one 16-byte vector a lane


@functools.lru_cache(maxsize=None)
def _device_limits(index: int):
    """(SM count, opt-in shared memory of a block in floats) of CUDA
    device `index`: the card's side of both plans, read once."""
    props = torch.cuda.get_device_properties(index)
    return (props.multi_processor_count,
            props.shared_memory_per_block_optin // 4)


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    shared: bool     # the (d,) accumulator in each block's shared memory
    blocks: int
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def scatter_plan(n: int, d: int, sms: int, max_d: int) -> ScatterPlan:
    """The scatter-add's launch for n entries into d bins on a card with
    `sms` SMs whose shared-memory branch ends at `max_d` bins: up to one
    block per SM (each zeroes and flushes all d bins, so no more than the
    entries keep busy: a step of a block takes one 16-byte vector of 4
    entries a thread), or a grid of global-atomic blocks."""
    if d <= max_d:
        per_block = SCATTER_SHARED_THREADS * 4
        blocks = min(max(-(-n // per_block), 1), sms)
        return ScatterPlan(True, blocks, SCATTER_SHARED_THREADS, 4 * d)
    blocks = min(max(-(-n // (4 * SCATTER_GLOBAL_THREADS)), 1), 16 * sms)
    return ScatterPlan(False, blocks, SCATTER_GLOBAL_THREADS, 0)


@dataclasses.dataclass(frozen=True)
class MarginPlan:
    shared_w: bool   # w copied into each block's shared memory
    tile_rows: int   # rows per warp tile: tile_rows * L fills whole lines
    lines: int       # 128-entry lines per full tile
    tiles: int
    blocks: int
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def margin_plan(rows: int, L: int, d: int, sms: int,
                max_d: int) -> MarginPlan:
    """The margin gather's launch for (rows, L) slots and w (d,) on a card
    with `sms` SMs whose shared memory holds up to `max_d` floats: tiles
    of 128 / gcd(L, 128) whole rows, so each tile is a whole number of
    128-entry lines and starts on the 16-byte grid, one warp per tile at
    a time, up to one block per SM."""
    tile_rows = MARGIN_LINE // math.gcd(L, MARGIN_LINE)
    # the kernel counts a tile's entries in 32 bits
    if tile_rows * L >= 1 << 32:
        raise ValueError(f"margin_gather: L = {L} is too long")
    tiles = -(-rows // tile_rows)
    warps = MARGIN_THREADS // 32
    blocks = min(max(-(-tiles // warps), 1), sms)
    shared_w = d <= max_d
    return MarginPlan(shared_w, tile_rows, tile_rows * L // MARGIN_LINE,
                      tiles, blocks, MARGIN_THREADS, 4 * d if shared_w else 0)


def margin_gather_plain(w, idx, val):
    """(w[idx] * val).sum(-1): the reference's ``take`` + einsum
    (``flink_ms_tpu/ops/svm.py:463-465``)."""
    g = torch.index_select(w, 0, idx.reshape(-1)).reshape(idx.shape)
    return (g * val).sum(-1)


def scatter_add_plain(idx, vals, d, row_scale=None):
    """zeros(d).index_add_(idx, contrib): the reference's unsorted
    ``.at[idx].add`` (``flink_ms_tpu/ops/svm.py:494-497``), with contrib
    = vals, or vals * row_scale[..., None] when a row scale is given."""
    contrib = vals if row_scale is None else vals * row_scale[..., None]
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
    rows, d = out.numel(), w.numel()
    plan = margin_plan(rows, L, d, *_device_limits(w.get_device()))
    with torch.cuda.device(w.device):
        err = _margin_library().margin_gather_f32(
            w.data_ptr(), d, idx.data_ptr(), val.data_ptr(), rows, L,
            plan.tile_rows, int(plan.shared_w), plan.blocks, plan.threads,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"margin_gather_f32 launch failed: CUDA error "
                           f"{err} (rows={rows}, L={L}, d={d}, {plan})")
    LAUNCHES["margin_gather"] += 1
    return out


def scatter_add_dw(idx, vals, d, row_scale=None):
    """dw (d,) = Σ contrib over the entries whose idx is f, for every
    feature f: the round's Δw = XᵀΔα before the 1/λn.  contrib is vals,
    or, with ``row_scale`` of shape ``idx.shape[:-1]``, vals[..., l] *
    row_scale[...] (the same f32 product as ``vals * row_scale[..., None]``,
    formed in the kernel).  CUDA tensors go to the kernel (idx int32,
    vals and row_scale f32, out f32); CPU tensors to
    ``scatter_add_plain``."""
    _check_pair("scatter_add_dw", idx, vals)
    d = int(d)
    if d < 0:
        raise ValueError(f"scatter_add_dw: d must be >= 0, got {d}")
    if row_scale is not None:
        if tuple(row_scale.shape) != tuple(idx.shape[:-1]):
            raise ValueError(f"scatter_add_dw: row_scale must have the shape "
                             f"{tuple(idx.shape[:-1])}, got "
                             f"{tuple(row_scale.shape)}")
        if row_scale.dtype != vals.dtype:
            raise TypeError(f"scatter_add_dw: row_scale must be {vals.dtype} "
                            f"like the values, got {row_scale.dtype}")
        if row_scale.device != vals.device:
            raise ValueError(f"scatter_add_dw: row_scale on "
                             f"{row_scale.device}, values on {vals.device}")
    if not _on_card("scatter_add_dw", vals):
        return scatter_add_plain(idx, vals, d, row_scale)
    scaled = () if row_scale is None else (row_scale,)
    _check_kernel_args("scatter_add_dw", idx, vals, *scaled)
    out = torch.empty(d, dtype=torch.float32, device=vals.device)
    n, L = idx.numel(), idx.shape[-1]
    plan = scatter_plan(n, d, *_device_limits(vals.get_device()))
    with torch.cuda.device(vals.device):
        err = _scatter_library().scatter_add_f32(
            idx.data_ptr(), vals.data_ptr(),
            None if row_scale is None else row_scale.data_ptr(), n, L, d,
            int(plan.shared), plan.blocks, plan.threads, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_f32 launch failed: CUDA error {err} "
                           f"(n={n}, L={L}, d={d}, {plan})")
    LAUNCHES["scatter_add_dw" if row_scale is None
             else "scatter_add_dw[row_scale]"] += 1
    return out


def scatter_shared_max_d(device=None) -> int:
    """The largest d whose accumulator ``scatter_add_dw``'s kernel keeps in
    shared memory on a CUDA device (default: the current one); above it
    the kernel adds straight into device memory.  ``margin_gather`` copies
    w into shared memory up to the same d."""
    index = torch.device("cuda" if device is None else device).index
    return _device_limits(torch.cuda.current_device() if index is None
                          else index)[1]


# c_void_p for every pointer and the stream: an undeclared argument would
# pass as a 32-bit int and cut the pointer
_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong


_INT = ctypes.c_int


@functools.cache
def _margin_library() -> ctypes.CDLL:
    lib = _build.load("svm_margin_gather")
    lib.margin_gather_f32.argtypes = [_PTR, _LL, _PTR, _PTR, _LL, _INT, _INT,
                                      _INT, _INT, _INT, _PTR, _PTR]
    lib.margin_gather_f32.restype = _INT
    return lib


@functools.cache
def _scatter_library() -> ctypes.CDLL:
    lib = _build.load("svm_scatter_add")
    lib.scatter_add_f32.argtypes = [_PTR, _PTR, _PTR, _LL, _INT, _LL, _INT,
                                    _INT, _INT, _PTR, _PTR]
    lib.scatter_add_f32.restype = _INT
    return lib
