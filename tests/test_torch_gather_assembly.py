"""The port's bucket assembly (``flink_ms_tpu_torch/ops/gather_assembly.py``)
on the CPU, where the wrapper runs the kernel's plain version: against the
JAX package's Pallas ``fused_bucket_assembly`` (interpret mode, forced into
several rating-list chunks and table slices) and against its XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ms_tpu.ops import als as JA
from flink_ms_tpu.ops import gather_assembly as JG
from flink_ms_tpu_torch.ops import gather_assembly as GA

S, K, R, W = 300, 8, 37, 50


def _bucket(rng, table_dtype):
    """A factor table whose last slot is the zero dummy, and one bucket of
    rating lists whose tails are pads pointing at it.  -> numpy f32 table
    (exactly representable in `table_dtype`), idx, val."""
    y = rng.standard_normal((S, K)).astype(np.float32)
    y[-1] = 0.0
    y = torch.from_numpy(y).to(table_dtype).float().numpy()
    idx = rng.integers(0, S - 1, (R, W)).astype(np.int32)
    val = rng.uniform(1.0, 5.0, (R, W)).astype(np.float32)
    lens = rng.integers(1, W + 1, R)
    pad = np.arange(W)[None, :] >= lens[:, None]
    idx[pad] = S - 1
    val[pad] = 0.0
    return y, idx, val


def _torch_args(y, idx, val, table_dtype):
    return (torch.from_numpy(y).to(table_dtype), torch.from_numpy(idx),
            torch.from_numpy(val))


def _close(got, want):
    # f32 reassociation only: rtol 1e-5 / atol 1e-5 of max|want|
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_jax_kernel_chunked_and_sliced(rng, monkeypatch,
                                                     implicit, table_dtype):
    # w-chunk 16 -> 4 rating-list chunks; a 6000-byte budget cuts the f32
    # table (9600 B) into 4 slices, the bf16 one (4800 B) into 1
    monkeypatch.setenv("FLINK_MS_ALS_ASSEMBLY_W_CHUNK", "16")
    monkeypatch.setenv("FLINK_MS_ALS_ASSEMBLY_VMEM_BYTES", "6000")
    y, idx, val = _bucket(rng, table_dtype)
    jdt = jnp.bfloat16 if table_dtype == torch.bfloat16 else jnp.float32
    A_j, b_j = JG.fused_bucket_assembly(
        jnp.asarray(y).astype(jdt), jnp.asarray(idx), jnp.asarray(val),
        jnp.float32, "cpu", implicit=implicit, alpha=40.0)
    A_t, b_t = GA.fused_bucket_assembly(
        *_torch_args(y, idx, val, table_dtype), torch.float32,
        implicit=implicit, alpha=40.0)
    _close(A_t.numpy(), np.asarray(A_j))
    _close(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_jax_xla_path(rng, monkeypatch, implicit, table_dtype):
    monkeypatch.setenv("FLINK_MS_ALS_ASSEMBLY", "xla")
    y, idx, val = _bucket(rng, table_dtype)
    jdt = jnp.bfloat16 if table_dtype == torch.bfloat16 else jnp.float32
    A_j, b_j = JA._bucket_normal_eqs(
        jnp.asarray(y).astype(jdt), jnp.asarray(idx), jnp.asarray(val),
        implicit, 40.0, jnp.float32, "highest")
    A_t, b_t = GA.bucket_assembly_plain(
        *_torch_args(y, idx, val, table_dtype), torch.float32, implicit, 40.0)
    _close(A_t.numpy(), np.asarray(A_j))
    _close(b_t.numpy(), np.asarray(b_j))


def test_pads_add_nothing(rng):
    y, idx, val = _bucket(rng, torch.float32)
    A, b = GA.fused_bucket_assembly(*_torch_args(y, idx, val, torch.float32))
    keep = idx != S - 1
    for r in range(R):
        ys = y[idx[r, keep[r]]].astype(np.float64)
        np.testing.assert_allclose(A[r].numpy(), ys.T @ ys, rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(b[r].numpy(), ys.T @ val[r, keep[r]],
                                   rtol=1e-5, atol=1e-4)


def test_cpu_tensors_take_the_plain_version(rng):
    args = _torch_args(*_bucket(rng, torch.float32), torch.float32)
    before = GA.LAUNCHES
    A, b = GA.fused_bucket_assembly(*args, implicit=True)
    assert GA.LAUNCHES == before  # no kernel launched on the CPU
    A2, b2 = GA.bucket_assembly_plain(*args, implicit=True)
    assert torch.equal(A, A2) and torch.equal(b, b2)


def test_wrapper_rejects_bad_arguments(rng):
    y, idx, val = _torch_args(*_bucket(rng, torch.float32), torch.float32)
    with pytest.raises(TypeError, match="idx"):
        GA.fused_bucket_assembly(y, idx.float(), val)
    with pytest.raises(ValueError, match="expected"):
        GA.fused_bucket_assembly(y, idx, val[:, :3])


@pytest.mark.parametrize("implicit", [False, True])
def test_out_views_are_filled_in_place(rng, implicit):
    y, idx, val = _torch_args(*_bucket(rng, torch.float32), torch.float32)
    want_A, want_b = GA.bucket_assembly_plain(y, idx, val, implicit=implicit)
    A = torch.full((R + 5, K, K), float("nan"))
    b = torch.full((R + 5, K), float("nan"))
    views = (A[3:3 + R], b[3:3 + R])  # a non-zero row offset
    got = GA.fused_bucket_assembly(y, idx, val, implicit=implicit, out=views)
    assert got[0].data_ptr() == views[0].data_ptr()
    assert torch.equal(A[3:3 + R], want_A) and torch.equal(b[3:3 + R], want_b)
    # rows outside the views are untouched
    assert torch.isnan(A[:3]).all() and torch.isnan(A[3 + R:]).all()
    assert torch.isnan(b[:3]).all() and torch.isnan(b[3 + R:]).all()


def test_out_views_are_checked(rng):
    y, idx, val = _torch_args(*_bucket(rng, torch.float32), torch.float32)
    A, b = torch.empty(R, K, K), torch.empty(R, K)
    with pytest.raises(ValueError, match="out must be"):
        GA.fused_bucket_assembly(y, idx, val, out=(A[1:], b[1:]))
    with pytest.raises(TypeError, match="out must be"):
        GA.fused_bucket_assembly(y, idx, val, out=(A.double(), b))
    with pytest.raises(ValueError, match="contiguous"):
        GA.fused_bucket_assembly(y, idx, val,
                                 out=(A.transpose(1, 2), b))


@pytest.mark.parametrize("esize", [4, 2])
def test_assembly_plan_for_every_k(esize):
    """The kernel's launch plan for each width it takes: every register
    tile has a thread, groups tile a warp or are whole warps, and a block
    stays within the kernel's launch bounds and the card's shared
    memory."""
    for k in range(1, GA.MAX_K + 1):
        plan = GA.assembly_plan(k, esize)
        assert plan.ts in GA.TILE_SIZES
        assert GA.tile_count(k, plan.ts) <= plan.g
        assert plan.g in (8, 16) or plan.g % 32 == 0
        assert plan.g > 32 or 32 % plan.g == 0
        assert plan.rows_per_block * plan.g <= (
            GA.MAX_THREADS if plan.ts == 4 else GA.BLOCK_THREADS)
        assert plan.smem_bytes == plan.rows_per_block * \
            GA.group_smem_bytes(k, plan.ts, esize)
        assert plan.smem_bytes <= GA.SMEM_LIMIT
    # the main path's width: 10 x 10 tiles, two rows per warp
    assert GA.assembly_plan(50, 4) == GA.AssemblyPlan(
        ts=10, g=16, rows_per_block=8,
        smem_bytes=8 * GA.group_smem_bytes(50, 10, 4))
    with pytest.raises(ValueError):
        GA.assembly_plan(129)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,ts", [(1, 4), (7, 4), (50, 10), (64, 10),
                                  (33, 8), (128, 10)])
def test_slot_table_layout(rng, k, ts, dtype):
    """Each row of the kernel's table: ceil(k/ts) tiles of ts elements,
    each padded with zeros to a 16-byte slot, rows whole 16-byte pieces."""
    y = torch.from_numpy(rng.standard_normal((9, k)).astype(np.float32))
    y = y.to(dtype)
    got = GA.slot_table(y, ts)
    slot = GA.slot_elems(ts, y.element_size())
    nt = -(-k // ts)
    assert got.shape == (9, nt * slot) and got.dtype == dtype
    assert (got.shape[1] * y.element_size()) % 16 == 0
    assert slot >= ts and (slot * y.element_size()) % 16 == 0
    tiles = got.view(9, nt, slot)
    assert torch.equal(tiles[:, :, :ts].reshape(9, nt * ts)[:, :k], y)
    assert not tiles[:, :, ts:].any()
    assert not tiles[:, :, :ts].reshape(9, nt * ts)[:, k:].any()
