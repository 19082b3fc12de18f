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
