"""The port's batched Cholesky solve (``flink_ms_tpu_torch/ops/cholesky.py``)
on the CPU, where the wrapper runs the kernel's plain version: against a
float64 numpy solve, and against the JAX package's Pallas
``cholesky_solve_batched`` (interpret mode) in both of its layouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ms_tpu.ops.cholesky_pallas import \
    cholesky_solve_batched as jax_solve
from flink_ms_tpu_torch.ops import cholesky as CH


def _spd(rng, n, k):
    G = rng.standard_normal((n, k, k)).astype(np.float32)
    A = G @ G.transpose(0, 2, 1) + 5.0 * np.eye(k, dtype=np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("k", [3, 8, 16, 50, 64])
@pytest.mark.parametrize("n", [1, 100, 257])
def test_plain_matches_numpy_f64(rng, k, n):
    # the tolerance of the JAX package's own kernel test
    # (tests/test_cholesky_pallas.py): f32 elimination vs an f64 solve
    A, b = _spd(rng, n, k)
    x = CH.cholesky_solve_batched(torch.from_numpy(A), torch.from_numpy(b))
    x_ref = np.linalg.solve(
        A.astype(np.float64), b.astype(np.float64)[..., None]
    )[..., 0]
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("layout", ["lane_major", "batch_major"])
@pytest.mark.parametrize("k", [8, 50])
def test_plain_matches_jax_kernel(rng, k, layout):
    # the same elimination in the same order; only f32 rounding of
    # fused/unfused products differs
    A, b = _spd(rng, 100, k)
    want = np.asarray(jax_solve(jnp.asarray(A), jnp.asarray(b),
                                layout=layout))
    got = CH.cholesky_solve_batched(torch.from_numpy(A), torch.from_numpy(b),
                                    layout=layout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_identity_systems_of_empty_slots(rng):
    # the sweep hands empty slots an identity system with b = 0
    A = np.broadcast_to(np.eye(7, dtype=np.float32), (5, 7, 7)).copy()
    x = CH.cholesky_solve_batched(torch.from_numpy(A), torch.zeros(5, 7))
    assert torch.equal(x, torch.zeros(5, 7))


def test_cpu_tensors_take_the_plain_version(rng):
    A, b = _spd(rng, 9, 4)
    before = CH.LAUNCHES
    x = CH.cholesky_solve_batched(torch.from_numpy(A), torch.from_numpy(b))
    assert CH.LAUNCHES == before  # no kernel launched on the CPU
    assert torch.equal(x, CH.cholesky_solve_plain(torch.from_numpy(A),
                                                  torch.from_numpy(b)))


@pytest.mark.parametrize("bad", ["layout", "shape", "dtype"])
def test_wrapper_rejects_bad_arguments(rng, bad):
    A, b = (torch.from_numpy(a) for a in _spd(rng, 3, 4))
    kwargs = {}
    if bad == "layout":
        kwargs["layout"] = "column_major"
    elif bad == "shape":
        b = b[:, :3]
    else:
        b = b.double()
    with pytest.raises(ValueError):
        CH.cholesky_solve_batched(A, b, **kwargs)


def test_solve_plan_for_every_k():
    """Up to k = 64 the register path at k padded to a multiple of 4 (the
    kernel's templates run KP = 4, 8, ..., 64); wider systems the
    shared-memory path."""
    for k in range(1, CH.MAX_K + 1):
        kp = CH.solve_plan(k)
        if k <= CH.MAX_REG_K:
            assert kp % 4 == 0 and k <= kp < k + 4 and kp <= 64
        else:
            assert kp == 0
    assert CH.solve_plan(50) == 52
    with pytest.raises(ValueError):
        CH.solve_plan(0)
