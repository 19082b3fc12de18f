"""The port's CoCoA round-boundary kernels
(``flink_ms_tpu_torch/ops/svm_kernels.py``) on the CPU, where each wrapper
runs its plain version: against the JAX package's Pallas ``margin_gather``
and ``scatter_add_dw`` in interpret mode, on ragged and duplicate-laden
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ms_tpu.ops import svm_kernels as JK
from flink_ms_tpu_torch.ops import svm_kernels as SK


def _layout(rng, C, H, L, d, pad_frac=0.3):
    """(C, H, L) int32 feature ids with duplicates inside rows and zero pad
    slots (id 0, value 0) at the tails, f32 values, and an f32 w (d,)."""
    idx = rng.integers(0, d, (C, H, L)).astype(np.int32)
    if L > 1:
        idx[..., 1] = idx[..., 0]  # a duplicate id in every row
    val = rng.standard_normal((C, H, L)).astype(np.float32)
    lens = rng.integers(0, L + 1, (C, H))
    pad = (np.arange(L) >= lens[..., None]) & \
        (rng.uniform(size=(C, H, 1)) < pad_frac)
    idx[pad] = 0
    val[pad] = 0.0
    w = rng.standard_normal(d).astype(np.float32)
    return w, idx, val


def _close(got, want):
    # f32 reassociation only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# (C, H, L, d): rows ragged against the reference's 512-row tile, one slot
# per row, a lane-ragged L and d, and a single row
SHAPES = [(3, 300, 7, 50), (5, 37, 1, 11), (2, 129, 33, 130), (1, 1, 70, 300)]


@pytest.mark.parametrize("C,H,L,d", SHAPES)
def test_margin_gather_plain_matches_jax_kernel(rng, C, H, L, d):
    w, idx, val = _layout(rng, C, H, L, d)
    want = JK.margin_gather(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(val),
                            jnp.float32, "cpu")
    got = SK.margin_gather(torch.from_numpy(w), torch.from_numpy(idx),
                           torch.from_numpy(val))
    assert got.shape == (C, H) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("C,H,L,d", SHAPES)
def test_scatter_add_plain_matches_jax_kernel(rng, C, H, L, d):
    _, idx, contrib = _layout(rng, C, H, L, d)
    want = JK.scatter_add_dw(jnp.asarray(idx), jnp.asarray(contrib), d,
                             jnp.float32, "cpu")
    got = SK.scatter_add_dw(torch.from_numpy(idx), torch.from_numpy(contrib),
                            d)
    assert got.shape == (d,) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("C,H,L,d", SHAPES)
def test_scatter_add_row_scale_matches_jax_kernel(rng, C, H, L, d):
    """The gram engine's form: values and a per-row Δα, against the JAX
    kernel on the contribution val * Δα[..., None]."""
    _, idx, val = _layout(rng, C, H, L, d)
    dalpha = rng.standard_normal((C, H)).astype(np.float32)
    contrib = val * dalpha[..., None]
    want = JK.scatter_add_dw(jnp.asarray(idx), jnp.asarray(contrib), d,
                             jnp.float32, "cpu")
    got = SK.scatter_add_dw(torch.from_numpy(idx), torch.from_numpy(val), d,
                            row_scale=torch.from_numpy(dalpha))
    assert got.shape == (d,) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want))
    # the same f32 products as the contribution tensor, summed the same way
    assert torch.equal(got, SK.scatter_add_plain(
        torch.from_numpy(idx), torch.from_numpy(contrib), d))


def test_duplicates_and_pads_count_as_the_formula_says(rng):
    w, idx, val = _layout(rng, 4, 9, 6, 13)
    wx = SK.margin_gather(*map(torch.from_numpy, (w, idx, val))).numpy()
    dw = SK.scatter_add_dw(torch.from_numpy(idx), torch.from_numpy(val),
                           13).numpy()
    ref_wx = np.zeros((4, 9))
    ref_dw = np.zeros(13)
    for c, h, l in np.ndindex(idx.shape):
        ref_wx[c, h] += float(w[idx[c, h, l]]) * float(val[c, h, l])
        ref_dw[idx[c, h, l]] += float(val[c, h, l])
    np.testing.assert_allclose(wx, ref_wx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw, ref_dw, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_versions(rng):
    w, idx, val = map(torch.from_numpy, _layout(rng, 3, 5, 4, 20))
    before = dict(SK.LAUNCHES)
    assert torch.equal(SK.margin_gather(w, idx, val),
                       SK.margin_gather_plain(w, idx, val))
    assert torch.equal(SK.scatter_add_dw(idx, val, 20),
                       SK.scatter_add_plain(idx, val, 20))
    assert SK.LAUNCHES == before  # no kernel launched on the CPU


def test_wrappers_refuse_other_devices_and_bad_arguments(rng):
    w, idx, val = map(torch.from_numpy, _layout(rng, 2, 3, 4, 10))
    for fn, args in ((SK.margin_gather, (w.to("meta"), idx.to("meta"),
                                         val.to("meta"))),
                     (SK.scatter_add_dw, (idx.to("meta"), val.to("meta"),
                                          10))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args)
    with pytest.raises(TypeError, match="int32"):
        SK.margin_gather(w, idx.long(), val)
    with pytest.raises(TypeError, match="int32"):
        SK.scatter_add_dw(idx.long(), val, 10)
    with pytest.raises(ValueError, match="one shape"):
        SK.margin_gather(w, idx, val[..., :2])
    with pytest.raises(ValueError, match="one shape"):
        SK.scatter_add_dw(idx, val[:1], 10)
    with pytest.raises(ValueError, match=r"w \(d,\)"):
        SK.margin_gather(w[None], idx, val)
    with pytest.raises(ValueError, match="d must be"):
        SK.scatter_add_dw(idx, val, -1)


def test_scatter_add_refuses_a_row_scale_it_cannot_take(rng):
    _, idx, val = map(torch.from_numpy, _layout(rng, 2, 3, 4, 10))
    scale = torch.ones(2, 3)
    with pytest.raises(ValueError, match=r"row_scale must have the shape "
                                         r"\(2, 3\)"):
        SK.scatter_add_dw(idx, val, 10, row_scale=scale[:, :2])
    with pytest.raises(ValueError, match="row_scale must have the shape"):
        SK.scatter_add_dw(idx, val, 10, row_scale=torch.ones(2, 3, 4))
    with pytest.raises(TypeError, match="row_scale must be torch.float32"):
        SK.scatter_add_dw(idx, val, 10, row_scale=scale.double())
    with pytest.raises(ValueError, match="row_scale on meta"):
        SK.scatter_add_dw(idx, val, 10, row_scale=scale.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        SK.scatter_add_dw(idx.to("meta"), val.to("meta"), 10,
                          row_scale=scale.to("meta"))
