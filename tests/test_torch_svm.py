"""The port's CoCoA SVM (``flink_ms_tpu_torch/ops/svm.py``) against the JAX
package's on the CPU: the host layout array for array, the fit with the
reference's own threefry step indices injected across engines, modes and
the reference's round-boundary selections, a fit continued from the
reference's state, segmenting, the port's own generator, and mode names
the port refuses (typos)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ms_tpu.core import formats as JF
from flink_ms_tpu.ops import svm as JS
from flink_ms_tpu.parallel.mesh import make_mesh
from flink_ms_tpu_torch.core import formats as TF
from flink_ms_tpu_torch.ops import svm as TS
from flink_ms_tpu_torch.ops import svm_kernels as SK


def _data(rng, n=300, d=120, nnz=8, flip=0.1, ragged=True):
    """RCV1-like rows: features drawn with replacement (duplicate ids in a
    row), optionally ragged row lengths (some empty), labels from a sparse
    teacher with flips.  -> (JAX SparseData, port SparseData)."""
    lens = rng.integers(0, nnz + 1, n) if ragged else np.full(n, nnz)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    idx = rng.integers(0, d, indptr[-1])
    val = rng.normal(size=indptr[-1]) / np.sqrt(nnz)
    w_true = rng.normal(size=d)
    starts = np.minimum(indptr[:-1], max(len(idx) - 1, 0))
    margin = np.add.reduceat(val * w_true[idx], starts)
    margin[lens == 0] = 0.0
    y = np.sign(margin)
    y[y == 0] = 1
    y = np.where(rng.uniform(size=n) < flip, -y, y)
    fields = dict(labels=y, indptr=indptr, indices=idx, values=val,
                  n_features=d)
    return JF.SparseData(**fields), TF.SparseData(**fields)


def jax_steps(seed, start, rounds, C, H, rows):
    """The reference's step indices for rounds [start, start + rounds):
    randint(fold_in(fold_in(fold_in(PRNGKey(seed), chain), round), step),
    (), 0, rows) (``flink_ms_tpu/ops/svm.py:298,332,425-435``) ->
    (rounds, C, H) int32.  If this formula were wrong, the fit tests below
    would fail, so it checks itself."""
    base = jax.random.PRNGKey(np.uint32(seed))

    def one(r, c, h):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.fold_in(base, c), r), h)
        return jax.random.randint(key, (), 0, rows)

    grid = jax.vmap(jax.vmap(jax.vmap(one, (None, None, 0)), (None, 0, None)),
                    (0, None, None))
    return np.asarray(grid(jnp.arange(start, start + rounds, dtype=jnp.int32),
                           jnp.arange(C, dtype=jnp.int32),
                           jnp.arange(H, dtype=jnp.int32)))


def _close(got, want):
    # the repo's cross-engine tolerance (tests/test_svm.py:275)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("ragged", [True, False])
def test_prepare_svm_blocked_equals_reference(rng, K, ragged):
    jd, td = _data(rng, n=203, ragged=ragged)
    want = JS.prepare_svm_blocked(jd, K, seed=3)
    got = TS.prepare_svm_blocked(td, K, seed=3)
    assert (got.n_blocks, got.n_examples, got.n_features,
            got.rows_per_block) == (want.n_blocks, want.n_examples,
                                    want.n_features, want.rows_per_block)
    for name in ("idx", "val", "label", "sq_norm"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _configs(H, rounds, **kw):
    return (JS.SVMConfig(iterations=rounds, local_iterations=H, **kw),
            TS.SVMConfig(iterations=rounds, local_iterations=H, **kw))


# (case, config kwargs, environment of the JAX run only)
PALLAS = {"FLINK_MS_SVM_WX0": "pallas", "FLINK_MS_SVM_DW": "pallas"}
FIT_CASES = [
    (f"{inner}-{name}{'-jax-pallas' if env else ''}",
     dict(inner=inner, **kw), env)
    for inner in ("scatter", "gram")
    for name, kw in (("avg", dict(mode="avg")),
                     ("add-sigma", dict(mode="add", sigma_prime=4.0)),
                     ("add-safe", dict(mode="add")))
    for env in (({}, PALLAS) if inner == "gram" else ({},))
]


@pytest.mark.parametrize("case,cfg,jax_env", FIT_CASES,
                         ids=[c[0] for c in FIT_CASES])
def test_fit_matches_reference(rng, monkeypatch, case, cfg, jax_env):
    jd, td = _data(rng)
    K, rounds = 8, 4
    pj = JS.prepare_svm_blocked(jd, K, seed=0)
    pt = TS.prepare_svm_blocked(td, K, seed=0)
    H = pj.rows_per_block
    jc, tc = _configs(H, rounds, regularization=1e-2, **cfg)
    with monkeypatch.context() as m:
        for key, val in jax_env.items():
            m.setenv(key, val)
        want_w = JS.svm_fit(jd, jc, make_mesh(1), problem=pj).weights
        fit, dev_args = JS.compile_svm_fit(pj, jc, make_mesh(1))
        _, want_a = fit(jnp.asarray(rounds, jnp.int32), *dev_args)
    steps = jax_steps(0, 0, rounds, K, H, H)
    got = TS.svm_fit(td, tc, device="cpu", problem=pt, steps=steps)
    assert got.weights.dtype == np.float64
    _close(got.weights, want_w)
    fit_t, args_t = TS.compile_svm_fit(pt, tc, device="cpu")
    w_t, a_t = fit_t(rounds, *args_t, steps=steps)
    _close(w_t.numpy(), want_w)
    _close(a_t.numpy(), np.asarray(want_a))
    assert np.abs(want_w).max() > 0.1  # the fit moved


def test_svm_fit_without_problem_blocks_by_device_count(rng):
    """No `problem`: the reference blocks by its mesh's device count, not
    by a block count (``flink_ms_tpu/ops/svm.py:668-669``); the port's mesh
    is one card, so one chain holds every row."""
    jd, td = _data(rng, n=120)
    jc, tc = _configs(40, 3, regularization=1e-2)
    want = JS.svm_fit(jd, jc, make_mesh(1)).weights
    steps = jax_steps(0, 0, 3, 1, 40, 120)
    got = TS.svm_fit(td, tc, device="cpu", steps=steps).weights
    _close(got, want)


@pytest.mark.parametrize("inner", ["gram", "scatter"])
def test_fit_continues_from_reference_state(rng, inner):
    """The port takes over the reference's (w, alpha) after 4 rounds and
    runs rounds 4..6 with ``start=4``: the result equals the reference's
    7-round fit."""
    jd, td = _data(rng)
    K = 8
    pj = JS.prepare_svm_blocked(jd, K, seed=0)
    pt = TS.prepare_svm_blocked(td, K, seed=0)
    H = pj.rows_per_block
    jc, tc = _configs(H, 7, regularization=1e-2, mode="add",
                      sigma_prime=4.0, inner=inner)
    fit_j, args_j = JS.compile_svm_fit(pj, jc, make_mesh(1))
    w4, a4 = fit_j(jnp.asarray(4, jnp.int32), *args_j)
    w7, a7 = fit_j(jnp.asarray(7, jnp.int32), *args_j)
    fit_t, args_t = TS.compile_svm_fit(pt, tc, device="cpu")
    args_t[0] = torch.from_numpy(np.array(w4))
    args_t[5] = torch.from_numpy(np.array(a4))
    w, a = fit_t(3, *args_t, start=4, steps=jax_steps(0, 4, 3, K, H, H))
    _close(w.numpy(), np.asarray(w7))
    _close(a.numpy(), np.asarray(a7))


@pytest.mark.parametrize("inner", ["gram", "scatter"])
def test_segmented_fit_bit_identical_to_one_shot(rng, inner):
    """4 + 3 + 3 rounds chained through ``start=`` equal 10 rounds bit for
    bit on the CPU: each round's step table depends on (seed, absolute
    round) only, and the plain scatter-add runs in a fixed order."""
    _, td = _data(rng)
    p = TS.prepare_svm_blocked(td, 8, seed=0)
    cfg = TS.SVMConfig(iterations=10, local_iterations=p.rows_per_block,
                       regularization=1e-2, mode="add", sigma_prime=4.0,
                       seed=5, inner=inner)
    fit, dev_args = TS.compile_svm_fit(p, cfg, device="cpu")
    w_one, a_one = fit(10, *dev_args)
    w, a = dev_args[0], dev_args[5]
    for start, n in ((0, 4), (4, 3), (7, 3)):
        args = list(dev_args)
        args[0], args[5] = w, a
        w, a = fit(n, *args, start=start)
    assert torch.equal(w, w_one) and torch.equal(a, a_one)
    assert not torch.equal(dev_args[0], w_one)  # dev_args left as they were
    # the table is a function of (seed, round) alone
    assert torch.equal(TS.draw_steps(5, 7, 8, 30, 12),
                       TS.draw_steps(5, 7, 8, 30, 12))
    assert not torch.equal(TS.draw_steps(5, 7, 8, 30, 12),
                           TS.draw_steps(5, 8, 8, 30, 12))
    assert not torch.equal(TS.draw_steps(5, 7, 8, 30, 12),
                           TS.draw_steps(6, 7, 8, 30, 12))


@pytest.mark.parametrize("mode,sigma", [("add", 4.0), ("avg", None)])
def test_own_generator_reaches_reference_objective(rng, mode, sigma):
    """Without injected steps the port draws its own: at equal rounds its
    objective is within 5% of the reference's."""
    jd, td = _data(rng, n=800, d=300, nnz=10)
    K, rounds = 16, 10
    pj = JS.prepare_svm_blocked(jd, K, seed=0)
    pt = TS.prepare_svm_blocked(td, K, seed=0)
    jc, tc = _configs(pj.rows_per_block, rounds, regularization=1e-3,
                      mode=mode, sigma_prime=sigma)
    want = JS.svm_fit(jd, jc, make_mesh(1), problem=pj).hinge_loss(jd, 1e-3)
    got = TS.svm_fit(td, tc, device="cpu", problem=pt).hinge_loss(td, 1e-3)
    assert got < 1.0 and want < 1.0
    assert abs(got - want) <= 0.05 * want, (got, want)


def test_gram_engine_runs_both_kernel_wrappers(rng, monkeypatch):
    """Each gram round calls ``margin_gather`` once and ``scatter_add_dw``
    once (their plain versions on the CPU); the scatter engine calls
    neither."""
    calls = {"margin": 0, "scatter": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TS, "margin_gather", count("margin", SK.margin_gather))
    monkeypatch.setattr(TS, "scatter_add_dw",
                        count("scatter", SK.scatter_add_dw))
    _, td = _data(rng, n=100)
    p = TS.prepare_svm_blocked(td, 4, seed=0)
    for inner, want in (("gram", 3), ("scatter", 0)):
        calls.update(margin=0, scatter=0)
        cfg = TS.SVMConfig(iterations=3, local_iterations=5, inner=inner)
        TS.svm_fit(td, cfg, device="cpu", problem=p)
        assert calls == {"margin": want, "scatter": want}, inner


def test_gram_round_scales_rows_in_the_scatter_add(rng, monkeypatch):
    """The gram engine hands ``scatter_add_dw`` the device's (C, H, L)
    values themselves and the (C, H) Δα as ``row_scale``: no operation of
    the round outside the two kernel wrappers makes a (C, H, L) tensor, so
    the contribution val * Δα is not built.  The result is the scatter-add
    of that contribution, bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, td = _data(rng, n=100)
    p = TS.prepare_svm_blocked(td, 4, seed=0)
    shape = tuple(p.idx.shape)
    made, seen = [], []
    paused = [False]

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not paused[0]:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor) and tuple(t.shape) == shape:
                        made.append(str(func))
            return out

    def unrecorded(fn, *a, **kw):
        paused[0] = True
        try:
            return fn(*a, **kw)
        finally:
            paused[0] = False

    def margin(*a):  # its plain version gathers a (C, H, L) tensor
        return unrecorded(SK.margin_gather, *a)

    def scatter(idx, vals, d, row_scale=None):
        # on the CPU the wrapper's plain version builds it; the kernel
        # forms each product in registers
        seen.append((vals, row_scale))
        got = unrecorded(SK.scatter_add_dw, idx, vals, d,
                         row_scale=row_scale)
        want = unrecorded(lambda: SK.scatter_add_plain(
            idx, vals * row_scale[..., None], d))
        assert torch.equal(got, want)
        return got

    monkeypatch.setattr(TS, "margin_gather", margin)
    monkeypatch.setattr(TS, "scatter_add_dw", scatter)
    cfg = TS.SVMConfig(iterations=2, local_iterations=5, inner="gram")
    fit, dev_args = TS.compile_svm_fit(p, cfg, device="cpu")
    with Shapes():
        fit(2, *dev_args)
    assert len(seen) == 2
    for vals, row_scale in seen:
        assert vals is dev_args[2]
        assert row_scale is not None and tuple(row_scale.shape) == shape[:2]
    assert made == [], made


def test_build_gram_equals_dense_product(rng):
    """G[c] = S_c S_cᵀ with duplicate ids accumulated and pads adding
    nothing; a d large enough for one chain per 256 MiB chunk cuts the
    build into several chunks."""
    C, H, L = 3, 4, 5
    for d in (17, 9_000_000):
        idx = rng.integers(0, min(d, 40), (C, H, L)).astype(np.int32)
        idx[:, :, 1] = idx[:, :, 0]
        val = rng.standard_normal((C, H, L)).astype(np.float32)
        val[:, -1, 2:] = 0.0
        dense = np.zeros((C, H, min(d, 40)))
        for c, h, l in np.ndindex(idx.shape):
            dense[c, h, idx[c, h, l]] += val[c, h, l]
        got = TS.build_gram(torch.from_numpy(idx), torch.from_numpy(val), d)
        np.testing.assert_allclose(got.numpy(),
                                   dense @ dense.transpose(0, 2, 1),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("budget,inner", [(None, "gram"), ("1", "scatter")])
def test_auto_engine_gate_matches_reference(rng, monkeypatch, budget, inner):
    if budget is not None:
        monkeypatch.setenv("FLINK_MS_SVM_GRAM_BYTES", budget)
    jd, td = _data(rng, n=100)
    pj = JS.prepare_svm_blocked(jd, 4)
    pt = TS.prepare_svm_blocked(td, 4)
    jc, tc = _configs(5, 1)
    want = JS._resolve_inner(pj, jc, make_mesh(1))
    assert TS._resolve_inner(pt, tc) == want == inner


@pytest.mark.parametrize("var,value,match", [
    ("FLINK_MS_SVM_STEP", "fast", "must be"),
    ("FLINK_MS_SVM_DW", "segment", "must be"),
])
def test_unported_modes_raise(rng, monkeypatch, var, value, match):
    monkeypatch.setenv(var, value)
    _, td = _data(rng, n=50)
    with pytest.raises(ValueError, match=match):
        TS.svm_fit(td, TS.SVMConfig(iterations=1), device="cpu")


@pytest.mark.parametrize("var,value", [
    ("FLINK_MS_SVM_DW", "pallas"), ("FLINK_MS_SVM_DW", "direct"),
    ("FLINK_MS_SVM_WX0", "einsum"), ("FLINK_MS_SVM_STEP", "dynamic"),
])
def test_reference_boundary_selections_change_nothing(rng, monkeypatch, var,
                                                      value):
    _, td = _data(rng, n=80)
    cfg = TS.SVMConfig(iterations=2, local_iterations=6, inner="gram")
    base = TS.svm_fit(td, cfg, device="cpu").weights
    monkeypatch.setenv(var, value)
    assert np.array_equal(TS.svm_fit(td, cfg, device="cpu").weights, base)


def test_injected_steps_are_checked(rng):
    _, td = _data(rng, n=40)
    p = TS.prepare_svm_blocked(td, 2)
    cfg = TS.SVMConfig(iterations=2, local_iterations=3)
    with pytest.raises(ValueError, match=r"steps must be \(2, 2, 3\)"):
        TS.svm_fit(td, cfg, device="cpu", problem=p,
                   steps=np.zeros((2, 2, 4), np.int64))
    with pytest.raises(ValueError, match=r"lie in \[0, 20\)"):
        TS.svm_fit(td, cfg, device="cpu", problem=p,
                   steps=np.full((2, 2, 3), 20))


@pytest.mark.parametrize("kw", [dict(mode="sum"), dict(sigma_prime=0.5),
                                dict(inner="dense")])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        JS.SVMConfig(**kw)
    with pytest.raises(ValueError) as got:
        TS.SVMConfig(**kw)
    assert str(got.value) == str(want.value)


def test_model_objective_matches_reference(rng):
    jd, td = _data(rng, n=60)
    w = rng.normal(size=120)
    np.testing.assert_array_equal(TS.SVMModel(w).decision_function(td),
                                  JS.SVMModel(w).decision_function(jd))
    assert TS.SVMModel(w).hinge_loss(td, 0.1) == \
        JS.SVMModel(w).hinge_loss(jd, 0.1)
