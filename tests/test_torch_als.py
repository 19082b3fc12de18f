"""The port's blocked ALS (``flink_ms_tpu_torch/ops/als.py``) against the
JAX package's on the CPU: the host layout array for array, the fit from the
same injected init across the mode matrix, and prediction."""

import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU, see conftest)
import numpy as np
import pytest
import torch

from flink_ms_tpu.ops import als as JA
from flink_ms_tpu.parallel.mesh import make_mesh
from flink_ms_tpu_torch.ops import als as TA


def _ratings(rng, n_users, n_items, nnz, skew):
    if skew == "zipf":
        def draw(n, s):
            w = 1.0 / np.arange(1, n + 1) ** s
            cdf = np.cumsum(w) / w.sum()
            return np.searchsorted(cdf, rng.uniform(size=nnz))

        u, i = draw(n_users, 0.7), draw(n_items, 1.0)
    else:
        u = rng.integers(0, n_users, nnz)
        i = rng.integers(0, n_items, nnz)
    return u + 7, i + 1000, rng.uniform(1.0, 5.0, nnz)


@pytest.mark.parametrize("skew", ["uniform", "zipf"])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_prepare_blocked_equals_reference(rng, D, skew):
    u, i, r = _ratings(rng, 300, 120, 4000, skew)
    want = JA.prepare_blocked(u, i, r, D)
    got = TA.prepare_blocked(u, i, r, D)
    assert got.n_blocks == want.n_blocks and got.nnz == want.nnz
    assert np.array_equal(got.user_ids, want.user_ids)
    assert np.array_equal(got.item_ids, want.item_ids)
    for side in ("u", "i"):
        a, b = getattr(got, side), getattr(want, side)
        assert (a.per_block, a.n_rows, a.widths, a.rows) == \
            (b.per_block, b.n_rows, b.widths, b.rows)
        assert np.array_equal(a.perm, b.perm)
        assert a.count.dtype == b.count.dtype
        assert np.array_equal(a.count, b.count)
        assert len(a.idx) == len(b.idx) == len(a.val) == len(b.val)
        for x, y in zip(a.idx + a.val, b.idx + b.val):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _low_rank(rng, n_users=40, n_items=30, k=4, density=0.6):
    uf = rng.normal(size=(n_users, k))
    itf = rng.normal(size=(n_items, k))
    mask = rng.uniform(size=(n_users, n_items)) < density
    u, i = np.nonzero(mask)
    r = (uf @ itf.T)[u, i]
    if not np.all(np.isin(np.arange(n_users), u)):
        raise AssertionError("every user needs a rating")
    return u, i, r


# (case, config kwargs, environment of both packages, environment of the
#  JAX run only, environment of the port run only)
FIT_CASES = [
    ("explicit-weighted", {}, {}, {}, {}),
    ("explicit-plain-lambda", {"weighted_reg": False}, {}, {}, {}),
    ("implicit", {"implicit": True, "alpha": 2.0}, {}, {}, {}),
    ("fused", {}, {"FLINK_MS_ALS_FUSED": "1"}, {}, {}),
    ("fused-chunked", {}, {"FLINK_MS_ALS_FUSED": "1",
                           "FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES": "20000"},
     {}, {}),
    ("fused-chunked-implicit", {"implicit": True, "alpha": 2.0},
     {"FLINK_MS_ALS_FUSED": "1",
      "FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES": "20000"}, {}, {}),
    ("chunked-assembly", {},
     {"FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES": "4000"}, {}, {}),
    # the port has one assembly and one solve, the kernels' wrappers; the
    # reference is held to it in each of its selections
    ("assembly-kernel", {}, {}, {"FLINK_MS_ALS_ASSEMBLY": "pallas"}, {}),
    ("assembly-kernel-vs-xla", {}, {}, {"FLINK_MS_ALS_ASSEMBLY": "xla"}, {}),
    ("jax-pallas-solver", {}, {"FLINK_MS_ALS_SOLVER": "pallas"}, {}, {}),
    ("jax-lax-solver", {}, {}, {"FLINK_MS_ALS_SOLVER": "lax"}, {}),
    ("bf16-exchange", {"exchange_dtype": "bfloat16"}, {}, {}, {}),
    ("fused-bf16-exchange", {"exchange_dtype": "bfloat16"},
     {"FLINK_MS_ALS_FUSED": "1"}, {}, {}),
    ("implicit-bf16-exchange", {"implicit": True, "alpha": 2.0,
                                "exchange_dtype": "bfloat16"}, {}, {}, {}),
]


@pytest.mark.parametrize("case,cfg,env,jax_env,port_env", FIT_CASES,
                         ids=[c[0] for c in FIT_CASES])
def test_fit_matches_reference(rng, monkeypatch, case, cfg, env, jax_env,
                               port_env):
    u, i, r = _low_rank(rng)
    k = 4
    uf0 = rng.normal(size=(40, k)).astype(np.float32)
    itf0 = rng.normal(size=(30, k)).astype(np.float32)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    with monkeypatch.context() as m:
        for key, val in jax_env.items():
            m.setenv(key, val)
        want = JA.als_fit(u, i, r, JA.ALSConfig(num_factors=k, iterations=3,
                                                lambda_=0.1, **cfg),
                          make_mesh(1), init=(uf0, itf0))
    with monkeypatch.context() as m:
        for key, val in port_env.items():
            m.setenv(key, val)
        got = TA.als_fit(u, i, r, TA.ALSConfig(num_factors=k, iterations=3,
                                               lambda_=0.1, **cfg),
                         device="cpu", init=(uf0, itf0))
    # the reference's factor tolerance (tests/test_cholesky_pallas.py)
    np.testing.assert_allclose(got.user_factors.numpy(), want.user_factors,
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.item_factors.numpy(), want.item_factors,
                               rtol=1e-3, atol=1e-5)


def test_predict_and_rmse_match_reference(rng):
    u, i, r = _low_rank(rng)
    init = (rng.normal(size=(40, 4)).astype(np.float32),
            rng.normal(size=(30, 4)).astype(np.float32))
    want = JA.als_fit(u, i, r, JA.ALSConfig(num_factors=4, iterations=4,
                                            lambda_=0.1), make_mesh(1),
                      init=init)
    got = TA.als_fit(u, i, r, TA.ALSConfig(num_factors=4, iterations=4,
                                           lambda_=0.1), device="cpu",
                     init=init)
    pu = np.concatenate([u[:50], [999, 3]])  # unknown user, then unknown item
    pi = np.concatenate([i[:50], [2, 999]])
    p_t = TA.predict(got, pu, pi, device="cpu")
    p_j = JA.predict(want, pu, pi)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-3, atol=1e-4)
    assert p_t[-2] == 0.0 and p_t[-1] == 0.0
    assert abs(TA.rmse(got, u, i, r, device="cpu")
               - JA.rmse(want, u, i, r)) < 1e-4


def test_model_from_arrays_reproduces_jax_predict(rng, monkeypatch):
    u, i, r = _low_rank(rng)
    jm = JA.als_fit(u, i, r, JA.ALSConfig(num_factors=4, iterations=3,
                                          lambda_=0.1), make_mesh(1))
    tm = TA.model_from_arrays(jm.user_ids, jm.item_ids, jm.user_factors,
                              jm.item_factors, device="cpu")
    assert tm.user_factors.device.type == "cpu" and tm.num_factors == 4
    monkeypatch.setenv("FLINK_MS_PREDICT_CHUNK", "97")  # several chunks
    # the same f32 products, summed over k = 4 in possibly another order
    np.testing.assert_allclose(TA.predict(tm, u, i, device="cpu"),
                               JA.predict(jm, u, i), rtol=1e-6, atol=1e-6)


def test_dummy_slots_stay_zero(rng):
    u, i, r = _low_rank(rng)
    problem = TA.prepare_blocked(u, i, r, 1)
    fit_fn, args = TA.compile_fit(problem, TA.ALSConfig(num_factors=4),
                                  "cpu")
    uf, itf = fit_fn(3, *args)
    assert torch.equal(uf[-1], torch.zeros(4))
    assert torch.equal(itf[-1], torch.zeros(4))
    # the seeded init is reproducible and leaves the inputs untouched
    again = TA.compile_fit(problem, TA.ALSConfig(num_factors=4), "cpu")[1]
    assert torch.equal(again[0], args[0]) and torch.equal(again[1], args[1])
    assert torch.equal(fit_fn(3, *args)[0], uf)


def test_compile_fit_runs_one_block(rng):
    # outside a process group the mesh is one rank: a layout for two
    # blocks is refused, naming the block count that runs
    u, i, r = _low_rank(rng)
    with pytest.raises(ValueError, match=r"n_blocks=1\)"):
        TA.compile_fit(TA.prepare_blocked(u, i, r, 2),
                       TA.ALSConfig(num_factors=4), "cpu")


def test_warm_start(rng):
    u, i, r = _low_rank(rng)
    problem = TA.prepare_blocked(u, i, r, 1)
    prev_u = {int(problem.user_ids[0]): np.full(4, 0.5)}
    uf, itf = TA.warm_start_factors(problem.user_ids, problem.item_ids,
                                    prev_u, {}, 4, seed=3)
    assert np.array_equal(uf[0], np.full(4, 0.5, np.float32))
    assert uf.dtype == np.float32 and itf.shape == (30, 4)
    cfg = TA.ALSConfig(num_factors=4, iterations=0)
    model = TA.als_fit(u, i, r, cfg, device="cpu", problem=problem,
                       init_user_factors=uf, init_item_factors=itf)
    assert np.array_equal(model.user_factors.numpy(), uf)
    assert np.array_equal(model.item_factors.numpy(), itf)
    with pytest.raises(ValueError, match="together"):
        TA.als_fit(u, i, r, cfg, device="cpu", init_user_factors=uf)
    with pytest.raises(ValueError, match="exclusive"):
        TA.als_fit(u, i, r, cfg, device="cpu", init=(uf, itf),
                   init_user_factors=uf, init_item_factors=itf)
    with pytest.raises(ValueError, match="shapes"):
        TA.als_fit(u, i, r, cfg, device="cpu", init_user_factors=uf[:3],
                   init_item_factors=itf)


@pytest.mark.parametrize("var,value", [
    ("FLINK_MS_ALS_BUCKET_RATIO", "1.0"),
    ("FLINK_MS_ALS_BUCKET_RATIO", "20"),
    ("FLINK_MS_ALS_BUCKET_RATIO", "wide"),
])
def test_selection_variables_are_validated(rng, monkeypatch, var, value):
    u, i, r = _low_rank(rng)
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError, match=var):
        TA.als_fit(u, i, r, TA.ALSConfig(num_factors=4, iterations=1),
                   device="cpu")


ROUTE_CASES = [
    ("unfused", {}),
    ("chunked-assembly", {"FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES": "1000"}),
    ("fused", {"FLINK_MS_ALS_FUSED": "1"}),
    ("fused-chunked", {"FLINK_MS_ALS_FUSED": "1",
                       "FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES": "2000"}),
]


@pytest.mark.parametrize("case,env", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_sweep_runs_through_the_kernel_wrappers(rng, monkeypatch, case, env):
    """Every bucket row is assembled and every system solved by the
    kernels' wrappers, which launch the kernels on the card; the fused
    mode's chunked solves take the batch-major entry, as in the
    reference."""
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    asm_rows, solves = [], []
    real_asm, real_solve = TA.fused_bucket_assembly, TA.cholesky_solve_batched

    def asm(y_all, idx, val, *args, **kwargs):
        asm_rows.append(idx.shape[0])
        return real_asm(y_all, idx, val, *args, **kwargs)

    def solve(A, b, layout=None):
        solves.append((A.shape[0], layout))
        return real_solve(A, b, layout=layout)

    monkeypatch.setattr(TA, "fused_bucket_assembly", asm)
    monkeypatch.setattr(TA, "cholesky_solve_batched", solve)
    u, i, r = _low_rank(rng)
    problem = TA.prepare_blocked(u, i, r, 1)
    fit_fn, args = TA.compile_fit(problem, TA.ALSConfig(num_factors=4), "cpu")
    fit_fn(1, *args)
    n_rows = sum(problem.u.rows) + sum(problem.i.rows)
    n_buckets = len(problem.u.widths) + len(problem.i.widths)
    assert sum(asm_rows) == n_rows
    assert (len(asm_rows) > n_buckets) == ("chunked" in case)
    if case.startswith("fused"):
        # one solve per assembled chunk; the dummy slots are not solved
        assert [n for n, _ in solves] == asm_rows
        want = {"batch_major"} if "chunked" in case else {None}
        assert {layout for _, layout in solves} == want
    else:
        assert solves == [(problem.u.per_block, None),
                          (problem.i.per_block, None)]


def test_resolve_exchange():
    assert TA.resolve_exchange("auto") is None
    assert TA.resolve_exchange(None) is None
    assert TA.resolve_exchange("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        TA.resolve_exchange("int8")


@pytest.mark.parametrize("chunk_bytes", [None, "1500"])
@pytest.mark.parametrize("implicit", [False, True])
def test_assemble_normal_eqs_fills_one_tensor(rng, monkeypatch, chunk_bytes,
                                              implicit):
    """Every bucket is assembled straight into its rows of one
    (per_block, k, k) system tensor, chunked or not, with no torch.cat:
    the result equals the buckets' own assemblies joined, the zero dummy
    system last."""
    if chunk_bytes:
        monkeypatch.setenv("FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES", chunk_bytes)
    u, i, r = _low_rank(rng)
    problem = TA.prepare_blocked(u, i, r, 1)
    y = torch.from_numpy(rng.normal(size=(problem.i.per_block, 4))
                         .astype(np.float32))
    y[-1] = 0.0
    buckets = [(torch.from_numpy(problem.u.idx[j][0]),
                torch.from_numpy(problem.u.val[j][0].astype(np.float32)))
               for j in range(len(problem.u.widths))]
    parts = [TA.fused_bucket_assembly(y, idx, val, implicit=implicit,
                                      alpha=2.0) for idx, val in buckets]
    want_A = torch.cat([p[0] for p in parts] + [torch.zeros(1, 4, 4)])
    want_b = torch.cat([p[1] for p in parts] + [torch.zeros(1, 4)])

    def no_cat(*args, **kwargs):
        raise AssertionError("torch.cat joined the buckets")

    monkeypatch.setattr(TA.torch, "cat", no_cat)
    A, b = TA._assemble_normal_eqs(y, buckets, implicit, 2.0, torch.float32)
    assert A.shape == (problem.u.per_block, 4, 4)
    assert torch.equal(A, want_A) and torch.equal(b, want_b)
    assert torch.equal(A[-1], torch.zeros(4, 4))
