"""The byte and operation counts behind ``chip_smoke.py``'s bounds, and
its copy of the RCV1-shaped workload."""

import numpy as np
import pytest

import chip_smoke


@pytest.mark.parametrize("k", [1, 3, 8, 50, 64, 100])
@pytest.mark.parametrize("n", [1, 9, 17])
def test_lower_triangle_bytes_counts_each_sector_once(n, k):
    # every f32 of the lower triangles, diagonal included, of n row-major
    # k x k matrices stored back to back, by the 32-byte sector it lies in
    sectors = {(m * k * k + p * k + q) * 4 // 32
               for m in range(n) for p in range(k) for q in range(p + 1)}
    assert chip_smoke.lower_triangle_bytes(n, k) == 32 * len(sectors)


def test_assembly_flops_count_the_symmetric_half():
    # k = 2: A's lower triangle is 3 multiply-adds, b is 2, per rating
    assert chip_smoke.assembly_flops(10, 2) == 10 * 2 * (3 + 2)
    assert chip_smoke.assembly_flops(0, 50) == 0


@pytest.mark.parametrize("rows,L,d", [(1, 1, 1), (704_512, 70, 47_236),
                                      (15, 33, 1000)])
def test_svm_kernel_byte_counts(rows, L, d):
    # margin gather: int32 idx + f32 val per slot, f32 w, f32 margin per row
    assert chip_smoke.margin_gather_bytes(rows, L, d) == \
        rows * L * (4 + 4) + d * 4 + rows * 4
    # scatter-add: int32 idx + f32 contrib per entry, f32 (d,) out
    assert chip_smoke.scatter_add_bytes(rows * L, d) == \
        rows * L * (4 + 4) + d * 4


def test_rcv1_shape_bounds_are_about_0_12_ms():
    rows = 8192 * 86  # K chains x rows per chain at n = 700,000
    for nbytes in (chip_smoke.margin_gather_bytes(rows, 70, 47_236),
                   chip_smoke.scatter_add_bytes(rows * 70, 47_236)):
        ms = nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
        assert 0.117 < ms < 0.119


def test_synth_rcv1_equals_the_bench_copy():
    import bench_sections

    got = chip_smoke.synth_rcv1(500, 300, 7, seed=2)
    want = bench_sections.synth_rcv1(500, 300, 7, seed=2, flip_p=0.05)
    for name in ("labels", "indptr", "indices", "values"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.n_features == want.n_features == 300


def test_bounds_of_the_ml20m_user_half_sweep():
    # PERF.md's bounds of the user half-sweep: the assembly by its 53.0
    # GFLOP, the solve by the 0.928 GB of its lower triangles, b and x
    k = 50
    asm_ms, asm_by = chip_smoke.bound(
        chip_smoke.assembly_flops(20_000_000, k),
        chip_smoke.assembly_bytes(138_493, 24_836_712, 26_745 * k, k))
    sol_ms, sol_by = chip_smoke.bound(chip_smoke.solve_flops(138_494, k),
                                      chip_smoke.solve_bytes(138_494, k))
    assert asm_by == "operations" and 0.790 < asm_ms < 0.792
    assert sol_by == "bytes" and 0.276 < sol_ms < 0.278


def test_row_scale_scatter_add_bytes_at_rcv1():
    # the row-scale form reads idx and the values of every entry and the
    # (C, H) scale, and writes the (d,) sum
    rows, n, d = 8192 * 86, 8192 * 86 * 70, 47_236
    nbytes = chip_smoke.scatter_add_bytes(n, d, rows)
    assert nbytes == n * (4 + 4) + rows * 4 + d * 4
    assert round(nbytes / 1e9, 4) == 0.3975
    ms, by = chip_smoke.bound(2 * n, nbytes)
    assert by == "bytes" and round(ms, 4) == 0.1187


SMS, MAX_D = 132, 58_112  # an H100's SMs and shared-memory floats


@pytest.mark.parametrize("d", [1, 47_236, MAX_D - 1, MAX_D, MAX_D + 1,
                               1_355_191])
@pytest.mark.parametrize("rows", [1, 259, 704_512])
def test_margin_plan_tiles_whole_lines(rows, d):
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    for L in range(1, 129):
        plan = SK.margin_plan(rows, L, d, SMS, MAX_D)
        # whole 128-entry lines per tile, so every tile starts on the
        # 16-byte grid; the fewest rows that do so
        assert plan.tile_rows * L % 128 == 0
        assert all(r * L % 128 for r in range(1, plan.tile_rows))
        assert plan.lines == plan.tile_rows * L // 128 >= 1
        assert (plan.tiles - 1) * plan.tile_rows < rows
        assert plan.tiles * plan.tile_rows >= rows
        # one warp per tile at a time, no block without a tile, at most
        # one block per SM
        warps = plan.threads // 32
        assert 1 <= plan.blocks <= SMS
        assert (plan.blocks - 1) * warps < plan.tiles
        assert plan.shared_w == (d <= MAX_D)
        assert plan.smem_bytes == (4 * d if d <= MAX_D else 0)
        assert plan.smem_bytes <= 4 * MAX_D
    assert SK.margin_plan(704_512, 70, 47_236, SMS, MAX_D) == SK.MarginPlan(
        True, 64, 35, 11_008, 132, 1024, 188_944)


@pytest.mark.parametrize("d", [1, 47_236, MAX_D, MAX_D + 1, 1_355_191])
@pytest.mark.parametrize("n", [1, 3, 9_000, 49_315_840])
def test_scatter_plan_branch_and_grid(n, d):
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    plan = SK.scatter_plan(n, d, SMS, MAX_D)
    assert plan.shared == (d <= MAX_D)
    assert plan.blocks >= 1
    if plan.shared:
        # each block zeroes and flushes all d bins: at most one per SM and
        # none without a step of entries
        per_step = plan.threads * 4  # one 16-byte vector a thread
        assert plan.blocks <= SMS
        assert (plan.blocks - 1) * per_step < n
        assert plan.smem_bytes == 4 * d <= 4 * MAX_D
    else:
        assert plan.blocks <= 16 * SMS and plan.smem_bytes == 0


def test_margin_plan_refuses_a_tile_past_32_bits():
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    # the kernel counts a tile's entries in 32 bits: 128 rows of an odd L
    assert SK.margin_plan(1, (1 << 25) - 1, 10, SMS, MAX_D).tile_rows == 128
    with pytest.raises(ValueError, match="too long"):
        SK.margin_plan(1, (1 << 25) + 1, 10, SMS, MAX_D)


# -- phases 10 and 11, rehearsed on the CPU at small sizes --------------------


def test_make_catalog_equals_the_ann_profile_copy(monkeypatch):
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "ann_profile", os.path.join(root, "scripts", "ann_profile.py"))
    script = importlib.util.module_from_spec(spec)
    with monkeypatch.context() as m:
        # the script pins these at import; keep its pins out of the session
        m.setenv("TPUMS_TOPK_PLATFORM", "cpu")
        m.setenv("JAX_PLATFORMS", "cpu")
        spec.loader.exec_module(script)
    for n, d in ((5000, 16), (40_000, 8)):
        got, want = chip_smoke.make_catalog(n, d), script.make_catalog(n, d)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_topk_agrees_allows_only_near_ties():
    s64 = np.array([5.0, 9.0, 7.0, 7.0 + 1e-7, 1.0, 3.0])
    assert chip_smoke.topk_agrees([1, 3, 2], s64, 3) == (True, True)
    # the near-tied pair in either order, and at the k-th place
    assert chip_smoke.topk_agrees([1, 2, 3], s64, 3) == (True, False)
    assert chip_smoke.topk_agrees([1, 2], s64, 2) == (True, False)
    assert chip_smoke.topk_agrees([1, 0, 2], s64, 3)[0] is False
    assert chip_smoke.topk_agrees([1, 3, 3], s64, 3)[0] is False
    assert chip_smoke.topk_agrees([1, 3], s64, 3)[0] is False


@pytest.fixture
def small_model():
    from flink_ms_tpu_torch.ops import als as TA

    rng = np.random.default_rng(0)
    ratings = (rng.integers(0, 300, 20_000), rng.integers(0, 1_500, 20_000),
               rng.uniform(1, 5, 20_000))
    model = TA.als_fit(*ratings, TA.ALSConfig(num_factors=8, iterations=3,
                                              lambda_=0.1), "cpu")
    return model, ratings, TA.rmse(model, *ratings, "cpu")


def test_serve_phase_rehearsal(small_model, capsys):
    import torch

    model, ratings, rmse = small_model
    out = chip_smoke.serve_phase(torch, {"model": model}, ratings, rmse,
                                 torch.device("cpu"))
    assert out["p50_ms"] > 0 and out["qps"] > 0
    logs = capsys.readouterr().out
    assert "256 agree" in logs and "256 of 256 replies equal" in logs
    assert "in-place updates +1000, full builds +0" in logs
    assert "relative gap" in logs


@pytest.fixture
def small_scale(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SCALE_EXACT_ROWS", 20_000)
    monkeypatch.setattr(chip_smoke, "SCALE_IVF_ROWS", 60_000)
    monkeypatch.setattr(chip_smoke, "IVF_ENV", {
        "TPUMS_TOPK_TIER": "ivf", "TPUMS_ANN_NLIST": "128",
        "TPUMS_ANN_NPROBE": "16", "TPUMS_ANN_MIN_ROWS": "1000"})


def test_serve_scale_phase_rehearsal(small_scale, capsys):
    import torch

    out = chip_smoke.serve_scale_phase(torch, torch.device("cpu"))
    assert set(out) == {"exact_1m", "ivf_10m", "exact_10m"}
    logs = capsys.readouterr().out
    assert "64 top-100 lists against a float64 re-rank" in logs
    assert "serves exact" in logs and "serves ivf" in logs


def test_serve_scale_phase_fails_without_the_ivf_tier(small_scale,
                                                      monkeypatch):
    import torch

    from flink_ms_tpu_torch.serve.ann import IVFIndex

    def broken(*a, **kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(IVFIndex, "build", broken)
    with pytest.raises(chip_smoke.SmokeFailure, match="IVF tier was not "
                                                      "built"):
        chip_smoke.serve_scale_phase(torch, torch.device("cpu"))
