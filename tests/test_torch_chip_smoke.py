"""The byte and operation counts behind ``chip_smoke.py``'s bounds, its
copies of the benchmark workloads, and rehearsals of its phases 10 to 15
on the CPU at small sizes."""

import numpy as np
import pytest
import torch

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
    model, ratings, rmse = small_model
    out = chip_smoke.serve_phase(torch, {"model": model}, ratings, rmse,
                                 torch.device("cpu"))
    assert out["p50_ms"] > 0 and out["qps"] > 0
    logs = capsys.readouterr().out
    assert "256 agree" in logs and "256 of 256 replies equal" in logs
    assert "in-place updates +1000, full builds +0" in logs
    assert "relative gap" in logs


@pytest.fixture
def small_job(monkeypatch):
    for name, value in (("JOB_TOPK_USERS", 32), ("JOB_LATENCY_CALLS", 50),
                        ("JOB_HARNESS_QUERIES", 50), ("JOB_MSE_RATINGS", 2000),
                        ("JOB_SGD_RATINGS", 400), ("JOB_SAMPLE", 16),
                        ("JOB_CHECKPOINT_MS", 300), ("JOB_WAIT_S", 60.0),
                        ("JOB_PUSH_USERS", 32), ("JOB_PUSH_KEYS", 16),
                        ("JOB_PUSH_BATCHES", 6), ("JOB_PUSH_ROWS", 20),
                        ("JOB_SEGMENT_BYTES", 1 << 16),
                        ("JOB_SNAPSHOT_MIN_BYTES", 1),
                        ("JOB_COMPACT_MODELS",
                         ("model", "model-served", "model-served"))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setenv("TPUMS_HEARTBEAT_S", "0.1")


def test_serving_job_phase_rehearsal(small_model, small_job, capsys):
    """Phase 17 on the CPU: the job is a subprocess with ``--device cpu``."""
    model, ratings, _ = small_model
    out = chip_smoke.serving_job_phase(torch, model, ratings, 0.1,
                                       torch.device("cpu"))
    logs = capsys.readouterr().out
    assert "32 equal to the in-process handler, 32 agree" in logs
    assert "16 of 16 sampled keys serve their last journal row" in logs
    assert "16 TOPK equal to those before: True" in logs
    # the snapshot plane at its defaults, the push plane, compaction
    assert "job snapshot at ready: 1802 rows" in logs
    assert ("33 of 33 folded TOPK subscriptions equal a pull TOPKV" in logs
            and "33 agree with a float64 top-k" in logs
            and "16 of 16 KEY subscriptions' last value equals GET" in logs)
    assert logs.count(" 0 missed, 0 duplicates") == 3
    assert "as first sent: True" in logs and "a fresh S " in logs
    assert "UNSUB stopped the deltas: True" in logs
    assert "equality not checked" in logs
    assert "the same COUNT, MGET and TOPK: True" in logs
    assert "and 64 TOPK k=10 the same bytes: True" in logs
    assert out["push_dispatches"] >= 1 and out["push_sgd_deltas"] > 0
    assert out["compact_bytes_after"] < out["compact_bytes_before"]
    assert out["snapshot_bootstrap_s"] > 0
    assert np.isfinite(out["mse_after"]) and out["mse_after"] != out[
        "mse_live"]  # the uniform fresh ratings moved the served model
    assert out["restore_s"] > 0 and out["wire_p50_ms"] > 0
    assert abs(out["mse_live"] - out["mse_offline"]) <= 1e-5 * out[
        "mse_offline"]


def test_serving_job_phase_fails_when_the_job_drops_an_sgd_row(
        small_model, small_job, monkeypatch):
    """A journal that loses the last SGD row: the job never serves it, and
    the served-equals-last-journal-row check fails the phase."""
    from flink_ms_tpu_torch.serve import journal as PJ

    real = PJ.Journal.append
    calls = []

    def lossy(self, lines, flush=True):
        lines = list(lines)
        calls.append(len(lines))
        if len(calls) > 1 and len(lines) == 2 * 400 % 512:
            lines = lines[:-1]  # the last SGD batch loses its last row
        return real(self, lines, flush)

    monkeypatch.setattr(PJ.Journal, "append", lossy)
    model, ratings, _ = small_model
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="1 served rows differ from their last journal"):
        chip_smoke.serving_job_phase(torch, model, ratings, 0.1,
                                     torch.device("cpu"))


@pytest.fixture
def fleet_base(monkeypatch):
    """Phase 18's inputs at a small size: a published topic of random
    rank-8 rows (1,200 users, 1,100 items, the MEAN rows) and the one
    job's replies from ``fleet_baseline``; the phase's sizes shrunk."""
    from flink_ms_tpu_torch.core import formats as F

    # the members' arenas start small and grow with their rows, so that
    # their files stay dense: on a filesystem that discards freed blocks
    # synchronously, deleting a sparse file costs one discard per extent,
    # and a 65,536-slot arena holding a thousand rows has a thousand
    monkeypatch.setenv("TPUMS_ARENA_CAPACITY", "256")
    for name, value in (("FLEET_MGET_KEYS", 64), ("FLEET_LATENCY_CALLS", 20),
                        ("FLEET_WINDOW_S", 0.5), ("FLEET_RATE_QPS", 100.0),
                        ("FLEET_RESHARD_RATINGS", 1000),
                        ("FLEET_RATINGS", 3000), ("FLEET_WAIT_S", 90.0),
                        ("FLEET_CHECKPOINT_MS", 300)):
        monkeypatch.setattr(chip_smoke, name, value)
    rng = np.random.default_rng(0)
    uf, itf = rng.normal(size=(1200, 8)), rng.normal(size=(1100, 8))
    published = [F.format_als_row(u, "U", uf[u]) for u in range(1200)]
    published += [F.format_als_row(i, "I", itf[i]) for i in range(1100)]
    published += [F.format_als_row("MEAN", side, m.mean(axis=0))
                  for side, m in (("U", uf), ("I", itf))]
    return chip_smoke.fleet_baseline(published, torch.device("cpu"), 16)


def test_fleet_phase_rehearsal(fleet_base, capsys):
    """Phase 18 on the CPU: every worker a ``--device cpu`` process."""
    out = chip_smoke.fleet_phase(torch, fleet_base, torch.device("cpu"))
    logs = capsys.readouterr().out
    assert "sum 2302 (the one job's 2302); MGET of 64 keys equal to the " \
        "one job's: True" in logs
    assert logs.count("16 of 16 agree with a float64 top-k") == 2
    assert "the same MGET and 16 fan-out TOPK: True" in logs
    assert "from the checkpoint" in logs
    assert "0 client-visible errors" in logs and "1 respawn" in logs
    assert "payloads at every topology equal the one job's: True" in logs
    assert "live generations [3]" in logs
    assert "1000 submitted, 0 lost, 0 doubled" in logs
    assert "equal one SGDStep run over the same ratings byte for byte: " \
        "True" in logs
    assert "4000 submitted, 0 lost, 0 doubled" in logs
    assert logs.count(" 0 failed queries") == 2
    assert out["updates_per_s"] > 0 and out["fanout_p50_ms"] > 0
    assert out["ha_respawn_s"] > 0 and len(out["cutover_s"]) == 2
    assert np.isfinite(out["visibility_p99_ms"])


def test_fleet_phase_fails_when_an_apply_record_is_dropped(
        fleet_base, tmp_path, monkeypatch):
    """A fleet whose partition 3 lost its first apply record: the audit
    counts those ratings lost, and the reshard check fails the phase."""
    from flink_ms_tpu_torch.serve import update_plane as UP

    real = UP._read_all_lines
    lossy_topic = UP.apply_topic(chip_smoke.JOB_TOPIC, 3)

    def lossy(j):
        lines = real(j)
        return lines[1:] if j.topic == lossy_topic else lines

    monkeypatch.setattr(UP, "_read_all_lines", lossy)
    for k, v in chip_smoke.FLEET_ENV.items():
        monkeypatch.setenv(k, v)
    run = chip_smoke.FleetRun(str(tmp_path), fleet_base, torch.device("cpu"))
    try:
        chip_smoke.fleet_group(run)
        with pytest.raises(chip_smoke.SmokeFailure,
                           match="the reshard audit .*'lost': [1-9]"):
            chip_smoke.fleet_updates(run)
    finally:
        run.close()


@pytest.fixture
def small_scale(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SCALE_EXACT_ROWS", 20_000)
    monkeypatch.setattr(chip_smoke, "SCALE_IVF_ROWS", 60_000)
    monkeypatch.setattr(chip_smoke, "IVF_ENV", {
        "TPUMS_TOPK_TIER": "ivf", "TPUMS_ANN_NLIST": "128",
        "TPUMS_ANN_NPROBE": "16", "TPUMS_ANN_MIN_ROWS": "1000"})


def test_serve_scale_phase_rehearsal(small_scale, capsys):
    out = chip_smoke.serve_scale_phase(torch, torch.device("cpu"))
    assert set(out) == {"exact_1m", "ivf_10m", "exact_10m"}
    logs = capsys.readouterr().out
    assert "64 top-100 lists against a float64 re-rank" in logs
    assert "serves exact" in logs and "serves ivf" in logs


def test_serve_scale_phase_fails_without_the_ivf_tier(small_scale,
                                                      monkeypatch):
    from flink_ms_tpu_torch.serve.ann import IVFIndex

    def broken(*a, **kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(IVFIndex, "build", broken)
    with pytest.raises(chip_smoke.SmokeFailure, match="IVF tier was not "
                                                      "built"):
        chip_smoke.serve_scale_phase(torch, torch.device("cpu"))


# -- phases 12 to 15, rehearsed on the CPU at small sizes ---------------------


@pytest.fixture
def counted(monkeypatch):
    """On the CPU no kernel launches, so the wrappers' counts stay 0: the
    fits' wrappers are replaced by fakes that count as each wrapper does
    where it launches its kernel, then run the plain versions."""
    from flink_ms_tpu_torch.ops import als as TA
    from flink_ms_tpu_torch.ops import cholesky as CH
    from flink_ms_tpu_torch.ops import gather_assembly as GA
    from flink_ms_tpu_torch.ops import svm as TS
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    chip_smoke.count_plain_versions(TA, CH, GA, TS, SK, monkeypatch.setattr)
    monkeypatch.setattr(chip_smoke, "RANK", 8)
    return TA, CH, GA, TS, SK


@pytest.fixture
def als_run(counted):
    TA = counted[0]
    users, items, ratings = chip_smoke.synth_ratings(400, 250, 30_000, seed=0)
    problem = TA.prepare_blocked(users, items, ratings, 1)
    gen = torch.Generator().manual_seed(42)
    init = (TA.init_factors(problem.n_users, 8, gen).numpy(),
            TA.init_factors(problem.n_items, 8, gen).numpy())
    straight = TA.als_fit(users, items, ratings, TA.ALSConfig(
        num_factors=8, iterations=3, lambda_=chip_smoke.LAMBDA), "cpu",
        problem=problem, init=init)
    return problem, (users, items, ratings), init, straight


def test_staged_phase_rehearsal(counted, als_run, capsys):
    TA, CH, GA = counted[:3]
    problem, ratings_t, init, straight = als_run
    n_buckets = len(problem.u.widths) + len(problem.i.widths)
    launches = chip_smoke.staged_phase(torch, TA, CH, GA, problem, ratings_t,
                                       init, straight, 0.001,
                                       torch.device("cpu"))
    assert launches == {"cholesky": 6, "assembly": 3 * n_buckets,
                        "cholesky_batch_major": 0}
    logs = capsys.readouterr().out
    assert "[ALS] staging: resuming from iteration 2 (" in logs
    assert "printed the resume line: True" in logs
    assert "[als-iteration] 3 steps" in logs


def test_staged_phase_fails_when_the_snapshot_does_not_resume(
        counted, als_run, monkeypatch):
    TA, CH, GA = counted[:3]
    problem, ratings_t, init, straight = als_run
    monkeypatch.setattr(TA, "load_staged", lambda *a, **kw: None)
    with pytest.raises(chip_smoke.SmokeFailure, match="did not resume"):
        chip_smoke.staged_phase(torch, TA, CH, GA, problem, ratings_t, init,
                                straight, 0.001, torch.device("cpu"))


@pytest.fixture
def svm_run(counted, monkeypatch):
    TS = counted[3]
    for name, value in (("SVM_N", 3000), ("SVM_D", 400), ("SVM_NNZ", 9),
                        ("SVM_K", 32)):
        monkeypatch.setattr(chip_smoke, name, value)
    data, problem = chip_smoke.svm_inputs(TS)[:2]
    cfg = chip_smoke.svm_config(TS, problem)
    fit, args = TS.compile_svm_fit(problem, cfg, "cpu")
    w, alpha = fit(chip_smoke.SVM_ROUNDS, *args)
    model = TS.SVMModel(weights=w.numpy().astype(np.float64))
    return {"w": w, "alpha": alpha,
            "alpha1": fit(1, *args)[1], "sec_per_round": 0.01,
            "w_repeat_equal": True,
            "objective": [1.0, model.hinge_loss(data, chip_smoke.SVM_LAMBDA)]}


def test_svm_modes_phase_rehearsal(counted, svm_run, capsys):
    TS, SK = counted[3:]
    out = chip_smoke.svm_modes_phase(torch, TS, SK, svm_run,
                                     torch.device("cpu"))
    # time_rounds: a warm-up and 3 samples of 1 and 10 rounds; then 10 and 1
    ran = 4 * (1 + chip_smoke.SVM_ROUNDS) + chip_smoke.SVM_ROUNDS + 1
    assert out["onehot"] == {"margin_gather": ran, "scatter_add_dw": 0,
                             "scatter_add_dw[row_scale]": ran}
    for mode in ("sorted", "presorted"):
        assert out[mode] == {"margin_gather": ran, "scatter_add_dw": 0,
                             "scatter_add_dw[row_scale]": 0}
    logs = capsys.readouterr().out
    assert "equal bit for bit True (the dynamic step run again: True)" in logs
    assert "svm mode onehot (runs as step dynamic, Δw direct)" in logs
    for mode in ("sorted", "presorted"):
        assert f"svm mode {mode} (runs as step dynamic, Δw sorted)" in logs


def test_svm_modes_phase_fails_if_a_sorted_mode_scatters(counted, svm_run,
                                                         monkeypatch):
    """A sorted mode that ran the scatter-add kernel instead of its
    segment sum: the same numbers, but phase 13 fails on the launches."""
    TS, SK = counted[3:]
    monkeypatch.setattr(TS, "_dw_choice", lambda: "direct")
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="svm mode sorted: .* row-scale scatter-adds"):
        chip_smoke.svm_modes_phase(torch, TS, SK, svm_run,
                                   torch.device("cpu"))


def test_gen_phase_rehearsal(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "N_USERS", 20_000)
    monkeypatch.setattr(chip_smoke, "N_ITEMS", 5_000)
    monkeypatch.setattr(chip_smoke, "RANK", 8)
    out = chip_smoke.gen_phase(torch, torch.device("cpu"))
    assert set(out) == {"als_p1_rows_per_s", "als_p4_rows_per_s",
                        "svm_rows_per_s"}
    logs = capsys.readouterr().out
    assert "rows equal the replayed draws: True" in logs
    assert "gen SVM: 48 buckets of 1000 (48000 weights)" in logs


def test_gen_phase_fails_on_rows_off_the_draws(monkeypatch):
    from flink_ms_tpu_torch.gen import als_model_generator as AG

    monkeypatch.setattr(chip_smoke, "N_USERS", 300)
    monkeypatch.setattr(chip_smoke, "N_ITEMS", 200)
    monkeypatch.setattr(chip_smoke, "RANK", 4)
    real = AG.generate_rows
    monkeypatch.setattr(AG, "generate_rows",
                        lambda n, c, latent, seed, *a: real(n, c, latent,
                                                            seed + 7, *a))
    with pytest.raises(chip_smoke.SmokeFailure, match="not the card's draws"):
        chip_smoke.gen_phase(torch, torch.device("cpu"))


def test_retrain_phase_rehearsal(counted, monkeypatch, capsys):
    TA, CH, GA = counted[:3]
    ratings_t = chip_smoke.synth_ratings(300, 200, 20_000, seed=0)
    model = TA.als_fit(*ratings_t, TA.ALSConfig(
        num_factors=8, iterations=3, lambda_=chip_smoke.LAMBDA), "cpu")
    monkeypatch.setattr(chip_smoke, "N_USERS", len(model.user_ids))
    monkeypatch.setattr(chip_smoke, "N_ITEMS", len(model.item_ids))
    launches = chip_smoke.retrain_phase(torch, CH, GA, model, ratings_t,
                                        torch.device("cpu"))
    assert launches["cholesky"] == 4 * chip_smoke.RETRAIN_ITERS
    assert launches["cholesky_batch_major"] == 0
    logs = capsys.readouterr().out
    assert "retrain cold (auto-v000001, warm False)" in logs
    assert "retrain warm (auto-v000002, warm True)" in logs
    assert logs.count("equal to the tables: True") == 2


def _serve_phase_ab():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "serve_phase_ab.py")
    spec = importlib.util.spec_from_file_location("serve_phase_ab", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    return ab


def test_serve_phase_ab_reads_every_number_of_a_log():
    """``scripts/serve_phase_ab.py`` reads its numbers from the lines
    ``chip_smoke.py`` prints; a line that changes shape drops its key."""
    ab = _serve_phase_ab()
    log = "\n".join([
        "[smoke] main default: 0.008662 sec/iter (median of 3)",
        "[smoke] svm main: 0.046318 sec/round (median of 3)",
        "[smoke] serve ML-20M (x): 256 TOPK k=10 unbatched p50 0.7852 ms, "
        "p99 1.5935 ms (exact scan bytes bound 0.1 ms)",
        "[smoke] serve batched, 32 threads: 2530.5 queries/s (101.2 ms)",
        "[smoke] scale exact 1000000: p50 at B=1 1.3692 ms (exact scan "
        "bytes bound 0.019104 ms), 4610.1 queries/s at B=32",
        "[smoke] scale exact 10000000: p50 at B=1 1.8974 ms (bound "
        "0.191045 ms), 1929.5 queries/s at B=32",
        "[smoke] scale ivf 10000000 x 16: build 9.339s (upload)",
        "[smoke] scale ivf 10000000: p50 at B=1 2.4116 ms (bound 0.19 ms), "
        "2204.2 queries/s at B=32"])
    got = ab.numbers(log)
    assert got == {
        "als": {"sec_per_iter": 0.008662},
        "svm": {"sec_per_round": 0.046318},
        "topk_ml20m": {"p50_ms": 0.7852, "p99_ms": 1.5935},
        "batcher_ml20m": {"qps": 2530.5},
        "exact_1m": {"p50_ms": 1.3692, "qps": 4610.1},
        "exact_10m": {"p50_ms": 1.8974, "qps": 1929.5},
        "ivf_10m": {"p50_ms": 2.4116, "qps": 2204.2},
        "ivf_build": {"s": 9.339}}
    assert "exact_1m" not in ab.numbers(log.replace("p50 at B=1", "p50"))
    samples = "\n".join(
        [f"[smoke] [ab] batcher sample {n}: {q} queries/s"
         for n, q in enumerate((3000.5, 2000.0, 2500.0))]
        + ["[smoke] [ab] exact 1M sample 0: p50 0.6000 ms, 7000.0 queries/s"])
    got = ab.numbers(samples)
    assert got["samples_batcher_qps"] == {"n": 3, "median": 2500.0,
                                          "min": 2000.0, "max": 3000.5}
    assert got["samples_exact_1m_p50_ms"]["median"] == 0.6
    assert got["samples_exact_1m_qps"]["n"] == 1


def test_serve_phase_ab_samples_run_on_the_cpu(small_model):
    """The repeated measurements drive the port's own entry points: the
    batcher over a trained model, the exact tier over a catalog."""
    ab = _serve_phase_ab()
    dev = torch.device("cpu")
    handler, u_ids, qu = ab.batcher_handler(chip_smoke, small_model[0], dev)
    assert handler.batching and len(qu) == 256
    assert ab.batcher_qps(chip_smoke, handler, u_ids, qu) > 0
    rows, queries = chip_smoke.make_catalog(3000, chip_smoke.SCALE_D)
    index, _ = chip_smoke.scale_index(
        torch, rows, [str(i) for i in range(len(rows))], dev,
        {"TPUMS_TOPK_TIER": "exact"})
    p50, qps = ab.exact_1m(chip_smoke, torch, index, queries)
    assert p50 > 0 and qps > 0



# -- phase 17's push, snapshot and compaction helpers --------------------------


def _snap(counters=(), hists=()):
    return {"counters": [{"name": n, "labels": {"state": "S"}, "value": v}
                         for n, v in counters],
            "gauges": [],
            "histograms": [{"name": n, "labels": {"state": "S"},
                            "le": [0.001, 0.01, 0.1], "counts": list(c),
                            "sum": s, "count": sum(c)}
                           for n, c, s in hists]}


def test_push_window_reads_the_engine_and_ingest_series():
    before = _snap([("tpums_push_deltas_total", 10),
                    ("tpums_push_candidates_total", 5),
                    ("tpums_push_population_total", 20),
                    ("tpums_ingest_rows_total", 100)],
                   [("tpums_push_latency_seconds", (4, 1, 0, 0), 0.01),
                    ("tpums_ingest_apply_seconds", (1, 0, 0, 0), 0.5)])
    after = _snap([("tpums_push_deltas_total", 30),
                   ("tpums_push_dispatches_total", 3),
                   ("tpums_push_candidates_total", 15),
                   ("tpums_push_population_total", 60),
                   ("tpums_ingest_rows_total", 300)],
                  [("tpums_push_latency_seconds", (4, 20, 1, 0), 0.2),
                   ("tpums_ingest_apply_seconds", (3, 0, 0, 0), 1.5)])
    w = chip_smoke.push_window(before, after)
    assert (w["deltas"], w["dispatches"], w["candidates"]) == (20, 3, 10)
    assert w["selectivity"] == 0.25 and w["ingest_rows_per_s"] == 200.0
    # 20 of the 21 new observations sit in the (1 ms, 10 ms] bucket
    assert w["latency_p50_ms"] == 10.0 and w["latency_p99_ms"] == 100.0
    le = [0.001, 0.01]
    assert np.isnan(chip_smoke.bucket_quantile(le, np.zeros(3, int), 0.5))
    assert chip_smoke.bucket_quantile(le, np.array([0, 0, 2]), 0.5) == \
        float("inf")


def test_snapshot_lines_read_what_the_job_logs(tmp_path, capfd):
    from flink_ms_tpu_torch.serve import consumer as PC
    from flink_ms_tpu_torch.serve import journal as PJ

    d = str(tmp_path / "j")
    PJ.Journal(d, "t").append([f"{i},I,{i}.5" for i in range(300)])
    job = PC.ServingJob(PJ.Journal(d, "t"), "ALS_MODEL", PC.parse_als_record,
                        PC.MemoryStateBackend(), host="127.0.0.1", port=0,
                        device="cpu", topk_index=False,
                        snapshot_min_bytes=1).start()
    try:
        assert job.wait_ready(30)
        import time

        time.sleep(0.2)
    finally:
        job.stop()
    lines = chip_smoke.snapshot_lines(capfd.readouterr().err)
    assert [(r, o) for r, o, _ in lines] == [(300, job.offset)]
    assert lines[0][2] >= 0
    assert chip_smoke.dir_bytes(d) > PJ.Journal(d, "t").end_offset()


def test_push_subscriber_folds_and_audits(monkeypatch, tmp_path):
    """The subscriber against a port lookup server in this process: its
    folded lists equal pull TOPKV after the updates, its KEY values equal
    GET, and a lost delta shows in the audit as a hole."""
    from flink_ms_tpu_torch.serve.client import QueryClient
    from flink_ms_tpu_torch.serve.push import audit_push_sequences
    from flink_ms_tpu_torch.serve.server import LookupServer
    from flink_ms_tpu_torch.serve.table import ModelTable
    from flink_ms_tpu_torch.serve.topk import make_als_topk_handler

    monkeypatch.setenv("TPUMS_REGISTRY_DIR", str(tmp_path))
    rng = np.random.default_rng(0)
    table = ModelTable(2)
    table.put_many([(f"{i}-I", chip_smoke.payload_of(
        rng.integers(-8, 9, 4).astype(np.float32) / 4)) for i in range(40)]
        + [(f"{u}-U", chip_smoke.payload_of(
            rng.integers(-8, 9, 4).astype(np.float32) / 4)) for u in range(6)])
    srv = LookupServer({"ALS_MODEL": table}, host="127.0.0.1", port=0,
                       topk_handlers={"ALS_MODEL": make_als_topk_handler(
                           table, device="cpu")}).start()
    try:
        sub = chip_smoke.PushSubscriber(srv.port)
        for u in range(5):
            sub.subscribe("TOPK", table.get(f"{u}-U"))
        ksid = sub.subscribe("KEY", "3-I")
        sub.subscribe_tab(table.get("5-U"))
        with QueryClient("127.0.0.1", srv.port) as pull:
            for b in range(8):
                table.put_many([(f"{i}-I", chip_smoke.payload_of(
                    rng.integers(-12, 13, 4).astype(np.float32) / 4))
                    for i in rng.choice(40, 6, replace=False)])
                sub.settle(pull.metrics, quiet_s=0.05)
            for sid, query in sub.query.items():
                reply = pull._roundtrip(f"TOPKV\tALS_MODEL\t10\t{query}")
                assert sub.topk[sid] == dict(zip(*chip_smoke.parse_reply(
                    reply[2:])))
            assert sub.keys[ksid] == pull.query_state("ALS_MODEL", "3-I")
        audit = audit_push_sequences(sub.events)
        assert audit["missed"] == audit["duplicates"] == 0
        assert audit["delivered"] > 8
        lost = [e for e in sub.events if e[0] == "S" or e[2] != 2]
        assert audit_push_sequences(lost)["missed"] >= 1
        sub.close()
    finally:
        srv.stop()


@pytest.fixture
def small_arena(monkeypatch, fleet_base):
    for name, value in (("ARENA_LATENCY_CALLS", 20),
                        ("ARENA_NATIVE_CALLS", 50), ("ARENA_MGET_KEYS", 8),
                        ("ARENA_DFREE_RATINGS", 500),
                        ("ARENA_RATINGS", 2000)):
        monkeypatch.setattr(chip_smoke, name, value)
    return fleet_base


def test_arena_phase_rehearsal(small_arena, capsys):
    """Phase 19 on the CPU: every member a ``--device cpu`` process, the
    rocksdb job in this process."""
    out = chip_smoke.arena_phase(torch, small_arena, torch.device("cpu"))
    logs = capsys.readouterr().out
    assert "(its log: table: arena), plane python" in logs
    assert "COUNT 2302 (the dict job's 2302), MGET of 64 keys equal: True" \
        in logs
    assert "16 of 16 agree with a float64 top-k" in logs
    assert "every list agrees with a float64 top-k" in logs
    assert "from the snapshot in" in logs and "equal to the dict job's: " \
        "True, True" in logs
    assert "a NativeStateBackend, ingest path native" in logs
    assert "from the checkpoint, 0 rows replayed, COUNT 2303 (the rows" in logs
    assert "500 submitted, 0 lost, 0 doubled" in logs
    assert "equal one SGDStep run byte for byte: True" in logs
    assert "2500 submitted, 0 lost, 0 doubled" in logs
    assert out["cas_swaps"] > 0 and out["arena_updates_per_s"] > 0
    assert out["resident_bytes"] > 0 and out["size_bytes"] >= \
        out["resident_bytes"] // 2
    assert out["publish_link_s"] >= 0 and out["rocksdb_restart_s"] > 0
