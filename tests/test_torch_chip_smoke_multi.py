"""Phase 16 of ``chip_smoke.py`` (multi-GPU), rehearsed on the CPU at
small sizes: a one-rank process group, 2 spawned gloo ranks, the sharded
tier as 2 slices.  A file of its own, so that the test runner can spread
it and ``tests/test_torch_chip_smoke.py`` over two workers."""

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture
def counted(monkeypatch):
    """The fits' wrappers replaced by fakes that count as each wrapper
    does where it launches its kernel, then run the plain versions (on
    the CPU no kernel launches)."""
    from flink_ms_tpu_torch.ops import als as TA
    from flink_ms_tpu_torch.ops import cholesky as CH
    from flink_ms_tpu_torch.ops import gather_assembly as GA
    from flink_ms_tpu_torch.ops import svm as TS
    from flink_ms_tpu_torch.ops import svm_kernels as SK

    chip_smoke.count_plain_versions(TA, CH, GA, TS, SK, monkeypatch.setattr)
    monkeypatch.setattr(chip_smoke, "RANK", 8)
    return TA, CH, GA, TS, SK


@pytest.fixture
def multi_inputs(counted, monkeypatch):
    """Phase 16's inputs at small sizes: phase 4's 3-iteration model and
    phase 7's w from the same starts.  The ranks are spawned processes,
    so they count the plain versions themselves (``REHEARSE_COUNTS``)."""
    TA, CH, GA, TS, SK = counted
    for name, value in (("N_USERS", 400), ("N_ITEMS", 250), ("NNZ", 30_000),
                        ("ROUTED_USERS", 4_000), ("ROUTED_ITEMS", 4_000),
                        ("ROUTED_NNZ", 3_000), ("SVM_N", 960),
                        ("SVM_D", 400), ("SVM_NNZ", 9), ("SVM_K", 32),
                        ("REHEARSE_COUNTS", True),
                        ("FUSED_ENV", {"FLINK_MS_ALS_FUSED": "1",
                                       "FLINK_MS_ALS_ASSEMBLY_CHUNK_BYTES":
                                       "20000"})):
        monkeypatch.setattr(chip_smoke, name, value)
    ratings_t = chip_smoke.synth_ratings(400, 250, 30_000, seed=0)
    problem = TA.prepare_blocked(*ratings_t, 1)
    gen = torch.Generator().manual_seed(42)
    init = (TA.init_factors(problem.n_users, 8, gen).numpy(),
            TA.init_factors(problem.n_items, 8, gen).numpy())
    model = TA.als_fit(*ratings_t, TA.ALSConfig(
        num_factors=8, iterations=3, lambda_=chip_smoke.LAMBDA), "cpu",
        problem=problem, init=init)
    _, sproblem = chip_smoke.svm_inputs(TS)[:2]
    fit, args = TS.compile_svm_fit(sproblem,
                                   chip_smoke.svm_config(TS, sproblem), "cpu")
    w = fit(chip_smoke.SVM_ROUNDS, *args)[0]
    return problem, ratings_t, init, {"default": {"model": model}}, w


def test_multi_world1_phase_rehearsal(counted, multi_inputs, capsys):
    TA, CH, GA, TS, SK = counted
    problem, ratings_t, init, runs, w = multi_inputs
    chip_smoke.multi_world1_phase(torch, TA, CH, GA, TS, SK, problem,
                                  ratings_t, init, runs, w,
                                  torch.device("cpu"))
    logs = capsys.readouterr().out
    assert "world 1 over gloo: ALS 3 iterations bit for bit phase 4's: " \
        "True" in logs
    assert "presorted Δw bit for bit the same fit outside a group: True" \
        in logs
    assert "(launches {'margin_gather': 10, 'scatter_add_dw': 0, " \
        "'scatter_add_dw[row_scale]': 10})" in logs
    from flink_ms_tpu_torch.parallel import distributed as pdist

    assert not pdist.in_group()


def test_multi_gloo_phase_rehearsal(multi_inputs, capfd):
    # as the run starts it: in the background, waited for later
    _, _, _, runs, w = multi_inputs
    finish = chip_smoke.multi_gloo_phase(torch, runs, w,
                                         torch.device("cpu"))
    launches = finish()
    assert set(launches) == {"als_d2", "als_d2_fused", "als_routed",
                             "svm_d2"}
    assert launches["als_d2"]["cholesky"] > 0
    assert launches["als_d2_fused"]["cholesky_batch_major"] > 0
    assert launches["svm_d2"]["scatter_add_dw[row_scale]"] > 0
    logs = capfd.readouterr().out
    assert logs.count("(gloo, one card shared): ALS ML-20M") == 2
    assert "snapshot writes [1, 2, 3], resumed True" in logs
    assert "snapshot writes [], resumed True" in logs
    assert "equal to gathered bit for bit True" in logs
    assert "accuracy user half-sweep" not in logs  # each block's own label
    assert logs.count("accuracy user block") == 2


def test_d_tolerance_catches_one_dropped_rating(counted, multi_inputs):
    # phase 16 holds the D-rank fits against D = 1 at D_RTOL / D_ATOL: a
    # fit that lost one rating of 30,000 on the way must fail it
    TA = counted[0]
    problem, (u, i, r), init, runs, _ = multi_inputs
    keep = np.ones(len(u), bool)
    keep[0] = False
    lost = TA.als_fit(u[keep], i[keep], r[keep], TA.ALSConfig(
        num_factors=8, iterations=3, lambda_=chip_smoke.LAMBDA), "cpu",
        init=init)
    want = runs["default"]["model"]
    assert np.array_equal(lost.user_ids, want.user_ids)
    off = max(chip_smoke.factors_off(a, b, chip_smoke.D_RTOL,
                                     chip_smoke.D_ATOL)
              for a, b in ((lost.user_factors, want.user_factors),
                           (lost.item_factors, want.item_factors)))
    assert off > 1.0


def test_multi_shard_phase_rehearsal(capsys):
    p50, qps = chip_smoke.multi_shard_phase(
        torch, torch.device("cpu"), [torch.device("cpu")] * 2, 20_000,
        "(c) sharded exact, 2 slices")
    assert p50 > 0 and qps > 0
    logs = capsys.readouterr().out
    assert "20000 rows in 2 slices of 16384" in logs
    assert "64 of 64 top-100 lists with the exact tier's ids" in logs


def test_multi_nccl_phase_needs_two_cards(capsys):
    # on one device (d) runs no job: the D values above the cards skip
    out = chip_smoke.multi_nccl_phase(torch, torch.device("cpu"),
                                      counts=())
    assert out == {}
