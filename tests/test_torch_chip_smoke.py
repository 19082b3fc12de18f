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
