"""The byte and operation counts behind ``chip_smoke.py``'s bounds."""

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
