"""The byte arithmetic of the rooflines on fixed shapes (the shapes and
bytes of PERF.md's kernel table)."""
import pytest

from benchmark import peaks


@pytest.mark.parametrize("codes,rows,windows,want", [
    (4096 * 150, 4096, 4096 * 120, 4_628_480),          # 4096 reads of 150
    (131_072 * 150, 131_072, 131_072 * 120, 148_111_360),  # large launch
])
def test_ragged_launch_bytes(codes, rows, windows, want):
    assert peaks.ragged_launch_bytes(codes, rows, windows) == want


def test_dense_launch_bytes():
    # the classify batch (8192, 150) at k = 31
    assert peaks.dense_launch_bytes(8192 * 150, 8192 * 120) == 9_093_120


def test_consolidate_bytes_and_bound():
    # a store of 2^24 keys, a full buffer of 2^25 lanes, 2^24 + 2^23 out
    n = peaks.consolidate_bytes(1 << 24, 1 << 25, (1 << 24) + (1 << 23))
    assert n == 12 * (1 << 24) + 8 * (1 << 25) + 12 * ((1 << 24) + (1 << 23))
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
