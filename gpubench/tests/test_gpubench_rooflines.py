"""The kernels' operation and byte counts, held to the bounds PERF.md
states for the main and circular paths."""

import pytest

from gpubench.rooflines import k1, k2, k3, peaks


def test_k1_main_path_bound():
    # the main path's K1 launch: B=2,048, 923,425 steps; 15 match bins
    seconds, by = k1.launch_bound_s(2048, 923_425, n_t=2000, nb=15, K=150)
    assert by == "operations"
    assert seconds * 1e3 == pytest.approx(0.0187, abs=5e-5)


def test_k3_circular_path_bound():
    seconds, by = k3.launch_bound_s(2048, 19_456, 4_480)
    assert by == "bytes"
    assert seconds * 1e3 == pytest.approx(0.0622, abs=5e-5)


def test_k2_operations_scale_with_steps():
    ints, f32 = k2.unaligned_ops(2000, 1000, 100)
    assert ints == 1000 * (3 * k1.THREEFRY_INT_OPS + 4 + k2.UNALIGNED_STATE_INT_OPS)
    assert f32 == 5000 + 100 * peaks.lookup_ops(2000)


def test_lookup_is_a_binary_search():
    assert [peaks.lookup_ops(n) for n in (1, 2, 15, 16, 17)] == [1, 2, 5, 5, 6]
