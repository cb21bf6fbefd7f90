"""The reference's exact integer product, on both of its branches.

``numpy_ref._int_matmul`` multiplies through float64 BLAS when every
partial sum provably stays below 2**53 and through NumPy's int64 loop
otherwise.  Each case is checked against the product in Python integers.
"""

import numpy as np
import pytest

from libiqo_tpu.golden import numpy_ref


def _exact(a, b):
    return a.astype(object) @ b.astype(object)


@pytest.mark.parametrize("seed", range(4))
def test_float_branch_signed_operands(seed):
    """Work-row and coefficient magnitudes of the resize passes."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-32768, 32768, (40, 70), np.int64)
    b = rng.integers(-65535, 65536, (70, 30), np.int64)
    assert numpy_ref._abs_sum_bound(a, b) < 2**53
    got = numpy_ref._int_matmul(a, b)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got.astype(object), _exact(a, b))


def test_float_branch_just_under_bound():
    # x*y + 2 is odd and needs all 53 bits of float64's significand
    x, y = 2**26 - 1, 2**27 - 1
    a = np.array([[x, 1], [-x, 1]], np.int64)
    b = np.array([[y, -y], [2, 2]], np.int64)
    assert 2**52 < numpy_ref._abs_sum_bound(a, b) < 2**53
    got = numpy_ref._int_matmul(a, b)
    np.testing.assert_array_equal(got.astype(object), _exact(a, b))
    assert int(got[0, 0]) == x * y + 2


def test_int_branch_over_bound():
    # x*y + 1 = 2**54 + 2**27 + 1 is odd above 2**53: float64 would round it
    x, y = 2**27, 2**27 + 1
    a = np.array([[x, 1], [-x, 1]], np.int64)
    b = np.array([[y, -y], [1, 1]], np.int64)
    assert numpy_ref._abs_sum_bound(a, b) >= 2**53
    got = numpy_ref._int_matmul(a, b)
    np.testing.assert_array_equal(got.astype(object), _exact(a, b))
    assert int(got[0, 0]) == x * y + 1


def test_int_branch_random_wide_operands():
    rng = np.random.default_rng(7)
    a = rng.integers(-2**30, 2**30, (12, 16), np.int64)
    b = rng.integers(-2**28, 2**28, (16, 9), np.int64)
    assert numpy_ref._abs_sum_bound(a, b) >= 2**53
    np.testing.assert_array_equal(numpy_ref._int_matmul(a, b).astype(object),
                                  _exact(a, b))
