"""Randomized geometry fuzzing: golden oracle vs the reference C++ Generic.

Catches table/index transcription errors on geometry classes the curated
lists miss.  Seeded, so failures reproduce.  Set LIBIQO_FUZZ_N to raise
the count locally (default keeps CI fast).  The device path's own fuzz,
which needs no reference build, is tests/test_xla_fuzz.py.
"""

import os

import numpy as np
import pytest

from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import cref, numpy_ref

pytestmark = pytest.mark.skipif(
    not cref.available(), reason="reference build unavailable"
)

N = int(os.environ.get("LIBIQO_FUZZ_N", "40"))
RNG = np.random.default_rng(2024)


def _rand_geom():
    sw = int(RNG.integers(8, 700))
    sh = int(RNG.integers(8, 500))
    dw = int(RNG.integers(4, 700))
    dh = int(RNG.integers(4, 500))
    return sw, sh, dw, dh


def _lanczos_crash(plan) -> bool:
    if plan.y.main_begin > plan.y.n_dst:
        return True
    return any((ax.deno[ax.is_border] == 0).any() for ax in (plan.y, plan.x))


@pytest.mark.parametrize("i", range(N))
def test_fuzz_lanczos(i):
    sw, sh, dw, dh = _rand_geom()
    degree = int(RNG.integers(1, 5))
    px = int(RNG.integers(1, 3))
    plan = build_plan("lanczos", sw, sh, dw, dh, degree=degree, px_scale=px)
    src = RNG.integers(0, 256, (sh, sw), np.uint8)
    if _lanczos_crash(plan):
        from helpers import assert_defined_divergence

        assert_defined_divergence(
            plan, src, f"lanczos{degree} px{px} {sw}x{sh}->{dw}x{dh}")
        return
    got = numpy_ref.resize_u8(plan, src)
    want = cref.lanczos(degree, src, dw, dh, px)
    np.testing.assert_array_equal(
        got, want, err_msg=f"lanczos{degree} px{px} {sw}x{sh}->{dw}x{dh}")


@pytest.mark.parametrize("i", range(N))
def test_fuzz_area(i):
    sw, sh, dw, dh = _rand_geom()
    plan = build_plan("area", sw, sh, dw, dh)
    src = RNG.integers(0, 256, (sh, sw), np.uint8)
    np.testing.assert_array_equal(
        numpy_ref.resize_u8(plan, src), cref.area(src, dw, dh),
        err_msg=f"area {sw}x{sh}->{dw}x{dh}")


@pytest.mark.parametrize("i", range(N))
def test_fuzz_linear(i):
    sw, sh, dw, dh = _rand_geom()
    plan = build_plan("linear", sw, sh, dw, dh)
    src = RNG.integers(0, 256, (sh, sw), np.uint8)
    if plan.y.reference_oob or plan.x.reference_oob:
        from helpers import assert_defined_divergence

        assert_defined_divergence(plan, src, f"linear {sw}x{sh}->{dw}x{dh}")
        return
    np.testing.assert_array_equal(
        numpy_ref.resize_u8(plan, src), cref.linear(src, dw, dh),
        err_msg=f"linear {sw}x{sh}->{dw}x{dh}")
