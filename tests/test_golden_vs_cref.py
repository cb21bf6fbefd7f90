"""Cross-validate the NumPy golden oracle against the reference C++ Generic
implementations (built from /root/reference, driven via ctypes).

This is the root of the correctness chain: the XLA device path is tested
against the golden oracle, and the golden oracle is proven here
byte-identical to the reference.
"""

import numpy as np
import pytest

from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import cref, numpy_ref

pytestmark = pytest.mark.skipif(
    not cref.available(), reason="reference build unavailable"
)

RNG = np.random.default_rng(0)

# (src_w, src_h, dst_w, dst_h) sweeps: integer ratios, gcd=1 primes, odd
# sizes, identity, single-axis, extreme ratios.
GEOMETRIES = [
    (640, 480, 320, 240),      # BASELINE config 1
    (1920, 1080, 480, 270),    # BASELINE config 2 (4:1 non-trivial phases)
    (1280, 720, 1920, 1080),   # BASELINE config 3 upsample
    (100, 80, 99, 79),         # gcd=1 slight downsample
    (97, 61, 31, 23),          # primes
    (64, 64, 64, 64),          # identity
    (64, 48, 64, 24),          # Y-only resize
    (64, 48, 32, 48),          # X-only resize
    (50, 40, 200, 160),        # 4x upsample (lanczos/area)
    (321, 241, 123, 97),       # odd everything
    (16, 16, 3, 3),            # tiny, extreme ratio
    (1000, 2, 500, 2),         # degenerate height
]


def _img(w, h):
    return RNG.integers(0, 256, size=(h, w), dtype=np.uint8)


def _reference_would_crash(plan) -> bool:
    """The reference SIGFPEs (deno==0 integer division) or heap-overflows
    (border row loop running past dstH) on degenerate extreme-downscale
    geometries; there is no behavior to match there."""
    if plan.y.main_begin > plan.y.n_dst:
        return True
    for ax in (plan.y, plan.x):
        if (ax.deno[ax.is_border] == 0).any():
            return True
    return False


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("degree,px_scale", [(2, 1), (3, 1), (3, 2), (4, 1), (9, 1)])
def test_lanczos_matches_reference(geom, degree, px_scale):
    sw, sh, dw, dh = geom
    src = _img(sw, sh)
    plan = build_plan("lanczos", sw, sh, dw, dh, degree=degree, px_scale=px_scale)
    if _reference_would_crash(plan):
        from helpers import assert_defined_divergence

        assert_defined_divergence(plan, src, f"lanczos{degree} px{px_scale} {geom}")
        return
    got = numpy_ref.resize_u8(plan, src)
    want = cref.lanczos(degree, src, dw, dh, px_scale)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_area_matches_reference(geom):
    sw, sh, dw, dh = geom
    src = _img(sw, sh)
    plan = build_plan("area", sw, sh, dw, dh)
    got = numpy_ref.resize_u8(plan, src)
    want = cref.area(src, dw, dh)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_linear_matches_reference(geom):
    sw, sh, dw, dh = geom
    src = _img(sw, sh)
    plan = build_plan("linear", sw, sh, dw, dh)
    if plan.y.reference_oob or plan.x.reference_oob:
        from helpers import assert_defined_divergence

        assert_defined_divergence(plan, src, f"linear {geom}")
        return
    got = numpy_ref.resize_u8(plan, src)
    want = cref.linear(src, dw, dh)
    np.testing.assert_array_equal(got, want)
