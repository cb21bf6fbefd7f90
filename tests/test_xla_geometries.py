"""Curated geometries through the public resizers on the XLA path, byte-exact
against the golden oracle: scale ratios, identity axes, degrees up to 9,
batches, gcd=1 primes, wide tap windows and the int16 work-row edge."""

import numpy as np
import pytest

from libiqo_tpu import AreaResizer, LanczosResizer, LinearResizer
from libiqo_tpu.golden import numpy_ref

# (id, algo, kwargs, sw, sh, dw, dh, batch, seed); batch None = one 2-D frame
CASES = [
    ("lanczos3-down", "lanczos", dict(degree=3), 960, 540, 480, 270, None, 0),
    ("lanczos2-up", "lanczos", dict(degree=2), 320, 180, 480, 270, None, 0),
    ("lanczos3-chroma", "lanczos", dict(degree=3, px_scale=2), 480, 270, 240, 135, None, 0),
    ("area-4to1", "area", {}, 960, 540, 240, 135, None, 0),
    ("area-5to1", "area", {}, 400, 300, 80, 60, None, 0),
    ("linear-down", "linear", {}, 640, 480, 320, 240, None, 0),
    ("linear-up", "linear", {}, 64, 48, 128, 96, None, 0),
    ("lanczos3-x-identity", "lanczos", dict(degree=3), 480, 512, 480, 256, None, 0),
    ("lanczos3-y-identity", "lanczos", dict(degree=3), 512, 270, 256, 270, None, 0),
    ("lanczos4-3to1", "lanczos", dict(degree=4), 768, 432, 256, 144, None, 0),
    ("lanczos9", "lanczos", dict(degree=9), 320, 240, 160, 120, None, 0),
    ("lanczos7-up", "lanczos", dict(degree=7), 256, 192, 512, 384, None, 0),
    ("batch4", "lanczos", dict(degree=3), 256, 192, 128, 96, 4, 0),
    ("batch3", "lanczos", dict(degree=3), 256, 192, 128, 96, 3, 0),
    ("batch6", "lanczos", dict(degree=3), 256, 192, 128, 96, 6, 0),
    ("primes-area", "area", {}, 97, 61, 31, 23, None, 0),
    ("primes-lanczos3", "lanczos", dict(degree=3), 97, 61, 31, 23, None, 0),
    ("primes-linear", "linear", {}, 97, 61, 31, 23, None, 0),
    # 512 taps per output: past the 258-tap bf16 bound, f32 X on the CPU
    ("area-512-tap", "area", {}, 8192, 4, 16, 4, None, 0),
    # 274 Y taps, also past the bf16 bound
    ("lanczos4-274-tap", "lanczos", dict(degree=4), 363, 614, 364, 18, None, 0),
    # 200,000 source rows: the banded Y form with ~6,452 taps
    ("area-200000-rows", "area", {}, 16, 200000, 16, 31, None, 0),
    # seeds whose Y-border renorm wraps work values into [32640, 32767],
    # where a signed byte split of the work row goes wrong
    ("work-range-seed10", "lanczos", dict(degree=3), 256, 70, 256, 5, None, 10),
    ("work-range-seed16", "lanczos", dict(degree=3), 256, 70, 256, 5, None, 16),
    ("work-range-seed18", "lanczos", dict(degree=3), 256, 70, 256, 5, None, 18),
]


def _resizer(algo, kw, sw, sh, dw, dh):
    if algo == "lanczos":
        return LanczosResizer(kw["degree"], sw, sh, dw, dh,
                              kw.get("px_scale", 1), backend="xla")
    cls = AreaResizer if algo == "area" else LinearResizer
    return cls(sw, sh, dw, dh, backend="xla")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_xla_matches_oracle(case):
    name, algo, kw, sw, sh, dw, dh, batch, seed = case
    r = _resizer(algo, kw, sw, sh, dw, dh)
    rng = np.random.default_rng(seed)
    shape = (sh, sw) if batch is None else (batch, sh, sw)
    src = rng.integers(0, 256, shape, np.uint8)
    if name.startswith("work-range"):
        w = numpy_ref._y_pass(r.plan, src.astype(np.int64))
        assert ((w >= 32640) & (w <= 32767)).any(), \
            "input no longer reaches the critical work range"
    got = r.resize(src)
    assert got.shape == shape[:-2] + (dh, dw)
    frames = src.reshape((-1, sh, sw))
    for i, out in enumerate(got.reshape((-1, dh, dw))):
        np.testing.assert_array_equal(
            out, numpy_ref.resize_u8(r.plan, frames[i]),
            err_msg=f"{name} frame {i}")
