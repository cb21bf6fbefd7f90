"""Executable cache (per-cycle construction protocol) + 64-frame video
pipeline (BASELINE config 5)."""

import time

import numpy as np

from libiqo_tpu import AreaResizer, LanczosResizer
from libiqo_tpu.api import _COMPILED_CACHE
from libiqo_tpu.golden import numpy_ref
from libiqo_tpu.yuv import YUV420Resizer

RNG = np.random.default_rng(44)


def test_fresh_construction_reuses_executables():
    src = RNG.integers(0, 256, (48, 64), np.uint8)
    r1 = AreaResizer(64, 48, 32, 24, backend="xla")
    out1 = r1.resize(src)           # compiles
    key = r1.plan.cache_key()
    assert key in _COMPILED_CACHE
    t0 = time.perf_counter()
    r2 = AreaResizer(64, 48, 32, 24, backend="xla")   # fresh instance
    out2 = r2.resize(src)
    dt = time.perf_counter() - t0
    np.testing.assert_array_equal(out1, out2)
    assert r2._jitted is r1._jitted  # shared executable
    assert dt < 2.0  # no recompile (compiles take much longer)


def test_64_frame_video_pipeline():
    """BASELINE config 5 at test scale: 64 frames through one executable."""
    sw, sh, dw, dh = 128, 96, 64, 48
    r = YUV420Resizer("lanczos3", sw, sh, dw, dh, backend="xla")
    B = 64
    y = RNG.integers(0, 256, (B, sh, sw), np.uint8)
    u = RNG.integers(0, 256, (B, sh // 2, sw // 2), np.uint8)
    v = RNG.integers(0, 256, (B, sh // 2, sw // 2), np.uint8)
    oy, ou, ov = r.resize_batch(y, u, v)
    assert np.asarray(oy).shape == (B, dh, dw)
    # spot-check frames 0 and 63 against the oracle
    from libiqo_tpu.core.plan import build_plan
    pl_ = build_plan("lanczos", sw, sh, dw, dh, degree=3)
    pc = build_plan("lanczos", sw // 2, sh // 2, dw // 2, dh // 2,
                    degree=3, px_scale=2)
    for i in (0, 63):
        np.testing.assert_array_equal(np.asarray(oy)[i],
                                      numpy_ref.resize_u8(pl_, y[i]))
        np.testing.assert_array_equal(np.asarray(ou)[i],
                                      numpy_ref.resize_u8(pc, u[i]))
        np.testing.assert_array_equal(np.asarray(ov)[i],
                                      numpy_ref.resize_u8(pc, v[i]))


def test_strided_views_accepted():
    """The reference API takes explicit strides; array views cover that."""
    big = RNG.integers(0, 256, (100, 200), np.uint8)
    roi = big[10:58, 20:84]  # non-contiguous view, 48x64
    r = LanczosResizer(3, 64, 48, 32, 24, backend="xla")
    from libiqo_tpu.core.plan import build_plan
    plan = build_plan("lanczos", 64, 48, 32, 24, degree=3)
    np.testing.assert_array_equal(
        r.resize(roi), numpy_ref.resize_u8(plan, np.ascontiguousarray(roi)))
