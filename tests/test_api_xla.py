"""XLA device path vs the golden oracle, byte-exact, on CPU backend.

Covers the graded BASELINE configs and the quirk corners (identity,
single-axis, gcd=1, inverted main ranges, pathological px_scale) plus
batching.
"""

import numpy as np
import pytest

from libiqo_tpu import AreaResizer, LanczosResizer, LinearResizer
from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import numpy_ref

RNG = np.random.default_rng(7)

GEOMETRIES = [
    (640, 480, 320, 240),
    (1920, 1080, 480, 270),
    (1280, 720, 1920, 1080),
    (100, 80, 99, 79),
    (97, 61, 31, 23),
    (64, 64, 64, 64),
    (64, 48, 64, 24),
    (64, 48, 32, 48),
    (321, 241, 123, 97),
    (16, 16, 3, 3),
]


def _img(w, h):
    return RNG.integers(0, 256, size=(h, w), dtype=np.uint8)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("degree,px_scale", [(2, 1), (3, 1), (3, 2)])
def test_lanczos_xla(geom, degree, px_scale):
    sw, sh, dw, dh = geom
    src = _img(sw, sh)
    r = LanczosResizer(degree, sw, sh, dw, dh, px_scale, backend="xla")
    want = numpy_ref.resize_u8(r.plan, src)
    np.testing.assert_array_equal(r.resize(src), want)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_area_xla(geom):
    sw, sh, dw, dh = geom
    src = _img(sw, sh)
    r = AreaResizer(sw, sh, dw, dh, backend="xla")
    want = numpy_ref.resize_u8(r.plan, src)
    np.testing.assert_array_equal(r.resize(src), want)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_linear_xla(geom):
    sw, sh, dw, dh = geom
    src = _img(sw, sh)
    r = LinearResizer(sw, sh, dw, dh, backend="xla")
    want = numpy_ref.resize_u8(r.plan, src)
    np.testing.assert_array_equal(r.resize(src), want)


def test_batched_matches_loop():
    sw, sh, dw, dh = 160, 120, 80, 60
    batch = RNG.integers(0, 256, size=(5, sh, sw), dtype=np.uint8)
    r = LanczosResizer(3, sw, sh, dw, dh, backend="xla")
    out = r.resize(batch)
    assert out.shape == (5, dh, dw)
    for i in range(5):
        np.testing.assert_array_equal(out[i], r.resize(batch[i]))


def test_input_validation():
    r = LinearResizer(64, 48, 32, 24, backend="xla")
    with pytest.raises(ValueError):
        r.resize(np.zeros((47, 64), np.uint8))
    with pytest.raises(TypeError):
        r.resize(np.zeros((48, 64), np.float32))
    with pytest.raises(ValueError):
        build_plan("area", 0, 4, 2, 2)
    with pytest.raises(ValueError):
        build_plan("nearest", 4, 4, 2, 2)


def test_numpy_backend_and_jax_io():
    import jax.numpy as jnp

    src = _img(64, 48)
    r = AreaResizer(64, 48, 16, 12, backend="numpy")
    want = numpy_ref.resize_u8(r.plan, src)
    np.testing.assert_array_equal(r.resize(src), want)
    r2 = AreaResizer(64, 48, 16, 12, backend="xla")
    out = r2.resize(jnp.asarray(src))
    assert not isinstance(out, np.ndarray)  # jax in -> jax out
    np.testing.assert_array_equal(np.asarray(out), want)


def test_warmup_compiles_and_serves():
    """warmup()/warmup_async() pre-build the executable (a first-call
    compile takes seconds); subsequent resizes reuse it and stay exact."""
    r = LanczosResizer(2, 96, 64, 48, 32, backend="xla")
    assert r.warmup() is r
    assert r._jitted is not None
    fut = LanczosResizer(2, 96, 64, 48, 32, backend="xla").warmup_async(batch=2)
    r2 = fut.result(timeout=120)
    src = _img(96, 64)
    np.testing.assert_array_equal(r.resize(src), r2.resize(src))
    np.testing.assert_array_equal(r.resize(src),
                                  numpy_ref.resize_u8(r.plan, src))
