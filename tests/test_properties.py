"""Property tests across backends (SURVEY §4's implied invariants)."""

import numpy as np
import pytest

from libiqo_tpu import AreaResizer, LanczosResizer, LinearResizer
from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import numpy_ref
from libiqo_tpu.utils.device import caps, describe

RNG = np.random.default_rng(33)


def _resizers(backend):
    return [
        LanczosResizer(3, 160, 120, 67, 53, backend=backend),
        AreaResizer(160, 120, 67, 53, backend=backend),
        LinearResizer(160, 120, 67, 53, backend=backend),
    ]


@pytest.mark.parametrize("backend", ["numpy", "xla"])
def test_flat_invariance(backend):
    """Exact-sum quantization must keep flat images flat (128 -> 128)."""
    for r in _resizers(backend):
        for val in (0, 128, 255):
            src = np.full((120, 160), val, np.uint8)
            out = r.resize(src)
            assert (out == val).all(), (type(r).__name__, backend, val)


def test_flat_image_invariance():
    """Exact-sum quantization must map flat 128 -> flat 128 (SURVEY §4)."""
    for algo in ("lanczos", "area", "linear"):
        plan = build_plan(algo, 320, 200, 123, 77, degree=3)
        src = np.full((200, 320), 128, dtype=np.uint8)
        out = numpy_ref.resize_u8(plan, src)
        assert (out == 128).all(), algo


def test_identity_resize_is_identity():
    src = RNG.integers(0, 256, (64, 64), np.uint8)
    for algo, kw in (("lanczos", dict(degree=3)), ("area", {}), ("linear", {})):
        plan = build_plan(algo, 64, 64, 64, 64, **kw)
        np.testing.assert_array_equal(numpy_ref.resize_u8(plan, src), src, algo)


def test_area_energy_conservation_integer_ratio():
    """For integer-ratio area downsampling, the mean is preserved within
    quantization (box filter averages exactly)."""
    src = RNG.integers(0, 256, (128, 128), np.uint8)
    plan = build_plan("area", 128, 128, 32, 32)
    out = numpy_ref.resize_u8(plan, src)
    assert abs(float(out.mean()) - float(src.mean())) < 1.0


def test_monotone_gradient_stays_monotone_linear():
    src = np.tile(np.arange(0, 200, dtype=np.uint8), (16, 1))
    plan = build_plan("linear", 200, 16, 100, 8)
    out = numpy_ref.resize_u8(plan, src)
    assert (np.diff(out[4].astype(int)) >= 0).all()


def test_device_caps():
    c = caps()
    assert c.num_devices >= 1
    assert c.platform in ("cpu", "gpu")
    assert isinstance(describe(), str) and c.device_kind in describe()


def test_resolved_backend_consistency():
    r = AreaResizer(64, 48, 32, 24)
    assert r.resolved_backend() == "xla"
    assert AreaResizer(64, 48, 32, 24, backend="numpy").resolved_backend() == "numpy"
    with pytest.raises(ValueError):
        AreaResizer(64, 48, 32, 24, backend="pallas")
