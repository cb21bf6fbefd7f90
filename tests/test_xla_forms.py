"""Every dense-or-banded form of the XLA path on the CPU, forced per test.

The banded form serves the 4K X axis on the GPU and the int form the
pathological px_scale phases; neither is what the CPU picks for these
geometries on its own.  Forms are forced by lowering the selection bounds
inside the test, and ``make_resize_fn`` is called directly so that the
api's executable cache never holds a forced form.  bf16 never runs on the
CPU (XLA:CPU's emulated bf16 dot corrupts the heap).
"""

import jax
import numpy as np
import pytest

from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import numpy_ref
from libiqo_tpu.ops import xla_resize

from test_api_xla import GEOMETRIES

ALGOS = [("lanczos", {"degree": 3}), ("area", {}), ("linear", {})]


@pytest.mark.parametrize("form", ["banded", "int"])
@pytest.mark.parametrize("algo,kw", ALGOS, ids=[a for a, _ in ALGOS])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_forced_form_matches_oracle(geom, algo, kw, form, monkeypatch):
    if form == "banded":
        monkeypatch.setattr(xla_resize, "_DENSE_LIMIT", 0)
    else:
        monkeypatch.setattr(xla_resize, "_F32_EXACT_COEF_SUM", -1)
    sw, sh, dw, dh = geom
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    t = xla_resize.build_tables(plan)
    assert (t.y_mode, t.x_mode) == (form, form)
    fn, ops = xla_resize.make_resize_fn(plan, t)
    src = np.random.default_rng(sw * sh + dw).integers(0, 256, (sh, sw), np.uint8)
    np.testing.assert_array_equal(np.asarray(jax.jit(fn)(*ops, src)),
                                  numpy_ref.resize_u8(plan, src))
