"""Randomized geometry fuzzing of the device (XLA) path against the golden
oracle.  Seeded per case, so a failure reproduces on its own."""

import jax
import numpy as np
import pytest

from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import numpy_ref
from libiqo_tpu.ops import xla_resize


@pytest.mark.parametrize("i", range(40))
def test_fuzz_xla_path(i):
    """Device (XLA) path vs oracle on random geometries."""
    rng = np.random.default_rng(9000 + i)
    sw, sh = int(rng.integers(8, 700)), int(rng.integers(8, 500))
    dw, dh = int(rng.integers(4, 700)), int(rng.integers(4, 500))
    algo = ("lanczos", "area", "linear")[i % 3]
    kw = ({"degree": int(rng.integers(1, 10)),
           "px_scale": int(rng.integers(1, 3))} if algo == "lanczos" else {})
    plan = build_plan(algo, sw, sh, dw, dh, **kw)
    src = rng.integers(0, 256, (sh, sw), np.uint8)
    fn, ops = xla_resize.make_resize_fn(plan)
    got = np.asarray(jax.jit(fn)(*ops, src))
    np.testing.assert_array_equal(
        got, numpy_ref.resize_u8(plan, src),
        err_msg=f"{algo} {kw} {sw}x{sh}->{dw}x{dh} seed {9000 + i}")
