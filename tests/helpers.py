"""Shared test helpers (not collected by pytest)."""

import numpy as np

from libiqo_tpu.golden import numpy_ref


def assert_defined_divergence(plan, src, msg=""):
    """For geometries where the reference hits UB (OOB reads, SIGFPE, heap
    overflow) the behavior is ours to define: clamp/replicate semantics
    documented at core/plan.py (_axis_linear) and the golden oracle.  Assert
    both implementations (golden NumPy, XLA) agree on those defined outputs
    instead of skipping the geometry entirely.
    """
    import jax

    from libiqo_tpu.ops import xla_resize

    golden = numpy_ref.resize_u8(plan, src)
    fn, ops = xla_resize.make_resize_fn(plan)
    got = np.asarray(jax.jit(fn)(*ops, src))
    np.testing.assert_array_equal(got, golden, err_msg=f"xla {msg}")
