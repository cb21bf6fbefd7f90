"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Validates that sharded execution is byte-identical to the single-device
golden oracle — dp (frame batch) and sp (row sharding with ppermute halos).
"""

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import numpy_ref
from libiqo_tpu.parallel import sharding

RNG = np.random.default_rng(11)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _mesh(shape, names):
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def test_batch_dp_matches_oracle():
    mesh = _mesh((8,), ("data",))
    plan = build_plan("lanczos", 128, 96, 64, 48, degree=3)
    frames = RNG.integers(0, 256, (16, 96, 128), np.uint8)
    out = np.asarray(sharding.resize_batch_dp(plan, frames, mesh))
    for i in range(16):
        np.testing.assert_array_equal(out[i], numpy_ref.resize_u8(plan, frames[i]))


@pytest.mark.parametrize("algo,degree", [("lanczos", 3), ("area", 0), ("linear", 0)])
def test_row_sharded_matches_oracle(algo, degree):
    mesh = _mesh((8,), ("row",))
    kw = {"degree": degree} if algo == "lanczos" else {}
    plan = build_plan(algo, 320, 240, 160, 120, **kw)
    src = RNG.integers(0, 256, (240, 320), np.uint8)
    fn, operands = sharding.make_row_sharded_fn(plan, mesh)
    out = np.asarray(fn(*operands, src))
    np.testing.assert_array_equal(out, numpy_ref.resize_u8(plan, src))


def test_row_sharded_upsample():
    mesh = _mesh((4,), ("row",))
    plan = build_plan("lanczos", 64, 64, 128, 128, degree=2)
    src = RNG.integers(0, 256, (64, 64), np.uint8)
    fn, operands = sharding.make_row_sharded_fn(plan, mesh)
    out = np.asarray(fn(*operands, src))
    np.testing.assert_array_equal(out, numpy_ref.resize_u8(plan, src))


def test_yuv_step_dp():
    mesh = _mesh((4, 2), ("data", "row"))
    step, operands = sharding.make_yuv_step_fn(mesh, 64, 48, 32, 24, degree=3)
    B = 8
    y = RNG.integers(0, 256, (B, 48, 64), np.uint8)
    u = RNG.integers(0, 256, (B, 24, 32), np.uint8)
    v = RNG.integers(0, 256, (B, 24, 32), np.uint8)
    oy, ou, ov = step(*operands, y, u, v)
    pl = build_plan("lanczos", 64, 48, 32, 24, degree=3)
    pc = build_plan("lanczos", 32, 24, 16, 12, degree=3, px_scale=2)
    for i in range(B):
        np.testing.assert_array_equal(np.asarray(oy)[i], numpy_ref.resize_u8(pl, y[i]))
        np.testing.assert_array_equal(np.asarray(ou)[i], numpy_ref.resize_u8(pc, u[i]))
        np.testing.assert_array_equal(np.asarray(ov)[i], numpy_ref.resize_u8(pc, v[i]))


def test_yuv_step_dp_banded_form(monkeypatch):
    """The banded form (the 4K X axis on the GPU) inside shard_map: its
    scan carry must vary over the mesh axis like the frames do."""
    from libiqo_tpu.ops import xla_resize

    monkeypatch.setattr(xla_resize, "_DENSE_LIMIT", 0)
    mesh = _mesh((4,), ("data",))
    step, operands = sharding.make_yuv_step_fn(mesh, 64, 48, 32, 24, degree=3)
    y = RNG.integers(0, 256, (4, 48, 64), np.uint8)
    u = RNG.integers(0, 256, (4, 24, 32), np.uint8)
    v = RNG.integers(0, 256, (4, 24, 32), np.uint8)
    oy, ou, ov = step(*operands, y, u, v)
    pl = build_plan("lanczos", 64, 48, 32, 24, degree=3)
    pc = build_plan("lanczos", 32, 24, 16, 12, degree=3, px_scale=2)
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(oy)[i], numpy_ref.resize_u8(pl, y[i]))
        np.testing.assert_array_equal(np.asarray(ou)[i], numpy_ref.resize_u8(pc, u[i]))
        np.testing.assert_array_equal(np.asarray(ov)[i], numpy_ref.resize_u8(pc, v[i]))
    out = sharding.resize_batch_dp(pl, y, mesh)
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(out)[i], numpy_ref.resize_u8(pl, y[i]))


def test_yuv_step_odd_dims():
    """make_yuv_step_fn must follow the sample's stride semantics for odd
    dims: luma plans at TRUE dims, chroma at even-stride halves."""
    mesh = _mesh((2,), ("data",))
    step, operands = sharding.make_yuv_step_fn(mesh, 63, 47, 31, 23, degree=3)
    B = 2
    y = RNG.integers(0, 256, (B, 47, 63), np.uint8)
    u = RNG.integers(0, 256, (B, 24, 32), np.uint8)   # stride halves
    v = RNG.integers(0, 256, (B, 24, 32), np.uint8)
    oy, ou, ov = step(*operands, y, u, v)
    pl = build_plan("lanczos", 63, 47, 31, 23, degree=3)
    pc = build_plan("lanczos", 32, 24, 16, 12, degree=3, px_scale=2)
    for i in range(B):
        np.testing.assert_array_equal(np.asarray(oy)[i], numpy_ref.resize_u8(pl, y[i]))
        np.testing.assert_array_equal(np.asarray(ou)[i], numpy_ref.resize_u8(pc, u[i]))
        np.testing.assert_array_equal(np.asarray(ov)[i], numpy_ref.resize_u8(pc, v[i]))


def test_row_sharded_odd_height_pads():
    """Non-divisible heights ride the pad-and-slice wrapper: 237 source
    rows / 119 output rows on an 8-device mesh (neither divides 8)."""
    mesh = _mesh((8,), ("row",))
    plan = build_plan("lanczos", 320, 237, 160, 119, degree=3)
    src = RNG.integers(0, 256, (237, 320), np.uint8)
    fn, operands = sharding.make_row_sharded_fn(plan, mesh)
    out = np.asarray(fn(*operands, src))
    assert out.shape == (119, 160)
    np.testing.assert_array_equal(out, numpy_ref.resize_u8(plan, src))


def test_row_sharded_multi_hop_halo():
    """A tap window spanning several shards (halo > shard height) must
    chain ppermute hops: area 512->16 rows on 8 devices gives 64-row
    source shards but 32-tap windows on 2-row output shards whose band
    reaches across at least two neighbors at the edges."""
    mesh = _mesh((8,), ("row",))
    plan = build_plan("area", 128, 512, 64, 16)
    hs = 512 // 8
    assert plan.y.num_coefs * 1 >= hs // 2  # window genuinely wide
    src = RNG.integers(0, 256, (512, 128), np.uint8)
    fn, operands = sharding.make_row_sharded_fn(plan, mesh)
    np.testing.assert_array_equal(np.asarray(fn(*operands, src)),
                                  numpy_ref.resize_u8(plan, src))


def test_row_sharded_halo_taller_than_shard():
    """Extreme downscale where one output row's window covers more source
    rows than a whole shard (multi-hop halos, both directions)."""
    mesh = _mesh((8,), ("row",))
    plan = build_plan("area", 64, 256, 32, 4)        # 64-tap windows, hs=32
    assert plan.y.num_coefs > 256 // 8
    src = RNG.integers(0, 256, (256, 64), np.uint8)
    fn, operands = sharding.make_row_sharded_fn(plan, mesh)
    np.testing.assert_array_equal(np.asarray(fn(*operands, src)),
                                  numpy_ref.resize_u8(plan, src))


def test_batch_dp_non_divisible_batch():
    """dp with batch % mesh != 0 pads the frame axis and slices back."""
    mesh = _mesh((8,), ("data",))
    plan = build_plan("lanczos", 128, 96, 64, 48, degree=3)
    frames = RNG.integers(0, 256, (13, 96, 128), np.uint8)
    out = np.asarray(sharding.resize_batch_dp(plan, frames, mesh))
    assert out.shape[0] == 13
    for i in range(13):
        np.testing.assert_array_equal(out[i], numpy_ref.resize_u8(plan, frames[i]))


def test_padded_resize_batch_preserves_jax_arrays():
    """YUV420Resizer with odd dst dims must not force device->host syncs
    for jax-array batches (the zero pad stays a device op)."""
    import jax.numpy as jnp

    from libiqo_tpu.yuv import YUV420Resizer

    r = YUV420Resizer("area", 64, 48, 31, 23, backend="xla")
    y = jnp.asarray(RNG.integers(0, 256, (2, 48, 64), np.uint8))
    u = jnp.asarray(RNG.integers(0, 256, (2, 24, 32), np.uint8))
    v = jnp.asarray(RNG.integers(0, 256, (2, 24, 32), np.uint8))
    oy, ou, ov = r.resize_batch(y, u, v)
    assert not isinstance(oy, np.ndarray)
    assert oy.shape == (2, 24, 32)  # evened stride layout
    assert (np.asarray(oy)[:, 23:, :] == 0).all()
    assert (np.asarray(oy)[:, :, 31:] == 0).all()

def test_batch_row_sharded_2d_mesh():
    """dp x sp composition on a 2x4 mesh: frames over 'data', rows over
    'row'; byte-exact vs the oracle for every frame.  Odd batch (3 pads
    to 4) and non-divisible height (96 rows over 4 shards divides; 50
    dst rows pad) exercise both pad-and-slice paths."""
    mesh = _mesh((2, 4), ("data", "row"))
    plan = build_plan("lanczos", 128, 96, 96, 50, degree=3)
    fn, operands = sharding.make_batch_row_sharded_fn(plan, mesh)
    frames = RNG.integers(0, 256, (3, 96, 128), np.uint8)
    out = np.asarray(fn(*operands, frames))
    assert out.shape == (3, 50, 96)
    for i in range(3):
        np.testing.assert_array_equal(
            out[i], numpy_ref.resize_u8(plan, frames[i]))


def test_batch_row_sharded_dense_fallback():
    """The dense XLA body (vmapped over local frames) on the 2-D mesh,
    with an area plan."""
    mesh = _mesh((2, 4), ("data", "row"))
    plan = build_plan("area", 160, 120, 40, 32)
    fn, operands = sharding.make_batch_row_sharded_fn(plan, mesh)
    frames = RNG.integers(0, 256, (4, 120, 160), np.uint8)
    out = np.asarray(fn(*operands, frames))
    for i in range(4):
        np.testing.assert_array_equal(
            out[i], numpy_ref.resize_u8(plan, frames[i]))
