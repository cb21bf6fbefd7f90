"""XLA resize path: the exact fixed-point contract as matmuls.

A separable resize is two banded matmuls,

    dst = epilogue( Cy @ src @ CxT )

with every integer quantization of the reference's Generic path reproduced
exactly (ref: src/IQO{Lanczos,Area,Linear}ResizerImpl_Generic.cpp).  This is
the one device path, on the GPU and on the CPU.

Exact integer matmuls
---------------------
A float32 dot without an explicit precision may run in TF32 on the GPU
(10-bit mantissa), which silently breaks byte parity.  We make every dot
provably exact by keeping all products and partial sums below 2**24 (f32's
exact-integer range) using one of these modes, chosen per axis at plan time:

* ``bf16`` (GPU only, num_coefs <= 258): split the 16-bit coefficient
  matrix into two 8-bit byte planes, hi = c >> 8, lo = c & 255.  Every
  operand is <= 8 bits -> every bf16 product is exact, and per-row sums are
  <= num_coefs * 255 * 255 < 2**24 in the f32 accumulator.  These dots run
  on the tensor cores.
* ``f32`` (any num_coefs, per-row sum|coef| <= 65535): f32 dots at
  ``Precision.HIGHEST`` (true f32, exact for <= 24-bit integer operands);
  sums <= 255 * 65535 < 2**24.
* ``int`` (pathological px_scale phases whose |coef| row sums exceed
  65535): s32 x s32 -> s32 dot, exact by construction, speed irrelevant.
* ``banded`` (dense matrix above ``_DENSE_LIMIT`` elements): a ``lax.scan``
  over the taps with an int32 accumulator, O(num_coefs) work per output.

The X pass additionally splits the int16 work rows into hi/lo bytes
(work = hi*256 + lo, lo in [0,256)); recombination arithmetic runs in int32
whose two's-complement wrap matches the reference's C accumulator
(ref: Generic.cpp:555,598).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.plan import AxisPlan, ResizePlan

__all__ = ["DeviceTables", "build_tables", "make_resize_fn", "resize_xla"]

_F32_EXACT_COEF_SUM = 65535   # max per-row sum(|coef|) for exact f32 dots
_BF16_MAX_COEFS = 258         # num_coefs * 255 * 255 < 2**24
_DENSE_LIMIT = 1 << 22        # elements before a dense (n_dst, n_src) matrix
#                               switches to the O(num_coefs) banded form


def _axis_mode(ax: AxisPlan, allow_banded: bool = True) -> str:
    if allow_banded and ax.n_src * ax.n_dst > _DENSE_LIMIT:
        # banded streaming form: the reference never materializes a dense
        # matrix either — it walks num_coefs taps per output
        # (ref: src/IQOAreaResizerImpl_Generic.cpp:277-294)
        return "banded"
    if int(np.abs(ax.coef.astype(np.int64)).sum(axis=1).max()) > _F32_EXACT_COEF_SUM:
        return "int"
    # bf16 byte planes only on the GPU's tensor cores: XLA:CPU's emulated
    # bf16 matmul writes past odd-width buffers (heap corruption, seen on
    # jax 0.9); CPU f32 dots are true f32 and exact for all our bounds.
    if ax.num_coefs <= _BF16_MAX_COEFS and jax.default_backend() == "gpu":
        return "bf16"
    return "f32"


def _pack_banded(ax: AxisPlan):
    """O(num_coefs) operands: per-output tap rows + clipped source indices
    (OOB taps are already zero in the plan, so clipped indices are inert)."""
    idx = np.clip(ax.start[:, None] + np.arange(ax.num_coefs, dtype=np.int64),
                  0, ax.n_src - 1)
    return (ax.coef.astype(np.int32), idx.astype(np.int32))


def _pack_matrix(dense_i64: np.ndarray, mode: str):
    """Per-mode device operands for one dense coefficient matrix."""
    if mode == "bf16":
        hi = (dense_i64 >> 8).astype(np.float32).astype(jnp.bfloat16)
        lo = (dense_i64 & 255).astype(np.float32).astype(jnp.bfloat16)
        return (hi, lo)
    if mode == "f32":
        return (dense_i64.astype(np.float32),)
    return (dense_i64.astype(np.int32),)


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Host-built dense operands for one plan (put on device by the API)."""
    cy: tuple          # mode-dependent packing of (dst_h, src_h)
    cxt: tuple         # mode-dependent packing of (src_w, dst_w)
    deno_y: np.ndarray
    deno_x: np.ndarray
    border_y: np.ndarray
    border_x: np.ndarray
    y_mode: str
    x_mode: str

    def operands(self) -> tuple:
        return (*self.cy, *self.cxt, self.deno_y, self.deno_x,
                self.border_y, self.border_x)


def build_tables(plan: ResizePlan, allow_banded: bool = True) -> DeviceTables:
    y_mode = _axis_mode(plan.y, allow_banded)
    x_mode = _axis_mode(plan.x, allow_banded)
    return DeviceTables(
        cy=(_pack_banded(plan.y) if y_mode == "banded"
            else _pack_matrix(plan.y.dense(np.int64), y_mode)),
        cxt=(_pack_banded(plan.x) if x_mode == "banded"
             else _pack_matrix(plan.x.dense(np.int64).T.copy(), x_mode)),
        deno_y=np.where(plan.y.deno == 0, 1, plan.y.deno).astype(np.int32)[:, None],
        deno_x=np.where(plan.x.deno == 0, 1, plan.x.deno).astype(np.int32)[None, :],
        border_y=plan.y.is_border[:, None],
        border_x=plan.x.is_border[None, :],
        y_mode=y_mode,
        x_mode=x_mode,
    )


def _wrap_i16(x: jax.Array) -> jax.Array:
    return ((x + 32768) & 65535) - 32768


def _trunc_div(a: jax.Array, b: jax.Array) -> jax.Array:
    """C-style division truncating toward zero == lax.div on signed ints."""
    return jax.lax.div(a, jnp.broadcast_to(b, a.shape).astype(a.dtype))


def _dot_exact_i32(a: jax.Array, b: jax.Array) -> jax.Array:
    """Single exact small-integer matmul -> int32 (operands bf16/f32/i32)."""
    if a.dtype == jnp.int32 or b.dtype == jnp.int32:
        return jnp.dot(a.astype(jnp.int32), b.astype(jnp.int32),
                       preferred_element_type=jnp.int32)
    return jnp.dot(a, b, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)


def _matmul_coef_left(c_pack: tuple, mode: str, s_u8: jax.Array) -> jax.Array:
    """coef @ src as exact int32.  ``s_u8`` values are 0..255."""
    if mode == "banded":
        # stream num_coefs row-gathers (O(taps * n_dst * W) work, O(n_dst * W)
        # memory), accumulating in int32 whose wrap matches the reference's C
        # accumulator (ref: src/IQOAreaResizerImpl_Generic.cpp:277-294)
        coef, idx = c_pack
        s = s_u8.astype(jnp.int32)

        def tap(c_t, i_t):
            return c_t[:, None] * jnp.take(s, i_t, axis=0)

        # the first tap seeds the carry, so it varies with the input like
        # the sum does (a constant zero carry fails shard_map's check)
        acc, _ = jax.lax.scan(lambda acc, t: (acc + tap(*t), None),
                              tap(coef[:, 0], idx[:, 0]),
                              (coef.T[1:], idx.T[1:]))
        return acc
    if mode == "bf16":
        hi, lo = c_pack
        s = s_u8.astype(jnp.bfloat16)
        return (_dot_exact_i32(hi, s) * 256 + _dot_exact_i32(lo, s))
    if mode == "f32":
        return _dot_exact_i32(c_pack[0], s_u8.astype(jnp.float32))
    return jnp.dot(c_pack[0], s_u8.astype(jnp.int32),
                   preferred_element_type=jnp.int32)


def _matmul_work_right(w_i32: jax.Array, c_pack: tuple, mode: str) -> jax.Array:
    """work @ coefT as exact int32.  ``w_i32`` values span int16/uint16."""
    if mode == "banded":
        coef, idx = c_pack  # (n_dst_x, taps)

        def tap(c_t, i_t):
            return c_t[None, :] * jnp.take(w_i32, i_t, axis=1)

        acc, _ = jax.lax.scan(lambda acc, t: (acc + tap(*t), None),
                              tap(coef[:, 0], idx[:, 0]),
                              (coef.T[1:], idx.T[1:]))
        return acc
    w_lo = w_i32 & 255
    w_hi = w_i32 >> 8
    if mode == "bf16":
        chi, clo = c_pack
        wl = w_lo.astype(jnp.bfloat16)
        wh = w_hi.astype(jnp.bfloat16)
        hh = _dot_exact_i32(wh, chi)
        hl = _dot_exact_i32(wh, clo)
        lh = _dot_exact_i32(wl, chi)
        ll = _dot_exact_i32(wl, clo)
        # int32 two's-complement recombination == reference C accumulator
        return hh * 65536 + (hl + lh) * 256 + ll
    if mode == "f32":
        c = c_pack[0]
        hi = _dot_exact_i32(w_hi.astype(jnp.float32), c)
        lo = _dot_exact_i32(w_lo.astype(jnp.float32), c)
        return hi * 256 + lo
    return jnp.dot(w_i32, c_pack[0], preferred_element_type=jnp.int32)


def _resize_2d(static, tables, src: jax.Array) -> jax.Array:
    """One (src_h, src_w) u8 image -> (dst_h, dst_w) u8."""
    (wrap16, y_bias, out_shift, y_has_border, x_has_border,
     y_mode, x_mode, n_cy) = static
    cy_pack = tables[:n_cy]
    rest = tables[n_cy:]
    n_cx = len(rest) - 4
    cxt_pack = rest[:n_cx]
    deno_y, deno_x, border_y, border_x = rest[n_cx:]

    # ---- Y pass ---------------------------------------------------------
    nume = _matmul_coef_left(cy_pack, y_mode, src)
    if wrap16:
        w = _wrap_i16(nume)
        if y_has_border:
            border_val = _wrap_i16(_trunc_div(w * y_bias, deno_y))
            w = jnp.where(border_y, border_val, w)
    else:
        w = nume  # area/linear sums bounded by design (<= 255*bias)

    # ---- X pass ---------------------------------------------------------
    sums = _matmul_work_right(w, cxt_pack, x_mode)
    half = 1 << (out_shift - 1)
    main = (sums + half) >> out_shift
    if x_has_border:
        border_val = _trunc_div(sums + half, deno_x * y_bias)
        v = jnp.where(border_x, border_val, main)
    else:
        v = main
    v = _wrap_i16(v)  # convertToInt/roundedDiv narrow to int16 pre-clamp
    return jnp.clip(v, 0, 255).astype(jnp.uint8)


def make_resize_fn(plan: ResizePlan, tables: DeviceTables | None = None):
    """Build a jittable resize over (..., src_h, src_w) u8 arrays.

    Returns (fn, host_operands): call ``fn(*operands, src)``.  Leading batch
    dims vmap through one compiled executable (the construct-once contract,
    ref: include/libiqo/LanczosResizer.hpp:17-25).
    """
    t = tables if tables is not None else build_tables(plan)
    static = (plan.wrap16, plan.y.bias, plan.out_shift,
              bool(plan.y.is_border.any()), bool(plan.x.is_border.any()),
              t.y_mode, t.x_mode, len(t.cy))

    def fn(*args):
        *ops, src = args
        ops = tuple(ops)
        if src.ndim == 2:
            return _resize_2d(static, ops, src)
        batch_shape = src.shape[:-2]
        flat = src.reshape((-1,) + src.shape[-2:])
        out = jax.vmap(lambda im: _resize_2d(static, ops, im))(flat)
        return out.reshape(batch_shape + out.shape[-2:])

    return fn, t.operands()


def resize_xla(plan: ResizePlan, src, tables: DeviceTables | None = None):
    """One-shot convenience; normal use goes through api.py's jit cache."""
    fn, operands = make_resize_fn(plan, tables)
    return jax.jit(fn)(*operands, jnp.asarray(src))
