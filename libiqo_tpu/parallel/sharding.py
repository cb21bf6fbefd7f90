"""Multi-device scaling: device-mesh sharding for batched and spatial resize.

The reference's only parallelism is OpenMP row striping in shared memory
(ref: src/IQOLanczosResizerImpl_AVX512.cpp:269-308, src/IQOHWCap.cpp:14-30);
it has no distributed backend at all.  The equivalents here:

* **dp (batch/data parallel)** — shard the frame axis of a batch across the
  mesh; resizing is embarrassingly parallel per frame so XLA inserts no
  collectives at all.
* **sp (spatial / row sharding)** — shard source rows across devices for
  frames too large (or latency-sensitive) for one device.  The Y pass needs
  a halo of neighbor rows (the tap window crosses shard boundaries); we
  exchange fixed-size halos with mesh neighbors via ``jax.lax.ppermute``
  inside ``shard_map`` — the only communication in the whole framework.

The two compose over a 2-D mesh (``make_batch_row_sharded_fn``): frames
over one axis, rows over the other, halos moving along the row axis only.
Every per-device body is the XLA formulation of ``ops/xla_resize.py``.
The GPUs of one host are joined all to all (NVLink), so meshes follow the
algorithm alone and take devices in plain order.  tp/pp/ep have no analog
here: there are no weight matrices to split, no layer pipeline, no
experts — a resize plan's "weights" are KB-scale coefficient tables,
replicated everywhere.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.plan import ResizePlan
from ..ops import xla_resize

__all__ = ["resize_batch_dp", "make_row_sharded_fn",
           "make_batch_row_sharded_fn", "make_yuv_step_fn"]


def resize_batch_dp(plan: ResizePlan, frames, mesh: Mesh, axis: str = "data"):
    """Resize a (B, H, W) u8 batch with B sharded over ``axis``.

    Each device resizes its local batch shard via shard_map; no
    collectives — outputs stay sharded.  Batches not divisible by the mesh
    extent are zero-padded on the frame axis and sliced back (the analog
    of OpenMP's any-count row striping).
    """
    from jax import shard_map

    n = mesh.shape[axis]
    b = frames.shape[0]
    pad = -b % n
    if pad:
        pad_w = [(0, pad)] + [(0, 0)] * (frames.ndim - 1)
        frames = (np.pad(frames, pad_w) if isinstance(frames, np.ndarray)
                  else jnp.pad(frames, pad_w))

    fn, operands = xla_resize.make_resize_fn(plan)
    in_specs = (*[P()] * len(operands), P(axis, None, None))
    sm = shard_map(fn, mesh=mesh, in_specs=in_specs,
                   out_specs=P(axis, None, None))
    in_shard = NamedSharding(mesh, P(axis, None, None))
    frames = jax.device_put(frames, in_shard)
    ops = [jax.device_put(o, NamedSharding(mesh, P())) for o in operands]
    out = jax.jit(sm)(*ops, frames)
    return out[:b] if pad else out


def _row_shard_layout(plan: ResizePlan, n: int):
    """Host-side layout for row sharding: per-device output blocks, the
    source band each needs, and the halo sizes to exchange with neighbors.

    Requires dst_h and src_h divisible by n (pad upstream otherwise).
    """
    y = plan.y
    src_h, dst_h = y.n_src, y.n_dst
    if src_h % n or dst_h % n:
        # make_row_sharded_fn pads the plan to divisibility before calling
        raise ValueError(f"src_h={src_h} and dst_h={dst_h} must divide the "
                         f"row-shard count {n}")
    hs, hd = src_h // n, dst_h // n
    # source row range needed by each output block (OOB taps are zero-coef,
    # so clip to valid rows)
    starts = y.start
    lo = np.array([max(0, int(starts[d * hd:(d + 1) * hd].min())) for d in range(n)])
    hi = np.array([min(src_h, int(starts[d * hd:(d + 1) * hd].max()) + y.num_coefs)
                   for d in range(n)])
    halo_up = int(np.max(np.maximum(0, np.arange(n) * hs - lo)))
    halo_dn = int(np.max(np.maximum(0, hi - (np.arange(n) + 1) * hs)))
    # halos taller than one shard are fine: _halo_exchange chains ppermute
    # hops to reach any distance
    # per-device Cy block over the (halo_up + hs + halo_dn) band
    band = halo_up + hs + halo_dn
    cy_full = plan.y.dense(np.int64)
    cy_blocks = np.zeros((n, hd, band), dtype=np.int64)
    for d in range(n):
        base = d * hs - halo_up
        for j in range(band):
            s = base + j
            if 0 <= s < src_h:
                cy_blocks[d, :, j] = cy_full[d * hd:(d + 1) * hd, s]
    return hs, hd, halo_up, halo_dn, cy_blocks


def _halo_exchange(src, axis: str, n: int, halo_up: int, halo_dn: int):
    """Extend a device's local row shard with neighbor halos.

    Rows live on axis -2, so the same exchange serves (rows, w) shards and
    batched (b, rows, w) shards (dp x sp meshes).  Halos taller than one
    shard chain multiple ppermute hops: hop ``h`` carries the tail (up) /
    head (down) rows of the shard ``h`` devices away, so any tap window is
    reachable regardless of the shard height.  Wrapped edges (rows that
    would come from before device 0 / after device n-1) are masked to
    zero: the corresponding taps are zero too, matching the reference
    dropping out-of-range taps at runtime.
    """
    idx = jax.lax.axis_index(axis)
    hs = src.shape[-2]
    up_parts, dn_parts = [], []
    for h in range(1, -(-halo_up // hs) + 1):
        t = min(hs, halo_up - (h - 1) * hs)    # rows carried by hop h
        piece = src[..., hs - t:, :]
        moved = jax.lax.ppermute(piece, axis,
                                 [(i, (i + h) % n) for i in range(n)])
        up_parts.insert(0, jnp.where(idx >= h, moved, jnp.zeros_like(moved)))
    for h in range(1, -(-halo_dn // hs) + 1):
        t = min(hs, halo_dn - (h - 1) * hs)
        piece = src[..., :t, :]
        moved = jax.lax.ppermute(piece, axis,
                                 [(i, (i - h) % n) for i in range(n)])
        dn_parts.append(jnp.where(idx < n - h, moved, jnp.zeros_like(moved)))
    parts = up_parts + [src] + dn_parts
    return jnp.concatenate(parts, axis=-2) if len(parts) > 1 else src


def _pad_rows_plan(plan: ResizePlan, n: int):
    """Extend a plan's Y axis so src_h and dst_h divide ``n``.

    Padded source rows hold zeros and no real output's taps reach them
    (taps past the true n_src are already clipped to zero in the plan);
    padded output rows get all-zero tap rows and are sliced off by the
    wrapper.  Returns (padded_plan, src_pad, dst_pad).
    """
    y = plan.y
    src_pad = -y.n_src % n
    dst_pad = -y.n_dst % n
    if not src_pad and not dst_pad:
        return plan, 0, 0
    coef = np.concatenate(
        [y.coef, np.zeros((dst_pad, y.num_coefs), y.coef.dtype)])
    # pad starts repeat the last real window (kept in range so per-device
    # band bounds stay tight); their taps are zero so values don't matter
    start = np.concatenate(
        [y.start, np.full(dst_pad, int(y.start[-1]) if y.n_dst else 0,
                          y.start.dtype)])
    deno = np.concatenate([y.deno, np.ones(dst_pad, y.deno.dtype)])
    is_border = np.concatenate([y.is_border, np.zeros(dst_pad, bool)])
    y_pad = dataclasses.replace(
        y, n_src=y.n_src + src_pad, n_dst=y.n_dst + dst_pad,
        coef=coef, start=start, deno=deno, is_border=is_border)
    return dataclasses.replace(plan, y=y_pad), src_pad, dst_pad


def make_row_sharded_fn(plan: ResizePlan, mesh: Mesh, axis: str = "row"):
    """Build a jitted (src_h, src_w) -> (dst_h, dst_w) resize with source
    and output rows sharded over ``axis``; Y-pass halos move via ppermute
    (multi-hop when a tap window spans several shards).

    Any height works: non-divisible src/dst heights are zero-padded to the
    shard count with all-zero coefficient rows and sliced back after — the
    analog of OpenMP striping handling any row count
    (ref: src/IQOLanczosResizerImpl_AVX512.cpp:269-308).

    Returns (fn, operands): call fn(*operands, src) with src row-sharded.
    """
    n_dev = mesh.shape[axis]
    plan, src_pad, dst_pad = _pad_rows_plan(plan, n_dev)
    if src_pad or dst_pad:
        inner_fn, operands = make_row_sharded_fn(plan, mesh, axis)
        true_dst = plan.y.n_dst - dst_pad

        def fn(*args):
            *ops, src = args
            src = jnp.pad(src, ((0, src_pad), (0, 0)))
            return inner_fn(*ops, src)[:true_dst]

        return jax.jit(fn), operands
    return _make_row_sharded_dense(plan, mesh, axis)


def _make_row_sharded_dense(plan: ResizePlan, mesh: Mesh, axis: str,
                            data_axis: str | None = None):
    """Row-sharded resize with the dense XLA formulation as the per-device
    body.  With ``data_axis`` the source carries a leading frame axis
    sharded over it; the per-device math vmaps over the local frames AFTER
    the halo exchange, so the collective runs once per step regardless of
    batch."""
    from jax import shard_map

    n = mesh.shape[axis]
    hs, hd, halo_up, halo_dn, cy_blocks = _row_shard_layout(plan, n)
    # dense modes only: this path packs explicit per-device Cy blocks
    t = xla_resize.build_tables(plan, allow_banded=False)

    # pack per-device Cy blocks in the same exact-dot format
    cy_pack = xla_resize._pack_matrix(cy_blocks.reshape(n * hd, -1), t.y_mode)
    cy_pack = tuple(np.asarray(c).reshape(n, hd, -1) for c in cy_pack)
    n_cy = len(cy_pack)
    static = (plan.wrap16, plan.y.bias, plan.out_shift,
              bool(plan.y.is_border.any()), bool(plan.x.is_border.any()),
              t.y_mode, t.x_mode, n_cy)

    def local_fn(*args):
        *ops, deno_y, border_y, src = args
        cy_p = tuple(o[0] for o in ops[:n_cy])       # squeeze device dim
        # X-pass tables are replicated (KB-scale next to the frames)
        tables = (*cy_p, *ops[n_cy:], deno_y[0], t.deno_x, border_y[0],
                  t.border_x)
        band = _halo_exchange(src, axis, n, halo_up, halo_dn)

        def compute(band2d):
            return xla_resize._resize_2d(static, tables, band2d)

        return jax.vmap(compute)(band) if data_axis else compute(band)

    deno_y = np.where(plan.y.deno == 0, 1, plan.y.deno).astype(np.int32)
    deno_y = deno_y.reshape(n, hd)[:, :, None]
    border_y = plan.y.is_border.reshape(n, hd)[:, :, None]

    src_spec = P(data_axis, axis, None) if data_axis else P(axis, None)
    in_specs = (
        *[P(axis, None, None)] * n_cy,          # per-device Cy blocks
        *[P()] * len(t.cxt),                    # replicated X tables
        P(axis, None, None),                    # deno_y blocks
        P(axis, None, None),                    # border_y blocks
        src_spec,                               # src rows
    )
    sm = shard_map(local_fn, mesh=mesh,
                   in_specs=in_specs, out_specs=src_spec)
    operands = (*cy_pack, *t.cxt, deno_y, border_y)
    return jax.jit(sm), operands


def make_batch_row_sharded_fn(plan: ResizePlan, mesh: Mesh,
                              data_axis: str = "data", row_axis: str = "row"):
    """dp x sp over a 2-D mesh: resize a (B, src_h, src_w) u8 batch with
    frames sharded over ``data_axis`` AND rows over ``row_axis``.

    Composes the two parallelism modes: frame parallelism needs no
    communication; the Y-pass halos move via ppermute along ``row_axis``
    only, so the collective scales with mesh rows, not total devices.  Any
    batch size and any height work (zero-padded to the mesh extents and
    sliced back).  The per-device body is the dense XLA formulation
    vmapped over local frames.

    Returns (fn, operands): call fn(*operands, batch) with batch
    (B, src_h, src_w); output is (B, dst_h, dst_w), sharded the same way.
    """
    n_data = mesh.shape[data_axis]
    n_row = mesh.shape[row_axis]
    plan_p, src_pad, dst_pad = _pad_rows_plan(plan, n_row)
    inner, operands = _make_row_sharded_dense(plan_p, mesh, row_axis,
                                              data_axis=data_axis)
    true_dst = plan_p.y.n_dst - dst_pad

    def fn(*args):
        *ops, src = args
        b = src.shape[0]
        b_pad = -b % n_data
        if b_pad or src_pad:
            src = jnp.pad(src, ((0, b_pad), (0, src_pad), (0, 0)))
        out = inner(*ops, src)
        return out[:b, :true_dst]

    return jax.jit(fn), operands


def make_yuv_step_fn(mesh: Mesh, src_w: int, src_h: int, dst_w: int, dst_h: int,
                     degree: int = 3, data_axis: str = "data"):
    """The framework's full multi-device "step": a batched YUV420 frame
    resize (Y at full size, U/V at half size with px_scale=2,
    ref: sample/resize_yuv420p.cpp:150-163) with the batch sharded over
    ``data_axis`` via shard_map — each device resizes its local frame
    shard.  Frame-parallel resizing needs no collectives; the row-sharded
    path (make_row_sharded_fn) covers the spatial axis.

    Returns (step, operands): step(*operands, y, u, v) -> (Y', U', V').
    """
    from jax import shard_map

    from ..core.plan import build_plan

    # same stride semantics as yuv.YUV420Resizer: luma at TRUE (possibly
    # odd) dims, chroma at even-stride-derived dims
    # (ref: sample/resize_yuv420p.cpp:66-69,125-159) — callers pass luma
    # planes of shape (src_h, src_w) and chroma of the stride-halves
    sw, sh = src_w + src_w % 2, src_h + src_h % 2
    dw, dh = dst_w + dst_w % 2, dst_h + dst_h % 2
    plan_l = build_plan("lanczos", src_w, src_h, dst_w, dst_h, degree=degree)
    plan_c = build_plan("lanczos", sw // 2, sh // 2, dw // 2, dh // 2,
                        degree=degree, px_scale=2)

    fn_l, ops_l = xla_resize.make_resize_fn(plan_l)
    fn_c, ops_c = xla_resize.make_resize_fn(plan_c)
    n_l, n_c = len(ops_l), len(ops_c)

    def step(*args):
        ol = args[:n_l]
        oc = args[n_l:n_l + n_c]
        y, u, v = args[n_l + n_c:]
        return fn_l(*ol, y), fn_c(*oc, u), fn_c(*oc, v)

    in_specs = (
        *[P()] * (n_l + n_c),
        P(data_axis, None, None),
        P(data_axis, None, None),
        P(data_axis, None, None),
    )
    sm = shard_map(step, mesh=mesh, in_specs=in_specs,
                   out_specs=P(data_axis, None, None))
    return jax.jit(sm), (*ops_l, *ops_c)
