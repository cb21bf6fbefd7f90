"""Smoke test of the resize path on NVIDIA GPUs, through its entry points.

    python chip_smoke.py             # one GPU: phases 1-5
    python chip_smoke.py --chips 4   # four GPUs: the sharded paths only

Everything runs in this one process: a second JAX process on the card
would fail for want of memory.  The first failed phase stops the run with
a non-zero exit.  Every comparison is byte-exact (0 LSB) against
``golden/numpy_ref``, the plain NumPy reference.  The one-GPU phases:

1. device   JAX's default device must be a GPU (a JAX whose CUDA plugin
            does not load silently falls back to the CPU).
2. forms    every exact-dot form of ``ops/xla_resize.py`` that can run on
            the GPU, compiled for the card at a real width.
3. configs  the graded configurations through the public resizers, with
            host numpy arrays in and out: the served path.
4. CLIs     ``resize_yuv420p`` against its numpy backend, and a short
            streaming ``benchmark``, both called in process.
5. readings first timings on the card, with device-resident input.  They
            are informative, not a benchmark.

With ``--chips 4`` only the sharded paths run: dp, row-sp and dp x sp
over four GPUs, each compared with the one-GPU result and with the
reference.  Lines with a number carry the card's name and power limit as
``nvidia-smi`` reports them.  The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from libiqo_tpu import LanczosResizer, api
from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.golden import numpy_ref
from libiqo_tpu.ops import xla_resize
from libiqo_tpu.utils.device import gpu_name_and_power_limit
from libiqo_tpu.yuv import YUV420Resizer

# (label, method, src_w, src_h, dst_w, dst_h, batch); method None = the
# luma plane alone through LanczosResizer(3, ...)
CONFIGS = [
    ("lanczos3 YUV420 4K->1080p x16", "lanczos3", 3840, 2160, 1920, 1080, 16),
    ("linear YUV420 640x480->320x240 x16", "linear", 640, 480, 320, 240, 16),
    ("area YUV420 1920x1080->480x270 x16", "area", 1920, 1080, 480, 270, 16),
    ("lanczos2 YUV420 1280x720->1920x1080 x16", "lanczos2", 1280, 720, 1920, 1080, 16),
    ("lanczos3 luma 4K->1080p x16", None, 3840, 2160, 1920, 1080, 16),
    ("lanczos3 YUV420 4K->1080p x64 video", "lanczos3", 3840, 2160, 1920, 1080, 64),
]

# Essential traffic of one YUV420 4K->1080p frame: u8 planes in and out.
FRAME_BYTES = 3840 * 2160 * 3 // 2 + 1920 * 1080 * 3 // 2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
TIMED_CALLS = 20


def log(*parts) -> None:
    print(*parts, flush=True)


def require_gpu(devices, count: int = 1) -> None:
    """Stop the run unless JAX's default devices are ``count`` GPUs."""
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX's default device is "
                 f"{devices[0].platform!r}, not a GPU")
    if len(devices) < count:
        sys.exit(f"chip_smoke: need {count} GPUs, JAX sees {len(devices)}")


def last_line(devices) -> str:
    """The run's result line, with the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def frames(rng, batch: int, h: int, w: int) -> np.ndarray:
    return rng.integers(0, 256, (batch, h, w), np.uint8)


def yuv_frames(seed: int, batch: int, w: int, h: int):
    """Seeded planar YUV420 batch at the resizer's even strides."""
    rng = np.random.default_rng(seed)
    sw, sh = w + w % 2, h + h % 2
    return (frames(rng, batch, h, w), frames(rng, batch, sh // 2, sw // 2),
            frames(rng, batch, sh // 2, sw // 2))


def assert_exact(got, want, what: str) -> None:
    """Byte equality with the reference output ``want``."""
    got = np.asarray(got)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    diff = int(np.abs(got.astype(np.int16) - want).max()) if got.size else 0
    if diff:
        raise AssertionError(f"{what}: max error {diff} LSB, "
                             f"{int((got != want).sum())} pixels differ")


def timed(fn, *args, calls: int = TIMED_CALLS):
    """Median, min and max seconds of ``calls`` calls after one warm-up,
    each ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), max(ts)


# The selection bounds of ``xla_resize._axis_mode`` that, lowered, force
# one dot form wherever the form can serve an axis (the CPU tests lower
# the same bounds).  Unforced, the GPU picks bf16 for every dense axis
# here.
FORCING = {"bf16": {}, "f32": {"_BF16_MAX_COEFS": -1},
           "int": {"_F32_EXACT_COEF_SUM": -1}, "banded": {"_DENSE_LIMIT": -1}}
FORMS = tuple(FORCING)


@contextlib.contextmanager
def forced_form(mode: str):
    """Tables built inside pack ``mode`` where ``_axis_mode`` may pick it.
    Call ``make_resize_fn`` with them directly, so that the api's
    executable cache never holds a forced form."""
    saved = {k: getattr(xla_resize, k) for k in FORCING[mode]}
    for k, v in FORCING[mode].items():
        setattr(xla_resize, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(xla_resize, k, v)


# ---- phase 1 ---------------------------------------------------------------

def phase_device(card: str, count: int) -> None:
    import jax

    devices = jax.devices()
    require_gpu(devices, count)
    d = devices[0]
    api._configure_compilation_cache()
    log(f"[device] kind={d.device_kind!r} count={len(devices)} "
        f"bytes_limit={(d.memory_stats() or {}).get('bytes_limit')}")
    log(f"[device] jax {jax.__version__}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[device] compile cache: {jax.config.jax_compilation_cache_dir}")
    log(f"[device] nvidia-smi: {card}")


# ---- phase 2 ---------------------------------------------------------------

def form_cases(modes, luma_wh=(3840, 2160, 1920, 1080)):
    """(label, plan, forced mode or None, expected (y_mode, x_mode)), where
    an expected None is not checked."""
    sw, sh, dw, dh = luma_wh
    luma = build_plan("lanczos", sw, sh, dw, dh, degree=3)
    chroma = build_plan("lanczos", sw // 2, sh // 2, dw // 2, dh // 2,
                        degree=3, px_scale=2)
    # lanczos5 px_scale=2 at 1920->1905: |tap| row sums above 65535 on X
    wide = build_plan("lanczos", 1920, sh // 2, 1905, dh // 2,
                      degree=5, px_scale=2)
    cases = [("luma chosen", luma, None, (None, None)),
             ("chroma chosen", chroma, None, (None, None)),
             ("lanczos5 px2 chosen", wide, None, (None, "int"))]
    for m in modes:
        # the 4K luma X axis is past the dense limit, so always banded
        x_luma = "banded" if sw * dw > xla_resize._DENSE_LIMIT else m
        cases.append((f"luma Y {m}", luma, m, (m, x_luma)))
        cases.append((f"chroma {m}", chroma, m, (m, m)))
    return cases


def forced_tables(plan, mode):
    if mode is None:
        return xla_resize.build_tables(plan)
    with forced_form(mode):
        return xla_resize.build_tables(plan)


def phase_forms(card: str, modes, luma_wh=(3840, 2160, 1920, 1080)) -> None:
    import jax

    rng = np.random.default_rng(2)
    srcs: dict = {}
    for label, plan, forced, expect in form_cases(modes, luma_wh):
        if id(plan) not in srcs:
            src = frames(rng, 1, plan.y.n_src, plan.x.n_src)[0]
            srcs[id(plan)] = src, numpy_ref.resize_u8(plan, src)
        src, want = srcs[id(plan)]
        t = forced_tables(plan, forced)
        if any(e not in (None, m) for e, m in zip(expect, (t.y_mode, t.x_mode))):
            raise AssertionError(f"{label}: took Y {t.y_mode}, X {t.x_mode}, "
                                 f"expected {expect}")
        fn, ops = xla_resize.make_resize_fn(plan, t)
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*ops, src).compile()
        compile_s = time.perf_counter() - t0
        assert_exact(compiled(*ops, src), want, label)
        log(f"[forms] {label}: Y {t.y_mode}, X {t.x_mode}, "
            f"{plan.x.n_src}x{plan.y.n_src}->{plan.x.n_dst}x{plan.y.n_dst}, "
            f"0 LSB, compile {compile_s:.2f} s [{card}]")


# ---- phase 3 ---------------------------------------------------------------

def make_resizer(method, sw, sh, dw, dh):
    if method is None:
        return LanczosResizer(3, sw, sh, dw, dh)
    return YUV420Resizer(method, sw, sh, dw, dh)


def yuv_plans(r: YUV420Resizer):
    return r._luma.plan, r._chroma.plan


def phase_configs(card: str, configs=CONFIGS) -> None:
    for i, (label, method, sw, sh, dw, dh, batch) in enumerate(configs):
        y, u, v = yuv_frames(10 + i, batch, sw, sh)
        r = make_resizer(method, sw, sh, dw, dh)
        t0 = time.perf_counter()
        if method is None:
            oy = r.resize(y)
            plans = [(oy, r.plan, y)]
        else:
            oy, ou, ov = r.resize_batch(y, u, v)
            pl, pc = yuv_plans(r)
            plans = [(np.asarray(oy)[..., :dh, :dw], pl, y), (ou, pc, u),
                     (ov, pc, v)]
        first_s = time.perf_counter() - t0
        for got, plan, src in plans:
            if not isinstance(got, np.ndarray):
                raise AssertionError(f"{label}: host input gave "
                                     f"{type(got).__name__} output")
            for f in (0, batch - 1):
                assert_exact(got[f], numpy_ref.resize_u8(plan, src[f]),
                             f"{label} frame {f}")
        log(f"[configs] {label}: frames 0 and {batch - 1}, all planes 0 LSB, "
            f"first call {first_s:.2f} s [{card}]")


# ---- phase 4 ---------------------------------------------------------------

def phase_clis(card: str, out_dir: Path, wh=(3840, 2160, 1920, 1080)) -> None:
    from libiqo_tpu.cli import benchmark, resize_yuv420p
    from libiqo_tpu.yuv import YUV420Frame, write_yuv420

    sw, sh, dw, dh = wh
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "cli_in.yuv"
    outs = {b: out_dir / f"cli_out_{b}.yuv" for b in ("auto", "numpy")}
    y, u, v = yuv_frames(20, 4, sw, sh)
    try:
        write_yuv420(src, [YUV420Frame(y[i], u[i], v[i]) for i in range(4)])
        for backend, path in outs.items():
            rc = resize_yuv420p.main([
                "-m", "lanczos3", "-i", str(src), "-iw", str(sw),
                "-ih", str(sh), "-o", str(path), "-ow", str(dw),
                "-oh", str(dh), "--backend", backend])
            if rc != 0:
                raise AssertionError(f"resize_yuv420p --backend {backend} "
                                     f"returned {rc}")
        a, b = (p.read_bytes() for p in outs.values())
        if a != b or not a:
            raise AssertionError("resize_yuv420p output differs from "
                                 "--backend numpy")
        log(f"[clis] resize_yuv420p: 4 frames {sw}x{sh}->{dw}x{dh}, "
            f"{len(a)} bytes equal to --backend numpy [{card}]")
    finally:
        for p in (src, *outs.values()):
            p.unlink(missing_ok=True)
    rc = benchmark.main(["-m", "lanczos3", "-iw", str(sw), "-ih", str(sh),
                         "-ow", str(dw), "-oh", str(dh), "--stream", "64",
                         "--batch", "16"])
    if rc != 0:
        raise AssertionError(f"benchmark --stream returned {rc}")
    log(f"[clis] benchmark --stream 64 --batch 16: rc 0 [{card}]")


# ---- phase 5 ---------------------------------------------------------------

def _pack(ax, mode, transpose=False):
    """One axis's operands in ``mode``, as ``build_tables`` packs them."""
    if mode == "banded":
        return xla_resize._pack_banded(ax)
    dense = ax.dense(np.int64)
    return xla_resize._pack_matrix(dense.T.copy() if transpose else dense,
                                   mode)


def _y_form(mode, cy, s):
    import jax

    return jax.vmap(lambda im: xla_resize._matmul_coef_left(cy, mode, im))(s)


def _x_form(mode, cxt, w):
    import jax

    return jax.vmap(lambda wi: xla_resize._matmul_work_right(wi, cxt, mode))(w)


def phase_readings(card: str, modes, readings: dict, configs=CONFIGS,
                   wh=(3840, 2160, 1920, 1080), batch: int = 16) -> None:
    import jax

    for i, (label, method, sw, sh, dw, dh, n) in enumerate(configs):
        y, u, v = (jax.device_put(a) for a in yuv_frames(30 + i, n, sw, sh))
        r = make_resizer(method, sw, sh, dw, dh)
        if method is None:
            med, lo, hi = timed(r.resize, y)
        else:
            med, lo, hi = timed(r.resize_batch, y, u, v)
        per = med / n
        line = (f"{label}: {per * 1e3:.4f} ms/frame median of "
                f"{TIMED_CALLS} calls (call min {lo * 1e3:.3f} ms, "
                f"max {hi * 1e3:.3f} ms, batch {n})")
        if method == "lanczos3" and (sw, sh) == (3840, 2160):
            share = FRAME_BYTES / HBM_BYTES_PER_S / per
            line += (f", byte roofline {FRAME_BYTES / HBM_BYTES_PER_S * 1e6:.2f} "
                     f"us/frame = {share:.2%} of it")
        readings[label] = {"ms_per_frame": per * 1e3, "call_ms_min": lo * 1e3,
                           "call_ms_max": hi * 1e3, "batch": n}
        log(f"[readings] {line} [{card}]")

    # headline executables: memory analysis and each form of each axis
    sw, sh, dw, dh = wh
    r = YUV420Resizer("lanczos3", sw, sh, dw, dh)
    y, u, v = (jax.device_put(a) for a in yuv_frames(40, batch, sw, sh))
    uv = jax.numpy.concatenate([u, v])
    for name, res, arg in (("luma", r._luma, y), ("chroma U+V", r._chroma, uv)):
        res._ensure_compiled()
        mem = res._jitted.lower(*res._operands, arg).compile().memory_analysis()
        fields = {k: getattr(mem, k) for k in dir(mem)
                  if k.endswith("_in_bytes")} if mem is not None else None
        readings[f"memory_analysis {name} x{batch}"] = fields
        log(f"[readings] memory_analysis {name} x{batch}: {fields} [{card}]")

    # each form of each headline axis alone; "int" serves only |tap| sums
    # above 65535, never these axes
    timed_forms = [m for m in modes if m != "int"]
    plan = r._luma.plan
    for mode in timed_forms:
        cy = tuple(jax.device_put(c) for c in _pack(plan.y, mode))
        med, lo, hi = timed(jax.jit(functools.partial(_y_form, mode)), cy, y)
        readings[f"luma Y {mode}"] = {"ms_per_frame": med / batch * 1e3}
        log(f"[readings] luma Y axis {mode} x{batch}: {med / batch * 1e3:.4f} "
            f"ms/frame (call min {lo * 1e3:.3f}, max {hi * 1e3:.3f} ms) "
            f"[{card}]")
    x_mode = xla_resize._axis_mode(plan.x)
    cxt = tuple(jax.device_put(c)
                for c in _pack(plan.x, x_mode, transpose=True))
    w = jax.device_put(np.random.default_rng(41).integers(
        -32768, 32768, (batch, dh, sw), np.int32))
    med, lo, hi = timed(jax.jit(functools.partial(_x_form, x_mode)), cxt, w)
    readings[f"luma X {x_mode}"] = {"ms_per_frame": med / batch * 1e3}
    log(f"[readings] luma X axis {x_mode} x{batch}: {med / batch * 1e3:.4f} "
        f"ms/frame (call min {lo * 1e3:.3f}, max {hi * 1e3:.3f} ms) [{card}]")

    # whole planes with each form forced, as the resizer would run them
    for name, p, src in (("luma", plan, y), ("chroma", r._chroma.plan, u)):
        for mode in timed_forms:
            t = forced_tables(p, mode)
            fn, ops = xla_resize.make_resize_fn(p, t)
            ops = tuple(jax.device_put(o) for o in ops)
            med, lo, hi = timed(jax.jit(fn), *ops, src)
            key = f"{name} plane Y {t.y_mode} X {t.x_mode}"
            readings[key] = {"ms_per_frame": med / batch * 1e3}
            log(f"[readings] {key} x{batch}: {med / batch * 1e3:.4f} "
                f"ms/frame (call min {lo * 1e3:.3f}, max {hi * 1e3:.3f} ms) "
                f"[{card}]")


# ---- four GPUs ---------------------------------------------------------------

def phase_sharded(card: str, devices, wh=(3840, 2160, 1920, 1080),
                  batch: int = 16) -> None:
    """dp, row-sp and dp x sp over four devices, each byte-compared with
    the one-device XLA result and, for one frame, with the reference."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from libiqo_tpu.parallel import sharding

    sw, sh, dw, dh = wh
    devs = np.array(devices[:4])

    def on_four(out, what):
        n = len(out.sharding.device_set)
        if n != 4:
            raise AssertionError(f"{what}: output on {n} devices, not 4")

    y, u, v = yuv_frames(50, batch, sw, sh)
    ref = YUV420Resizer("lanczos3", sw, sh, dw, dh)
    one = [np.asarray(a) for a in ref.resize_batch(*(jax.device_put(p, devices[0])
                                                     for p in (y, u, v)))]
    pl, pc = yuv_plans(ref)

    mesh = Mesh(devs, ("data",))
    step, ops = sharding.make_yuv_step_fn(mesh, sw, sh, dw, dh)
    outs = step(*ops, y, u, v)
    for name, got, want, plan, src in zip("YUV", outs, one, (pl, pc, pc),
                                          (y, u, v)):
        on_four(got, f"dp {name}")
        got = np.asarray(got)
        if not np.array_equal(got, want[..., :got.shape[-2], :got.shape[-1]]):
            raise AssertionError(f"dp {name}: differs from one GPU")
        assert_exact(got[0], numpy_ref.resize_u8(plan, src[0]),
                     f"dp {name} frame 0")
    log(f"[sharded] make_yuv_step_fn dp=4, {batch} frames {sw}x{sh}->{dw}x{dh}: "
        f"equal to one GPU, frame 0 0 LSB vs reference [{card}]")
    # device-resident timing of the same batch: dp over four GPUs against
    # the one-GPU resizer
    rep = NamedSharding(mesh, P())
    part = NamedSharding(mesh, P("data", None, None))
    med4, _, _ = timed(step, *(jax.device_put(o, rep) for o in ops),
                       *(jax.device_put(a, part) for a in (y, u, v)))
    med1, _, _ = timed(ref.resize_batch,
                       *(jax.device_put(a, devices[0]) for a in (y, u, v)))
    log(f"[sharded] dp=4 {med4 / batch * 1e3:.4f} ms/frame, one GPU "
        f"{med1 / batch * 1e3:.4f} ms/frame, median of {TIMED_CALLS} calls "
        f"of {batch} frames [{card}]")

    fn, ops = sharding.make_row_sharded_fn(pl, Mesh(devs, ("row",)))
    out = fn(*ops, y[0])
    on_four(out, "row-sp")
    if not np.array_equal(np.asarray(out), one[0][0, :dh, :dw]):
        raise AssertionError("row-sp: differs from one GPU")
    want0 = numpy_ref.resize_u8(pl, y[0])
    assert_exact(out, want0, "row-sp")
    log(f"[sharded] make_row_sharded_fn row=4, luma {sw}x{sh}->{dw}x{dh}: "
        f"equal to one GPU, 0 LSB vs reference [{card}]")

    fn, ops = sharding.make_batch_row_sharded_fn(
        pl, Mesh(devs.reshape(2, 2), ("data", "row")))
    out = fn(*ops, y[:4])
    on_four(out, "dp x sp")
    if not np.array_equal(np.asarray(out), one[0][:4, :dh, :dw]):
        raise AssertionError("dp x sp: differs from one GPU")
    assert_exact(np.asarray(out)[0], want0, "dp x sp frame 0")
    log(f"[sharded] make_batch_row_sharded_fn 2x2, 4 luma frames: equal to "
        f"one GPU, frame 0 0 LSB vs reference [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4 = run only the sharded paths over four GPUs")
    ap.add_argument("--out", type=Path, default=Path("smoke_out"),
                    help="directory for scratch files and readings.json")
    args = ap.parse_args(argv)

    import jax

    card = gpu_name_and_power_limit() or "nvidia-smi unavailable"
    phase_device(card, args.chips)
    devices = jax.devices()
    t0 = time.perf_counter()
    if args.chips == 4:
        phase_sharded(card, devices)
    else:
        readings: dict = {"card": card, "device_kind": devices[0].device_kind}
        phase_forms(card, FORMS)
        phase_configs(card)
        phase_clis(card, args.out)
        phase_readings(card, FORMS, readings)
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "readings.json").write_text(json.dumps(readings, indent=1))
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"nvidia-smi: {card}")
    print(last_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
