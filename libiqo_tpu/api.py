"""Public API: LanczosResizer / AreaResizer / LinearResizer.

Mirrors the reference facades (ref: include/libiqo/LanczosResizer.hpp:26-52,
AreaResizer.hpp:20-44, LinearResizer.hpp:20-44) with the same
construct-once / resize-many contract: the constructor does all
geometry-dependent work (coefficient plans, device tables, jit compilation
cache), ``resize`` is pure compiled compute.

Differences from the reference surface:

* ``resize`` takes/returns arrays, not raw pointers+strides; strided views
  are handled by numpy/JAX slicing at zero cost.
* ``resize`` accepts a leading batch dimension — one compiled executable
  serves any batch of the same geometry.
* ``backend=`` selects the compute path: ``"auto"`` / ``"xla"`` (the XLA
  formulation on the default JAX device, GPU or CPU) or ``"numpy"`` (the
  golden Generic oracle on the host).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .core.plan import ResizePlan, build_plan
from .golden import numpy_ref

__all__ = ["Resizer", "LanczosResizer", "AreaResizer", "LinearResizer",
           "clear_compiled_cache", "compilation_cache_dir"]

_BACKENDS = ("auto", "xla", "numpy")

# Global executable cache keyed by the plan key: the reference's
# benchmark protocol constructs a fresh resizer every cycle
# (ref: benchmark/benchmark.cpp:1019-1031); with this cache a fresh
# construction costs only the (native, ~ms) table build while compiled
# executables and device-resident tables are reused, so construct-once
# semantics survive the construct-per-cycle protocol.
# LRU-bounded: each entry pins device-resident coefficient tables (KBs to a
# few MB of device memory), so a long-lived server resizing many geometries
# must not grow without bound (the reference frees per-resizer state on
# destruction).
_COMPILED_CACHE_MAX = int(os.environ.get("LIBIQO_TPU_CACHE_SIZE", "256"))
_COMPILED_CACHE: dict = {}


def clear_compiled_cache() -> None:
    """Drop all cached executables and their device-resident tables."""
    _COMPILED_CACHE.clear()


def _cache_put(key, value) -> None:
    if _COMPILED_CACHE_MAX <= 0:
        return                            # caching disabled
    if key in _COMPILED_CACHE:
        del _COMPILED_CACHE[key]          # refresh LRU position
    elif len(_COMPILED_CACHE) >= _COMPILED_CACHE_MAX:
        oldest = next(iter(_COMPILED_CACHE))
        del _COMPILED_CACHE[oldest]
    _COMPILED_CACHE[key] = value


def _cache_get(key):
    value = _COMPILED_CACHE.get(key)
    if value is not None:
        del _COMPILED_CACHE[key]          # move to the back (most recent)
        _COMPILED_CACHE[key] = value
    return value


def _spawn_warmup(fn, *args):
    """Run ``fn`` on a daemon thread, returning a Future.

    Deliberately not a ThreadPoolExecutor: its threads are non-daemon and
    joined at interpreter exit, so a warmup still compiling when the
    server shuts down would hold the process open.  A daemon thread lets
    the process exit."""
    import concurrent.futures
    import threading

    fut: "concurrent.futures.Future" = concurrent.futures.Future()

    def run():
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 — relayed via the future
            fut.set_exception(e)

    threading.Thread(target=run, name="libiqo-warmup", daemon=True).start()
    return fut


# Fixed, git-ignored directory in the checkout: the cache path is part of
# the cache key, so it must not move between runs.
_DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"
_cache_configured = False


def compilation_cache_dir(environ=os.environ) -> str | None:
    """The persistent compilation cache in use: ``$JAX_COMPILATION_CACHE_DIR``
    when set (JAX reads it itself), else ``None`` when
    ``LIBIQO_TPU_NO_COMPILE_CACHE`` is set, else ``<checkout>/.jax_cache``."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    if environ.get("LIBIQO_TPU_NO_COMPILE_CACHE"):
        return None
    return str(_DEFAULT_CACHE_DIR)


def _configure_compilation_cache() -> None:
    """Persist compiled executables across processes, so each geometry
    compiles once per machine."""
    global _cache_configured
    if _cache_configured:
        return
    _cache_configured = True
    d = compilation_cache_dir()
    if d is None:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            return      # read-only install: run uncached rather than fail
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


class Resizer:
    """Base resizer bound to one geometry and one algorithm.

    Outputs are byte-identical to the reference Generic implementation on
    every backend.
    """

    def __init__(self, plan: ResizePlan, backend: str = "auto"):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        self._plan = plan
        self._backend = backend
        self._jitted = None       # compiled fn for the lazy device path
        self._operands = None     # device-resident tables

    # -- introspection ----------------------------------------------------

    @property
    def plan(self) -> ResizePlan:
        return self._plan

    @property
    def src_shape(self) -> tuple[int, int]:
        return (self._plan.y.n_src, self._plan.x.n_src)

    @property
    def dst_shape(self) -> tuple[int, int]:
        return (self._plan.y.n_dst, self._plan.x.n_dst)

    def resolved_backend(self) -> str:
        return "xla" if self._backend == "auto" else self._backend

    # -- compute ----------------------------------------------------------

    def _ensure_compiled(self):
        if self._jitted is not None:
            return
        key = self._plan.cache_key()
        cached = _cache_get(key)
        if cached is not None:
            self._jitted, self._operands = cached
            return
        _configure_compilation_cache()
        import jax

        from .ops import xla_resize

        fn, operands = xla_resize.make_resize_fn(self._plan)
        self._operands = tuple(jax.device_put(o) for o in operands)
        self._jitted = jax.jit(fn)
        _cache_put(key, (self._jitted, self._operands))

    def resize(self, src):
        """Resize (src_h, src_w) or (..., src_h, src_w) u8 -> u8.

        numpy in -> numpy out; jax array in -> jax array out (undeviced
        lazily, letting callers pipeline on device).
        """
        backend = self.resolved_backend()
        want_numpy = isinstance(src, np.ndarray) or backend == "numpy"
        if src.shape[-2:] != self.src_shape:
            raise ValueError(
                f"source spatial shape {src.shape[-2:]} != constructed "
                f"geometry {self.src_shape}"
            )
        if src.dtype != np.uint8:
            raise TypeError(f"source must be uint8, got {src.dtype}")

        if backend == "numpy":
            arr = np.asarray(src)
            if arr.ndim == 2:
                return numpy_ref.resize_u8(self._plan, arr)
            flat = arr.reshape((-1,) + arr.shape[-2:])
            out = np.stack([numpy_ref.resize_u8(self._plan, im) for im in flat])
            return out.reshape(arr.shape[:-2] + out.shape[-2:])

        self._ensure_compiled()
        import jax.numpy as jnp

        out = self._jitted(*self._operands, jnp.asarray(src))
        return np.asarray(out) if want_numpy else out

    # -- warmup -----------------------------------------------------------
    #
    # The FIRST resize of a fresh geometry compiles the executable, once
    # per geometry per machine thanks to the persistent compilation cache
    # (compilation_cache_dir()).  Servers should pre-build geometries at
    # startup with warmup().

    def warmup(self, batch: int | None = None):
        """Compile this resizer's executable for ``batch`` frames now
        (None = single-frame shape) instead of paying the cold-compile
        cost on the first real ``resize`` call.  Returns ``self``."""
        if self.resolved_backend() == "numpy":
            return self
        self._ensure_compiled()
        import jax
        import jax.numpy as jnp

        shape = self.src_shape if batch is None else (batch, *self.src_shape)
        out = self._jitted(*self._operands, jnp.zeros(shape, jnp.uint8))
        jax.block_until_ready(out)
        return self

    def warmup_async(self, batch: int | None = None):
        """``warmup`` on a background daemon thread (jit compilation is
        thread-safe); returns a ``concurrent.futures.Future`` resolving to
        ``self`` so servers can overlap startup work."""
        return _spawn_warmup(self.warmup, batch)


class LanczosResizer(Resizer):
    """Lanczos resampler (ref: include/libiqo/LanczosResizer.hpp:26-33).

    :param degree: window size (2 = Lanczos2, 3 = Lanczos3, ...)
    :param px_scale: pixel scale — pass 2 for U/V planes of YUV420 so the
        kernel support matches luma units (ref: sample/resize_yuv420p.cpp:159)
    """

    def __init__(self, degree: int, src_w: int, src_h: int,
                 dst_w: int, dst_h: int, px_scale: int = 1,
                 backend: str = "auto"):
        super().__init__(
            build_plan("lanczos", src_w, src_h, dst_w, dst_h,
                       degree=degree, px_scale=px_scale),
            backend,
        )


class AreaResizer(Resizer):
    """Area-average resampler, downscale-oriented
    (ref: include/libiqo/AreaResizer.hpp:20-27)."""

    def __init__(self, src_w: int, src_h: int, dst_w: int, dst_h: int,
                 backend: str = "auto"):
        super().__init__(build_plan("area", src_w, src_h, dst_w, dst_h),
                         backend)


class LinearResizer(Resizer):
    """Bilinear resampler (ref: include/libiqo/LinearResizer.hpp:20-27)."""

    def __init__(self, src_w: int, src_h: int, dst_w: int, dst_h: int,
                 backend: str = "auto"):
        super().__init__(build_plan("linear", src_w, src_h, dst_w, dst_h),
                         backend)
