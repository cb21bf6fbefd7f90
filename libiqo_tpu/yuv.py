"""YUV420 planar frame resizing — the reference's flagship workload.

Mirrors sample/resize_yuv420p.cpp: the Y plane resizes at full size and the
U/V planes at half size; Lanczos chroma passes px_scale=2 so the window
support matches luma units (ref: sample/resize_yuv420p.cpp:150-163).  All
three planes run as one fused jitted graph (construct-once, resize-many).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .api import AreaResizer, LanczosResizer, LinearResizer, Resizer

__all__ = ["YUV420Frame", "YUV420Resizer", "iter_yuv420", "read_yuv420",
           "write_yuv420"]


@dataclasses.dataclass
class YUV420Frame:
    """One planar YUV420 frame: Y (h, w), U and V (h/2, w/2), all uint8."""
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray

    @property
    def width(self) -> int:
        return self.y.shape[-1]

    @property
    def height(self) -> int:
        return self.y.shape[-2]


def _even(v: int) -> int:
    """Strides rounded up to even, as the sample does
    (ref: sample/resize_yuv420p.cpp:66-69)."""
    return (v + 1) & ~1


def iter_yuv420(path: str, width: int, height: int,
                frames: int | None = None):
    """Stream raw planar YUV420 frames one at a time (constant memory —
    the reference sample also reads frame-by-frame,
    ref: sample/resize_yuv420p.cpp:94-112)."""
    w, h = _even(width), _even(height)
    cw, ch = w // 2, h // 2
    frame_bytes = w * h + 2 * cw * ch
    n = 0
    with open(path, "rb") as fp:
        while frames is None or n < frames:
            buf = fp.read(frame_bytes)
            if len(buf) < frame_bytes:
                return
            f = np.frombuffer(buf, dtype=np.uint8)
            yield YUV420Frame(
                y=f[: w * h].reshape(h, w),
                u=f[w * h: w * h + cw * ch].reshape(ch, cw),
                v=f[w * h + cw * ch:].reshape(ch, cw))
            n += 1


def read_yuv420(path: str, width: int, height: int, frames: int | None = None):
    """Read raw planar YUV420 frames into a list (convenience wrapper over
    :func:`iter_yuv420`; use the iterator for giant files)."""
    return list(iter_yuv420(path, width, height, frames))


def write_yuv420(path: str, frames) -> None:
    with open(path, "wb") as fp:
        for f in frames:
            fp.write(np.ascontiguousarray(f.y).tobytes())
            fp.write(np.ascontiguousarray(f.u).tobytes())
            fp.write(np.ascontiguousarray(f.v).tobytes())


class YUV420Resizer:
    """Three-plane resizer bound to one geometry.

    :param method: "linear" | "area" | "lanczosN" (N = degree 1..9)

    Construct-once: three plans + jitted executables; ``resize`` takes one
    :class:`YUV420Frame`, ``resize_batch`` takes batched planes (one
    executable call per plan).
    """

    def __init__(self, method: str, src_w: int, src_h: int,
                 dst_w: int, dst_h: int, backend: str = "auto"):
        # The reference sample resizes the Y plane at its TRUE (possibly
        # odd) dimensions and evens only the buffer strides; chroma
        # resizers are constructed from the evened strides (stX/2, not
        # srcW/2), so the padding column/row is chroma *data*
        # (ref: sample/resize_yuv420p.cpp:66-69,125-131,153-159).
        sw, sh = _even(src_w), _even(src_h)
        dw, dh = _even(dst_w), _even(dst_h)
        self.src_size = (sw, sh)        # strides (file layout)
        self.dst_size = (dw, dh)
        self._true_src = (src_w, src_h)
        self._true_dst = (dst_w, dst_h)
        self.method = method
        if method.startswith("lanczos"):
            degree = int(method[len("lanczos"):] or 3)
            # chroma planes use px_scale=2 (ref: sample/resize_yuv420p.cpp:159)
            self._luma: Resizer = LanczosResizer(
                degree, src_w, src_h, dst_w, dst_h, backend=backend)
            self._chroma: Resizer = LanczosResizer(
                degree, sw // 2, sh // 2, dw // 2, dh // 2, px_scale=2,
                backend=backend)
        elif method == "area":
            self._luma = AreaResizer(src_w, src_h, dst_w, dst_h,
                                     backend=backend)
            self._chroma = AreaResizer(sw // 2, sh // 2, dw // 2, dh // 2,
                                       backend=backend)
        elif method == "linear":
            self._luma = LinearResizer(src_w, src_h, dst_w, dst_h,
                                       backend=backend)
            self._chroma = LinearResizer(sw // 2, sh // 2, dw // 2, dh // 2,
                                         backend=backend)
        else:
            raise ValueError(f"unknown method {method!r} "
                             "(linear | area | lanczos[1-9])")

    def _slice_y(self, y):
        w, h = self._true_src
        return y[..., :h, :w]

    def _pad_y(self, oy):
        """Place the true-dim luma result into the evened-stride layout;
        the padding column/row stays zero, matching the reference's
        zero-initialized output buffer (sample/resize_yuv420p.cpp:88).
        Preserves array kind: jax in -> jax out (no forced host sync)."""
        w, h = self._true_dst
        dw, dh = self.dst_size
        if (w, h) == (dw, dh):
            return oy
        widths = [(0, 0)] * (oy.ndim - 2) + [(0, dh - h), (0, dw - w)]
        if isinstance(oy, np.ndarray):
            return np.pad(oy, widths)
        import jax.numpy as jnp

        return jnp.pad(oy, widths)

    def resize(self, frame: YUV420Frame) -> YUV420Frame:
        # U and V share a plan: one batched executable call for both
        uv = np.stack([frame.u, frame.v])
        ouv = self._chroma.resize(uv)
        oy = self._pad_y(self._luma.resize(self._slice_y(frame.y)))
        return YUV420Frame(y=oy, u=ouv[0], v=ouv[1])

    def resize_batch(self, y, u, v):
        """Batched planes (B, h, w)/(B, h/2, w/2) -> resized batch tuple.
        U and V are fused through one chroma executable call."""
        import jax.numpy as jnp

        cat = np.concatenate if isinstance(u, np.ndarray) else jnp.concatenate
        ouv = self._chroma.resize(cat([u, v]))
        b = u.shape[0]
        oy = self._pad_y(self._luma.resize(self._slice_y(y)))
        return oy, ouv[:b], ouv[b:]
