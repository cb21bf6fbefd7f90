"""libiqo_tpu: an image resampling framework on JAX/XLA.

A from-scratch JAX/XLA rebuild of the capabilities of yoffy/libiqo:
Lanczos, Area and Linear resampling of single-channel U8 images with
bit-exact parity against the reference's Generic fixed-point
implementations, plus batching, fused YUV420 pipelines and device-mesh
sharding.  It runs on an NVIDIA GPU, and on the CPU for tests.

Quick start::

    import numpy as np
    from libiqo_tpu import LanczosResizer

    r = LanczosResizer(degree=3, src_w=3840, src_h=2160,
                       dst_w=1920, dst_h=1080)
    out = r.resize(np.zeros((2160, 3840), np.uint8))   # (1080, 1920) u8
"""

from .api import AreaResizer, LanczosResizer, LinearResizer, Resizer
from .core.plan import ResizePlan, build_plan

__version__ = "0.4.0"

__all__ = [
    "AreaResizer",
    "LanczosResizer",
    "LinearResizer",
    "Resizer",
    "ResizePlan",
    "build_plan",
    "__version__",
]
