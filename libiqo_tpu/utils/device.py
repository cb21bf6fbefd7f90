"""Device capability queries — the analog of the reference's HWCap
(ref: src/IQOHWCap.hpp:6-57, src/IQOHWCap.cpp:14-66).

Where HWCap probes CPUID leaves to pick a SIMD implementation and counts
OpenMP processors, this module reports the JAX platform, per-device kind
and memory, and the parallel width that replaces thread counts: the
device count (the dp axis).  On the GPU it also reads the card's name and
power limit, which every timing must be reported beside: a card set below
its maximum power runs slower under load.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess

__all__ = ["DeviceCaps", "caps", "describe", "gpu_name_and_power_limit"]


@dataclasses.dataclass(frozen=True)
class DeviceCaps:
    platform: str            # "gpu" | "cpu"
    device_kind: str         # e.g. "NVIDIA H100 80GB HBM3"
    num_devices: int         # dp width (HWCap::getNumberOfProcs analog)
    memory_per_device: int | None   # bytes the allocator may use, if reported


@functools.lru_cache(maxsize=1)
def caps() -> DeviceCaps:
    import jax

    devs = jax.devices()
    d0 = devs[0]
    stats = d0.memory_stats() or {}    # None on the CPU backend
    return DeviceCaps(
        platform=d0.platform,
        device_kind=d0.device_kind,
        num_devices=len(devs),
        memory_per_device=stats.get("bytes_limit"),
    )


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, as
    the tool prints it ("NVIDIA H100 80GB HBM3, 700.00 W"), or None when
    the tool is absent or fails.  Runs as a subprocess that never touches
    JAX or the card's memory."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def describe() -> str:
    c = caps()
    mem = f"{c.memory_per_device / 2**30:.1f} GiB" if c.memory_per_device else "?"
    s = f"{c.num_devices}x {c.device_kind} ({c.platform}), {mem}/device"
    if c.platform == "gpu":
        s += f", nvidia-smi: {gpu_name_and_power_limit() or 'unavailable'}"
    return s
