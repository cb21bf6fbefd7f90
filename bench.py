"""Benchmark: 4K -> 1080p Lanczos3 YUV420 throughput on one GPU.

Reproduces the reference benchmark workload (benchmark/benchmark.cpp:
1019-1031 — resize Y at full size, U and V at half size with px_scale=2,
seeded random planes) on a device-resident batch of 16 frames through
``YUV420Resizer.resize_batch``, and reports input-luma Mpix/s from the
median of REPS timed calls, each ending in ``jax.block_until_ready``.
Compilation is warmed up first and reported separately.

Run on a machine with a GPU: ``python bench.py``.  Exits non-zero, with
no JSON, when JAX finds no GPU.  Prints ONE JSON line with the card's
name and power limit as ``nvidia-smi`` reports them.
"""

import json
import statistics
import sys
import time

import numpy as np

SRC_W, SRC_H, DST_W, DST_H = 3840, 2160, 1920, 1080
BATCH = 16
REPS = 30

_METRIC = "4K->1080p lanczos3 YUV420 luma-input Mpix/s/chip"


def main() -> int:
    import jax

    from libiqo_tpu.utils.device import gpu_name_and_power_limit
    from libiqo_tpu.yuv import YUV420Resizer

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX's default device is "
              f"{dev.platform}", file=sys.stderr)
        return 1

    rng = np.random.default_rng(0)  # seeded planes, as benchmark.cpp:51-59
    y = jax.device_put(rng.integers(0, 256, (BATCH, SRC_H, SRC_W), np.uint8))
    u = jax.device_put(rng.integers(0, 256, (BATCH, SRC_H // 2, SRC_W // 2), np.uint8))
    v = jax.device_put(rng.integers(0, 256, (BATCH, SRC_H // 2, SRC_W // 2), np.uint8))

    r = YUV420Resizer("lanczos3", SRC_W, SRC_H, DST_W, DST_H)
    t0 = time.perf_counter()
    jax.block_until_ready(r.resize_batch(y, u, v))    # compile + warm
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(r.resize_batch(y, u, v))
        times.append((time.perf_counter() - t0) / BATCH)
    per_frame = statistics.median(times)

    print(json.dumps({
        "metric": _METRIC,
        "value": SRC_W * SRC_H / per_frame / 1e6,
        "unit": "Mpix/s",
        "ms_per_frame": per_frame * 1e3,
        "ms_per_frame_min": min(times) * 1e3,
        "ms_per_frame_max": max(times) * 1e3,
        "batch": BATCH,
        "reps": REPS,
        "first_call_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": gpu_name_and_power_limit(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
