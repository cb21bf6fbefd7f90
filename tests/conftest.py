"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests must be runnable anywhere, so we force the CPU platform with 8
virtual devices to exercise sharding paths (multi-device semantics
without multi-device hardware).  The platform is forced through
jax.config, which wins over whatever JAX_PLATFORMS the environment sets.
Checks that need the GPU live in chip_smoke.py, not in this suite.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
