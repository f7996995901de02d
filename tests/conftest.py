"""Test configuration.

Tests run on the CPU, on a virtual 8-device mesh (test_multichip.py checks
the sharded paths against the replicated ones; ``python chip_smoke.py
--four`` makes the same checks on four GPUs), and in float64 to hit
IPOPT-grade tolerances, mirroring the accuracy bars of the reference test
suite (RMS < 1e-2 vs golden, 1e-5 vs analytic solutions). Tests marked
``gpu`` need an NVIDIA card and skip without one.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
