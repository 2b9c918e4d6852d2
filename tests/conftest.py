"""Test config: the tests run on the CPU, with x64 and 8 virtual devices so
the sharding tests exercise a multi-device mesh without a GPU (mirrors the
reference's oversubscribed-mpiexec parallel test strategy,
autotest/framework.py:78-108).  ``jax_platforms`` is set before any
backend is used, so a machine with a GPU still runs the tests on the CPU;
the GPU path is exercised by ``python chip_smoke.py``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
