"""Test configuration: the tests run on the CPU with an 8-device
virtual mesh.

The sharding strategy is validated on 8 virtual CPU devices.  The
platform is set through jax.config before any backend initializes, so a
JAX_PLATFORMS already in the environment cannot move the tests to an
accelerator; chip_smoke.py is the end-to-end check on the GPU.
"""
import os
import re

flags = os.environ.get("XLA_FLAGS", "")
# force EXACTLY 8 virtual devices (override any preset count: mesh tests
# assume an 8-way layout)
flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # function-scoped with a fixed seed: each test's data is reproducible
    # regardless of which other tests ran (a shared session stream made
    # every test depend on suite order)
    return np.random.default_rng(0xDA5)
