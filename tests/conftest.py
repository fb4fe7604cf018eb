"""Test configuration: force an 8-device virtual CPU mesh BEFORE jax import.

SURVEY.md §5 item 4: multi-host semantics are tested without a cluster via
`--xla_force_host_platform_device_count`.  This file must set the env vars at
module scope, before anything imports jax.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# Pin the CPU backend even where a GPU plugin is installed, so the tests run
# on the virtual 8-device CPU mesh regardless of what the environment says.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
