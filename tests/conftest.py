"""Test configuration: force a virtual 8-device CPU mesh before jax import.

This is the accelerator-free analog of multi-device testing without a cluster
(SURVEY.md §4): sharding/collective code paths are exercised on
xla_force_host_platform_device_count=8 CPU devices.
"""
import os

# Explicit assignment: the host environment may preset JAX_PLATFORMS to an
# accelerator backend, and tests must run on the virtual CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402  (import after env setup)

# The env var is captured at jax import time; if a pytest plugin imported
# jax before this conftest ran, force the platform through the config
# (effective until the first backend initialization).
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _assert_cpu():
    assert jax.default_backend() == "cpu", "tests must run on the CPU mesh"
    yield


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
