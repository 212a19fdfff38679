"""Test configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu``, the default set here when
the variable is unset) with 8 virtual devices, so that mesh/sharding
paths are exercised hermetically.  Tests marked ``gpu`` need the card:
they skip elsewhere, and ``JAX_PLATFORMS=cuda python -m pytest tests
-m gpu`` runs them on a GPU machine.  Env vars must be set before jax
is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from visfd_jax.utils import enable_compile_cache  # noqa: E402

# Persistent compile cache: the suite is dominated by XLA:CPU compiles
# of the same jitted pipelines; cache them across test runs.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import pathlib

import numpy as np
import pytest

REFERENCE_TESTS = pathlib.Path("/root/reference/tests")


@pytest.fixture(scope="session")
def reference_fixture_dir():
    if not REFERENCE_TESTS.is_dir():
        pytest.skip("reference test fixtures not available")
    return REFERENCE_TESTS


@pytest.fixture()
def rng():
    return np.random.default_rng(12345)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips elsewhere; run with -m gpu)")


@pytest.fixture()
def gpu():
    """Skip unless JAX's default device is a GPU (decided when the test
    runs, never at import: every xdist worker must collect the same
    tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
