"""Test configuration: run on CPU with a virtual 8-device mesh.

Mirrors the reference's strategy of exercising the multi-threaded algorithms
on whatever host is available (SURVEY.md §4): we simulate an 8-device mesh
with XLA's host-platform device-count flag so shard_map collectives run for
real, and enable x64 so uint64/f64 keys round-trip through numpy oracles.

Must run before the first ``import jax`` anywhere in the test session.
A program that imported JAX first (``chip_smoke.py`` running the ``gpu``
tests in its own process, on its card) keeps the platform it chose.

Tests marked ``gpu`` need the card; the ``gpu`` fixture skips them
elsewhere.
"""
import os
import sys

if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
# keep the XLA plan paths covered: only tiny sorts take the host-native
# fast path in tests (tests/test_host_sort.py covers it explicitly)
os.environ.setdefault("RDST_TPU_HOST_SORT_MAX", "2048")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xD51)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card via chip_smoke.py)")
    return jax.devices()[0]
