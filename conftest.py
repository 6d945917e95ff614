"""Test harness configuration.

Tests run on the CPU with 8 virtual devices (standing in for a device
mesh) and 64-bit precision enabled so the numerics can be validated
against the float64 oracle.  JAX_PLATFORMS, when set, picks the platform
instead: the tests marked ``gpu`` need the card and run there with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``; elsewhere
they skip.  The platform is set through jax.config before any backend
is initialised.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none (decided here,
    at run time, never while test modules are imported)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on the "
                    "card)")
    return devs[0]
