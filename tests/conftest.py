"""Test configuration.

The suite runs on the JAX CPU backend with 8 virtual devices (multi-device
sharding is validated on a virtual CPU mesh), and Pallas kernels run in
interpret mode there.  Tests marked `gpu` need an NVIDIA GPU and skip
elsewhere; on a machine with a card run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

The backend is forced to CPU unless JAX_PLATFORMS names another platform.
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs, never at
    import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda pytest -m gpu)")
