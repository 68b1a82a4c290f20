"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Multi-device sharding behaviour is exercised the way the reference
exercises MPI (every unit test at np=1..4, unit_tests.py:29-37): by
running the same code over several virtual devices on one host.

Tests marked `gpu` need an NVIDIA GPU and skip elsewhere; whether a
card is present is decided inside the `gpu_device` fixture. They run
on a machine with a card when JAX_PLATFORMS names it:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Otherwise the platform is fixed to the CPU via jax.config before any
backend initialises.
"""

import os

import pytest

_PLATFORMS = os.environ.get("JAX_PLATFORMS", "").split(",")
if "cuda" not in _PLATFORMS:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if "cuda" not in _PLATFORMS:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (skips elsewhere; run with "
        "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)",
    )


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's first device is {dev}")
    return dev
