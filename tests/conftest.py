"""Test configuration.

By default the tests run on the CPU backend with 8 virtual devices, so the
multi-device sharding tests run without any accelerator, and with x64
enabled for f64 parity.  Tests marked `gpu` need an NVIDIA GPU: run them
on the card with `JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`;
elsewhere they skip with a reason.  Whether a card is present is decided
inside the `gpu_device` fixture, never while a module is imported."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX's device is {dev.platform})")
    return dev
