"""Test configuration: force the JAX CPU backend with 8 virtual devices so
sharding/pjit paths are exercised without an accelerator.

The live jax config is updated too, in case something imported jax before
this hook ran (an environment variable alone would then be too late).
The persistent compilation cache stays off: tests compile tiny shapes
and must not write into the checkout's cache.

Tests that need the GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them on the CPU backend. On a machine
with a card, ``python -m pytest tests -m gpu`` runs them there: that
selection leaves the default backend alone.
"""

import os

import pytest


def pytest_configure(config):
    if config.getoption("markexpr") == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the backend has none (decided at run
    time, never at import, so every test worker collects the same
    tests)."""
    import jax

    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU: run `python -m pytest tests -m gpu` on the card")
    return devices[0]
