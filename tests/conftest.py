"""Test configuration: the virtual 8-device CPU mesh, or the GPU.

By default the suite runs on CPU with 8 virtual devices, so multi-device
sharding is validated without hardware (SURVEY.md §4: CPU mesh emulation)
and the Pallas kernel runs through the interpreter (`interpret=True`,
always passed explicitly). `python -m pytest tests -m gpu` selects the
tests that need a GPU and leaves JAX on its default platform; the `gpu`
fixture skips them where no GPU is present.
"""

import os

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (run with `-m gpu` on a GPU machine)")
    if config.getoption("markexpr", "") == "gpu":
        return
    # Before any JAX backend initializes: env vars for the CPU client, and
    # the config directly (a plugin may have imported jax already).
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")
    # Persistent compilation cache: interpret-mode kernel traces still pay
    # real XLA:CPU compiles; caching them across runs saves minutes.
    from l2n.utils.compile_cache import enable
    enable()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests -m gpu` on a "
                    "machine with one")


@pytest.fixture
def rng():
    return np.random.Generator(np.random.PCG64(1234))
