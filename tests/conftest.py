"""Test configuration: run on CPU with 8 virtual devices.

Multi-chip sharding tests need a virtual device mesh; everything numerical
runs fine on the CPU backend. The platform is set through jax.config (in
case jax was imported before this file); XLA_FLAGS still takes effect
because backends initialize lazily.

Markers: ``slow`` (deselected by the tier-1 run) and ``gpu`` (needs an
NVIDIA GPU; such a test decides inside a fixture or its body whether a
card is present and skips otherwise — the GPU path is exercised end to end
by ``chip_smoke.py``).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
