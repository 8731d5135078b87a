"""Test configuration: force CPU with 8 virtual devices so multi-device
sharding paths are exercised without GPUs (SURVEY.md §4: the rebuild tests
multi-host behavior on a single host by faking mesh axes).

``PIPE_TPU_TESTS_ON_CHIP=1`` leaves the platform to JAX instead: that is
how ``chip_smoke.py`` runs the ``chip``-marked tests on the card."""

import os

ON_CHIP = os.environ.get("PIPE_TPU_TESTS_ON_CHIP") == "1"

if not ON_CHIP:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CHIP:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The 1-second liveness deadline the reference enforces per integration test
# (pipe_test.go:16-18). Compilation on CPU is slower than Go, so scale up,
# but keep a hard ceiling so hangs fail rather than stall CI.
PIPE_TIMEOUT = 60.0


@pytest.fixture
def pipe_timeout():
    return PIPE_TIMEOUT


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU; skips the test off the card (``chip``-marked tests
    run on it through ``python chip_smoke.py``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run through chip_smoke.py")
    return jax.devices()[0]
