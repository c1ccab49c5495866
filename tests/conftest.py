"""Test harness config: run on CPU with 8 virtual devices.

Must run before the first `import jax` anywhere in the test session, so env
vars are set at conftest import time. Multi-chip sharding tests use the
8-device virtual CPU mesh (__graft_entry__.dryrun_multichip runs the same
path on virtual devices).

``TCGAN_TEST_PLATFORM=gpu`` leaves the platform to JAX instead, so the
``gpu``-marked tests can run on the card (``make test-gpu``); elsewhere
the ``gpu_device`` fixture skips them.
"""

import os

ON_GPU = os.environ.get("TCGAN_TEST_PLATFORM") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    # Force the local CPU backend via the config API as well as the env
    # var, so no test dispatch reaches an accelerator plugin.
    jax.config.update("jax_platforms", "cpu")

# Tests run in float64 (mirrors the reference's f64 CPU solver for parity
# checks; the production GPU path is f32). Explicit f32 arrays keep
# their dtype.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first NVIDIA GPU; skips the test where there is none (decided
    here, at run time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with make test-gpu on the "
                    "card)")
    return jax.devices()[0]
