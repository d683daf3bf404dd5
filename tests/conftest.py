"""Test platform: the CPU with a deterministic 8-device virtual mesh, unless
JAX_PLATFORMS names others (on the card: JAX_PLATFORMS=cuda,cpu runs the
tests marked `gpu`; see README).

jax may already be imported when this runs, so env vars alone are not
enough; the platform goes through config.update before any backend starts.
"""
import os

import jax
import pytest

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every xdist worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest -m gpu tests/` on the card")
    return devs[0]
