"""Test harness configuration.

Tests run hermetically on the CPU backend with 8 virtual XLA devices, so
the sharding layer (mesh + shard_map + halo exchange) runs without a
multi-GPU host — the strategy SURVEY.md section 4 prescribes for the
distributed coverage the reference never had. The platform is forced
through jax.config, which holds even when jax was imported before this
file ran.

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them on any other backend. chip_smoke.py runs them on
the GPU with GSDR_TESTS_ON_GPU=1, which leaves the platform alone.
"""

import os

import pytest

if not os.environ.get("GSDR_TESTS_ON_GPU"):
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not os.environ.get("GSDR_TESTS_ON_GPU"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU: the Triton kernels have
    no CPU compiler (the interpreter covers their arithmetic here)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs the gpu-marked tests "
                    "on the card")
