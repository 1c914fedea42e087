"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-chip sharding paths are exercised without TPU hardware (the driver
separately dry-runs the multichip path; see __graft_entry__.py)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running end-to-end tests (tier-1 runs -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (skips without one; run on the card with "
        "`python -m pytest -m cuda tests/test_torch_*.py`)")


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


@pytest.fixture(autouse=True)
def _seed_everything():
    import paddle_tpu as paddle

    paddle.seed(2024)
    np.random.seed(2024)
    yield
