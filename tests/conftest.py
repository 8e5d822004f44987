import dataclasses

import jax
import pytest

# NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 device.
# Multi-device sharding tests spawn subprocesses that set the flag themselves.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips on a machine without one)")


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def reduced_no_drop(cfg):
    """Reduced config with MoE capacity high enough that nothing drops
    (exactness tests)."""
    c = cfg.reduced()
    if c.uses_moe:
        c = dataclasses.replace(c, capacity_factor=float(c.num_experts))
    return c
