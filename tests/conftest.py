import os

import pytest


def pytest_configure(config):
    """Pin JAX to a virtual 8-device CPU mesh before any test module
    imports it, so multi-device sharding is exercised without a GPU.

    Card-only tests carry the `gpu` marker (deselected by default) and also
    skip themselves through the `gpu` fixture.  On the card,
    `python -m pytest tests/ -m gpu` leaves the platform to JAX.
    """
    if config.getoption("markexpr", "") == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend")
