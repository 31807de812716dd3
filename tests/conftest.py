"""Test config: an 8-device virtual CPU mesh, so multi-device sharding
paths are exercised without accelerator hardware (SURVEY.md section 4).

The tests run on the CPU unless JAX_PLATFORMS says otherwise: tests
marked `gpu` need the card and skip elsewhere (run them on a GPU host
with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`). XLA_FLAGS must
be set before the first backend initialization.
"""

import functools
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pathlib

import pytest

REFERENCE_MODELS = pathlib.Path("/root/reference/examples/models")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips when none is present"
    )


@pytest.fixture(scope="session")
def models_dir():
    if not REFERENCE_MODELS.exists():
        pytest.skip("reference model assets not available")
    return REFERENCE_MODELS


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test on a host without one."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX backend is {jax.default_backend()}")
    return jax.devices()[0]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run every pallas_call made during the test in interpret mode, so a
    GPU kernel's arithmetic is testable on the CPU."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
