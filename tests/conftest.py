"""Test harness config: JAX runs on a virtual 8-device CPU platform, so
sharding and collective paths are exercised without a GPU. Tests that
need a GPU carry the `gpu` marker and take the `gpu` fixture, which
skips them unless JAX's default device is one; run them on the card
with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import pytest

REFERENCE_RES = pathlib.Path("/root/reference/res")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU as JAX's default device")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


def _fixture(name: str) -> bytes:
    path = REFERENCE_RES / name
    if not path.exists():
        pytest.skip(f"reference fixture {name} not available")
    return path.read_bytes()


@pytest.fixture
def reader_test01() -> bytes:
    """96 B, 3-field, LF, ragged last row (uniform-stride violation)."""
    return _fixture("reader_test01.csv")


@pytest.fixture
def sample_csv() -> bytes:
    """300 B, 3-field, LF, quoted single chars; stride 3 x 15."""
    return _fixture("sample.csv")


@pytest.fixture
def sample_rx() -> bytes:
    """623 B, 8-field, CRLF, UTF-8 BOM, comma inside quotes; stride 9 x 8."""
    return _fixture("sample_rx.csv")
