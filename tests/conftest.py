"""Test configuration: CPU with 8 virtual devices (sharding tests).

Unit and parity tests run on a virtual 8-device CPU mesh unless
JAX_PLATFORMS says otherwise. Tests marked ``gpu`` need a card and skip
without one; chip_smoke.py runs them on the GPU.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import pytest

REFERENCE_DIR = pathlib.Path(
    os.environ.get("BRISK_REFERENCE_DIR", "/root/reference")
)
TEST_DATA = REFERENCE_DIR / "brisk" / "src" / "test" / "test_data"


@pytest.fixture(scope="session")
def test_data_dir():
    if not TEST_DATA.exists():
        pytest.skip("reference test data not available")
    return TEST_DATA


@pytest.fixture(scope="session")
def img1(test_data_dir):
    from ethzasl_brisk_jax.core.image_io import read_pgm

    return read_pgm(str(test_data_dir / "img1.pgm"))


@pytest.fixture(scope="session")
def img2(test_data_dir):
    from ethzasl_brisk_jax.core.image_io import read_pgm

    return read_pgm(str(test_data_dir / "img2.pgm"))
