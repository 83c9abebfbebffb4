"""Test configuration.

Unit tests run on the CPU with 8 virtual devices, so multi-device
sharding logic is exercised without several GPUs (SURVEY.md §4
implication d). Tests marked `gpu` need an NVIDIA GPU: they take the
`gpu_device` fixture, which skips them where JAX finds none.
`python chip_smoke.py` runs the same checks on the card at real widths.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

from dipper_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running scale tests (deselect with "
        "-m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; "
        "chip_smoke.py runs these checks on the card)")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX finds none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check "
                    "on the card")
