"""Test configuration.

- The suite runs on the CPU backend (`JAX_PLATFORMS=cpu`), with 8 virtual CPU
  devices so the multi-device mesh paths run without several cards. Even where a
  GPU is visible, tests default to the CPU device so exactness goldens hold.
- Matmul precision pinned to 'highest' so float32 parity goldens hold on every
  backend (a GPU's default precision may run float32 matmuls as TF32).
- Tests that need the card are marked `gpu` and take the `gpu_device` fixture,
  which skips when no GPU is visible. On the card:
  `python -m pytest -m gpu tests/`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from dmnerf_tpu.utils.cache import enable_persistent_cache  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
jax.config.update("jax_default_device", jax.devices("cpu")[0])
enable_persistent_cache()


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU; run on the card with `python -m pytest -m gpu tests/`")
    return devices[0]
