"""Test harness: force an 8-device CPU mesh so sharding logic is exercised
without an accelerator (the reference had no distributed tests at all;
cf. SURVEY §4). Tests that need the GPU carry the `gpu` marker and skip
here (see the `gpu` fixture); chip_smoke.py runs their checks on the
card."""

import os

# The test suite runs on a virtual 8-device CPU mesh. jax.config updates
# (effective until the first backend is initialised) also hold when jax was
# imported before this file ran.
# SMB_VISION_TEST_GPU=1 leaves the platform to JAX, for the card-only tests
# (`python -m pytest -m gpu tests/` on a GPU machine).
ON_GPU = os.environ.get("SMB_VISION_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_threefry_partitionable", True)
# the CLIs point JAX's persistent compilation cache at the checkout
# (utils/compile_cache.py); tests compile tiny programs and keep it off
jax.config.update("jax_enable_compilation_cache", False)
# XLA:CPU's DEFAULT matmul precision is bf16-like; use exact f32 in tests so
# numeric comparisons are meaningful.
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The native CT loader (.so) is gitignored — build it on demand so a fresh
# checkout runs the native tests instead of silently skipping them.
_so = os.path.join(os.path.dirname(__file__), "..", "smb_vision_tpu",
                   "data", "_native", "libctloader.so")
if not os.path.exists(_so):
    try:
        import subprocess
        import sys as _sys

        subprocess.run(
            [_sys.executable,
             os.path.join(os.path.dirname(__file__), "..", "scripts",
                          "build_native.py")],
            check=True, capture_output=True, timeout=120)
    except Exception:  # noqa: BLE001 — tests then skip via native_available
        pass


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first device when it is a GPU; skips otherwise. Tests marked
    `gpu` take this fixture, so the decision is made when the test runs."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on "
                    "the card")
    return dev


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]
