"""Test harness config.

Default: run on the CPU with 8 virtual devices.  This gives the
multi-device sharding tests a real 8-device mesh without GPUs (SURVEY.md
§4: a capability the CUDA reference lacked), and keeps the suite
runnable anywhere.  Pallas kernels run with ``interpret=True``.

Card tests carry the ``gpu`` marker and ask for the ``gpu`` fixture,
which skips them when JAX has no GPU.  To run them on a card, name the
GPU platform so this file leaves the platform alone:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    # entry points under test point the persistent compile cache at the
    # checkout; the xdist workers would share it with unsynchronized
    # writes, so tests compile in memory only
    jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "tests/ -m gpu (on a machine with a card)")
    return jax.devices()[0]
