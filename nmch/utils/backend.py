"""Where the kernels run, decided in one place.

On an NVIDIA GPU the Pallas kernels are compiled by Triton.  On a CPU
they run through the Pallas interpreter, but only when the CPU was
asked for (``JAX_PLATFORMS=cpu``, or ``jax.config.update(
"jax_platforms", "cpu")`` before the first device touch, as the test
suite does): a run that wanted the GPU and found none fails instead of
falling back to a CPU that is orders of magnitude slower.
"""

from __future__ import annotations

import jax

CPU_HINT = ("set JAX_PLATFORMS=cpu to run on the CPU (kernels in Pallas "
            "interpret mode, for tests and small runs)")


def _configured_platforms() -> str:
    return jax.config.jax_platforms or ""


def cpu_requested() -> bool:
    """True when the process was restricted to the CPU platform."""
    plats = _configured_platforms()
    return {p.strip().lower() for p in plats.split(",") if p.strip()} \
        == {"cpu"}


def kernel_interpret() -> bool:
    """False on a GPU (compiled Triton kernels); True on a CPU that was
    asked for (interpret mode).  Raises on a CPU that was not asked
    for, and on any other platform."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        if cpu_requested():
            return True
        raise RuntimeError(f"no GPU found; {CPU_HINT}")
    raise RuntimeError(f"unsupported platform {platform!r}: the kernels "
                       f"run on an NVIDIA GPU; {CPU_HINT}")
