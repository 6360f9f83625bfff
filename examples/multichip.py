"""Multi-device scale-out example: shard paths over every available GPU.

On a machine with several GPUs this runs one fused kernel per card and
combines two scalars with a psum over NVLink:

    python examples/multichip.py

On a CPU the same code runs on virtual devices, with the kernels in
interpret mode:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def main():
    from nmch import HestonParams
    from nmch.parallel.mesh import make_mesh, sharded_moments
    from nmch.results import SimResult
    from nmch.oracle import heston_call_undiscounted
    from nmch.utils.backend import kernel_interpret

    devices = jax.devices()
    mesh = make_mesh(devices)
    params = HestonParams()
    n_paths = 128 * 64 * len(devices)
    m, m2 = sharded_moments(mesh, params.as_array(), seed=1234, epoch=0,
                            N=200, n_paths=n_paths, method="fe",
                            engine="pallas", interpret=kernel_interpret())
    res = SimResult(float(m), float(m2), n_paths)
    print(f"devices: {len(devices)} x {devices[0].platform}")
    print(f"paths:   {n_paths} (sharded {n_paths // len(devices)}/device)")
    print(f"price:   {res.price:.6f} +/- {res.err:.2e}")
    print(f"oracle:  {heston_call_undiscounted(params):.6f}")


if __name__ == "__main__":
    main()
