"""Quickstart: price an ATM European call under Heston on a GPU.

The 5-step lifecycle (same shape as the reference's README example):

    declare -> init(seed) -> compute() -> print_stats() -> finalize()

Run: ``python examples/quickstart.py`` (on a CPU: ``JAX_PLATFORMS=cpu python
examples/quickstart.py``, kernels in interpret mode).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nmch import NMCH_FE, NMCH_EM, HestonParams, SimConfig
from nmch.oracle import heston_call_undiscounted


def main():
    params = HestonParams(k=0.5, rho=-0.7, theta=0.1, sigma=0.3)
    cfg = SimConfig(NTPB=512, NB=128, N=1000)   # 65,536 paths

    print(f"Semi-analytic Heston price: "
          f"{heston_call_undiscounted(params):.6f}\n")

    for cls in (NMCH_FE, NMCH_EM):
        m = cls(cfg, params)            # engine="pallas" by default
        m.init(seed=1234)
        m.compute()                     # warm-up (compiles); discard
        m.compute()                     # timed run on fresh draws
        m.print_stats()
        print()
        m.finalize()

    # parameter sweep with persistent RNG streams (no re-seeding):
    m = NMCH_FE(cfg, params)
    m.init(seed=1234)
    m.compute()
    for sigma in (0.2, 0.3, 0.4):
        m.set_sigma(sigma)
        res = m.compute()
        print(f"sigma={sigma}: price={res.price:.6f} +/- {res.err:.2e} "
              f"({res.exec_time_ms:.1f} ms)")
    m.finalize()

    # the fast/accurate variants beyond the reference (see README):
    print("\nvariance-reduced / QMC variants:")
    for label, kwargs in (
        ("FE rot=4 rotation sampling (headline)", dict(rot=4)),
        ("FE scrambled-Sobol + Brownian bridge", dict(engine="qmc")),
        ("FE QMC with full Owen scrambling", dict(engine="qmc",
                                                  scramble="owen")),
        ("FE MRG32k3a (curand's third family)", dict(engine="scan",
                                                     rng="mrg32k3a")),
    ):
        m = NMCH_FE(cfg, params, **kwargs)
        m.init(seed=1234)
        m.compute()
        res = m.compute()
        print(f"  {label}: price={res.price:.6f} "
              f"ci={res.ci_error:.2e} ({res.exec_time_ms:.1f} ms)")
        m.finalize()
    m = NMCH_EM(cfg, params, rng="threefry4", conditional=True)
    m.init(seed=1234)
    m.compute()
    res = m.compute()
    print(f"  EM threefry4 + conditional MC: price={res.price:.6f} "
          f"ci={res.ci_error:.2e} ({res.exec_time_ms:.1f} ms)")
    m.finalize()

    # pathwise Greeks: jax.grad through the simulator (ops/greeks.py)
    m = NMCH_FE(cfg, params, engine="scan")
    m.init(seed=1234)
    g = m.greeks()
    print("\npathwise Greeks (one epoch of draws): "
          + ", ".join(f"d/d{k}={v:+.4f}" for k, v in g.items()
                      if k != "price"))
    m.finalize()

    # EM sensitivities: exactly-pathwise (S_0, r, rho)
    # through the conditional payoff + CRN finite differences for the
    # rejection-sampled parameters (ops/em_greeks.py).  Smaller config:
    # the CRN-FD pass compiles 10 bumped EM simulations into one
    # program.
    m = NMCH_EM(SimConfig(NTPB=512, NB=32, N=250), params,
                engine="scan")
    m.init(seed=1234)
    g = m.greeks(fd=True)
    print("EM sensitivities (pathwise S_0/r/rho, CRN-FD rest): "
          + ", ".join(f"d/d{k}={v:+.4f}" for k, v in g.items()
                      if k != "price"))
    m.finalize()


if __name__ == "__main__":
    main()
