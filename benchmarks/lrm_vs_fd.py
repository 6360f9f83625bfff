"""Measure the LRM (score-function) vs CRN-FD variance crossover for
the five non-pathwise EM sensitivities (ops/em_lrm.py module
docstring's prediction: LRM score variance grows ~ N * lam ~ N^2, so
LRM should win at coarse grids and lose to CRN-FD as N grows).

Statistical comparison — runs on CPU (the conftest-style backend pin
below); hardware speed is irrelevant to estimator spread.  For each N
in the ladder, both estimators are run over E independent epochs at
the same n_paths; the table reports per-parameter mean +- std and the
semi-analytic oracle FD truth.  Results recorded in
benchmarks/RESULTS.md.

Run: ``python benchmarks/lrm_vs_fd.py [--n-paths 16384 --epochs 8]``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import dataclasses

import jax.numpy as jnp
import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n-paths", type=int, default=1 << 14)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--Ns", type=str, default="8,16,32,64,128")
    args = p.parse_args(argv)

    from nmch.oracle import heston_call_undiscounted
    from nmch.ops.em_greeks import em_greeks_fd
    from nmch.ops.em_lrm import LRM_PARAMS, em_greeks_lrm
    from nmch.params import HestonParams
    from nmch.rng.philox import split_seed

    P = HestonParams()
    k0, k1 = split_seed(0)
    pv = P.as_array()

    # oracle truth by FD on the semi-analytic price
    truth = {}
    for name in LRM_PARAMS:
        x = getattr(P, name)
        h = 1e-3 * max(abs(x), 0.05)
        up = dataclasses.replace(P, **{name: x + h})
        dn = dataclasses.replace(P, **{name: x - h})
        truth[name] = (heston_call_undiscounted(up)
                       - heston_call_undiscounted(dn)) / (2 * h)

    print(f"n_paths={args.n_paths} epochs={args.epochs}")
    print(f"{'N':>5s} {'param':>6s} {'oracle':>9s} "
          f"{'LRM mean+-std':>20s} {'CRN-FD mean+-std':>20s} {'winner':>7s}")
    for N in (int(s) for s in args.Ns.split(",")):
        acc = {name: ([], []) for name in LRM_PARAMS}
        for e in range(args.epochs):
            ep = jnp.uint32(e)
            _, gl = em_greeks_lrm(pv, ep, k0, k1, N=N,
                                  n_paths=args.n_paths)
            gf = em_greeks_fd(pv, ep, k0, k1, N=N,
                              n_paths=args.n_paths)
            gl, gf = jax.device_get((gl, gf))
            for name in LRM_PARAMS:
                acc[name][0].append(float(gl[name]))
                acc[name][1].append(float(gf[name]))
        for name in LRM_PARAMS:
            lm, ls = np.mean(acc[name][0]), np.std(acc[name][0])
            fm, fs = np.mean(acc[name][1]), np.std(acc[name][1])
            win = "LRM" if ls < fs else "FD"
            print(f"{N:5d} {name:>6s} {truth[name]:9.4f} "
                  f"{lm:10.4f}+-{ls:8.4f} {fm:10.4f}+-{fs:8.4f} {win:>7s}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
