"""Error-matched QMC benchmark (GPU) — the error-matched table.

Reference error curve (results/scalability.png + BASELINE.md): at
N=1000 the reference's 95%-CI error is ~8e-4 at 2.6e5 paths, scaling
as c/sqrt(n) with c = 8e-4*sqrt(2.6e5) ~ 0.408, and it simulates at
99.1 G path*steps/s.  So the reference needs

    t_ref(err) = (c/err)^2 * N / 99.1e9   seconds

to reach a target error.  We measure the QMC engine's (time, err) at
several point counts and report speedup = t_ref(err_qmc) / t_qmc.

Usage: python benchmarks/qmc_bench.py [--N 1000] [--csv out]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

REF_C = 8e-4 * (2.6e5) ** 0.5       # err * sqrt(paths), reference fit
REF_RATE = 99.1e9                    # path*steps/s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=1000)
    ap.add_argument("--paths", default="8192,32768,131072")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--ndtri", choices=["fast", "precise"],
                    default="fast",
                    help="'precise' = full AS241 inverse CDF — the "
                         "probe for the f32 plateau at "
                         ">= 2^20 points (RESULTS.md soak)")
    ap.add_argument("--scramble", choices=["lms-shift", "shift", "owen"],
                    default="lms-shift",
                    help="'owen' = independent nested-uniform scramble "
                         "per replicate (no shared-scramble "
                         "conditioning in the CI)")
    args = ap.parse_args()

    from nmch.params import HestonParams
    from nmch.results import SimResult
    from nmch.rng.philox import split_seed
    from nmch.ops.fe_qmc import fe_moments_qmc

    params = HestonParams().as_array()
    k0, k1 = split_seed(1234)

    lines = ["n_points,N,ms,ci_error,t_ref_ms,speedup_error_matched"]
    print(lines[0], flush=True)
    for n in (int(x) for x in args.paths.split(",")):
        def run(epoch):
            return fe_moments_qmc(params, jnp.uint32(epoch), k0, k1,
                                  N=args.N, n_paths=n,
                                  ndtri_mode=args.ndtri,
                                  scramble=args.scramble)
        jax.block_until_ready(run(0))
        t0 = time.perf_counter()
        outs = [jax.block_until_ready(run(1 + i))
                for i in range(args.reps)]
        dt = (time.perf_counter() - t0) / args.reps
        vals = jax.device_get(outs)
        # pool the CI over the measured reps (each has only 8 shifts)
        cis = [SimResult(float(m), float(m2), n).ci_error
               for m, m2 in vals]
        ci = float(sum(c * c for c in cis) / len(cis)) ** 0.5
        t_ref = (REF_C / ci) ** 2 * args.N / REF_RATE
        line = (f"{n},{args.N},{dt*1e3:.1f},{ci:.3e},{t_ref*1e3:.1f},"
                f"{t_ref/dt:.1f}")
        print(line, flush=True)
        lines.append(line)

    if args.csv:
        with open(args.csv, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
