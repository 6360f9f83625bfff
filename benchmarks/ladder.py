"""Engine-variant timing ladder vs the reference's published numbers.

The reference compared K1/K2/K3 kernels and PgM/PiM/MM memory modes
(profilings/timings.txt, NMCH_FE.hpp:84-140).  Our ladder compares
engine x rng variants under the reference's headline config
(2^19 paths x N=10^4 by default) and prints the reference numbers next
to ours.

Run: ``python benchmarks/ladder.py [--paths 524288 --N 10000]``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ROWS = [
    # (label, ms, config) — from profilings/timings.txt:5-34
    ("CUDA FE_K1 PgM (XORWOW)", 52.874, "2^19 paths x N=10^4"),
    ("CUDA FE_K1 MM (XORWOW)", 52.883, "2^19 paths x N=10^4"),
    ("CUDA FE XORWOW normal2", 53.238, "2^19 paths x N=10^4"),
    ("CUDA FE Philox normal4", 72.066, "2^19 paths x N=10^4"),
    ("CUDA FE Philox normal2", 85.052, "2^19 paths x N=10^4"),
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--paths", type=int, default=1 << 19)
    p.add_argument("--N", type=int, default=10_000)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--no-em", action="store_true")
    # EM is ~100x more work per path-step; bench it at the reference's
    # EM comparison scale (results/execution_time_comparison.png: N=10^3)
    p.add_argument("--em-paths", type=int, default=1 << 17)
    p.add_argument("--em-N", type=int, default=1000)
    args = p.parse_args(argv)

    from nmch.utils.profiling import variant_ladder

    rows = variant_ladder(n_paths=args.paths, N=args.N, reps=args.reps,
                          include_em=False)
    if not args.no_em:
        rows += variant_ladder(n_paths=args.em_paths, N=args.em_N,
                               reps=max(2, args.reps // 2),
                               include_fe=False, include_em=True)

    print("\n== NMCH variant ladder ==")
    print(f"{'variant':30s} {'config':>22s} {'ms':>10s} {'G path-steps/s':>15s}")
    for r in rows:
        label = f"{r['method']} {r['engine']} rng={r['rng']}"
        cfg = f"{r['n_paths']} x N={r['N']}"
        print(f"{label:30s} {cfg:>22s} {r['ms']:10.2f} "
              f"{r['gpathsteps_per_s']:15.1f}")

    scale = (args.paths * args.N) / (float(1 << 19) * 1e4)
    print("\n== reference (unnamed CUDA GPU, scaled to this config) ==")
    for label, ms, cfg in REFERENCE_ROWS:
        print(f"{label:34s} {ms * scale:10.2f}  ({cfg}: {ms:.2f} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
