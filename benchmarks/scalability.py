"""Reproduce the reference's scalability study (results/scalability.png).

The reference plot shows the 95%-CI error of both methods following the
s^(-1/2) Monte Carlo law as the path count grows to ~2.6e5.  This script
sweeps path counts for FE and EM, fits the power law, and saves the
log-log plot plus a CSV.

Run: ``python benchmarks/scalability.py [--outdir benchmarks/out]``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="benchmarks/out")
    p.add_argument("--N", type=int, default=1000)
    p.add_argument("--engine", default=None, choices=[None, "pallas", "scan"])
    p.add_argument("--methods", default="fe,em")
    p.add_argument("--max-log2", type=int, default=18)
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    import jax
    from nmch import NMCH_FE, NMCH_EM, HestonParams, SimConfig
    from nmch.oracle import heston_call_undiscounted

    engine = args.engine or ("pallas" if jax.default_backend() == "gpu"
                             else "scan")
    params = HestonParams()
    oracle = heston_call_undiscounted(params)

    path_counts = [1 << k for k in range(12, args.max_log2 + 1)]
    rows = []
    sel = [m.strip() for m in args.methods.split(",") if m.strip()]
    for method, cls in (("fe", NMCH_FE), ("em", NMCH_EM)):
        if method not in sel:
            continue
        for n_paths in path_counts:
            cfg = SimConfig.from_n_paths(n_paths, N=args.N)
            m = cls(cfg, params, engine=engine)
            m.init(cfg.seed)
            m.compute()                  # warm-up discard
            res = m.compute()
            rows.append((method, n_paths, res.price, res.err,
                         abs(res.price - oracle), res.exec_time_ms))
            print(f"{method} n={n_paths:7d} price={res.price:.6f} "
                  f"err={res.err:.2e} |bias|={rows[-1][4]:.2e} "
                  f"t={res.exec_time_ms:.1f}ms", flush=True)
            m.finalize()

    csv = os.path.join(args.outdir, "scalability.csv")
    with open(csv, "w") as f:
        f.write("method,n_paths,price,err,abs_bias,exec_ms\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    for method, marker in (("fe", "o"), ("em", "s")):
        sel = [r for r in rows if r[0] == method]
        if not sel:
            continue
        ns = np.array([r[1] for r in sel], float)
        errs = np.array([r[3] for r in sel], float)
        ax.loglog(ns, errs, marker + "-", label=f"{method} 95% CI err")
        slope = np.polyfit(np.log(ns), np.log(errs), 1)[0]
        print(f"{method}: fitted error ~ paths^{slope:.3f} (expect -0.5)")
    ref = rows[0][3] * np.sqrt(path_counts[0] / np.asarray(path_counts,
                                                           float))
    ax.loglog(path_counts, ref, "k--", alpha=0.5, label=r"$s^{-1/2}$")
    ax.set_xlabel("paths")
    ax.set_ylabel("95% CI error")
    ax.legend()
    ax.set_title(f"MC error scaling (N={args.N}, engine={engine})")
    out = os.path.join(args.outdir, "scalability.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
