"""Reproduce the reference's NTPB x NB comparison surfaces
(results/execution_time_comparison.png + error_comparison_fe_em.png).

The reference sweeps grid geometries NTPB x NB in {32..512}^2 at
N=1000 and plots two side-by-side heatmaps per figure: FE vs EM
execution time, and FE vs EM 95%-CI error (SURVEY.md §2 "Published
results" row).  The kernels' own blocks
are a launch detail (ops/path_blocks.py); n_paths = NTPB*NB is what
matters physically, so we sweep the identical grid and emit the same
two figures plus a CSV.

Engines: the fused kernels in the reference's choice of its fastest
kernel (K3) for these figures — FE pallas/threefry4 (the bench.py
engine), EM pallas/philox poisson_cut=128 (the method default).
Timing: REPS calls after a discarded warm-up, each ended with
block_until_ready.

Run on a GPU (on a CPU that was asked for, the kernels run in
interpret mode):
    python benchmarks/grid_compare.py [--outdir benchmarks/out]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SIZES = (32, 64, 128, 256, 512)     # the reference's grid range
REPS = {"fe": 10, "em": 5}


def measure(method: str, n_paths: int, N: int, interpret: bool):
    import jax
    import jax.numpy as jnp
    from nmch.params import HestonParams
    from nmch.rng.philox import split_seed
    from nmch.results import SimResult

    pv = HestonParams().as_array()
    k0, k1 = split_seed(1234)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])

    if method == "fe":
        from nmch.ops.fe_pallas import fe_moments_pallas
        def run(epoch):
            return fe_moments_pallas(pv, sw, jnp.uint32(epoch),
                                     jnp.uint32(0), N=N, n_paths=n_paths,
                                     rng="threefry4", interpret=interpret)
    else:
        from nmch.ops.em_pallas import em_moments_pallas

        def run(epoch):
            return em_moments_pallas(pv, sw, jnp.uint32(epoch),
                                     jnp.uint32(0), N=N, n_paths=n_paths,
                                     poisson_cut=128.0,
                                     interpret=interpret)

    reps = REPS[method]
    jax.block_until_ready(run(0))             # compile + warm-up
    t0 = time.perf_counter()
    outs = [jax.block_until_ready(run(1 + i)) for i in range(reps)]
    dt_ms = (time.perf_counter() - t0) * 1e3 / reps
    vals = jax.device_get(outs)
    m, m2 = (float(x) for x in vals[-1])
    return dt_ms, SimResult(m, m2, n_paths).err


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="benchmarks/out")
    p.add_argument("--N", type=int, default=1000)
    p.add_argument("--sizes", default=None,
                   help="comma-separated NTPB/NB values (smoke runs)")
    args = p.parse_args(argv)
    global SIZES
    if args.sizes:
        SIZES = tuple(int(s) for s in args.sizes.split(","))
    os.makedirs(args.outdir, exist_ok=True)

    from nmch.utils.backend import kernel_interpret
    interpret = kernel_interpret()

    rows = []
    t_grid = {"fe": np.zeros((len(SIZES), len(SIZES))),
              "em": np.zeros((len(SIZES), len(SIZES)))}
    e_grid = {"fe": np.zeros((len(SIZES), len(SIZES))),
              "em": np.zeros((len(SIZES), len(SIZES)))}
    for method in ("fe", "em"):
        for bi, NB in enumerate(SIZES):
            for ti, NTPB in enumerate(SIZES):
                dt_ms, err = measure(method, NTPB * NB, args.N, interpret)
                t_grid[method][bi, ti] = dt_ms
                e_grid[method][bi, ti] = err
                rows.append((method, NTPB, NB, dt_ms, err))
                print(f"{method} NTPB={NTPB} NB={NB}: {dt_ms:.3f} ms, "
                      f"err={err:.2e}", flush=True)

    csv = os.path.join(args.outdir, "grid_compare.csv")
    with open(csv, "w") as f:
        f.write("method,NTPB,NB,execution_time_ms,err\n")
        for r in rows:
            f.write(f"{r[0]},{r[1]},{r[2]},{r[3]:.6f},{r[4]:.8f}\n")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    # figure 1: execution time, FE | EM (log color: EM is ~2 orders
    # slower, like the reference's right panel)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, method in zip(axes, ("fe", "em")):
        im = ax.imshow(t_grid[method], cmap="viridis", origin="lower",
                       aspect="auto", norm=LogNorm())
        ax.set_xticks(range(len(SIZES)), [str(s) for s in SIZES])
        ax.set_yticks(range(len(SIZES)), [str(s) for s in SIZES])
        ax.set_xlabel("NTPB")
        ax.set_ylabel("NB")
        ax.set_title(f"{method.upper()} execution time (N={args.N})")
        fig.colorbar(im, ax=ax, label="ms")
    fig.tight_layout()
    fig.savefig(os.path.join(args.outdir,
                             "execution_time_comparison.png"), dpi=120)
    plt.close(fig)

    # figure 2: 95%-CI error, FE | EM (shared scale: the reference's
    # point is that the two methods' accuracy surfaces coincide)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    vmin = min(g.min() for g in e_grid.values())
    vmax = max(g.max() for g in e_grid.values())
    for ax, method in zip(axes, ("fe", "em")):
        im = ax.imshow(e_grid[method], cmap="viridis", origin="lower",
                       aspect="auto", norm=LogNorm(vmin=vmin, vmax=vmax))
        ax.set_xticks(range(len(SIZES)), [str(s) for s in SIZES])
        ax.set_yticks(range(len(SIZES)), [str(s) for s in SIZES])
        ax.set_xlabel("NTPB")
        ax.set_ylabel("NB")
        ax.set_title(f"{method.upper()} 95%-CI error (N={args.N})")
        fig.colorbar(im, ax=ax, label="err")
    fig.tight_layout()
    fig.savefig(os.path.join(args.outdir, "error_comparison_fe_em.png"),
                dpi=120)
    plt.close(fig)

    print(json.dumps({
        "csv": csv,
        "fe_time_ms_range": [round(float(t_grid['fe'].min()), 3),
                             round(float(t_grid['fe'].max()), 3)],
        "em_time_ms_range": [round(float(t_grid['em'].min()), 3),
                             round(float(t_grid['em'].max()), 3)],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
