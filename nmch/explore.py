"""Parameter-space exploration sweep — the reference's ``exploration``.

Reproduces ``src/NMCH/test/exploration.cu``: sweep kappa in [0.1, 10],
theta in [0.01, 0.5], sigma in [0.1, 1] in 5 steps each, skip
infeasible ``20*k*theta < sigma^2`` combos (exploration.cu:76,105), do
one warm-up compute() per method first ("the first run is always slow",
:65-67 — here that's the jit compile), reuse the same RNG streams
across every point via the setters (:14-17), and print the identical
CSV: ``method, k, theta, sigma, execution_time, err``.

Reference geometry: NTPB=512, NB=10 (5,120 paths), N=1000, XORWOW K3.
We default to the same path count with the Philox-stream pallas engine.

Speed note: because parameters are *traced* inputs, the entire sweep
reuses a single compiled kernel per method — the analogue
of the reference's persistent kernel, with zero recompiles.

Run: ``python -m nmch.explore [--NB 10] [--out sweep.csv]``.
"""

from __future__ import annotations

import argparse
import sys

from .params import HestonParams, SimConfig
from .methods.fe import NMCH_FE
from .methods.em import NMCH_EM

K_MIN, K_MAX = 0.1, 10.0
THETA_MIN, THETA_MAX = 0.01, 0.5
SIGMA_MIN, SIGMA_MAX = 0.1, 1.0
STEPS = 5


def _grid(lo: float, hi: float, steps: int = STEPS):
    """The reference's inclusive stepped loop
    (for(x=lo; x<=hi; x+=(hi-lo)/steps))."""
    step = (hi - lo) / steps
    out = []
    x = lo
    # float-accumulation loop like the reference; bound the count
    for _ in range(steps + 2):
        if x > hi + 1e-9:
            break
        out.append(x)
        x += step
    return out


def feasible(k: float, theta: float, sigma: float) -> bool:
    """The reference's sweep filter: skip when 20*k*theta < sigma^2
    ('the variance of the FE is too small otherwise',
    exploration.cu:76)."""
    return 20.0 * k * theta >= sigma * sigma


def sweep(method_obj, name: str, out=sys.stdout, timed_reps: int = 1):
    """Warm up, then sweep the feasible grid with stream reuse.

    timed_reps > 1: measure each point's execution time by queueing
    that many compute dispatches back-to-back and materializing once,
    so the per-point time excludes the host's per-call synchronization.
    Each rep consumes its own stream epoch, so the stream-continuation
    contract is unchanged (the reference CSV carries a measured time
    per point, exploration.cu:83-85)."""
    method_obj.compute()  # warm-up, discarded (exploration.cu:65-67)
    for k, theta, sigma in grid_points():
        method_obj.set_theta(theta)
        method_obj.set_sigma(sigma)
        method_obj.set_k(k)
        if timed_reps > 1:
            import time
            import jax
            from .results import SimResult
            epochs = [method_obj.streams.next_epoch()
                      for _ in range(timed_reps)]
            t0 = time.perf_counter()
            outs = [method_obj._moments(e) for e in epochs]
            vals = jax.device_get(outs)
            per_ms = (time.perf_counter() - t0) * 1e3 / timed_reps
            m, m2 = (float(x) for x in vals[-1])
            res = SimResult(m, m2, method_obj.cfg.n_paths,
                            exec_time_ms=per_ms)
        else:
            res = method_obj.compute()
        print(f"{name}, {k:f}, {theta:f}, {sigma:f}, "
              f"{res.exec_time_ms:f}, {res.err:f}",
              file=out, flush=True)


def grid_points():
    """The reference's feasible (k, theta, sigma) grid, in its loop
    order (sigma outer, theta, k inner — exploration.cu:71-81)."""
    pts = []
    for sigma in _grid(SIGMA_MIN, SIGMA_MAX):
        for theta in _grid(THETA_MIN, THETA_MAX):
            for k in _grid(K_MIN, K_MAX):
                if feasible(k, theta, sigma):
                    pts.append((k, theta, sigma))
    return pts


def sweep_batched(cfg: SimConfig, seed: int, out=sys.stdout,
                  method: str = "fe", rng: str = "philox",
                  conditional: bool = False):
    """FE/EM sweep as ONE jitted call over the whole parameter grid
    (SURVEY.md §7.8 'vmapped grid': the scan engine vmapped over the
    parameter rows) — same CSV, amortized per-point time.  Each point
    prices at its own stream epoch."""
    import time
    import numpy as np
    import jax
    import jax.numpy as jnp
    from .ops.fe import fe_sweep_scan
    from .ops.em import em_sweep_scan, FAST_POISSON_CUT
    from .results import SimResult

    pts = grid_points()
    base = HestonParams()
    pm = jnp.asarray([[base.T, base.S_0, base.v_0, base.r, k, base.rho,
                       theta, sigma] for (k, theta, sigma) in pts],
                     jnp.float32)
    if method == "fe":
        run_all = jax.jit(lambda pm: fe_sweep_scan(
            pm, seed, 0, N=cfg.N, n_paths=cfg.n_paths))
    else:
        run_all = jax.jit(lambda pm: em_sweep_scan(
            pm, seed, 0, N=cfg.N, n_paths=cfg.n_paths, rng=rng,
            conditional=conditional, poisson_cut=FAST_POISSON_CUT))

    jax.block_until_ready(run_all(pm))       # compile + warm-up
    t0 = time.perf_counter()
    ms, m2s = run_all(pm)
    ms_host = np.asarray(ms)            # one device->host transfer
    m2_host = np.asarray(m2s)
    per_point_ms = (time.perf_counter() - t0) * 1e3 / len(pts)

    for (k, theta, sigma), m, m2 in zip(pts, ms_host, m2_host):
        err = SimResult(m, m2, cfg.n_paths).err
        print(f"{method}, {k:f}, {theta:f}, {sigma:f}, {per_point_ms:f}, "
              f"{err:f}", file=out, flush=True)


def run(argv=None) -> int:
    from .utils.cache import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(
        prog="exploration",
        description="(k, theta, sigma) sweep; CSV on stdout")
    p.add_argument("--NTPB", type=int, default=512)
    p.add_argument("--NB", type=int, default=10)       # exploration.cu:25
    p.add_argument("--N", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--engine", choices=["pallas", "scan"], default="pallas")
    p.add_argument("--methods", default="fe,em",
                   help="comma-separated subset of fe,em")
    p.add_argument("--rng", choices=["philox", "threefry4", "xorwow",
                                     "mrg32k3a"],
                   default="philox",
                   help="counter generator (threefry4 is ~2x faster "
                        "for EM); xorwow/mrg32k3a (loop mode, "
                        "--engine scan) sweep FE *and* EM with the "
                        "reference's stateful families — "
                        "exploration.cu:24-25,54-55 defaults to XORWOW "
                        "for both methods")
    p.add_argument("--conditional", action="store_true",
                   help="batched EM: closed-form conditional payoff "
                        "(CI ~1.9x smaller at the same cost)")
    p.add_argument("--batched", action="store_true",
                   help="price the whole grid in ONE jitted call per "
                        "method (the scan engine vmapped over the grid)")
    p.add_argument("--timed-reps", type=int, default=1,
                   help="loop mode: per-point time = average over this "
                        "many queued dispatches (incompatible with "
                        "--batched)")
    p.add_argument("--out", default=None, help="write CSV here (default "
                   "stdout, like the reference)")
    args = p.parse_args(argv)

    cfg = SimConfig(NTPB=args.NTPB, NB=args.NB, N=args.N, seed=args.seed)
    params = HestonParams()
    # validate BEFORE touching --out: opening truncates, and a typo'd
    # --methods must not destroy an existing sweep file
    methods = [m.strip() for m in args.methods.split(",") if m.strip()]
    unknown = [m for m in methods if m not in ("fe", "em")]
    if unknown:
        p.error(f"unknown method(s) {unknown}; valid: fe, em")
    if args.batched and args.timed_reps > 1:
        p.error("--timed-reps applies to loop mode only (the batched "
                "grid runs as one launch; its per-point time is the "
                "amortized total)")
    if args.timed_reps < 1:
        p.error("--timed-reps must be >= 1")
    if args.rng in ("xorwow", "mrg32k3a"):
        if args.batched:
            p.error(f"--rng {args.rng} needs loop mode (the batched "
                    f"sweep uses counter streams)")
        if args.engine != "scan":
            p.error(f"--rng {args.rng} needs --engine scan (the fused "
                    f"kernels draw from counter streams)")
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        print("method, k, theta, sigma, execution_time, err", file=out,
              flush=True)
        for name in methods:
            if args.batched:
                sweep_batched(cfg, args.seed, out, rng=args.rng,
                              conditional=args.conditional, method=name)
                continue
            if name == "fe":
                m = NMCH_FE(cfg, params, engine=args.engine,
                            rng=args.rng)
            else:
                # all four families honored: the stateful
                # pair already forced --engine scan above, matching
                # the reference's EM-with-XORWOW sweep
                # (exploration.cu:54-55)
                m = NMCH_EM(cfg, params, engine=args.engine,
                            rng=args.rng)
            m.init(args.seed)
            sweep(m, name, out, timed_reps=args.timed_reps)
            m.finalize()
    finally:
        if args.out:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
