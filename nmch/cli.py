"""``nmch`` CLI — the reference's single-run program.

Same flag surface as ``src/NMCH/test/nmch.cu:67-113`` (--NTPB --NB --T
--S_0 --v_0 --r --k --rho --theta --sigma --N --seed --method), with
the reference's *actual* defaults (NTPB=512, NB=512, N=1000, seed=1234
— nmch.cu:52-64; the reference's --help text claims NTPB=1024/N=50,
a documented bug we fix rather than copy, SURVEY.md §5 "config").

Extras beyond the reference: --engine pallas|scan|qmc,
--rng philox|threefry|threefry4|mrg32k3a|xorwow, --rot/--antithetic
and
--conditional (variance reduction), --poisson-cut (EM speed/accuracy
knob), --json (machine output), and
--oracle to print the real semi-analytic Heston price next to the
reference's Black–Scholes-with-vol-of-vol "true price".  Multi-chip
pricing goes through nmch.parallel (see examples/multichip.py).

Run: ``python -m nmch.cli --method fe`` (or the ``nmch`` wrapper).
"""

from __future__ import annotations

import argparse
import sys

from .params import HestonParams, SimConfig
from .methods.fe import NMCH_FE
from .methods.em import NMCH_EM


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nmch",
        description="Heston Monte Carlo pricer (JAX rebuild of NMCH)")
    p.add_argument("--NTPB", type=int, default=512,
                   help="paths per block-equivalent (default: 512)")
    p.add_argument("--NB", type=int, default=512,
                   help="number of blocks-equivalent (default: 512)")
    p.add_argument("--T", type=float, default=1.0, help="maturity")
    p.add_argument("--S_0", type=float, default=1.0, help="spot (=strike)")
    p.add_argument("--v_0", type=float, default=0.1, help="initial variance")
    p.add_argument("--r", type=float, default=0.0, help="risk-free rate")
    p.add_argument("--k", type=float, default=0.5, help="mean reversion")
    p.add_argument("--rho", type=float, default=-0.7, help="correlation")
    p.add_argument("--theta", type=float, default=0.1,
                   help="long-term variance")
    p.add_argument("--sigma", type=float, default=0.3, help="vol of vol")
    p.add_argument("--N", type=int, default=1000, help="time steps")
    p.add_argument("--seed", type=int, default=1234, help="RNG seed")
    p.add_argument("--method", choices=["fe", "em"], default="fe")
    # extensions beyond the reference
    p.add_argument("--engine", choices=["pallas", "scan", "qmc"],
               default=None,
               help="default: pallas (scan with --rng mrg32k3a/xorwow "
                    "— the stateful families live in the scan engine); "
                    "qmc = scrambled-Sobol + Brownian bridge (FE only; "
                    "error ~ n^-0.8)")
    p.add_argument("--rng", choices=["philox", "threefry", "threefry4",
                                     "mrg32k3a", "xorwow"],
                   default="philox",
                   help="mrg32k3a / xorwow = the reference's two stateful "
                        "curand families (skippable-stream rebuilds, "
                        "--engine scan)")
    p.add_argument("--poisson-cut", type=float, default=None,
                   help="EM only: lambda above which the Poisson mixture "
                        "index uses the one-round normal approximation "
                        "(default 128; 4000 = strict curand-parity "
                        "switching)")
    p.add_argument("--antithetic", action="store_true",
                   help="antithetic-variates variance reduction (FE only; "
                        "each path becomes a +/-G pair, CI typically "
                        "shrinks ~2x at the same path count; == --rot 2)")
    p.add_argument("--rot", type=int, choices=[1, 2, 4, 8], default=None,
                   help="rotation-coupled copies per path group (FE only): "
                        "2=antithetic, 4=+quarter-turn angle "
                        "stratification (fastest effective throughput)")
    p.add_argument("--conditional", action="store_true",
                   help="EM only: price with the exact conditional "
                        "expectation of the payoff given the variance "
                        "path (conditional Monte Carlo; ~1.9x smaller "
                        "CI at the same path count)")
    p.add_argument("--scramble", choices=["auto", "lms-shift", "shift",
                                          "owen"],
                   default="auto",
                   help="QMC randomization (--engine qmc only): auto "
                        "(default; lms-shift below 2^21 points, owen "
                        "above - the measured crossover), lms-shift, "
                        "shift, or owen (hash-based full Owen "
                        "scrambling, independent per replicate)")
    p.add_argument("--oracle", action="store_true",
                   help="also print the semi-analytic Heston price")
    p.add_argument("--greeks", action="store_true",
                   help="also print sensitivities: FE = all-parameter "
                        "pathwise (jax.grad through the simulator, "
                        "ops/greeks.py); EM = pathwise (S_0, r, rho) "
                        "+ CRN finite differences for the rest "
                        "(ops/em_greeks.py)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the untimed warm-up run (timing will include "
                        "compilation, like the reference's first run)")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON line instead of "
                        "the human stats block")
    return p


def run(argv=None) -> int:
    from .utils.cache import setup_compile_cache
    setup_compile_cache()
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.engine is None:
        # resolve the default rather than downgrade: the stateful
        # families price on the scan engine (the fused kernels draw
        # from counter streams)
        args.engine = ("scan" if args.rng in ("mrg32k3a", "xorwow")
                       else "pallas")
    if args.method == "em" and args.engine == "qmc":
        parser.error("--engine qmc is FE-only (the Sobol'/Brownian-"
                     "bridge construction has no EM analogue)")
    if args.scramble != "auto" and (args.method != "fe"
                                    or args.engine != "qmc"):
        print("note: --scramble applies to --method fe --engine qmc "
              "only; ignoring", file=sys.stderr)
        args.scramble = "auto"
    params = HestonParams(T=args.T, S_0=args.S_0, v_0=args.v_0, r=args.r,
                          k=args.k, rho=args.rho, theta=args.theta,
                          sigma=args.sigma)
    cfg = SimConfig(NTPB=args.NTPB, NB=args.NB, N=args.N, seed=args.seed)

    cls = NMCH_FE if args.method == "fe" else NMCH_EM
    kwargs = {"engine": args.engine}
    if args.method == "fe":
        kwargs["rng"] = args.rng
        kwargs["antithetic"] = args.antithetic
        kwargs["rot"] = args.rot
        kwargs["scramble"] = args.scramble
        if args.conditional:
            print("note: --conditional is EM-only; ignoring",
                  file=sys.stderr)
        if args.poisson_cut is not None:
            print("note: --poisson-cut is EM-only; ignoring",
                  file=sys.stderr)
    else:
        if args.rng in ("philox", "threefry4", "mrg32k3a", "xorwow"):
            # all four families priced for real (no silent philox
            # downgrade for the stateful pair — the reference prices EM
            # with XORWOW, exploration.cu:54-55)
            kwargs["rng"] = args.rng
        else:
            parser.error(f"--method em does not support --rng "
                         f"{args.rng} (choose philox/threefry4/"
                         f"mrg32k3a/xorwow)")
        if args.antithetic or args.rot:
            print("note: --antithetic/--rot are FE-only; ignoring",
                  file=sys.stderr)
        kwargs["conditional"] = args.conditional
        kwargs["poisson_cut"] = args.poisson_cut
    try:
        m = cls(cfg, params, **kwargs)
    except ValueError as e:
        # constructor-level combo validation (e.g. --rng xorwow
        # --engine pallas: the stateful families are scan-only)
        # surfaces as a parser error, not a raw traceback (the
        # engine=None auto-resolution above only protects the default
        # path)
        parser.error(str(e))
    m.init(args.seed)
    if not args.no_warmup:
        # discard the first (compiling) run, like exploration.cu:65-67;
        # the warm-up draws its own epoch so the timed run still uses
        # fresh randomness
        m.compute()
    res = m.compute()
    greeks = None
    if args.greeks:
        if args.method == "fe" and args.rng in ("philox", "threefry",
                                                "threefry4"):
            greeks = m.greeks()
        elif args.method == "em":
            # pathwise (S_0, r, rho) + CRN-FD (T, v_0, k, theta,
            # sigma) — ops/em_greeks.py for the validity analysis
            greeks = m.greeks(fd=True)
        else:
            print("note: --greeks needs a counter rng; ignoring",
                  file=sys.stderr)
    if args.json:
        import json
        rec = {
            "method": args.method, "engine": args.engine,
            "n_paths": cfg.n_paths, "N": cfg.N, "seed": args.seed,
            "price": res.price, "price_squared": res.price_squared,
            # strict-JSON safe: the qmc engine's synthesized moments
            # make the reference err formula meaningless -> null
            "err": (None if res.synthesized_moments else res.err),
            "ci_error": res.ci_error,
            "exec_time_ms": res.exec_time_ms,
            "init_time_ms": m.init_time_ms,
        }
        if greeks is not None:
            rec["greeks"] = {k: v for k, v in greeks.items()
                             if k != "price"}
        if args.oracle:
            from .oracle import heston_call_undiscounted
            rec["heston_oracle"] = heston_call_undiscounted(params)
        print(json.dumps(rec))
    else:
        m.print_stats()
        if args.engine == "qmc":
            # the stats block's reference-formula `err` is meaningless
            # for the QMC engine's synthesized moments (it reproduces
            # the plain-MC formula shape); the honest accuracy is the
            # t-quantile RQMC CI over the shift replicates
            print(f"RQMC 95% CI (shift-replicate spread): "
                  f"{res.ci_error:e}")
        if greeks is not None:
            gl = ", ".join(f"d/d{k}={v:+.5f}" for k, v in greeks.items()
                           if k != "price")
            label = ("Pathwise Greeks (jax.grad)" if args.method == "fe"
                     else "EM sensitivities (pathwise S_0/r/rho, CRN-FD "
                          "rest)")
            print(f"{label}: {gl}")
        if args.oracle:
            from .oracle import heston_call_undiscounted
            print(f"Semi-analytic Heston price (undiscounted): "
                  f"{heston_call_undiscounted(params):f}")
    m.finalize()
    return 0


def main() -> None:
    raise SystemExit(run())


if __name__ == "__main__":
    main()
