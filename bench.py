"""Headline benchmark: FE path·steps/sec on one GPU (+ error-matched).

Reference baseline (BASELINE.md): FE_K1 52.88 ms at 2^19 paths x
N=10^4 on the (unnamed) CUDA GPU => 99.1 G path·steps/s.  We run the
same workload shape on one GPU with the fused Triton kernel
(ops/fe_pallas.py) and the reproducible threefry4 counter streams,
rot=4 rotation sampling (2^19 path groups x 4 orthogonally-rotated
copies = 2^21 simulated paths, each a marginally-exact Euler path).

Reported keys (one JSON line on stdout):

  value / vs_baseline    raw simulated path·steps/s, rot=4.  Counting
                         rotated copies is *conservative*: the group-
                         variance ratio var(X)/(4 var(Y4)) is > 1, i.e.
                         a rot-4 group carries MORE information than 4
                         iid paths (re-measured each run from the same
                         (m, m2) outputs and reported as
                         fe_variance_ratio).
  plain_value/_vs_baseline  the rot=1 kernel — the strict apples-to-
                         apples iid number.
  rot8_value/_vs_baseline  rot=8 (4 quarter-turn angles x 2 antithetic
                         radii, ops/fe.py::radius_antithetic_scale),
                         with its own rot8_variance_ratio /
                         rot8_error_matched.
  fe_error_matched       time-to-equal-CI multiple vs the reference for
                         the rot=4 estimator = vs_baseline x
                         fe_variance_ratio.
  qmc_value              raw path·steps/s of the QMC engine at
                         2^20 points x N=1000 (scalability config).
  error_matched_value    QMC time-to-equal-CI multiple vs the
                         reference: t_ref(CI)/t_qmc with t_ref from the
                         reference's measured error curve (0.408/sqrt n
                         at 99.1 G path·steps/s, results/
                         scalability.png fit — see benchmarks/
                         RESULTS.md).
  qmc_scale_value / qmc_scale_error_matched  the same two at 2^22
                         points with independent Owen scrambles.
  em_value / em_vs_baseline  the exact-scheme EM engine at the
                         reference's 512x512 grid config (2^18 paths x
                         N=10^3, threefry4, fast poisson_cut) vs its
                         ~600 ms (BASELINE.md).
  em_cond_value / em_cond_variance_ratio / em_cond_error_matched
                         conditional=True (closed-form terminal payoff
                         given the variance path): raw throughput, the
                         plain/conditional variance ratio, and the
                         time-to-equal-CI multiple vs the reference.
  device / card          platform, device_kind and count as JAX reports
                         them; the card's name and power limit as
                         nvidia-smi reports them.

Timing methodology: compile + warm-up discarded (like the reference's
exploration warm-up, exploration.cu:65-67), then REPS runs, each ended
with block_until_ready; the mean is reported.  Without a GPU the script
exits non-zero: a number from another device is not this benchmark's.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

N_GROUPS = 1 << 19
N_STEPS = 10_000
ROT = 4
RNG = "threefry4"
BASELINE = 99.1e9      # path·steps/s, profilings/timings.txt:5-13
REF_ERR_COEF = 0.408   # reference CI ~ 0.408/sqrt(n), scalability fit
REPS = 5
QMC_PATHS = 1 << 20
QMC_SCALE_PATHS = 1 << 22
QMC_N = 1000
EM_PATHS = 1 << 18     # the reference's 512x512 EM grid config
EM_N = 1000
EM_BASELINE = EM_PATHS * EM_N / 0.600   # ~600 ms, BASELINE.md:24


def _note(msg: str) -> None:
    """Progress -> stderr (stdout is ONLY the one JSON line)."""
    print(f"# bench {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr,
          flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _steady(fn, reps):
    """(seconds per call, per-call (m, m2) values) after a warm-up."""
    import jax
    jax.block_until_ready(fn(0))        # compile + warm-up (discarded)
    vals, t_total = [], 0.0
    for i in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(1 + i))
        t_total += time.perf_counter() - t0
        vals.append(tuple(float(x) for x in jax.device_get(out)))
    return t_total / reps, vals


def _mean_var(vals):
    # per-epoch variances averaged (NOT var of pooled moments: mixing
    # the across-epoch spread of m into the within-run variance biases
    # the error-matched ratio)
    m = sum(v[0] for v in vals) / len(vals)
    var = sum(v[1] - v[0] ** 2 for v in vals) / len(vals)
    return m, var


def main() -> int:
    import jax
    if jax.default_backend() != "gpu":
        print("bench.py measures the GPU and found none "
              f"(JAX backend: {jax.default_backend()})", file=sys.stderr)
        return 1
    import jax.numpy as jnp
    from nmch.params import HestonParams
    from nmch.rng.philox import split_seed
    from nmch.ops.fe_pallas import fe_moments_pallas
    from nmch.ops.fe_qmc import fe_moments_qmc
    from nmch.ops.em_pallas import em_moments_pallas
    from nmch.ops.em import FAST_POISSON_CUT
    from nmch.results import SimResult
    from nmch.utils.cache import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    out: dict = {"metric": "fe_path_steps_per_sec", "unit": "path_steps/s",
                 "device": {"platform": dev.platform,
                            "kind": dev.device_kind,
                            "count": len(jax.devices())},
                 "card": card_line()}
    _note(f"device {out['device']} card {out['card']}")
    pv = HestonParams().as_array()
    k0, k1 = split_seed(1234)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])

    def fe(rot):
        _note(f"fe rot={rot}")
        dt, vals = _steady(lambda e: fe_moments_pallas(
            pv, sw, jnp.uint32(e), jnp.uint32(0), N=N_STEPS,
            n_paths=N_GROUPS, rng=RNG, rot=rot), REPS)
        m, var = _mean_var(vals)
        return rot * N_GROUPS * N_STEPS / dt, m, var

    r4, r1, r8 = fe(ROT), fe(1), fe(8)
    out["value"] = r4[0]
    out["vs_baseline"] = r4[0] / BASELINE
    out["plain_value"] = r1[0]
    out["plain_vs_baseline"] = r1[0] / BASELINE
    out["rot8_value"] = r8[0]
    out["rot8_vs_baseline"] = r8[0] / BASELINE
    # group-variance ratio: var(X_iid) / (rot * var(Y_rot)); >= 1 means
    # counting rotated copies as path-steps is conservative
    ratio = r1[2] / (ROT * r4[2])
    out["fe_variance_ratio"] = ratio
    out["fe_error_matched"] = ratio * r4[0] / BASELINE
    ratio8 = r1[2] / (8 * r8[2])
    out["rot8_variance_ratio"] = ratio8
    out["rot8_error_matched"] = ratio8 * r8[0] / BASELINE

    def qmc(n_paths, scramble, reps=3):
        _note(f"qmc 2^{int(math.log2(n_paths))} {scramble}")
        dt, vals = _steady(lambda e: fe_moments_qmc(
            pv, jnp.uint32(e), k0, k1, N=QMC_N, n_paths=n_paths,
            n_shifts=8, scramble=scramble), reps)
        # geomean CI over the epochs: a single 8-replicate CI estimate
        # has 7 dof and swings ~2x
        cis = [SimResult(v[0], v[1], n_paths).ci_error for v in vals]
        ci = math.exp(sum(math.log(c) for c in cis) / len(cis))
        t_ref = (REF_ERR_COEF / ci) ** 2 * QMC_N / BASELINE
        return n_paths * QMC_N / dt, t_ref / dt, ci

    q = qmc(QMC_PATHS, "lms-shift")
    out["qmc_value"], out["error_matched_value"] = q[0], q[1]
    qs = qmc(QMC_SCALE_PATHS, "owen")
    out["qmc_scale_value"], out["qmc_scale_error_matched"] = qs[0], qs[1]

    def em(conditional):
        _note(f"em conditional={conditional}")
        dt, vals = _steady(lambda e: em_moments_pallas(
            pv, sw, jnp.uint32(e), jnp.uint32(0), N=EM_N, n_paths=EM_PATHS,
            rng=RNG, conditional=conditional,
            poisson_cut=FAST_POISSON_CUT), REPS)
        return EM_PATHS * EM_N / dt, _mean_var(vals)[1]

    plain_rate, plain_var = em(False)
    cond_rate, cond_var = em(True)
    out["em_value"] = plain_rate
    out["em_vs_baseline"] = plain_rate / EM_BASELINE
    out["em_cond_value"] = cond_rate
    out["em_cond_variance_ratio"] = plain_var / cond_var
    out["em_cond_error_matched"] = (plain_var / cond_var * cond_rate
                                    / EM_BASELINE)
    out["config"] = (
        f"2^{int(math.log2(N_GROUPS))} groups x rot={ROT} "
        f"(2^{int(math.log2(N_GROUPS * ROT))} simulated paths) x "
        f"N={N_STEPS}, rng={RNG}, price={r4[1]:.6f}; qmc: "
        f"2^{int(math.log2(QMC_PATHS))} x N={QMC_N}, CI={q[2]:.2e}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
