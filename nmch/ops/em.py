"""Broadie–Kaya "Exact Method" (EM) — shared core + pure-JAX golden engine.

Per time step (reference ``src/NMCH/methods/NMCH_EM.cu:96-124``), the
variance transitions through its exact noncentral-chi-square law sampled
as a Poisson mixture of gammas:

    lambda   = 2 k e^{-k dt} / (sigma^2 (1 - e^{-k dt})) * v_t
    N_p      ~ Poisson(lambda)
    gamma    ~ Gamma(d + N_p),  d = 2 k theta / sigma^2
    v_{t+dt} = sigma^2 (1 - e^{-k dt}) / (2 k) * gamma

with the trapezoidal integrated variance vI = sum(v_t + v_{t+dt}) * dt/2
(the dt/2 applied once after the loop for numerical stability, exactly
like ``NMCH_EM.cu:108,113``), and the terminal price drawn in closed
form conditional on the variance path:

    m    = ln S_0 + r T - vI/2 + (rho/sigma)(v_T - v_0 - k theta T + k vI)
    S_T  = exp(m + sqrt((1 - rho^2) vI) * G)

Note: the reference hard-codes T = 1, S_0 = 1, r = 0 here
(``NMCH_EM.cu:116-124`` — its "k theta" term is really "k theta T");
we implement the general formula, which reduces to the reference's
bit-for-bit at the default parameters (SURVEY.md §7 "fix with note").

RNG consumption: each path's stream counter advances lane-locally
through the Poisson/Gamma rejection rounds (see ops/sampling.py), then
one block for the terminal normal — so golden and Pallas engines draw
identically.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..rng.normal import boxmuller, uniform_open01
from .sampling import (
    poisson_from_stream, gamma_ms_from_stream, anchored_zeros,
    make_stream_draw4, stream_state_init, STATEFUL_RNGS,
)
from .fe import path_index_grid  # re-exported layout helper

# measured fast Poisson cut (benchmarks/RESULTS.md EM ablation): the
# price is insensitive down to ~128 while the PTRS rounds it avoids
# dominate the EM step cost.  NMCH_EM's method-layer default and the
# mesh layer's sharded default both resolve None to this, so a default
# sharded run draws the same randomness as a default single-chip run;
# ops-layer None stays curand's strict 4000 (sampling._POISSON_LARGE).
FAST_POISSON_CUT = 128.0


def em_path_law(params_vec, N: int, path_lo, path_hi, epoch, k0, k1,
                rng: str = "philox", poisson_cut: float | None = None,
                seed: int | None = None):
    """Simulate the exact variance path; returns (m, sig_eff, v_T, vI,
    final_ctr) — the conditional law of ln S_T given the variance path:
    ln S_T ~ N(m, sig_eff^2)  (reference ``NMCH_EM.cu:116-124``).

    Shared verbatim by the golden engine and the Pallas kernels.
    params_vec may be a flat f32[8] (scalar parameters) or a sequence of
    eight arrays broadcastable against the path layout — the batched
    parameter-grid kernel passes (1, 128) per-lane columns.

    poisson_cut: lambda above which the Poisson mixture index N_p uses
    the continuity-corrected normal approximation instead of PTRS
    (default: sampling._POISSON_LARGE = 4000, curand's own switch,
    NMCH_EM.cu:102 uses curand_poisson which does the same).  The EM
    *price* tolerates a much lower cut than the raw sampler: the
    Poisson index is smoothed through Gamma(d + N_p) (adjacent indices'
    gammas overlap at width ~sqrt(d + lam) >> 1), so the normal
    approximation's O(skewness) = O(1/sqrt(lam)) CDF error enters the
    variance transition only through its smooth moments — measured
    price shift at cut=128 is below the 95% CI at 2^20 paths
    (tests/test_em.py::test_em_poisson_cut_price_parity, and the
    price measurements in benchmarks/RESULTS.md).

    rng: the counter families "philox"/"threefry4" draw at lane-local
    counters keyed by (k0, k1); the STATEFUL families
    "mrg32k3a"/"xorwow" (the reference prices EM with
    XORWOW, ``src/NMCH/test/exploration.cu:54-55``, and templates its
    EM kernels over all three curand states, ``random.cu:6-16``)
    carry the recurrence state through the step loop, initialized by
    matrix skip-ahead at (seed, path, epoch); ``seed`` (python int,
    static) is required for them and ignored otherwise.
    """
    T, S_0, v_0, r, k, rho, theta, sigma = (params_vec[i] for i in range(8))
    dt = T / jnp.float32(N)
    exp_kdt = jnp.exp(-k * dt)
    sig2 = sigma * sigma
    d = np.float32(2.0) * k * theta / sig2
    one_m = np.float32(1.0) - exp_kdt
    lam_const = np.float32(2.0) * k * exp_kdt / (sig2 * one_m)
    vfac = sig2 * one_m / (np.float32(2.0) * k)

    ep = jnp.asarray(epoch, dtype=jnp.uint32)
    # lane-anchored zeros for the while/fori carries (see the
    # ops/sampling.py module docstring)
    znr, fznr = anchored_zeros(path_lo)
    v0 = fznr + v_0
    vI0 = fznr
    if rng in STATEFUL_RNGS:
        if seed is None:
            raise ValueError(f"rng={rng!r} needs the integer seed "
                             "(stateful stream init)")
        ctr0 = stream_state_init(rng, seed, path_lo, ep)
    else:
        ctr0 = znr
    d_arr = fznr + d
    # broadcast loop constants over the path layout so fori carries and
    # sampler shapes stay uniform when params are (1, 128) columns
    lam_const = fznr + lam_const
    vfac = fznr + vfac

    def step(i, carry):
        Vt, vI, ctr = carry
        lam = lam_const * Vt
        N_p, ctr = poisson_from_stream(lam, ctr, ep, path_lo, path_hi,
                                       k0, k1, rng=rng,
                                       large_cut=poisson_cut)
        gam, ctr = gamma_ms_from_stream(d_arr + N_p, ctr, ep, path_lo,
                                        path_hi, k0, k1, rng=rng)
        Vt_next = vfac * gam
        vI = vI + (Vt + Vt_next)     # dt/2 applied once after the loop
        return (Vt_next, vI, ctr)

    Vt, vI, ctr = lax.fori_loop(0, N, step, (v0, vI0, ctr0))
    vI = vI * (dt * np.float32(0.5))

    m = (jnp.log(S_0) + r * T - np.float32(0.5) * vI
         + (rho / sigma) * (Vt - v_0 - k * theta * T + k * vI))
    sig_eff = jnp.sqrt((np.float32(1.0) - rho * rho) * vI)
    return m, sig_eff, Vt, vI, ctr


def em_terminal_core(params_vec, N: int, path_lo, path_hi, epoch, k0, k1,
                     rng: str = "philox", poisson_cut: float | None = None,
                     seed: int | None = None):
    """Simulate the exact scheme; returns (S_T, v_T, vI, final_ctr)."""
    m, sig_eff, Vt, vI, ctr = em_path_law(params_vec, N, path_lo, path_hi,
                                          epoch, k0, k1, rng=rng,
                                          poisson_cut=poisson_cut, seed=seed)
    # terminal draw (one more block per path)
    ep = jnp.asarray(epoch, dtype=jnp.uint32)
    w0, w1, _, _, ctr = make_stream_draw4(rng, ep, path_lo, path_hi,
                                          k0, k1)(ctr)
    g, _ = boxmuller(uniform_open01(w0), uniform_open01(w1))
    S_T = jnp.exp(m + sig_eff * g)
    return S_T, Vt, vI, ctr



_AS_P = np.float32(0.2316419)
_AS_B = tuple(np.float32(b) for b in
              (0.319381530, -0.356563782, 1.781477937,
               -1.821255978, 1.330274429))
_INV_SQRT_2PI = np.float32(0.3989422804014327)


def norm_cdf_vec(x):
    """Vectorized Abramowitz–Stegun 7.1.26 normal CDF (same constants
    as the reference's ``nmch::utils::NP``, utils.cu:5-25), branch-free
    for kernels.  Max abs error ~7.5e-8."""
    ax = jnp.abs(x)
    t = np.float32(1.0) / (np.float32(1.0) + _AS_P * ax)
    poly = _AS_B[4]
    for b in _AS_B[-2::-1]:
        poly = poly * t + b
    poly = poly * t
    phi = _INV_SQRT_2PI * jnp.exp(np.float32(-0.5) * ax * ax)
    nd = np.float32(1.0) - phi * poly
    return jnp.where(x >= np.float32(0.0), nd, np.float32(1.0) - nd)


def em_conditional_payoff(m, sig_eff, K):
    """E[(S_T - K)^+ | variance path] in closed form (conditional
    Monte Carlo): given the EM scheme's exact conditional law
    ln S_T ~ N(m, s^2), the payoff expectation is the Black–Scholes
    formula  e^{m+s^2/2} Phi(s - d) - K Phi(-d),  d = (ln K - m)/s.

    This *removes all terminal-draw noise* — a variance-reduction
    capability beyond the CUDA reference (which always samples S_T,
    ``NMCH_EM.cu:122-124``); measured CI shrink in RESULTS.md."""
    s = jnp.maximum(sig_eff, np.float32(1e-12))
    d = (jnp.log(K) - m) / s
    return (jnp.exp(m + np.float32(0.5) * s * s) * norm_cdf_vec(s - d)
            - K * norm_cdf_vec(-d))


def em_terminal(params_vec, N: int, path_idx, epoch, k0, k1,
                rng: str = "philox", poisson_cut: float | None = None,
                seed: int | None = None):
    """Golden engine entry: (S_T, v_T) for (R, 128) path indices."""
    path_lo = path_idx.astype(jnp.uint32)
    path_hi = jnp.zeros_like(path_lo)
    S_T, v_T, _, _ = em_terminal_core(params_vec, N, path_lo, path_hi,
                                      epoch, k0, k1, rng=rng,
                                      poisson_cut=poisson_cut, seed=seed)
    return S_T, v_T


def em_moments_scan(params_vec, N: int, path_idx, epoch, k0, k1,
                    rng: str = "philox", conditional: bool = False,
                    poisson_cut: float | None = None,
                    seed: int | None = None):
    """Golden engine: (E[X], E[X^2]) with X = (S_T - K)^+, K = S_0.

    conditional=True: X = E[(S_T - K)^+ | variance path] (conditional
    Monte Carlo, em_conditional_payoff) — same mean, strictly smaller
    variance, one fewer draw per path.

    seed: required (python int, static) when rng is a stateful family
    ("mrg32k3a"/"xorwow"); ignored for the counter families."""
    K = params_vec[1]
    if conditional:
        path_lo = path_idx.astype(jnp.uint32)
        m, sig_eff, _, _, _ = em_path_law(
            params_vec, N, path_lo, jnp.zeros_like(path_lo), epoch, k0, k1,
            rng=rng, poisson_cut=poisson_cut, seed=seed)
        payoff = em_conditional_payoff(m, sig_eff, K)
    else:
        S_T, _ = em_terminal(params_vec, N, path_idx, epoch, k0, k1,
                             rng=rng, poisson_cut=poisson_cut, seed=seed)
        payoff = jnp.maximum(S_T - K, 0.0)
    n = jnp.float32(payoff.size)
    return jnp.sum(payoff) / n, jnp.sum(payoff * payoff) / n


def em_sweep_scan(params_matrix, seed: int, epoch0: int, *, N: int,
                  n_paths: int, rng: str = "philox",
                  conditional: bool = False,
                  poisson_cut: float | None = None):
    """Batched EM parameter sweep (vmap over rows, row ``p`` at epoch
    ``epoch0 + p``).  poisson_cut=None keeps curand's 4000 switch;
    the method layer's fast 128 is passed explicitly by callers."""
    from ..rng.philox import split_seed
    k0, k1 = split_seed(seed)
    pidx = path_index_grid(n_paths)

    def one(pv, ep):
        return em_moments_scan(pv, N, pidx, ep, k0, k1, rng=rng,
                               conditional=conditional,
                               poisson_cut=poisson_cut)

    eps = jnp.uint32(epoch0) + jnp.arange(params_matrix.shape[0],
                                          dtype=jnp.uint32)
    return jax.vmap(one)(params_matrix.astype(jnp.float32), eps)
