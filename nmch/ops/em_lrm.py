"""Score-function (likelihood-ratio) EM sensitivities — the
derivative-free alternative to CRN finite differences for the
parameters rejection sampling makes non-differentiable
(ops/em_greeks.py), with a measured comparison vs CRN-FD in
benchmarks/RESULTS.md.

Idea: the non-pathwise EM parameters eta in (T, v_0, k, theta, sigma)
enter only through the variance chain's transition law.  Writing the
joint density of the sampled latents per step — the Poisson mixture
index n_t and the realized next variance v_{t+1} —

    p(n, v' | v) = Pois(n; lam(v)) * Gamma(v'; alpha = d + n,
                                           scale = vfac)

the likelihood-ratio estimator is

    d/d_eta E[H] = E[ d_eta H  +  (H - b) * sum_t d_eta log p_t ]

with the realized path held FIXED (no differentiation through the
rejection samplers at all — the class of failures that forced CRN-FD
is gone by construction), b a mean control variate (E[score] = 0), and
H the smooth conditional payoff.  Crucially, using the JOINT density
of (n, v') avoids the noncentral-chi-square marginal entirely — no
log-Bessel I_nu, only digamma(alpha) from the Gamma normalizer.

Per-step scores (all realized values fixed; J = d(lam_c, d, vfac)/d
eta by jacfwd of the closed-form constants):

    d_eta log Pois  = (n/lam - 1) * (v_t * J_lamc
                                     + [t = 0] * lam_c * e_{v_0})
    d_eta log Gamma = J_d * (log g - digamma(alpha))
                      + J_vfac * (g - alpha) / vfac,   g = v'/vfac

(the [t = 0] term: v_0 is itself a parameter, so the first transition's
rate lam_0 = lam_c * v_0 carries an extra derivative).

Variance caveat (the reason CRN-FD remains the shipping default): the
per-step Poisson score has variance ~ lam * (d_eta log lam)^2 and
lam ~ 2k/(sigma^2 dt) GROWS as dt -> 0, so the summed score variance
scales like N * lam ~ N^2 — the classic LRM small-step blowup
(Glasserman ch. 7.3).  Measured (benchmarks/lrm_vs_fd.py, table in
benchmarks/RESULTS.md) the blowup resolves PER PARAMETER: theta (and
mostly k) enter the law only through the Gamma shape d = 2 k theta /
sigma^2, so their scores stay N-flat and beat CRN-FD ~3x at every N
tested; T and sigma ride d log lam and their std grows ~ N (sigma:
0.045 -> 1.27 from N=8 to 128), losing to CRN-FD beyond the coarsest
grids.  Both estimators agree with the semi-analytic oracle FD
(tests/test_em_greeks.py::test_em_lrm_matches_oracle_fd).

The CUDA reference has no sensitivities of any kind.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .em import em_conditional_payoff
from .fe import path_index_grid
from .sampling import (
    poisson_from_stream, gamma_ms_from_stream, anchored_zeros,
)

LRM_PARAMS = ("T", "v_0", "k", "theta", "sigma")
# positions of the LRM parameters inside the flat f32[8] params vector
_P8 = {"T": 0, "v_0": 2, "k": 4, "theta": 6, "sigma": 7}

def digamma_vec(z):
    """psi(z) for f32 z > 0.

    Delegates to ``jax.scipy.special.digamma`` (abs error < 1e-6 over
    [0.05, 100], tests/test_em_greeks.py pins it against scipy) — the
    score loop is a plain XLA jit, so no Mosaic-lowerable hand-rolled
    series is needed here."""
    return jax.scipy.special.digamma(z.astype(jnp.float32))


def _transition_consts(p5, N: int):
    """(lam_c, d, vfac) from (T, v_0, k, theta, sigma) — closed form,
    differentiable (jacfwd gives the J rows the scores need)."""
    T, v_0, k, theta, sigma = (p5[i] for i in range(5))
    dt = T / np.float32(N)
    e = jnp.exp(-k * dt)
    sig2 = sigma * sigma
    one_m = np.float32(1.0) - e
    lam_c = np.float32(2.0) * k * e / (sig2 * one_m)
    d = np.float32(2.0) * k * theta / sig2
    vfac = sig2 * one_m / (np.float32(2.0) * k)
    return jnp.stack([lam_c, d, vfac])


@functools.partial(jax.jit, static_argnames=("N", "n_paths", "rng",
                                             "poisson_cut"))
def em_greeks_lrm(params_vec, epoch, k0, k1, *, N: int, n_paths: int,
                  rng: str = "philox", poisson_cut: float | None = None):
    """(price, greeks) with greeks = dict over LRM_PARAMS — the
    score-function estimator (module docstring).

    Unbiasedness note: requires the sampled Poisson index to actually
    follow Pois(lam); keep poisson_cut at the strict curand default
    (None -> 4000) rather than the fast 128 cut, whose normal
    approximation would put a small O(1/sqrt(cut)) inconsistency
    between the sampled law and the scored density."""
    pidx = path_index_grid(n_paths)
    path_lo = pidx.astype(jnp.uint32)
    path_hi = jnp.zeros_like(path_lo)
    ep = jnp.asarray(epoch, jnp.uint32)

    p5 = jnp.stack([params_vec[_P8[n]] for n in LRM_PARAMS])
    consts = _transition_consts(p5, N)
    J = jax.jacfwd(lambda q: _transition_consts(q, N))(p5)   # (3, 5)
    lam_c, d, vfac = consts[0], consts[1], consts[2]

    znr, fznr = anchored_zeros(path_lo)
    v0 = fznr + params_vec[2]
    d_arr = fznr + d

    def step(j, carry):
        Vt, vIr, ctr, sc = carry
        lam = lam_c * Vt
        n, ctr = poisson_from_stream(lam, ctr, ep, path_lo, path_hi,
                                     k0, k1, rng=rng,
                                     large_cut=poisson_cut)
        alpha = d_arr + n
        g, ctr = gamma_ms_from_stream(alpha, ctr, ep, path_lo, path_hi,
                                      k0, k1, rng=rng)
        Vn = vfac * g

        # floor lam: small Gamma shapes d << 1 can underflow vfac*g to
        # exactly 0 in f32, making lam = lam_c*V = 0 on some lane; n is
        # then 0 and an unfloored n/lam would be NaN, poisoning every
        # summed score.  With the floor the lane
        # contributes pois_fac = -1 against V_t ~ 0 — negligible, and
        # pricing itself never divides by lam.
        pois_fac = n / jnp.maximum(lam, np.float32(1e-37)) \
            - np.float32(1.0)
        gam_d = jnp.log(jnp.maximum(g, np.float32(1e-37))) \
            - digamma_vec(alpha)
        gam_v = (g - alpha) / vfac
        first = (j == 0).astype(jnp.float32)
        sc_new = []
        for i in range(5):
            s = pois_fac * (Vt * J[0, i])
            if i == 1:   # v_0: the first transition's rate is lam_c*v_0
                s = s + first * pois_fac * lam_c
            s = s + J[1, i] * gam_d + J[2, i] * gam_v
            sc_new.append(sc[i] + s)
        return (Vn, vIr + Vt + Vn, ctr, tuple(sc_new))

    sc0 = tuple(fznr for _ in range(5))
    v_T, vI_raw, _, sc = lax.fori_loop(0, N, step, (v0, fznr, znr, sc0))

    # realized path functionals are DATA for the explicit-derivative
    # term (their law was scored above) — EXCEPT the trapezoid's first
    # summand, which is v_0 itself: vI_raw = v_0 + 2*sum(mid) + v_N,
    # so holding the sampled (v_1..v_N) fixed still leaves an explicit
    # dvI/dv_0 = dt/2 that the score does not see (measured
    # bias before this fix: +0.015 on dP/dv_0 ~ 0.49, exactly
    # (dt/2) * dH/dvI)
    v_T = lax.stop_gradient(v_T)
    vI_rest = lax.stop_gradient(vI_raw - v0)
    S_0 = params_vec[1]
    r = params_vec[3]
    rho = params_vec[5]

    def payoff_of(q5):
        T, v_0q, k, theta, sigma = (q5[i] for i in range(5))
        dt = T / np.float32(N)
        vI = (vI_rest + v_0q) * (dt * np.float32(0.5))
        m = (jnp.log(S_0) + r * T - np.float32(0.5) * vI
             + (rho / sigma) * (v_T - v_0q - k * theta * T + k * vI))
        sig_eff = jnp.sqrt((np.float32(1.0) - rho * rho) * vI)
        return em_conditional_payoff(m, sig_eff, S_0)

    H, dH = jax.vjp(payoff_of, p5)
    price = jnp.sum(H) / jnp.float32(H.size)
    # mean control variate: E[score] = 0, so centering H costs only
    # O(1/n) bias and removes the price*score variance floor
    Hc = H - price
    n_f = jnp.float32(H.size)
    explicit = dH(jnp.ones_like(H) / n_f)[0]          # (5,) mean d_eta H
    lrm = jnp.stack([jnp.sum(Hc * sc[i]) / n_f for i in range(5)])
    g = explicit + lrm
    return price, dict(zip(LRM_PARAMS, (g[i] for i in range(5))))
