"""EM (Broadie–Kaya) sensitivities — pathwise where exact, CRN-FD
where rejection sampling breaks pathwise differentiability.

The differentiability
analysis for the exact scheme (``ops/em.py::em_path_law``, reference
``NMCH_EM.cu:96-124``):

**Pathwise-exact subset: (S_0, r, rho).**  The variance path
(v_t, vI, v_T) is driven by Poisson(lambda(v; k, sigma, dt)) and
Gamma(d + N_p) draws whose laws involve ONLY (T, v_0, k, theta,
sigma) — S_0, r and rho appear nowhere in the variance dynamics.
Conditional on the simulated variance path, the price is the smooth
closed form  E[(S_T-K)^+ | path] = BS(m, sig_eff)  with

    m       = ln S_0 + r T - vI/2 + (rho/sigma)(v_T - v_0 - k theta T
                                                + k vI)
    sig_eff = sqrt((1 - rho^2) vI)

(``em_conditional_payoff``), so d/d(S_0, r, rho) commutes with the
expectation over the (parameter-independent) variance randomness:
jax.grad through the conditional payoff holding (v_T, vI) fixed is an
UNBIASED pathwise estimator — no kink correction needed (the
conditional payoff is C^infinity, unlike the FE payoff's (.)^+).
Note rho's explicit appearance in m uses sigma, k, theta as
*coefficients*; those stay frozen at their input values, which is
exactly right: we differentiate w.r.t. rho only.

**Not pathwise-differentiable: (T, v_0, k, theta, sigma).**  These
enter the Poisson rate, the Gamma shape d = 2 k theta/sigma^2 and the
scale sig^2(1-e^{-k dt})/(2k).  Two obstructions:
(1) N_p is integer-valued: an infinitesimal parameter bump moves
    Poisson cell boundaries, flipping N_p by +-1 with probability
    O(h) and shifting the gamma shape by 1 — an O(1) jump, so the
    pathwise derivative misses the boundary terms (it sees only the
    smooth within-cell dependence);
(2) Marsaglia–Tsang is a rejection sampler: the accept/reject
    decision flips with probability O(h), again an O(1) state jump.
Both are the classic "discrete randomness" failures of pathwise
differentiation (Glasserman ch. 7.2).  The fallback implemented here
is **central finite differences with common random numbers**: the
bumped and base runs share the (seed, epoch) counter streams, so all
non-flipped paths cancel exactly and the FD variance is O(h)/h^2 =
O(1/h) per path instead of O(1/h^2).  Measured std at N=32, 2^14
paths (CPU, 4 epochs; truth from the semi-analytic oracle FD):
theta-sensitivity 0.137 +- 0.19 / 0.05 / 0.025 at rel_bump = 0.01 /
0.05 / 0.1 — the 1/sqrt(h) law in action, means on-truth throughout.
Default rel_bump = 0.05: O(h^2) bias ~ 0.25% relative, noise
~ sqrt(2^14/n_paths) x 0.05 on theta at other sizes; average over
epochs or raise n_paths for tighter estimates.  A score-function
(LRM) estimator is implemented in ops/em_lrm.py: it scores
the JOINT (Poisson index, realized v') density — no log-Bessel
needed, only digamma — removing the bump/bias trade entirely.
Measured (benchmarks/RESULTS.md): LRM is ~3x tighter on
(k, theta) at every N, but its (T, sigma) score variance grows
~ N * lam, so CRN-FD remains the shipping default;
``NMCH_EM.greeks(lrm=True)`` selects the score estimator.

The CUDA reference has no sensitivities of any kind.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .em import em_path_law, em_conditional_payoff, em_moments_scan
from .fe import path_index_grid

PATHWISE_PARAMS = ("S_0", "r", "rho")
FD_PARAMS = ("T", "v_0", "k", "theta", "sigma")
_IDX = {"T": 0, "S_0": 1, "v_0": 2, "r": 3, "k": 4, "rho": 5,
        "theta": 6, "sigma": 7}


@functools.partial(jax.jit,
                   static_argnames=("N", "n_paths", "rng", "fix_strike",
                                    "poisson_cut"))
def em_price_and_greeks(params_vec, epoch, k0, k1, *, N: int,
                        n_paths: int, rng: str = "philox",
                        poisson_cut: float | None = None,
                        fix_strike: bool = False):
    """(price, greeks) with greeks = dict over PATHWISE_PARAMS —
    the exactly-pathwise EM subset (module docstring).

    price is the conditional-MC estimate (same estimator as
    ``em_moments_scan(conditional=True)``); delta differentiates both
    spot and the K = S_0 coupling unless fix_strike=True (same
    convention as ops/greeks.py).
    """
    pidx = path_index_grid(n_paths)
    path_lo = pidx.astype(jnp.uint32)
    path_hi = jnp.zeros_like(path_lo)
    # simulate the variance path ONCE; its randomness does not depend
    # on (S_0, r, rho), so it is a constant w.r.t. the grad below
    _, _, v_T, vI, _ = em_path_law(params_vec, N, path_lo, path_hi,
                                   epoch, k0, k1, rng=rng,
                                   poisson_cut=poisson_cut)
    v_T = lax.stop_gradient(v_T)
    vI = lax.stop_gradient(vI)
    T = params_vec[0]
    v_0 = params_vec[2]
    k = params_vec[4]
    theta = params_vec[6]
    sigma = params_vec[7]

    def price_of(p3):
        S_0, r_, rho_ = p3[0], p3[1], p3[2]
        K = lax.stop_gradient(S_0) if fix_strike else S_0
        m = (jnp.log(S_0) + r_ * T - np.float32(0.5) * vI
             + (rho_ / sigma) * (v_T - v_0 - k * theta * T + k * vI))
        sig_eff = jnp.sqrt((np.float32(1.0) - rho_ * rho_) * vI)
        payoff = em_conditional_payoff(m, sig_eff, K)
        return jnp.sum(payoff) / jnp.float32(payoff.size)

    p3 = jnp.stack([params_vec[1], params_vec[3], params_vec[5]])
    price, g = jax.value_and_grad(price_of)(p3)
    return price, dict(zip(PATHWISE_PARAMS, (g[0], g[1], g[2])))


@functools.partial(jax.jit,
                   static_argnames=("N", "n_paths", "rng", "params",
                                    "poisson_cut", "rel_bump"))
def em_greeks_fd(params_vec, epoch, k0, k1, *, N: int, n_paths: int,
                 rng: str = "philox", poisson_cut: float | None = None,
                 params: tuple = FD_PARAMS, rel_bump: float = 5e-2):
    """Central-difference sensitivities with common random numbers for
    the non-pathwise EM parameters (module docstring).

    Bump size: rel_bump * max(|x|, 0.05) (the floor keeps r=0 and
    other near-zero parameters differentiable).  Uses the conditional
    estimator — the terminal-draw noise is already integrated out, so
    the FD difference carries only variance-path (sampler-flip)
    noise, whose std scales as 1/sqrt(rel_bump * n_paths) — the
    measured noise ladder is in the module docstring; the 5e-2
    default trades ~0.25%-relative O(h^2) bias for a 2.5x tighter
    estimate than 1e-2.
    """
    def price_of(pv):
        m, _ = em_moments_scan(pv, N, path_index_grid(n_paths), epoch,
                               k0, k1, rng=rng, conditional=True,
                               poisson_cut=poisson_cut)
        return m

    out = {}
    for name in params:
        i = _IDX[name]
        x = params_vec[i]
        h = np.float32(rel_bump) * jnp.maximum(jnp.abs(x),
                                               np.float32(0.05))
        up = price_of(params_vec.at[i].set(x + h))
        dn = price_of(params_vec.at[i].set(x - h))
        out[name] = (up - dn) / (np.float32(2.0) * h)
    return out
