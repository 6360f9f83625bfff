"""EM sensitivities: pathwise-exact trio FD-validated, CRN-FD ladder
sanity (ops/em_greeks.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmch.params import HestonParams, SimConfig
from nmch.rng.philox import split_seed
from nmch.ops.em_greeks import (
    em_price_and_greeks, em_greeks_fd, PATHWISE_PARAMS,
)
from nmch.ops.em import em_moments_scan
from nmch.ops.fe import path_index_grid

P = HestonParams()
K0, K1 = split_seed(1234)
N, N_PATHS = 16, 16384


def test_em_pathwise_price_matches_conditional_estimator():
    """The greeks' base price must be the conditional-MC estimator
    (same draws, same math)."""
    price, _ = em_price_and_greeks(P.as_array(), jnp.uint32(0), K0, K1,
                                   N=N, n_paths=N_PATHS)
    m, _ = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8))(
        P.as_array(), N, path_index_grid(N_PATHS), jnp.uint32(0),
        K0, K1, "philox", True, None)
    assert float(price) == pytest.approx(float(m), rel=1e-6)


def test_em_pathwise_trio_matches_crn_fd():
    """For (S_0, r, rho) the variance path is parameter-independent,
    so CRN central differences converge to the pathwise gradient."""
    pv = P.as_array()
    _, g = em_price_and_greeks(pv, jnp.uint32(0), K0, K1,
                               N=N, n_paths=N_PATHS)
    fd = em_greeks_fd(pv, jnp.uint32(0), K0, K1, N=N, n_paths=N_PATHS,
                      params=PATHWISE_PARAMS, rel_bump=1e-3)
    for name in PATHWISE_PARAMS:
        a, b = float(g[name]), float(fd[name])
        # identical variance paths cancel in the FD difference, so
        # tolerance is O(h^2) + f32 subtraction noise only
        assert a == pytest.approx(b, rel=5e-2, abs=5e-4), (name, a, b)


def test_em_pathwise_delta_sensible():
    """ATM-coupled delta (K moves with S_0) differs from fixed-strike
    delta; fixed-strike ATM call delta ~ Phi(d1) ~ 0.5-0.6."""
    pv = P.as_array()
    _, g_atm = em_price_and_greeks(pv, jnp.uint32(0), K0, K1,
                                   N=N, n_paths=N_PATHS)
    _, g_fix = em_price_and_greeks(pv, jnp.uint32(0), K0, K1,
                                   N=N, n_paths=N_PATHS, fix_strike=True)
    assert 0.4 < float(g_fix["S_0"]) < 0.75
    assert float(g_atm["S_0"]) != float(g_fix["S_0"])
    # ATM-homogeneous contract: price is linear in S_0 at K = S_0, so
    # dP/dS_0 = P/S_0 exactly
    price, _ = em_price_and_greeks(pv, jnp.uint32(0), K0, K1,
                                   N=N, n_paths=N_PATHS)
    assert float(g_atm["S_0"]) == pytest.approx(float(price), rel=1e-3)


def test_em_fd_ladder_matches_oracle_fd():
    """CRN-FD sensitivities for the rejection-sampled parameters must
    land on the semi-analytic oracle's own finite differences (the EM
    scheme is exact in distribution, so its price curve in each
    parameter IS the oracle curve).  Tolerances ~4x the measured
    flip-noise std at this (n_paths, rel_bump) — the noise ladder in
    ops/em_greeks.py's docstring."""
    import dataclasses
    from nmch.oracle import heston_call_undiscounted
    vals = {p: [] for p in ("T", "v_0", "k", "theta", "sigma")}
    for e in range(3):
        fd = em_greeks_fd(P.as_array(), jnp.uint32(e), K0, K1,
                          N=N, n_paths=N_PATHS)
        for p in vals:
            v = float(fd[p])
            assert np.isfinite(v), p
            vals[p].append(v)
    for p, got in vals.items():
        # the oracle FD evaluates at the SAME point as the EM side by
        # construction (dataclasses.replace on P, no copied defaults)
        x = getattr(P, p)
        h = 0.01 * max(abs(x), 0.05)
        up = dataclasses.replace(P, **{p: x + h})
        dn = dataclasses.replace(P, **{p: x - h})
        want = (heston_call_undiscounted(up)
                - heston_call_undiscounted(dn)) / (2 * h)
        assert abs(np.mean(got) - want) < 0.12, (p, got, want)
    assert np.mean(vals["theta"]) > 0.0
    assert np.mean(vals["v_0"]) > 0.0


def test_em_method_api_greeks():
    m = NMCH_EM_factory()
    m.init(7)
    out = m.greeks(fd=True)
    assert set(out) == {"price", "S_0", "r", "rho",
                        "T", "v_0", "k", "theta", "sigma"}
    assert 0.05 < out["price"] < 0.25
    # epoch accounting: greeks consumed 2 epochs (pathwise + fd)
    r = m.compute()
    assert np.isfinite(r.price)


def NMCH_EM_factory():
    from nmch.methods.em import NMCH_EM
    return NMCH_EM(SimConfig(NTPB=512, NB=8, N=16), P, engine="scan")


# ---------------------------------------------------------------------------
# score-function (LRM) estimator for the same five parameters
# (ops/em_lrm.py)

def test_digamma_accuracy():
    from scipy.special import digamma as sp_digamma
    from nmch.ops.em_lrm import digamma_vec
    z = jnp.asarray(np.linspace(0.05, 100.0, 4001), jnp.float32)
    got = np.asarray(digamma_vec(z))
    want = sp_digamma(np.asarray(z, np.float64))
    assert np.max(np.abs(got - want)) < 2e-6


def test_em_lrm_matches_oracle_fd():
    """LRM sensitivities must land on the semi-analytic oracle FD —
    same bar as the CRN-FD ladder test above.  Coarse grid (N=16):
    the regime where LRM's score variance is competitive (the
    variance grows ~ N * lam, em_lrm.py module docstring), and where
    the exact scheme makes coarse grids legitimate.  sigma is checked
    loosely (largest d(log lam)/d(eta) -> noisiest score)."""
    import dataclasses
    from nmch.oracle import heston_call_undiscounted
    from nmch.ops.em_lrm import em_greeks_lrm
    vals = {p: [] for p in ("T", "v_0", "k", "theta", "sigma")}
    for e in range(4):
        _, g = em_greeks_lrm(P.as_array(), jnp.uint32(e), K0, K1,
                             N=16, n_paths=N_PATHS)
        for p in vals:
            v = float(g[p])
            assert np.isfinite(v), p
            vals[p].append(v)
    for p, got in vals.items():
        x = getattr(P, p)
        h = 1e-3 * max(abs(x), 0.05)
        up = dataclasses.replace(P, **{p: x + h})
        dn = dataclasses.replace(P, **{p: x - h})
        want = (heston_call_undiscounted(up)
                - heston_call_undiscounted(dn)) / (2 * h)
        tol = 0.25 if p == "sigma" else 0.05
        assert abs(np.mean(got) - want) < tol, (p, got, want)
    assert np.mean(vals["theta"]) > 0.0
    assert np.mean(vals["v_0"]) > 0.0


def test_em_lrm_price_matches_conditional_estimator():
    from nmch.ops.em_lrm import em_greeks_lrm
    from nmch.ops.em import em_moments_scan
    from nmch.ops.fe import path_index_grid
    price, _ = em_greeks_lrm(P.as_array(), jnp.uint32(0), K0, K1,
                             N=N, n_paths=N_PATHS)
    m, _ = em_moments_scan(P.as_array(), N, path_index_grid(N_PATHS),
                           jnp.uint32(0), K0, K1, conditional=True)
    assert float(price) == pytest.approx(float(m), rel=1e-6)


def test_em_method_api_lrm():
    from nmch.methods.em import NMCH_EM
    from nmch.params import SimConfig
    m = NMCH_EM(SimConfig(NTPB=512, NB=4, N=16), P, engine="scan")
    m.init(3)
    out = m.greeks(lrm=True)
    assert set(out) == {"price", "S_0", "r", "rho",
                        "T", "v_0", "k", "theta", "sigma"}
    assert all(np.isfinite(v) for v in out.values())
    with pytest.raises(ValueError, match="not both"):
        m.greeks(fd=True, lrm=True)


def test_em_lrm_finite_under_gamma_underflow():
    """Small Gamma shapes d = 2*k*theta/sigma^2 << 1 underflow vfac*g
    to exactly 0.0 in f32 on a large fraction of lanes (P ~ 40% per
    draw at d = 0.01), driving the next step's lam to 0; the Poisson
    score's n/lam must not turn those lanes into NaN and poison all
    five greeks (pricing never divides by lam, only the score does)."""
    from nmch.ops.em_lrm import em_greeks_lrm
    p = HestonParams(k=0.5, theta=0.01, sigma=1.0)
    price, g = em_greeks_lrm(p.as_array(), jnp.uint32(0), K0, K1,
                             N=16, n_paths=2048)
    assert np.isfinite(float(price))
    for name, v in g.items():
        assert np.isfinite(float(v)), name
