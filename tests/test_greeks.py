"""Pathwise-Greeks tests (jax.grad through the FE engine).

Validation strategy: (1) the differentiable price reimplementation
must equal the golden engine's price bitwise-drive (same draws); (2)
pathwise gradients must match central finite differences of the SAME
fixed-seed estimator (common random numbers -- the kink contributes
only O(h) paths); (3) signs/ranges against financial facts and the
semi-analytic oracle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nmch.params import HestonParams
from nmch.rng.philox import split_seed
from nmch.ops.fe import fe_moments_scan, path_index_grid
from nmch.ops.greeks import fe_price_and_greeks, PARAM_NAMES

P = HestonParams()
K0, K1 = split_seed(1234)
N, NP = 32, 16384

_scan = jax.jit(fe_moments_scan, static_argnums=(1, 6))


def _price(pv):
    m, _ = _scan(jnp.asarray(pv, jnp.float32), N, path_index_grid(NP),
                 jnp.uint32(0), K0, K1, "philox")
    return float(m)


def test_price_matches_golden_engine():
    price, greeks = fe_price_and_greeks(P.as_array(), jnp.uint32(0),
                                        K0, K1, N=N, n_paths=NP)
    assert float(price) == pytest.approx(_price(P.as_array()), rel=1e-6)
    assert set(greeks) == set(PARAM_NAMES)
    for k, g in greeks.items():
        assert np.isfinite(float(g)), k


@pytest.mark.parametrize("idx,name,h", [(2, "v_0", 1e-3),
                                        (3, "r", 1e-3),
                                        (4, "k", 1e-2),
                                        (7, "sigma", 1e-3)])
def test_pathwise_matches_finite_difference(idx, name, h):
    """Central FD of the fixed-seed estimator == pathwise gradient.
    Common random numbers make the FD smooth except for the O(h)
    kink-crossing paths."""
    _, greeks = fe_price_and_greeks(P.as_array(), jnp.uint32(0),
                                    K0, K1, N=N, n_paths=NP)
    pv = np.asarray(P.as_array(), np.float64)
    up, dn = pv.copy(), pv.copy()
    up[idx] += h
    dn[idx] -= h
    fd = (_price(up) - _price(dn)) / (2 * h)
    assert float(greeks[name]) == pytest.approx(fd, rel=0.05, abs=5e-3), (
        name, fd, float(greeks[name]))


def test_delta_conventions_and_signs():
    _, g_atm = fe_price_and_greeks(P.as_array(), jnp.uint32(0), K0, K1,
                                   N=N, n_paths=NP)
    _, g_fix = fe_price_and_greeks(P.as_array(), jnp.uint32(0), K0, K1,
                                   N=N, n_paths=NP, fix_strike=True)
    # ATM-homogeneous delta: price scales linearly in S_0 (K = S_0, r=0)
    # so dP/dS_0 == P/S_0 == the price itself at S_0 = 1
    price, _ = fe_price_and_greeks(P.as_array(), jnp.uint32(0), K0, K1,
                                   N=N, n_paths=NP)
    assert float(g_atm["S_0"]) == pytest.approx(float(price), rel=1e-4)
    # classic fixed-strike ATM call delta is ~0.5-ish
    assert 0.3 < float(g_fix["S_0"]) < 0.8
    assert float(g_fix["S_0"]) != float(g_atm["S_0"])
    # more initial variance -> higher ATM price
    assert float(g_atm["v_0"]) > 0.0


def test_remat_matches_no_remat():
    p, g = fe_price_and_greeks(P.as_array(), jnp.uint32(0), K0, K1,
                               N=N, n_paths=2048, remat=False)
    pr, gr = fe_price_and_greeks(P.as_array(), jnp.uint32(0), K0, K1,
                                 N=N, n_paths=2048, remat=True)
    assert float(p) == pytest.approx(float(pr), rel=1e-6)
    for k in PARAM_NAMES:
        assert float(g[k]) == pytest.approx(float(gr[k]), rel=1e-4,
                                            abs=1e-7), k


def test_vega_vs_oracle_fd():
    """dP/dv_0 against a finite difference of the semi-analytic Heston
    oracle (loose: MC noise + O(dt) Euler bias)."""
    from nmch.oracle import heston_call_undiscounted
    _, g = fe_price_and_greeks(P.as_array(), jnp.uint32(0), K0, K1,
                               N=64, n_paths=65536)
    h = 1e-3
    up = heston_call_undiscounted(HestonParams(v_0=P.v_0 + h))
    dn = heston_call_undiscounted(HestonParams(v_0=P.v_0 - h))
    fd = (up - dn) / (2 * h)
    assert float(g["v_0"]) == pytest.approx(fd, rel=0.1), (float(g["v_0"]), fd)


def test_method_api_greeks():
    from nmch.methods.fe import NMCH_FE
    from nmch.params import SimConfig
    m = NMCH_FE(SimConfig(NTPB=512, NB=4, N=16), P, engine="scan")
    m.init(7)
    g = m.greeks()
    assert set(g) == {"price"} | set(PARAM_NAMES)
    # greeks() consumed epoch 0; compute() must draw fresh (epoch 1)
    r = m.compute()
    assert 0.05 < r.price < 0.25
    m2 = NMCH_FE(SimConfig(NTPB=512, NB=4, N=16), P, engine="scan",
                 rng="xorwow")
    m2.init(7)
    with pytest.raises(ValueError):
        m2.greeks()


def test_greeks_sweep_matches_single_point():
    """vmap x grad x scan: each grid row equals the single-point
    fe_price_and_greeks at its (params, epoch0+row) stream."""
    from nmch.ops.greeks import fe_greeks_sweep
    pm = jnp.stack([P.as_array(),
                    HestonParams(k=2.0, sigma=0.5, theta=0.2).as_array()])
    prices, grads = fe_greeks_sweep(pm, jnp.uint32(5), K0, K1, N=16,
                                    n_paths=2048)
    assert prices.shape == (2,) and grads.shape == (2, 8)
    for row in range(2):
        p1, g1 = fe_price_and_greeks(pm[row], jnp.uint32(5 + row),
                                     K0, K1, N=16, n_paths=2048)
        assert float(prices[row]) == pytest.approx(float(p1), rel=1e-6)
        for j, name in enumerate(PARAM_NAMES):
            assert float(grads[row, j]) == pytest.approx(
                float(g1[name]), rel=1e-5, abs=1e-8), name
