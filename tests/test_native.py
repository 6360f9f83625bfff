"""Native C++ runtime cross-validation tests.

The C++ library (native/nmch_native.cpp) re-implements the oracle and a
CPU Monte Carlo with independent code (own Gauss-Legendre, own complex
math, xoshiro128++ RNG) — agreement is strong evidence both sides are
right.  Skipped gracefully when no toolchain is available.
"""

import math

import pytest

from nmch import native
from nmch.params import HestonParams
from nmch.results import reference_err
from nmch.oracle import heston_call as py_heston, norm_cdf_as

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


@pytest.mark.parametrize("params", [
    HestonParams(),
    HestonParams(k=2.0, theta=0.04, sigma=0.5, rho=-0.3, v_0=0.04),
    HestonParams(r=0.03, T=2.0),
    HestonParams(sigma=1.0, theta=0.01, k=1.0),   # Feller violated
])
def test_native_oracle_matches_python(params):
    assert native.heston_call(params) == pytest.approx(
        py_heston(params), abs=1e-9)


def test_native_norm_cdf_parity():
    lib = native.load()
    for x in (-3.0, -0.5, 0.0, 0.7, 2.5, 11.0):
        assert lib.nmch_norm_cdf_as(x) == pytest.approx(norm_cdf_as(x),
                                                        abs=1e-12)


def test_native_reference_err_parity():
    assert native.reference_err_native(0.12, 0.045, 262144) == pytest.approx(
        reference_err(0.12, 0.045, 262144), rel=1e-12)


def test_cpu_mc_validates_oracle():
    """Fully independent path: C++ Euler + xoshiro vs semi-analytic."""
    p = HestonParams()
    m, m2 = native.cpu_fe_moments(p, N=200, n_paths=20000, seed=7)
    err = reference_err(m, m2, 20000)
    assert abs(m - py_heston(p)) < 3 * err + 2e-3   # CI + Euler bias


def test_cpu_mc_deterministic_per_seed():
    p = HestonParams()
    a = native.cpu_fe_moments(p, N=50, n_paths=2000, seed=42)
    b = native.cpu_fe_moments(p, N=50, n_paths=2000, seed=42)
    c = native.cpu_fe_moments(p, N=50, n_paths=2000, seed=43)
    assert a == b
    assert a != c


def test_cpu_em_validates_oracle():
    """The independent C++ Broadie-Kaya pricer (libstdc++ poisson/
    gamma samplers) must land on the semi-analytic price — the exact
    scheme carries no Euler bias, only the O(dt^2) trapezoid vI."""
    p = HestonParams()
    m, m2 = native.cpu_em_moments(p, N=100, n_paths=20000, seed=7)
    err = reference_err(m, m2, 20000)
    assert abs(m - py_heston(p)) < 3 * err + 1e-3


def test_cpu_em_conditional_tightens_ci():
    """conditional=True (closed-form terminal expectation) must match
    the sampled-terminal price and shrink the CI — the same
    variance-reduction contract as the JAX engine's."""
    p = HestonParams()
    m_s, m2_s = native.cpu_em_moments(p, N=64, n_paths=20000, seed=9)
    m_c, m2_c = native.cpu_em_moments(p, N=64, n_paths=20000, seed=9,
                                      conditional=True)
    e_s = reference_err(m_s, m2_s, 20000)
    e_c = reference_err(m_c, m2_c, 20000)
    assert abs(m_c - m_s) < 3 * math.hypot(e_s, e_c)
    assert e_c < e_s


def test_cpu_em_cross_validates_jax_engine():
    """Native C++ EM vs the JAX EM engine: two from-scratch
    implementations of the same exact scheme (different Poisson/Gamma
    samplers, different RNGs) must agree within combined CIs."""
    import jax.numpy as jnp
    from nmch.ops.em import em_moments_scan
    from nmch.ops.fe import path_index_grid
    from nmch.rng.philox import split_seed
    import jax
    p = HestonParams()
    n = 16384
    m_n, m2_n = native.cpu_em_moments(p, N=32, n_paths=n, seed=3)
    k0, k1 = split_seed(3)
    m_j, m2_j = jax.jit(em_moments_scan, static_argnums=(1, 6, 7))(
        p.as_array(), 32, path_index_grid(n), jnp.uint32(0), k0, k1,
        "philox", False)
    e_n = reference_err(m_n, m2_n, n)
    e_j = reference_err(float(m_j), float(m2_j), n)
    assert abs(m_n - float(m_j)) < 3 * math.hypot(e_n, e_j)
