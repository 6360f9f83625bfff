"""Property-based tests over the exploration parameter ranges.

The reference only ever exercises the 125-point (kappa, theta, sigma)
grid of ``exploration.cu:71-88``; these hypothesis tests draw from the
same continuous ranges (kappa in [0.1, 10], theta in [0.01, 0.5],
sigma in [0.1, 1], with the sweep's own 20*kappa*theta >= sigma^2
feasibility filter, plus rho in [-0.9, 0.9]) and assert the invariants
that must hold at *every* feasible point, not just the grid:

  - moments are finite, the price is a valid ATM-call value in
    [0, S_0) (undiscounted, r=0: E[(S_T - S_0)^+] < E[S_T] = S_0),
  - the variance proxy E[X^2] - E[X]^2 is nonnegative,
  - the golden scan engine and the Pallas kernel agree (the bitwise
    draw contract, asserted at f32-accumulation tolerance),
  - epochs give fresh draws.

settings: derandomized (stable CI), no deadline (first example pays
the XLA compile; params are *traced*, so all examples share it).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from hypothesis import given, settings, assume, strategies as st

from nmch.params import HestonParams
from nmch.rng.philox import split_seed
from nmch.ops.fe import fe_moments_scan, path_index_grid
from nmch.ops.fe_pallas import fe_moments_pallas
from nmch.ops.em import em_moments_scan

K0, K1 = split_seed(1234)
SW = jnp.stack([jnp.uint32(K0), jnp.uint32(K1)])

_scan = jax.jit(fe_moments_scan, static_argnums=(1, 6))
_em_scan = jax.jit(em_moments_scan, static_argnums=(1, 6, 7))

kappas = st.floats(0.1, 10.0)
thetas = st.floats(0.01, 0.5)
sigmas = st.floats(0.1, 1.0)
rhos = st.floats(-0.9, 0.9)


def _params(k, theta, sigma, rho=-0.7):
    return HestonParams(k=k, theta=theta, sigma=sigma, rho=rho)


def _feasible(k, theta, sigma):
    # the exploration sweep's own filter (exploration.cu:76,105)
    return 20.0 * k * theta >= sigma * sigma


@settings(max_examples=25, deadline=None, derandomize=True)
@given(k=kappas, theta=thetas, sigma=sigmas, rho=rhos)
def test_fe_price_is_valid_everywhere(k, theta, sigma, rho):
    assume(_feasible(k, theta, sigma))
    pv = _params(k, theta, sigma, rho).as_array()
    m, m2 = (float(x) for x in jax.device_get(
        _scan(pv, 16, path_index_grid(1024), jnp.uint32(0), K0, K1,
              "philox")))
    assert math.isfinite(m) and math.isfinite(m2)
    assert 0.0 <= m < 1.0          # undiscounted ATM call, S_0 = 1
    assert m2 >= m * m - 1e-6      # Var >= 0 up to f32 rounding
    assert m2 < 1.0


@settings(max_examples=10, deadline=None, derandomize=True)
@given(k=kappas, theta=thetas, sigma=sigmas)
def test_fe_golden_equals_kernel_everywhere(k, theta, sigma):
    assume(_feasible(k, theta, sigma))
    pv = _params(k, theta, sigma).as_array()
    n_paths, N = 512, 8
    m_s, m2_s = _scan(pv, N, path_index_grid(n_paths), jnp.uint32(2),
                      K0, K1, "philox")
    m_p, m2_p = fe_moments_pallas(pv, SW, jnp.uint32(2), jnp.uint32(0),
                                  N=N, n_paths=n_paths, rng="philox",
                                  interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6, abs=1e-9)
    assert float(m2_p) == pytest.approx(float(m2_s), rel=1e-6, abs=1e-9)


@settings(max_examples=8, deadline=None, derandomize=True)
@given(k=kappas, theta=thetas, sigma=sigmas)
def test_em_price_is_valid_everywhere(k, theta, sigma):
    """EM's rejection samplers must stay finite/valid over the whole
    sweep range (d = 2 k theta / sigma^2 spans ~0.02 .. 1000 here —
    both the alpha<1 boost branch and large-lambda regimes)."""
    assume(_feasible(k, theta, sigma))
    pv = _params(k, theta, sigma).as_array()
    m, m2 = (float(x) for x in jax.device_get(
        _em_scan(pv, 4, path_index_grid(256), jnp.uint32(0), K0, K1,
                 "philox", False)))
    assert math.isfinite(m) and math.isfinite(m2)
    assert 0.0 <= m < 1.0
    assert m2 >= m * m - 1e-6


@settings(max_examples=10, deadline=None, derandomize=True)
@given(e1=st.integers(0, 1000), e2=st.integers(0, 1000))
def test_epochs_decorrelate(e1, e2):
    assume(e1 != e2)
    pv = HestonParams().as_array()
    a, _ = _scan(pv, 8, path_index_grid(512), jnp.uint32(e1), K0, K1,
                 "philox")
    b, _ = _scan(pv, 8, path_index_grid(512), jnp.uint32(e2), K0, K1,
                 "philox")
    assert float(a) != float(b)
