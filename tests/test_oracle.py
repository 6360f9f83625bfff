"""Oracle tests: semi-analytic Heston price + reference BS parity."""

import math

import pytest

from nmch.params import HestonParams
from nmch.oracle import (
    heston_call, heston_call_undiscounted, bs_call, reference_true_price,
    norm_cdf_as, norm_cdf,
)


def test_norm_cdf_as_matches_exact():
    for x in (-3.0, -1.0, -0.5, 0.0, 0.3, 1.0, 2.5, 11.0, -11.0):
        assert abs(norm_cdf_as(x) - norm_cdf(x)) < 1e-7


def test_reference_true_price_value():
    # the value the reference prints at default params
    # (BS with vol = sigma = 0.3, T = 1): known-good from our exact BS
    assert abs(reference_true_price(1.0, 1.0, 0.0, 0.3)
               - bs_call(1.0, 1.0, 1.0, 0.0, 0.3)) < 1e-7


def test_heston_degenerates_to_bs_as_vol_of_vol_vanishes():
    p = HestonParams(sigma=1e-4)
    iv = p.theta * p.T + (p.v_0 - p.theta) * (1 - math.exp(-p.k * p.T)) / p.k
    bs = bs_call(p.S_0, p.K, p.T, p.r, math.sqrt(iv / p.T))
    assert abs(heston_call(p) - bs) < 1e-5


def test_heston_price_reasonable_at_defaults():
    # vs an independent high-precision evaluation of the same integral
    # (value pinned from two quadrature configurations agreeing to 1e-10)
    price = heston_call(HestonParams())
    assert abs(price - 0.119732509) < 1e-6


def test_heston_quadrature_converged():
    p = HestonParams()
    a = heston_call(p, u_max=200.0, n_nodes=2000)
    b = heston_call(p, u_max=400.0, n_nodes=4000)
    assert abs(a - b) < 1e-9


def test_heston_monotone_in_v0():
    lo = heston_call(HestonParams(v_0=0.05))
    hi = heston_call(HestonParams(v_0=0.2))
    assert lo < hi


def test_undiscounted_with_rate():
    p = HestonParams(r=0.05)
    assert heston_call_undiscounted(p) == pytest.approx(
        heston_call(p) * math.exp(p.r * p.T))
