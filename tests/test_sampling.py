"""Statistical tests for the vectorized Poisson/Gamma rejection samplers.

The reference has no sampler tests (SURVEY.md §4); we validate moments
(mean, variance, skewness where informative) against theory with
z-score bounds, across all algorithm regimes, plus the stream-counter
contract (lane-local consumption).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nmch.ops.sampling import (
    poisson_from_stream, gamma_ms_from_stream, lgamma_kp1,
    ptrs_log_accept_rhs,
)
from nmch.rng.philox import split_seed

SHAPE = (128, 128)            # 16384 samples
N = SHAPE[0] * SHAPE[1]
K0, K1 = split_seed(2024)
PLO = jnp.arange(N, dtype=jnp.uint32).reshape(SHAPE)
PHI = jnp.zeros_like(PLO)
CTR = jnp.zeros(SHAPE, jnp.uint32)


def _poisson(lam, epoch=0):
    f = jax.jit(lambda l: poisson_from_stream(
        jnp.full(SHAPE, l, jnp.float32), CTR, jnp.uint32(epoch), PLO, PHI,
        K0, K1))
    s, c = f(lam)
    return np.asarray(s), np.asarray(c)


def _gamma(a, epoch=1):
    f = jax.jit(lambda x: gamma_ms_from_stream(
        jnp.full(SHAPE, x, jnp.float32), CTR, jnp.uint32(epoch), PLO, PHI,
        K0, K1))
    s, c = f(a)
    return np.asarray(s), np.asarray(c)


def test_lgamma_accuracy():
    """<= 1e-4 absolute on small k (where the value is small enough
    for f32 to carry it) and <= 2e-6 relative across the PTRS range
    (at large k the value is ~3.7e4, so absolute error is bounded by
    f32 *evaluation rounding*, not by the Stirling truncation)."""
    ks = [0, 0.5, 1, 2, 2.7, 3.2, 5, 8, 9, 20, 47.3, 100]
    got = np.asarray(jax.jit(lgamma_kp1)(jnp.array(ks, jnp.float32)))
    for k, g in zip(ks, got):
        assert abs(g - math.lgamma(k + 1)) < 1e-4, (k, g)
    ks = [200, 1000, 2500, 4000, 5000]
    got = np.asarray(jax.jit(lgamma_kp1)(jnp.array(ks, jnp.float32)))
    for k, g in zip(ks, got):
        ref = math.lgamma(k + 1)
        assert abs(g - ref) / ref < 2e-6, (k, g, ref)


def test_ptrs_log_accept_rhs_cancellation_free():
    """The PTRS acceptance RHS kf*log(lam) - lam - lgamma(kf+1) must be
    accurate to ~1e-4 absolute even where the direct form loses ~1e-2
    to f32 cancellation (lam ~ 4000, |terms| ~ 3.7e4)."""
    rng = np.random.default_rng(7)
    for lam in (10.0, 35.0, 300.0, 1500.0, 3999.0):
        sd = math.sqrt(lam)
        kfs = np.maximum(np.floor(lam + sd * rng.normal(size=64)), 0.0)
        kfs = np.unique(np.concatenate([kfs, [0.0, 1.0, 2.0]]))
        got = np.asarray(jax.jit(ptrs_log_accept_rhs)(
            jnp.asarray(kfs, jnp.float32), jnp.float32(lam),
            jnp.float32(math.log(lam))))
        ref = kfs * math.log(lam) - lam - np.array(
            [math.lgamma(k + 1) for k in kfs])
        err = np.abs(got - ref)
        assert err.max() < 2e-4, (lam, err.max())


@pytest.mark.parametrize("lam", [0.3, 3.0, 9.9, 10.1, 50.0, 2000.0, 5000.0])
def test_poisson_moments_all_regimes(lam):
    s, _ = _poisson(lam)
    z_mean = (s.mean() - lam) / math.sqrt(lam / N)
    assert abs(z_mean) < 4.0, f"mean z={z_mean}"
    assert s.var() / lam == pytest.approx(1.0, rel=0.08)
    assert (s >= 0).all()
    assert np.allclose(s, np.round(s))  # integers


def test_poisson_counter_advances_lane_locally():
    s, c = _poisson(3.0)
    # at least one lane accepted before another -> counters differ
    assert len(np.unique(c)) > 1
    # all counters advanced at least one round
    assert (c >= 1).all()


def test_poisson_deterministic_per_stream():
    a, _ = _poisson(50.0)
    b, _ = _poisson(50.0)
    np.testing.assert_array_equal(a, b)
    d, _ = _poisson(50.0, epoch=7)
    assert not np.array_equal(a, d)


@pytest.mark.parametrize("a", [0.3, 0.9, 1.5, 30.0, 3000.0])
def test_gamma_moments(a):
    s, _ = _gamma(a)
    z_mean = (s.mean() - a) / math.sqrt(a / N)
    assert abs(z_mean) < 4.0, f"mean z={z_mean}"
    assert s.var() / a == pytest.approx(1.0, rel=0.08)
    assert (s >= 0).all()


def test_gamma_skewness_small_alpha():
    """alpha<1 boost path: skewness of Gamma(a) is 2/sqrt(a)."""
    a = 0.5
    s, _ = _gamma(a)
    skew = ((s - s.mean()) ** 3).mean() / s.std() ** 3
    assert skew == pytest.approx(2 / math.sqrt(a), rel=0.15)


def test_gamma_ks_against_scipy():
    from scipy import stats
    s, _ = _gamma(2.5)
    _, pval = stats.kstest(s.ravel(), "gamma", args=(2.5,))
    assert pval > 1e-4  # not a grossly wrong distribution


def test_poisson_ks_against_scipy():
    from scipy import stats
    lam = 30.0
    s, _ = _poisson(lam)
    # chi-square GOF over a binned support
    lo, hi = int(lam - 5 * lam**0.5), int(lam + 5 * lam**0.5)
    bins = np.arange(lo, hi + 2)
    obs, _ = np.histogram(s, bins=bins)
    exp = np.diff(stats.poisson.cdf(bins - 1, lam)) * N
    mask = exp > 5
    chi2 = ((obs[mask] - exp[mask]) ** 2 / exp[mask]).sum()
    dof = mask.sum() - 1
    assert chi2 < stats.chi2.ppf(0.9999, dof)


@pytest.mark.parametrize("lam", [200.0, 3000.0, 5000.0])
def test_poisson_large_lambda_chisquare(lam):
    """Chi-square GOF across the PTRS / normal-approximation boundary
    (lambda = 4000) — the range where lgamma_kp1's ~1e-2 absolute error
    is most consequential."""
    from scipy import stats
    n = 1 << 16
    lam_arr = jnp.full((n // 128, 128), lam, jnp.float32)
    path_lo = jnp.arange(n, dtype=jnp.uint32).reshape(n // 128, 128)
    ctr = jnp.zeros_like(path_lo)
    k0, k1 = split_seed(int(lam) + 13)
    kf, _ = jax.jit(poisson_from_stream)(
        lam_arr, ctr, jnp.uint32(0), path_lo, jnp.zeros_like(path_lo),
        k0, k1)
    ks = np.asarray(kf, np.float64).ravel()
    assert np.isfinite(ks).all()
    # bin the central +-4.5 sigma range, pool tails
    sd = np.sqrt(lam)
    edges = np.linspace(lam - 4.5 * sd, lam + 4.5 * sd, 40)
    obs, _ = np.histogram(ks, bins=edges)
    lo, hi = np.floor(edges[:-1]), np.floor(edges[1:])
    exp = (stats.poisson.cdf(hi, lam) - stats.poisson.cdf(lo, lam)) * n
    keep = exp > 8
    obs, exp = obs[keep], exp[keep]
    exp *= obs.sum() / exp.sum()
    chi2 = ((obs - exp) ** 2 / exp).sum()
    pval = stats.chi2.sf(chi2, len(obs) - 1)
    assert pval > 1e-5, (lam, chi2, pval)
    # first two moments
    assert abs(ks.mean() - lam) < 5 * sd / np.sqrt(n)
    assert abs(ks.std() / sd - 1) < 0.03
