"""QMC engine tests: Sobol' bit-parity vs scipy, bridge law, RQMC CI.

The validation strategy promised in ROADMAP #3: the point generator is
pinned bit-for-bit against scipy.stats.qmc (the independent oracle),
the Brownian bridge is validated against the increments' exact
covariance law, and the estimator is checked against the Heston
semi-analytic oracle with the randomized-QMC CI.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nmch.params import HestonParams, SimConfig
from nmch.results import SimResult
from nmch.rng.philox import split_seed
from nmch.rng.sobol import (
    direction_numbers, gray_codes, sobol_dims_u32, digital_shifts,
    u01_from_words, BITS,
)
from nmch.ops.fe_qmc import bb_plan, qmc_increments, fe_moments_qmc
from nmch.oracle import heston_call_undiscounted

P = HestonParams()
K0, K1 = split_seed(3)


def test_sobol_bit_parity_with_scipy():
    from scipy.stats import qmc
    d, k = 16, 10
    V = direction_numbers(d)
    x = np.asarray(sobol_dims_u32(gray_codes(1 << k), jnp.asarray(V)))
    mine = x.T.astype(np.float64) / 2 ** BITS
    ref = qmc.Sobol(d=d, scramble=False).random_base2(k)
    np.testing.assert_array_equal(mine, ref)


def test_u01_strictly_inside_unit_interval():
    x = jnp.asarray(np.array([0, 1, 2 ** BITS - 1], np.uint32))
    u = np.asarray(u01_from_words(x))
    assert (u > 0).all() and (u < 1).all()


def test_digital_shift_uniformity_and_determinism():
    d = jnp.arange(4096, dtype=jnp.uint32)
    s1 = np.asarray(digital_shifts(d, jnp.uint32(1), K0, K1))
    s2 = np.asarray(digital_shifts(d, jnp.uint32(1), K0, K1))
    s3 = np.asarray(digital_shifts(d, jnp.uint32(2), K0, K1))
    np.testing.assert_array_equal(s1, s2)
    assert (s1 != s3).mean() > 0.99
    assert (s1 < 2 ** BITS).all()
    u = s1.astype(np.float64) / 2 ** BITS
    assert abs(u.mean() - 0.5) < 4 / np.sqrt(12 * len(u))


def test_bb_plan_covers_every_step_once():
    for N in (1, 2, 7, 16, 100):
        levels = bb_plan(N)
        ms = np.concatenate([lev["m"] for lev in levels])
        assert sorted(ms.tolist()) == list(range(1, N + 1))
        dims = np.concatenate([lev["dims"] for lev in levels])
        assert sorted(dims.tolist()) == list(range(N))


def test_bridge_increments_match_brownian_law():
    """dW must be iid N(0, dt) across steps — the bridge is just a
    re-parameterization of the Brownian path."""
    N, n = 16, 8192
    dW1, dW2 = jax.jit(qmc_increments, static_argnums=(0, 1))(
        N, n, jnp.uint32(0), K0, K1, jnp.float32(1.0))
    dt = 1.0 / N
    for dW in (np.asarray(dW1, np.float64), np.asarray(dW2, np.float64)):
        assert np.abs(dW.mean(1)).max() < 5 * np.sqrt(dt / n)
        C = np.cov(dW)
        assert np.abs(C.diagonal() / dt - 1).max() < 0.05
        off = C - np.diag(np.diag(C))
        assert np.abs(off).max() / dt < 0.03
    # the two factors are independent
    c12 = np.corrcoef(np.asarray(dW1).ravel(), np.asarray(dW2).ravel())
    assert abs(c12[0, 1]) < 0.02


def test_qmc_price_within_ci_and_beats_mc():
    from nmch.ops.fe import fe_moments_scan, path_index_grid
    n, N = 16384, 64
    m, m2 = fe_moments_qmc(P.as_array(), jnp.uint32(0), K0, K1,
                           N=N, n_paths=n)
    q = SimResult(float(m), float(m2), n)
    mm, mm2 = jax.jit(fe_moments_scan, static_argnums=1)(
        P.as_array(), N, path_index_grid(n), jnp.uint32(0), K0, K1)
    mc = SimResult(float(mm), float(mm2), n)
    # >= 4x smaller CI at the same path count (measured ~16x)
    assert q.ci_error < mc.ci_error / 4
    oracle = heston_call_undiscounted(P)
    assert abs(q.price - oracle) < 5 * q.ci_error + 2e-3


def test_qmc_epochs_are_independent_replicates():
    n, N = 4096, 16
    prices = []
    for e in range(3):
        m, _ = fe_moments_qmc(P.as_array(), jnp.uint32(e), K0, K1,
                              N=N, n_paths=n)
        prices.append(float(m))
    assert len(set(prices)) == 3
    oracle = heston_call_undiscounted(P)
    for p in prices:
        assert abs(p - oracle) < 0.005


def test_qmc_method_api_and_validation():
    from nmch import NMCH_FE
    m = NMCH_FE(SimConfig(NTPB=512, NB=16, N=50), P, engine="qmc")
    m.init(1)
    res = m.compute()
    assert 0.1 < res.price < 0.14
    with pytest.raises(ValueError):
        NMCH_FE(SimConfig(), P, engine="qmc", rot=4)
    with pytest.raises(ValueError):
        NMCH_FE(SimConfig(), P, engine="qmc", rng="threefry4")


def test_lms_scramble_preserves_net_property():
    """Owen-style LMS: the scrambled generator must stay a digital net
    (one point per dyadic stratum in every dimension) and differ
    between epochs."""
    from nmch.rng.sobol import lms_scramble_directions
    V = direction_numbers(8)
    Vs = np.asarray(lms_scramble_directions(V, jnp.uint32(1), K0, K1))
    V2 = np.asarray(lms_scramble_directions(V, jnp.uint32(2), K0, K1))
    assert (Vs != np.asarray(V)).mean() > 0.5
    assert (Vs != V2).mean() > 0.5
    m = 12
    x = np.asarray(sobol_dims_u32(gray_codes(1 << m), jnp.asarray(Vs)))
    for j in range(8):
        # perfect equidistribution at EVERY dyadic resolution (the
        # property a wrong-orientation scramble silently destroys)
        for mp in (2, 4, 8, 12):
            cnt = np.bincount(x[j] >> (BITS - mp), minlength=1 << mp)
            assert (cnt == (1 << m) // (1 << mp)).all(), (j, mp)


def test_sobol_hilo_matches_direct_ladder():
    """The hi/lo GF(2)-factored generator is bit-identical to the
    30-pass XOR ladder, including with a base offset (the multi-chip
    point-range sharding primitive)."""
    from nmch.rng.sobol import (
        direction_numbers, gray_codes, sobol_dims_u32, sobol_dims_u32_hilo,
    )
    v = direction_numbers(32)
    for n in (512, 4096, 65536):
        a = np.asarray(sobol_dims_u32(gray_codes(n), v))
        b = np.asarray(sobol_dims_u32_hilo(n, v))
        assert (a == b).all(), n
    # base offsets: chip c's slice == the same slice of the full set
    full = np.asarray(sobol_dims_u32_hilo(8192, v))
    for c in (1, 3, 7):
        part = np.asarray(sobol_dims_u32_hilo(
            1024, v, base=jnp.uint32(c * 1024)))
        assert (part == full[:, c * 1024:(c + 1) * 1024]).all(), c


def test_ndtri_fast_accuracy_and_monotonicity():
    """The QMC engine's divisionless inverse CDF: < 5e-6 absolute on z
    over the u01_from_words range, monotone (sorted u -> sorted z)."""
    from scipy.special import ndtri as scipy_ndtri
    from nmch.rng.normal import ndtri_fast
    rng = np.random.default_rng(11)
    u = np.concatenate([
        rng.uniform(2 ** -24, 1 - 2 ** -24, 1 << 20),
        np.logspace(-7.2, -0.31, 20001),
        1 - np.logspace(-7.2, -0.31, 20001),
    ]).astype(np.float32)
    u = np.sort(u[(u > 0) & (u < 1)])
    z = np.asarray(jax.jit(ndtri_fast)(jnp.asarray(u)), np.float64)
    zt = scipy_ndtri(u.astype(np.float64))
    assert np.abs(z - zt).max() < 5e-6
    assert (np.diff(z) > -1e-5).all()


def test_bridge_increments_match_float64_bridge():
    """The bridge product's explicit algorithm (BRIDGE_PRECISION, three
    bf16 passes) keeps the increments at f32 grade against a float64
    NumPy bridge of the same normals (the card's error is in PERF.md;
    TF32 would be ~2e-3)."""
    from nmch.ops.fe_qmc import (
        qmc_normals_mxu, qmc_increments_mxu, bb_increment_matrix)
    N, n = 64, 512
    z1, z2 = qmc_normals_mxu(N, n, jnp.uint32(2), K0, K1)
    dw1, dw2 = qmc_increments_mxu(N, n, jnp.uint32(2), K0, K1,
                                  jnp.float32(1.0))
    A = bb_increment_matrix(N).astype(np.float64)
    for z, dw in ((z1, dw1), (z2, dw2)):
        ref = np.sqrt(1.0 / N) * (A @ np.asarray(z, np.float64))
        err = np.abs(np.asarray(dw, np.float64) - ref).max()
        assert err / np.sqrt(np.mean(ref * ref)) < 1e-4


def test_owen_scramble_preserves_net_property():
    """Hash-based Owen: each scrambled dimension must remain perfectly
    equidistributed at every dyadic resolution (the nested-uniform
    permutation property), differ across seeds, and be reproducible."""
    from nmch.rng.sobol import owen_scramble, owen_seeds
    V = direction_numbers(8)
    m = 12
    x = sobol_dims_u32(gray_codes(1 << m), jnp.asarray(V))      # (8, 2^m)
    keys = owen_seeds(jnp.arange(8, dtype=jnp.uint32)[:, None],
                      jnp.uint32(1), K0, K1)
    xs = np.asarray(owen_scramble(x, keys))
    xs2 = np.asarray(owen_scramble(x, keys))
    keys3 = owen_seeds(jnp.arange(8, dtype=jnp.uint32)[:, None],
                       jnp.uint32(2), K0, K1)
    xs3 = np.asarray(owen_scramble(x, keys3))
    assert (xs == xs2).all()                     # deterministic
    assert (xs != xs3).mean() > 0.5              # replicate-independent
    assert (xs >> BITS == 0).all()               # stays a 30-bit word
    for j in range(8):
        for mp in (2, 4, 8, 12):
            cnt = np.bincount(xs[j] >> (BITS - mp), minlength=1 << mp)
            assert (cnt == (1 << m) // (1 << mp)).all(), (j, mp)


def test_owen_engine_prices_and_tightens_ci():
    """scramble='owen' agrees with the oracle; its CI at a modest
    budget must at least match the LMS+shift CI's order (Owen's
    n^-1.5 advantage shows at scale; here we assert sanity, not the
    asymptotic rate)."""
    p = P.as_array()
    n_paths, N = 8 * 2048, 16
    m_o, m2_o = fe_moments_qmc(p, jnp.uint32(1), K0, K1, N=N,
                               n_paths=n_paths, scramble="owen")
    m_l, m2_l = fe_moments_qmc(p, jnp.uint32(1), K0, K1, N=N,
                               n_paths=n_paths)
    r_o = SimResult(float(m_o), float(m2_o), n_paths)
    r_l = SimResult(float(m_l), float(m2_l), n_paths)
    oracle = heston_call_undiscounted(P)
    assert abs(r_o.price - oracle) < 4 * r_o.ci_error + 2e-3
    # the 8-replicate CI estimate has ~7 dof — single-epoch ratios
    # swing 3x either way (measured geomeans are within ~15% of each
    # other at 2^14-2^16 points); assert same order, not superiority
    assert r_o.ci_error < 5 * r_l.ci_error
    assert float(m_o) != float(m_l)


def test_qmc_chunked_matches_unchunked():
    """Point-block chunking (the HBM cap for big single-chip runs)
    must not change the estimate: same randomized point set, disjoint
    index ranges, summed — like the multi-chip sharding."""
    p = P.as_array()
    n_paths, N = 8 * 4096, 16
    m1, m21 = fe_moments_qmc(p, jnp.uint32(2), K0, K1, N=N,
                             n_paths=n_paths)
    m2, m22 = fe_moments_qmc(p, jnp.uint32(2), K0, K1, N=N,
                             n_paths=n_paths, max_chunk=1024)
    assert float(m2) == pytest.approx(float(m1), rel=2e-6)
    assert float(m22) == pytest.approx(float(m21), rel=2e-4)


def test_qmc_ndtri_precise_mode():
    """ndtri_mode='precise' (full AS241) must price the same integral
    as the fast polynomial — the two maps differ by < 2.3e-6 in |z|,
    far under the CI at this size — and a non-dividing max_chunk must
    round DOWN to a divisor (gcd) instead of silently unchunking."""
    p = P.as_array()
    n_paths, N = 8 * 2048, 16
    m_f, _ = fe_moments_qmc(p, jnp.uint32(1), K0, K1, N=N,
                            n_paths=n_paths, ndtri_mode="fast")
    m_p, _ = fe_moments_qmc(p, jnp.uint32(1), K0, K1, N=N,
                            n_paths=n_paths, ndtri_mode="precise")
    assert float(m_p) == pytest.approx(float(m_f), abs=5e-5)
    # gcd rounding: 2048 points/replicate, max_chunk=768 -> gcd 256
    m_c, _ = fe_moments_qmc(p, jnp.uint32(1), K0, K1, N=N,
                            n_paths=n_paths, max_chunk=768)
    assert float(m_c) == pytest.approx(float(m_f), rel=2e-6)


def test_scramble_auto_resolution():
    """scramble='auto' (the default) resolves by the measured
    crossover: shared-LMS below 2^21 points, independent Owen
    scrambles above (RESULTS.md attribution: owen holds 77x+
    error-matched at 2^22-2^24 where lms stalls at 33-48x)."""
    from nmch.methods.fe import NMCH_FE
    from nmch.params import SimConfig
    m_small = NMCH_FE(SimConfig(NTPB=512, NB=16, N=8), P,
                      engine="qmc")
    assert m_small.scramble == "lms-shift"
    m_big = NMCH_FE(SimConfig(NTPB=1024, NB=2048, N=8), P,
                    engine="qmc")
    assert m_big.scramble == "owen"
    # non-qmc engines accept only the default passthrough
    m_fe = NMCH_FE(SimConfig(NTPB=512, NB=16, N=8), P,
                   engine="pallas")
    assert m_fe.scramble == "lms-shift"
    import pytest as _pytest
    with _pytest.raises(ValueError):
        NMCH_FE(SimConfig(), P, engine="pallas", scramble="owen")


def test_dyadic_bridge_exact_covariance_and_pow2_equivalence():
    """bridge='dyadic': the refinement map B must
    satisfy B B^T = dt I exactly (independent BM increments), and at
    power-of-2 N the padded tree coincides with the dense bridge so
    both bridges price identically.  (At N=1000 the padded tree is
    measured SLOWER and statistically worse — kept as a documented
    negative result, RESULTS.md 'dyadic bridge' note; the
    dense matmul bridge stays the production path.)"""
    from nmch.ops.fe_qmc import _dyadic_refine
    Npad, levels = 16, 4
    dt = 1.0 / Npad
    B = np.asarray(_dyadic_refine(jnp.eye(Npad, dtype=jnp.float32),
                                  np.float32(1.0), levels))
    np.testing.assert_allclose(B @ B.T, dt * np.eye(Npad), atol=1e-7)
    p = P.as_array()
    m_m, m2_m = fe_moments_qmc(p, jnp.uint32(1), K0, K1, N=16,
                               n_paths=8 * 512, bridge="mxu")
    m_d, m2_d = fe_moments_qmc(p, jnp.uint32(1), K0, K1, N=16,
                               n_paths=8 * 512, bridge="dyadic")
    assert float(m_d) == pytest.approx(float(m_m), rel=1e-5)
    assert float(m2_d) == pytest.approx(float(m2_m), rel=1e-4)
