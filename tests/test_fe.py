"""FE scheme tests: golden-vs-kernel parity + statistical oracle checks.

Mirrors the reference's verification strategy (SURVEY.md §4) but
mechanized: price within CI of the *real* Heston semi-analytic oracle,
CI-error ~ 1/sqrt(paths) scaling, engine equivalence, and the
persistent-stream contract across compute() calls.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nmch.params import HestonParams, SimConfig
from nmch.results import SimResult
from nmch.rng.philox import split_seed
from nmch.ops.fe import fe_moments_scan, fe_terminal, path_index_grid
from nmch.ops.fe_pallas import fe_moments_pallas
from nmch.oracle import heston_call_undiscounted

P = HestonParams()


def _scan_moments(params, n_paths, N, seed=1234, epoch=0):
    k0, k1 = split_seed(seed)
    m, m2 = jax.jit(fe_moments_scan, static_argnums=1)(
        params.as_array(), N, path_index_grid(n_paths), jnp.uint32(epoch),
        k0, k1)
    return float(m), float(m2)


def test_price_within_ci_of_heston_oracle():
    n_paths, N = 65536, 500
    m, m2 = _scan_moments(P, n_paths, N)
    res = SimResult(m, m2, n_paths)
    oracle = heston_call_undiscounted(P)
    # CI + small allowance for the O(dt) Euler discretization bias
    assert abs(res.price - oracle) < 3 * res.ci_error + 2e-3


def test_ci_error_scales_inverse_sqrt_paths():
    N = 200
    errs = []
    for n_paths in (8192, 32768, 131072):
        m, m2 = _scan_moments(P, n_paths, N)
        errs.append(SimResult(m, m2, n_paths).ci_error)
    # each 4x path increase should roughly halve the error
    assert errs[0] / errs[1] == pytest.approx(2.0, rel=0.25)
    assert errs[1] / errs[2] == pytest.approx(2.0, rel=0.25)


def test_pallas_interpret_matches_scan():
    """The fused kernel and the golden engine consume identical Philox
    draws, so prices agree to summation-order tolerance."""
    n_paths, N = 2048, 64
    m_s, m2_s = _scan_moments(P, n_paths, N)
    k0, k1 = split_seed(1234)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, m2_p = fe_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                                  jnp.uint32(0), N=N, n_paths=n_paths,
                                  interpret=True)
    assert float(m_p) == pytest.approx(m_s, rel=1e-6)
    assert float(m2_p) == pytest.approx(m2_s, rel=1e-6)


def test_pallas_odd_N_matches_scan():
    n_paths, N = 1024, 33
    m_s, _ = _scan_moments(P, n_paths, N)
    k0, k1 = split_seed(1234)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, _ = fe_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                               jnp.uint32(0), N=N, n_paths=n_paths,
                               interpret=True)
    assert float(m_p) == pytest.approx(m_s, rel=1e-6)


def test_epochs_give_fresh_independent_draws():
    n_paths, N = 16384, 100
    prices = [
        _scan_moments(P, n_paths, N, epoch=e)[0] for e in range(4)
    ]
    assert len(set(prices)) == 4  # all distinct
    # and all near the oracle
    oracle = heston_call_undiscounted(P)
    for p in prices:
        assert abs(p - oracle) < 0.01


def test_base_path_offsets_continue_streams():
    """Sharded chips use disjoint base_path offsets — verify offset paths
    reproduce the unsharded draws (stream = function of absolute index)."""
    params = P.as_array()
    k0, k1 = split_seed(42)
    full = fe_terminal(params, 16, path_index_grid(256), jnp.uint32(0),
                       k0, k1)[0]
    hi_half = fe_terminal(params, 16, path_index_grid(128, base=128),
                          jnp.uint32(0), k0, k1)[0]
    np.testing.assert_array_equal(np.asarray(full)[1:], np.asarray(hi_half))


def test_variance_reflection_keeps_v_nonnegative():
    params = HestonParams(sigma=1.0, k=0.1, theta=0.01)  # violent vol-of-vol
    k0, k1 = split_seed(7)
    _, v_T = fe_terminal(params.as_array(), 100, path_index_grid(1024),
                         jnp.uint32(0), k0, k1)
    assert (np.asarray(v_T) >= 0).all()


def test_r_nonzero_drift():
    """E[S_T] = S_0 e^{rT} under the risk-neutral measure."""
    params = HestonParams(r=0.1)
    k0, k1 = split_seed(3)
    S_T, _ = fe_terminal(params.as_array(), 250, path_index_grid(65536),
                         jnp.uint32(0), k0, k1)
    assert float(jnp.mean(S_T)) == pytest.approx(np.exp(0.1), abs=5e-3)


def test_antithetic_reduces_variance():
    """Antithetic pairs must cut the CI vs plain MC at equal sample
    count (payoff is monotone in the driving noise, so the pair
    covariance is negative)."""
    from nmch.ops.fe import fe_moments_antithetic_scan
    n_paths, N = 16384, 100
    k0, k1 = split_seed(1234)
    pidx = path_index_grid(n_paths)
    m_p, m2_p = jax.jit(fe_moments_scan, static_argnums=1)(
        P.as_array(), N, pidx, jnp.uint32(0), k0, k1)
    m_a, m2_a = jax.jit(fe_moments_antithetic_scan, static_argnums=1)(
        P.as_array(), N, pidx, jnp.uint32(0), k0, k1)
    plain = SimResult(float(m_p), float(m2_p), n_paths)
    anti = SimResult(float(m_a), float(m2_a), n_paths)
    assert anti.ci_error < 0.75 * plain.ci_error
    # both price near the oracle
    from nmch.oracle import heston_call_undiscounted
    oracle = heston_call_undiscounted(P)
    assert abs(anti.price - oracle) < 3 * anti.ci_error + 2e-3


def test_antithetic_pallas_matches_scan():
    from nmch.ops.fe import fe_moments_antithetic_scan
    n_paths, N = 1024, 32
    k0, k1 = split_seed(7)
    m_s, _ = jax.jit(fe_moments_antithetic_scan, static_argnums=1)(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, _ = fe_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                               jnp.uint32(0), N=N, n_paths=n_paths,
                               antithetic=True, interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6)


def test_antithetic_method_api():
    from nmch import NMCH_FE, SimConfig
    m = NMCH_FE(SimConfig(NTPB=512, NB=4, N=50), P, engine="scan",
                antithetic=True)
    m.init(1)
    res = m.compute()
    assert 0.08 < res.price < 0.16


def test_threefry4_engine_parity_and_price():
    """rng='threefry4' (fast reproducible): golden scan == pallas."""
    n_paths, N = 2048, 64
    k0, k1 = split_seed(1234)
    m_s, _ = jax.jit(fe_moments_scan, static_argnums=(1, 6))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1,
        "threefry4")
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, _ = fe_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                               jnp.uint32(0), N=N, n_paths=n_paths,
                               rng="threefry4", interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6)
    assert abs(float(m_s) - heston_call_undiscounted(P)) < 0.02


def test_rot4_pallas_matches_scan():
    """rot=4 (quarter-turn rotation sampling): golden == kernel."""
    from nmch.ops.fe import fe_moments_rot_scan
    n_paths, N = 1024, 32
    k0, k1 = split_seed(7)
    m_s, m2_s = jax.jit(fe_moments_rot_scan,
                        static_argnums=(1, 6, 7))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1,
        "philox", 4)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, m2_p = fe_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                                  jnp.uint32(0), N=N, n_paths=n_paths,
                                  rot=4, interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6)
    assert float(m2_p) == pytest.approx(float(m2_s), rel=1e-6)


def test_rot4_reduces_variance_vs_iid():
    """A rot-4 group mean must beat 4x iid paths on CI error — the
    property that makes counting rotated copies as simulated paths
    statistically honest (they're worth >= their count in variance)."""
    from nmch.ops.fe import fe_moments_rot_scan
    n_groups, N = 16384, 100
    k0, k1 = split_seed(1234)
    m_r, m2_r = jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))(
        P.as_array(), N, path_index_grid(n_groups), jnp.uint32(0), k0, k1,
        "philox", 4)
    rot = SimResult(float(m_r), float(m2_r), n_groups)
    m_i, m2_i = _scan_moments(P, 4 * n_groups, N)
    iid = SimResult(m_i, m2_i, 4 * n_groups)
    assert rot.ci_error < iid.ci_error
    oracle = heston_call_undiscounted(P)
    assert abs(rot.price - oracle) < 3 * rot.ci_error + 2e-3


def test_threefry_engine_parity_and_price():
    """rng='threefry': golden scan == pallas kernel; price within CI."""
    n_paths, N = 2048, 64
    k0, k1 = split_seed(1234)
    m_s, _ = jax.jit(fe_moments_scan, static_argnums=(1, 6))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1,
        "threefry")
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, _ = fe_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                               jnp.uint32(0), N=N, n_paths=n_paths,
                               rng="threefry", interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6)
    # and the estimate differs from philox draws but is statistically fine
    m_ph, _ = jax.jit(fe_moments_scan, static_argnums=(1, 6))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1,
        "philox")
    assert float(m_s) != float(m_ph)
    from nmch.oracle import heston_call_undiscounted
    assert abs(float(m_s) - heston_call_undiscounted(P)) < 0.02


def test_kahan_grid_accumulation_matches_f64():
    """Cross-tile compensated accumulation: the kernel's grid sum must
    match a float64 reference sum of the same payoffs to ~1e-7 relative
    at 2^20 paths (SURVEY §7 hard part 3; plain f32 running sums drift
    an order of magnitude more across 256 tiles)."""
    n_paths, N = 1 << 20, 4
    k0, k1 = split_seed(99)
    S_T, _ = jax.jit(fe_terminal, static_argnums=1)(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1)
    pay = np.asarray(jnp.maximum(S_T - P.S_0, 0.0), np.float64)
    ref_m = pay.sum() / n_paths
    ref_m2 = (pay * pay).sum() / n_paths
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m, m2 = fe_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                              jnp.uint32(0), N=N, n_paths=n_paths,
                              block=1024, interpret=True)
    assert abs(float(m) - ref_m) < 2e-7 * abs(ref_m)
    assert abs(float(m2) - ref_m2) < 2e-7 * abs(ref_m2)


@pytest.mark.parametrize("params", [
    HestonParams(sigma=0.9, theta=0.04, k=2.0),     # violent vol-of-vol
    HestonParams(r=0.1, v_0=0.04),                  # drift + low variance
    HestonParams(rho=0.5, sigma=0.5),               # positive correlation
])
def test_rot4_conservative_across_param_regimes(params):
    """The statistical basis of the headline metric (rot-4 copies are
    worth >= their count) must hold beyond the default parameters."""
    from nmch.ops.fe import fe_moments_rot_scan
    n_groups, N = 8192, 64
    k0, k1 = split_seed(7)
    m_r, m2_r = jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))(
        params.as_array(), N, path_index_grid(n_groups), jnp.uint32(0),
        k0, k1, "philox", 4)
    rot = SimResult(float(m_r), float(m2_r), n_groups)
    m_i, m2_i = jax.jit(fe_moments_scan, static_argnums=1)(
        params.as_array(), N, path_index_grid(4 * n_groups),
        jnp.uint32(0), k0, k1)
    iid = SimResult(float(m_i), float(m2_i), 4 * n_groups)
    assert rot.ci_error < 1.05 * iid.ci_error, (rot.ci_error, iid.ci_error)


def test_threefry4_rot4_parity():
    """The fast REPRODUCIBLE headline combo (rng=threefry4, rot=4):
    golden scan == pallas kernel bitwise-driven."""
    from nmch.ops.fe import fe_moments_rot_scan
    n_paths, N = 1024, 32
    k0, k1 = split_seed(11)
    m_s, m2_s = jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1,
        "threefry4", 4)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, m2_p = fe_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                                  jnp.uint32(0), N=N, n_paths=n_paths,
                                  rng="threefry4", rot=4, interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6)
    assert float(m2_p) == pytest.approx(float(m2_s), rel=1e-6)


def test_rot_group_step_matches_rotation_images_spec():
    """fe_rot_group_step's shared sign/swap algebra must equal mapping
    fe_step over rotation_images (the specification function) — the
    identity its docstring claims, pinned for every rot."""
    from nmch.ops.fe import (
        fe_consts, fe_step, fe_rot_group_step, rotation_images,
    )
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.standard_normal((4, 128)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((4, 128)).astype(np.float32))
    cst = fe_consts(jnp.float32(0.0), jnp.float32(0.5), jnp.float32(0.1),
                    jnp.float32(0.3), jnp.float32(-0.7),
                    jnp.sqrt(jnp.float32(1.0 - 0.49)),
                    jnp.float32(1e-3), jnp.sqrt(jnp.float32(1e-3)))
    for rot in (1, 2, 4, 8):
        S0 = jnp.full((4, 128), 1.0, jnp.float32)
        v0 = jnp.full((4, 128), 0.1, jnp.float32)
        Ss, vs = fe_rot_group_step([S0] * rot, [v0] * rot, a, b, cst, rot)
        for t, (g1, g2) in enumerate(rotation_images(a, b, rot)):
            S_ref, v_ref = fe_step(S0, v0, g1, g2, cst)
            np.testing.assert_allclose(np.asarray(Ss[t]),
                                       np.asarray(S_ref), rtol=2e-6)
            np.testing.assert_allclose(np.asarray(vs[t]),
                                       np.asarray(v_ref), rtol=2e-5,
                                       atol=1e-7)


def test_radius_antithetic_scale_preserves_normality():
    """(s a, s b) must be exactly N(0,1)^2 and its squared radius must
    flip the radius CDF (u -> 1-u) — the exactness contract of
    radius_antithetic_scale (ops/fe.py)."""
    from scipy.stats import kstest
    from nmch.ops.fe import radius_antithetic_scale
    rng = np.random.default_rng(0)
    a = rng.standard_normal(100000).astype(np.float32)
    b = rng.standard_normal(100000).astype(np.float32)
    s = np.asarray(radius_antithetic_scale(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(s).all() and (s > 0).all()
    assert kstest(s * a, "norm").pvalue > 1e-3
    assert kstest(s * b, "norm").pvalue > 1e-3
    u = np.exp(-(a * a + b * b) / 2)
    u_img = np.exp(-((s * a) ** 2 + (s * b) ** 2) / 2)
    np.testing.assert_allclose(u_img, 1.0 - u, atol=5e-7)


def test_rot8_reduces_variance_vs_iid():
    """A rot-8 group mean must beat 8x iid paths on CI error: the 4
    quarter-turn angles x 2 antithetic radii stratify both polar
    coordinates (the old 45-degree
    rot=8 measured ratio ~0.96 and earned no error-matched credit)."""
    from nmch.ops.fe import fe_moments_rot_scan
    n_groups, N = 16384, 64
    k0, k1 = split_seed(7)
    m_r, m2_r = jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))(
        P.as_array(), N, path_index_grid(n_groups), jnp.uint32(0), k0, k1,
        "philox", 8)
    rot = SimResult(float(m_r), float(m2_r), n_groups)
    m_i, m2_i = _scan_moments(P, 8 * n_groups, N)
    iid = SimResult(m_i, m2_i, 8 * n_groups)
    # measured ratio ~1.38 => CI ~ sqrt(1/1.38) ~ 0.85x the iid CI
    assert rot.ci_error < iid.ci_error
    oracle = heston_call_undiscounted(P)
    assert abs(rot.price - oracle) < 3 * rot.ci_error + 2e-3


def test_rot8_pallas_matches_scan():
    """Bitwise-driven parity for the redesigned rot=8 (the shared
    radius_antithetic_scale runs in both engines)."""
    from nmch.ops.fe import fe_moments_rot_scan
    n_paths, N = 1024, 32
    k0, k1 = split_seed(11)
    m_s, m2_s = jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1,
        "philox", 8)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, m2_p = fe_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                                  jnp.uint32(0), N=N, n_paths=n_paths,
                                  rng="philox", rot=8, interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6)
    assert float(m2_p) == pytest.approx(float(m2_s), rel=1e-6)
