"""EM (Broadie–Kaya exact scheme) tests.

Because the EM variance transition is exact, the price has *no*
discretization bias — it must agree with the semi-analytic oracle
within pure Monte Carlo error even at small N (the key property the
reference demonstrates by comparing FE and EM, SURVEY.md §4.3).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nmch.params import HestonParams, SimConfig
from nmch.results import SimResult
from nmch.rng.philox import split_seed
from nmch.ops.fe import path_index_grid
from nmch.ops.em import em_moments_scan, em_terminal
from nmch.ops.em_pallas import em_moments_pallas
from nmch.oracle import heston_call_undiscounted
from nmch.methods.em import NMCH_EM

P = HestonParams()


def _scan_moments(params, n_paths, N, seed=1234, epoch=0):
    k0, k1 = split_seed(seed)
    m, m2 = jax.jit(em_moments_scan, static_argnums=1)(
        params.as_array(), N, path_index_grid(n_paths), jnp.uint32(epoch),
        k0, k1)
    return float(m), float(m2)


def test_price_within_ci_of_oracle():
    m, m2 = _scan_moments(P, 16384, 100)
    res = SimResult(m, m2, 16384)
    oracle = heston_call_undiscounted(P)
    assert abs(res.price - oracle) < 3.5 * res.ci_error


def test_exactness_no_N_bias():
    """EM transitions are exact: a coarse grid (N=16) must price as
    well as a fine one (no O(dt) drift like FE)."""
    oracle = heston_call_undiscounted(P)
    m, m2 = _scan_moments(P, 32768, 16)
    res = SimResult(m, m2, 32768)
    assert abs(res.price - oracle) < 3.5 * res.ci_error


def test_variance_mean_reverts():
    """E[v_T] = theta + (v_0 - theta) e^{-kT} under CIR."""
    params = HestonParams(v_0=0.3, theta=0.1, k=2.0)
    k0, k1 = split_seed(5)
    _, v_T = em_terminal(params.as_array(), 64, path_index_grid(32768),
                         jnp.uint32(0), k0, k1)
    expected = params.theta + (params.v_0 - params.theta) * math.exp(
        -params.k * params.T)
    assert float(jnp.mean(v_T)) == pytest.approx(expected, rel=0.03)
    assert (np.asarray(v_T) > 0).all()   # exact scheme: v stays positive


def test_pallas_interpret_matches_scan():
    n_paths, N = 1024, 8
    m_s, _ = _scan_moments(P, n_paths, N)
    k0, k1 = split_seed(1234)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, _ = em_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                               jnp.uint32(0), N=N, n_paths=n_paths,
                               interpret=True)
    assert float(m_p) == pytest.approx(m_s, rel=1e-6)


def test_feller_violating_params_stay_finite():
    """sigma large / theta small (Feller violated): gamma shape d < 1
    exercises the alpha<1 boost; result must stay finite & sane."""
    params = HestonParams(sigma=1.0, theta=0.01, k=1.0)
    m, m2 = _scan_moments(params, 8192, 32)
    assert math.isfinite(m) and math.isfinite(m2)
    assert 0.0 <= m < 1.0


def test_method_lifecycle():
    m = NMCH_EM(SimConfig(NTPB=512, NB=4, N=25), P, engine="scan")
    m.init(1234)
    r1 = m.compute()
    r2 = m.compute()
    assert r1.price != r2.price         # streams continued
    assert 0.05 < r1.price < 0.25
    m.finalize()


def test_em_rejects_unknown_rng():
    # threefry (2x32) has no EM path; EM draws philox/threefry4 or a
    # stateful family
    with pytest.raises(ValueError, match="threefry"):
        NMCH_EM(SimConfig(), P, rng="threefry")


def test_em_threefry4_parity_and_price():
    """rng='threefry4': golden scan == pallas kernel; price sane and
    distinct from philox draws (fast reproducible generator for EM)."""
    from nmch.ops.em import em_moments_scan
    from nmch.ops.fe import path_index_grid
    import jax
    n_paths, N = 2048, 8
    k0, k1 = split_seed(1234)
    m_s, _ = jax.jit(em_moments_scan, static_argnums=(1, 6))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1,
        "threefry4")
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, _ = em_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                               jnp.uint32(0), N=N, n_paths=n_paths,
                               rng="threefry4", interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6)
    m_ph, _ = jax.jit(em_moments_scan, static_argnums=(1, 6))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1,
        "philox")
    assert float(m_s) != float(m_ph)
    from nmch.oracle import heston_call_undiscounted
    assert abs(float(m_s) - heston_call_undiscounted(P)) < 0.02


def test_em_threefry4_method_api():
    m = NMCH_EM(SimConfig(NTPB=512, NB=4, N=16), P, engine="scan",
                rng="threefry4")
    m.init(7)
    res = m.compute()
    assert 0.05 < res.price < 0.25


def test_em_conditional_reduces_ci_and_matches_oracle():
    """Conditional MC: same mean (within CI), strictly smaller CI."""
    from nmch.ops.em import em_moments_scan
    from nmch.ops.fe import path_index_grid
    from nmch.results import SimResult
    from nmch.oracle import heston_call_undiscounted
    import jax
    n_paths, N = 8192, 16
    k0, k1 = split_seed(1234)
    fn = jax.jit(em_moments_scan, static_argnums=(1, 6, 7))
    mc, m2c = fn(P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0),
                 k0, k1, "philox", True)
    mp, m2p = fn(P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0),
                 k0, k1, "philox", False)
    cond = SimResult(float(mc), float(m2c), n_paths)
    plain = SimResult(float(mp), float(m2p), n_paths)
    assert cond.ci_error < 0.7 * plain.ci_error
    oracle = heston_call_undiscounted(P)
    assert abs(cond.price - oracle) < 3 * cond.ci_error + 2e-3


def test_em_conditional_pallas_matches_scan():
    from nmch.ops.em import em_moments_scan
    from nmch.ops.fe import path_index_grid
    import jax
    n_paths, N = 2048, 8
    k0, k1 = split_seed(7)
    m_s, _ = jax.jit(em_moments_scan, static_argnums=(1, 6, 7))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), k0, k1,
        "philox", True)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, _ = em_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                               jnp.uint32(0), N=N, n_paths=n_paths,
                               conditional=True, interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6)


def test_em_conditional_method_api():
    m = NMCH_EM(SimConfig(NTPB=512, NB=4, N=16), P, engine="scan",
                conditional=True)
    m.init(7)
    res = m.compute()
    assert 0.08 < res.price < 0.16


def test_em_poisson_cut_price_parity():
    """Dropping the Poisson normal-approximation switch from curand's
    4000 to the shipping default 128 must not move the price beyond
    Monte Carlo noise (the Gamma(d + N_p) mixture smooths the
    O(1/sqrt(lam)) CDF error of the normal branch — ops/em.py).

    N=128 makes the per-step lambda ~ 2 v/(sigma^2 dt) ~ 280 at the
    default params, so the cut=128 run takes the normal branch on
    essentially every step while cut=4000 runs pure PTRS; the two
    consume different draw counts, so the runs are independent samples
    and the bound is the combined 3-sigma CI."""
    import jax
    n_paths, N = 16384, 128
    k0, k1 = split_seed(1234)
    fn = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8))
    m_fast, m2_fast = fn(P.as_array(), N, path_index_grid(n_paths),
                         jnp.uint32(0), k0, k1, "philox", True, 128.0)
    m_ref, m2_ref = fn(P.as_array(), N, path_index_grid(n_paths),
                       jnp.uint32(0), k0, k1, "philox", True, 4000.0)
    fast = SimResult(float(m_fast), float(m2_fast), n_paths)
    ref = SimResult(float(m_ref), float(m2_ref), n_paths)
    combined = math.hypot(fast.ci_error, ref.ci_error)
    assert abs(fast.price - ref.price) < 3.0 * combined / 1.96
    # and both agree with the semi-analytic oracle
    oracle = heston_call_undiscounted(P)
    assert abs(fast.price - oracle) < 3.5 * fast.ci_error


def test_em_poisson_cut_pallas_matches_scan():
    """poisson_cut is plumbed identically through golden and kernel."""
    n_paths, N = 2048, 32
    k0, k1 = split_seed(7)
    fn = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8))
    m_s, _ = fn(P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0),
                k0, k1, "philox", False, 64.0)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    m_p, _ = em_moments_pallas(P.as_array(), sw, jnp.uint32(0),
                               jnp.uint32(0), N=N, n_paths=n_paths,
                               poisson_cut=64.0, interpret=True)
    assert float(m_p) == pytest.approx(float(m_s), rel=1e-6)
    # a different cut must change the consumed stream (different law)
    m_s2, _ = fn(P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0),
                 k0, k1, "philox", False, 4000.0)
    assert float(m_s2) != float(m_s)


def test_em_method_default_poisson_cut_is_fast():
    m = NMCH_EM(SimConfig(), P, engine="scan")
    assert m.poisson_cut == 128.0
    m = NMCH_EM(SimConfig(), P, engine="scan", poisson_cut=4000.0)
    assert m.poisson_cut == 4000.0


# ---------------------------------------------------------------------------
# EM x the stateful curand families (the reference prices EM
# with XORWOW — exploration.cu:54-55, random.cu:6-16 templates the EM
# kernels over all three curand states)

def _stateful_scan_moments(rng, n_paths, N, seed=1234, epoch=0,
                           conditional=False):
    k0, k1 = split_seed(seed)
    fn = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8, 9))
    m, m2 = fn(P.as_array(), N, path_index_grid(n_paths),
               jnp.uint32(epoch), k0, k1, rng, conditional, None, seed)
    return float(m), float(m2)


@pytest.mark.parametrize("rng", ["xorwow", "mrg32k3a"])
def test_em_stateful_price_within_ci_of_oracle(rng):
    """The exact scheme driven by the stateful recurrences must land on
    the semi-analytic price (no discretization bias even at N=16)."""
    n = 16384
    m, m2 = _stateful_scan_moments(rng, n, 16)
    res = SimResult(m, m2, n)
    oracle = heston_call_undiscounted(P)
    assert abs(res.price - oracle) < 3.5 * res.ci_error


@pytest.mark.parametrize("rng", ["xorwow", "mrg32k3a"])
def test_em_stateful_stream_contract(rng):
    """(seed, path, epoch) streams: reproducible at the same triple,
    distinct across epochs and seeds."""
    a = _stateful_scan_moments(rng, 2048, 8, seed=7, epoch=0)
    b = _stateful_scan_moments(rng, 2048, 8, seed=7, epoch=0)
    c = _stateful_scan_moments(rng, 2048, 8, seed=7, epoch=1)
    d = _stateful_scan_moments(rng, 2048, 8, seed=8, epoch=0)
    assert a == b
    assert a != c
    assert a != d


def test_em_stateful_conditional_shrinks_ci():
    """Conditional MC composes with the stateful families too."""
    n = 8192
    m, m2 = _stateful_scan_moments("xorwow", n, 16)
    plain = SimResult(m, m2, n)
    m, m2 = _stateful_scan_moments("xorwow", n, 16, conditional=True)
    cond = SimResult(m, m2, n)
    assert cond.ci_error < plain.ci_error
    oracle = heston_call_undiscounted(P)
    assert abs(cond.price - oracle) < 3 * cond.ci_error + 2e-3


@pytest.mark.parametrize("rng", ["xorwow", "mrg32k3a"])
def test_em_stateful_method_api(rng):
    m = NMCH_EM(SimConfig(NTPB=512, NB=4, N=16), P, engine="scan",
                rng=rng)
    m.init(7)
    res = m.compute()
    assert math.isfinite(res.price) and res.price > 0
    # same stream contract as FE: epoch advances per compute()
    res2 = m.compute()
    assert res2.price != res.price


@pytest.mark.parametrize("rng", ["xorwow", "mrg32k3a"])
def test_em_stateful_validation(rng):
    # Pallas kernels keep the counter ladder
    with pytest.raises(ValueError, match="engine='scan'"):
        NMCH_EM(SimConfig(), P, engine="pallas", rng=rng)
    # path-index bits above 30 would alias onto lower streams
    with pytest.raises(ValueError, match="2\\^31"):
        NMCH_EM(SimConfig(NTPB=1 << 16, NB=1 << 15, N=8), P,
                engine="scan", rng=rng)
    # greeks need a counter rng
    m = NMCH_EM(SimConfig(NTPB=128, NB=1, N=8), P, engine="scan", rng=rng)
    m.init(3)
    with pytest.raises(ValueError, match="counter rng"):
        m.greeks()


def test_em_stateful_epoch_bound_enforced():
    """The per-family epoch bound guards the stateful stream layout
    (epochs nest below curand's 2^67 subsequence spacing)."""
    from nmch.rng.streams import stateful_max_epoch
    m = NMCH_EM(SimConfig(NTPB=128, NB=1, N=4), P, engine="scan",
                rng="xorwow")
    m.init(3)
    m.streams.epoch = stateful_max_epoch("xorwow")
    with pytest.raises(ValueError, match="exceeds"):
        m.compute()


def test_em_stateful_matches_native_validator():
    """Statistical cross-check against the independent C++ Broadie–Kaya
    validator (native/nmch_native.cpp::nmch_cpu_em_moments): two fully
    independent implementations of the exact scheme must price within
    combined Monte Carlo error."""
    from nmch import native
    if not native.available():
        pytest.skip("native toolchain unavailable")
    n = 16384
    m, m2 = _stateful_scan_moments("xorwow", n, 16)
    ours = SimResult(m, m2, n)
    nm, nm2 = native.cpu_em_moments(P, N=100, n_paths=20000, seed=11)
    theirs = SimResult(nm, nm2, 20000)
    combined = math.hypot(ours.ci_error, theirs.ci_error)
    assert abs(ours.price - theirs.price) < 3.5 * combined / 1.96
