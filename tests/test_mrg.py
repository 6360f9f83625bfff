"""MRG32k3a family tests: device == exact big-integer oracle.

Same pinning strategy as test_threefry4.py: an arbitrary-precision
python implementation of the published recurrence (L'Ecuyer 1999; the
reference's curandStateMRG32k3a_t family, random.cu:12-13) is the
oracle; the u32 device arithmetic must match it bitwise, including the
matrix skip-ahead that realizes the (seed, path, epoch) contract.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nmch.rng.mrg32k3a import (
    M1, M2, _C1, _C2, A12, A13N, A21, A23N, _A1, _A2, _mat_pow,
    seed_state, mrg_state_at, mrg_step, u01_from_z, modmul,
    PATH_LOG2, EPOCH_LOG2,
)
from nmch.params import HestonParams
from nmch.ops.fe import path_index_grid
from nmch.ops.fe_mrg import fe_moments_mrg
from nmch.results import SimResult
from nmch.oracle import heston_call_undiscounted


def _oracle_step(s1, s2):
    x1 = (A12 * s1[1] - A13N * s1[0]) % M1
    s1 = (s1[1], s1[2], x1)
    x2 = (A21 * s2[2] - A23N * s2[0]) % M2
    s2 = (s2[1], s2[2], x2)
    return (x1 - x2) % M1, s1, s2


def _device_state(seed, paths, epoch):
    pidx = jnp.asarray(np.array(paths, np.uint32).reshape(1, -1))
    s1, s2 = jax.jit(mrg_state_at, static_argnums=0)(
        seed, pidx, jnp.uint32(epoch))
    return ([np.asarray(c)[0] for c in s1],
            [np.asarray(c)[0] for c in s2])


def test_modmul_matches_bigint():
    rng = np.random.default_rng(0)
    for m, c in ((M1, _C1), (M2, _C2)):
        a = rng.integers(0, m, size=512, dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, m, size=512, dtype=np.uint64).astype(np.uint32)
        got = np.asarray(modmul(jnp.asarray(a), jnp.asarray(b), m, c))
        want = (a.astype(object) * b.astype(object)) % m
        assert (got.astype(object) == want).all()


def test_draws_match_bigint_oracle():
    """Path 0 at epoch 0 starts from the raw seed state; the first
    draws must equal the exact recurrence bitwise."""
    seed = 1234
    s1o, s2o = seed_state(seed)
    (s1d, s2d) = _device_state(seed, [0, 1], 0)
    assert tuple(int(c[0]) for c in s1d) == s1o
    assert tuple(int(c[0]) for c in s2d) == s2o

    # advance 8 draws on device (lane 0) and in the oracle
    pidx = path_index_grid(128)
    s1, s2 = mrg_state_at(seed, pidx, jnp.uint32(0))
    zs = []
    for _ in range(8):
        z, s1, s2 = mrg_step(s1, s2)
        zs.append(int(np.asarray(z)[0, 0]))
    o1, o2 = s1o, s2o
    for i in range(8):
        zo, o1, o2 = _oracle_step(o1, o2)
        assert zs[i] == zo, f"draw {i}: {zs[i]} != {zo}"


@pytest.mark.parametrize("path,epoch", [(1, 0), (0, 1), (5, 3), (2**20, 9)])
def test_skip_ahead_matches_matrix_power(path, epoch):
    """state(seed, p, e) == A^(p 2^67 + e 2^40) s0 — exact ints."""
    seed = 42
    s1o, s2o = seed_state(seed)
    n = path * (1 << PATH_LOG2) + epoch * (1 << EPOCH_LOG2)
    want1 = _apply(_mat_pow(_A1, n, M1), s1o, M1)
    want2 = _apply(_mat_pow(_A2, n, M2), s2o, M2)
    s1d, s2d = _device_state(seed, [path], epoch)
    assert tuple(int(c[0]) for c in s1d) == want1
    assert tuple(int(c[0]) for c in s2d) == want2


def _apply(M, s, m):
    return tuple(sum(M[i][j] * s[j] for j in range(3)) % m
                 for i in range(3))


def test_jump_consistency_small_steps():
    """A^(2^40) really is 2^40 recurrence steps: check on a small
    synthetic exponent instead (A^k via matrix == k oracle steps)."""
    s1o, s2o = seed_state(7)
    k = 1000
    o1, o2 = s1o, s2o
    for _ in range(k):
        _, o1, o2 = _oracle_step(o1, o2)
    assert _apply(_mat_pow(_A1, k, M1), s1o, M1) == o1
    assert _apply(_mat_pow(_A2, k, M2), s2o, M2) == o2


def test_streams_disjoint_across_paths_and_epochs():
    seed = 9
    a = _device_state(seed, [0], 0)
    b = _device_state(seed, [1], 0)
    c = _device_state(seed, [0], 1)
    assert a != b and a != c and b != c


def test_u01_in_open_unit_interval():
    pidx = path_index_grid(256)
    s1, s2 = mrg_state_at(3, pidx, jnp.uint32(0))
    z, _, _ = mrg_step(s1, s2)
    u = np.asarray(u01_from_z(z))
    assert (u > 0.0).all() and (u < 1.0).all()
    # mean of ~256 uniforms within 5 sigma of 1/2
    assert abs(u.mean() - 0.5) < 5 * (1 / 12) ** 0.5 / np.sqrt(u.size)


def test_fe_mrg_price_within_ci():
    P = HestonParams()
    n_paths, N = 16384, 64
    m, m2 = jax.jit(fe_moments_mrg, static_argnums=(1, 4))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), 1234)
    res = SimResult(float(m), float(m2), n_paths)
    oracle = heston_call_undiscounted(P)
    # FE carries O(dt) discretization bias at N=64
    assert abs(res.price - oracle) < 3.5 * res.ci_error + 2e-3


def test_method_api_mrg():
    from nmch.methods.fe import NMCH_FE
    from nmch.params import SimConfig
    P = HestonParams()
    m = NMCH_FE(SimConfig(NTPB=512, NB=4, N=16), P, engine="scan",
                rng="mrg32k3a")
    m.init(7)
    r1 = m.compute()
    r2 = m.compute()           # epoch 1: fresh draws
    assert 0.05 < r1.price < 0.25
    assert r1.price != r2.price
    # the stateful families price on the scan engine only; qmc and rot
    # variants are refused too
    with pytest.raises(ValueError):
        NMCH_FE(SimConfig(), P, engine="qmc", rng="mrg32k3a")
    with pytest.raises(ValueError):
        NMCH_FE(SimConfig(), P, engine="scan", rng="mrg32k3a", rot=4)


def test_u01_uniformity_ks():
    """KS test of the MRG32k3a uniforms across many streams (the same
    rigor bar as the sampler suite in test_sampling.py)."""
    from scipy.stats import kstest
    pidx = path_index_grid(8192)
    s1, s2 = mrg_state_at(11, pidx, jnp.uint32(0))
    us = []
    for _ in range(4):
        z, s1, s2 = mrg_step(s1, s2)
        us.append(np.asarray(u01_from_z(z)).ravel())
    u = np.concatenate(us)
    assert kstest(u, "uniform").pvalue > 1e-3


def test_boxmuller_normality_ks():
    from scipy.stats import kstest
    from nmch.rng.normal import boxmuller
    pidx = path_index_grid(8192)
    s1, s2 = mrg_state_at(13, pidx, jnp.uint32(0))
    z1, s1, s2 = mrg_step(s1, s2)
    z2, s1, s2 = mrg_step(s1, s2)
    g1, g2 = boxmuller(u01_from_z(z1), u01_from_z(z2))
    g = np.concatenate([np.asarray(g1).ravel(), np.asarray(g2).ravel()])
    assert kstest(g, "norm").pvalue > 1e-3
    assert abs(g.mean()) < 5 / np.sqrt(g.size)
