"""XORWOW family tests: device == exact GF(2) big-integer oracle.

Same pinning strategy as test_mrg.py: an arbitrary-precision python
implementation of the published recurrence (Marsaglia 2003, xorwow —
the reference's default ``curandStateXORWOW_t`` family,
random.cu:6-8) is the oracle; the u32 device arithmetic must match it
bitwise, including the GF(2)^160 matrix skip-ahead that realizes the
(seed, path, epoch) contract with curand's 2^67 subsequence spacing.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nmch.rng.xorwow import (
    WEYL, PATH_LOG2, EPOCH_LOG2, N_BITS,
    _step_words, _step_matrix, _pack, _unpack, _mat_vec, _mat_pow,
    seed_state, xorwow_state_at, xorwow_step, u01_from_out,
)
from nmch.params import HestonParams
from nmch.ops.fe import path_index_grid
from nmch.ops.fe_xorwow import fe_moments_xorwow
from nmch.results import SimResult
from nmch.oracle import heston_call_undiscounted


def _oracle_step(words, d):
    """Exact python recurrence: (out, words', d')."""
    words = _step_words(*words)
    d = (d + WEYL) & 0xFFFFFFFF
    return (words[4] + d) & 0xFFFFFFFF, words, d


def _device_state(seed, paths, epoch):
    pidx = jnp.asarray(np.array(paths, np.uint32).reshape(1, -1))
    s, d = jax.jit(xorwow_state_at, static_argnums=0)(
        seed, pidx, jnp.uint32(epoch))
    return ([np.asarray(c)[0] for c in s], np.asarray(d)[0])


def test_step_matrix_matches_recurrence():
    """F e_j == one step of the unit state, all 160 columns."""
    F = _step_matrix()
    for j in range(0, N_BITS, 7):
        assert _unpack(F[j]) == _step_words(*_unpack(1 << j))


def test_matrix_power_matches_direct_stepping():
    """F^k s0 == k direct recurrence steps (exact ints)."""
    st, _ = seed_state(7)
    w = st
    for _ in range(137):
        w = _step_words(*w)
    assert _unpack(_mat_vec(_mat_pow(137), _pack(st))) == w


def test_draws_match_exact_oracle():
    """Path 0 at epoch 0 starts from the raw seed state; the first
    outputs must equal the exact recurrence bitwise (incl. Weyl)."""
    seed = 1234
    st_o, d_o = seed_state(seed)
    s_d, d_d = _device_state(seed, [0, 1], 0)
    assert tuple(int(c[0]) for c in s_d) == st_o
    assert int(d_d[0]) == d_o

    pidx = path_index_grid(128)
    s, d = xorwow_state_at(seed, pidx, jnp.uint32(0))
    outs = []
    for _ in range(8):
        o, s, d = xorwow_step(s, d)
        outs.append(int(np.asarray(o)[0, 0]))
    w, dd = st_o, d_o
    for i in range(8):
        oo, w, dd = _oracle_step(w, dd)
        assert outs[i] == oo, f"draw {i}: {outs[i]} != {oo}"


@pytest.mark.parametrize("path,epoch", [(1, 0), (0, 1), (5, 3), (2**20, 9)])
def test_skip_ahead_matches_matrix_power(path, epoch):
    """state(seed, p, e) == F^(p 2^67 + e 2^40) s0, and the Weyl word
    is jump-invariant (362437 n === 0 mod 2^32 for these n)."""
    seed = 42
    st_o, d_o = seed_state(seed)
    n = path * (1 << PATH_LOG2) + epoch * (1 << EPOCH_LOG2)
    want = _unpack(_mat_vec(_mat_pow(n), _pack(st_o)))
    s_d, d_d = _device_state(seed, [path], epoch)
    assert tuple(int(c[0]) for c in s_d) == want
    assert int(d_d[0]) == d_o


def test_streams_disjoint_across_paths_and_epochs():
    seed = 9
    a = _device_state(seed, [0], 0)
    b = _device_state(seed, [1], 0)
    c = _device_state(seed, [0], 1)
    sa, sb, sc = (tuple(int(x[0]) for x in s) for s, _ in (a, b, c))
    assert sa != sb and sa != sc and sb != sc


def test_u01_in_open_unit_interval():
    pidx = path_index_grid(256)
    s, d = xorwow_state_at(3, pidx, jnp.uint32(0))
    o, _, _ = xorwow_step(s, d)
    u = np.asarray(u01_from_out(o))
    assert (u > 0.0).all() and (u < 1.0).all()
    assert abs(u.mean() - 0.5) < 5 * (1 / 12) ** 0.5 / np.sqrt(u.size)


def test_u01_uniformity_ks():
    from scipy.stats import kstest
    pidx = path_index_grid(8192)
    s, d = xorwow_state_at(11, pidx, jnp.uint32(0))
    us = []
    for _ in range(4):
        o, s, d = xorwow_step(s, d)
        us.append(np.asarray(u01_from_out(o)).ravel())
    u = np.concatenate(us)
    assert kstest(u, "uniform").pvalue > 1e-3


def test_boxmuller_normality_ks():
    from scipy.stats import kstest
    from nmch.rng.normal import boxmuller
    pidx = path_index_grid(8192)
    s, d = xorwow_state_at(13, pidx, jnp.uint32(0))
    o1, s, d = xorwow_step(s, d)
    o2, s, d = xorwow_step(s, d)
    g1, g2 = boxmuller(u01_from_out(o1), u01_from_out(o2))
    g = np.concatenate([np.asarray(g1).ravel(), np.asarray(g2).ravel()])
    assert kstest(g, "norm").pvalue > 1e-3
    assert abs(g.mean()) < 5 / np.sqrt(g.size)


def test_fe_xorwow_price_within_ci():
    P = HestonParams()
    n_paths, N = 16384, 64
    m, m2 = jax.jit(fe_moments_xorwow, static_argnums=(1, 4))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), 1234)
    res = SimResult(float(m), float(m2), n_paths)
    oracle = heston_call_undiscounted(P)
    # FE carries O(dt) discretization bias at N=64
    assert abs(res.price - oracle) < 3.5 * res.ci_error + 2e-3


def test_method_api_xorwow():
    from nmch.methods.fe import NMCH_FE
    from nmch.params import SimConfig
    P = HestonParams()
    m = NMCH_FE(SimConfig(NTPB=512, NB=4, N=16), P, engine="scan",
                rng="xorwow")
    m.init(7)
    r1 = m.compute()
    r2 = m.compute()           # epoch 1: fresh draws
    assert 0.05 < r1.price < 0.25
    assert r1.price != r2.price
    # the stateful families price on the scan engine only; qmc and rot
    # variants are refused too
    with pytest.raises(ValueError):
        NMCH_FE(SimConfig(), P, engine="qmc", rng="xorwow")
    with pytest.raises(ValueError):
        NMCH_FE(SimConfig(), P, engine="scan", rng="xorwow", rot=4)


def test_stateful_epoch_bound_enforced():
    """The per-family epoch bound (rng/streams.py::stateful_max_epoch)
    must gate both the method layer and the mesh
    sharding with the family's own constant."""
    from nmch.rng.streams import stateful_max_epoch
    from nmch.methods.fe import _stateful_jit
    from nmch.rng.xorwow import MAX_EPOCH as XW
    from nmch.rng.mrg32k3a import MAX_EPOCH as MRG
    assert stateful_max_epoch("xorwow") == XW
    assert stateful_max_epoch("mrg32k3a") == MRG
    with pytest.raises(ValueError, match="epoch"):
        _stateful_jit("xorwow", HestonParams().as_array(), 4,
                      path_index_grid(128), XW, 1)
    with pytest.raises(ValueError):
        stateful_max_epoch("philox")
