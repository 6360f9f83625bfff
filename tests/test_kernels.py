"""The Triton kernels in interpret mode, against the XLA engines.

The card runs the same kernels compiled (tests/test_gpu.py); here the
Pallas interpreter checks their logic: the shared path bodies, the
block layout with a ragged last block, the per-block partials and the
fixed-order second pass.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nmch.params import HestonParams
from nmch.rng.philox import split_seed
from nmch.ops.fe import (
    fe_moments_scan, fe_moments_rot_scan, path_index_grid, make_draw4)
from nmch.ops.fe_pallas import fe_moments_pallas, draw_words_pallas
from nmch.ops.em import em_moments_scan
from nmch.ops.em_pallas import em_moments_pallas
from nmch.ops.path_blocks import fixed_order_sum, block_payoff_sums

P = HestonParams()
K0, K1 = split_seed(21)
SW = jnp.stack([jnp.uint32(K0), jnp.uint32(K1)])
# identical draws; the sums differ only in float32 order
REL = 1e-6


def _fe_scan(N, n, rng, rot, epoch):
    if rot == 1:
        return jax.jit(fe_moments_scan, static_argnums=(1, 6))(
            P.as_array(), N, path_index_grid(n), jnp.uint32(epoch), K0, K1,
            rng)
    return jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))(
        P.as_array(), N, path_index_grid(n), jnp.uint32(epoch), K0, K1, rng,
        rot)


@pytest.mark.parametrize("rot", [1, 2, 4, 8])
@pytest.mark.parametrize("rng", ["philox", "threefry", "threefry4"])
def test_fe_kernel_interpret_matches_scan(rng, rot):
    """Odd N (masked last half-block) and a ragged last program
    (384 paths in blocks of 256)."""
    N, n = 9, 384
    m_s, m2_s = _fe_scan(N, n, rng, rot, 4)
    m_k, m2_k = fe_moments_pallas(P.as_array(), SW, jnp.uint32(4),
                                  jnp.uint32(0), N=N, n_paths=n, rng=rng,
                                  rot=rot, block=256, interpret=True)
    assert float(m_k) == pytest.approx(float(m_s), rel=REL)
    assert float(m2_k) == pytest.approx(float(m2_s), rel=REL)


@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("rng", ["philox", "threefry4"])
def test_em_kernel_interpret_matches_scan(rng, conditional):
    N, n = 6, 256
    m_s, m2_s = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8))(
        P.as_array(), N, path_index_grid(n), jnp.uint32(1), K0, K1, rng,
        conditional, 128.0)
    m_k, m2_k = em_moments_pallas(P.as_array(), SW, jnp.uint32(1),
                                  jnp.uint32(0), N=N, n_paths=n, rng=rng,
                                  conditional=conditional,
                                  poisson_cut=128.0, interpret=True)
    assert float(m_k) == pytest.approx(float(m_s), rel=REL)
    assert float(m2_k) == pytest.approx(float(m2_s), rel=REL)


@pytest.mark.parametrize("rng", ["philox", "threefry", "threefry4"])
def test_draw_words_kernel_interpret_bitwise(rng):
    n = 512
    got = draw_words_pallas(SW, jnp.uint32(2), jnp.uint32(9), rng=rng,
                            n_paths=n, interpret=True)
    lo = jnp.arange(n, dtype=jnp.uint32)
    want = make_draw4(rng, lo, jnp.zeros_like(lo), jnp.uint32(2), K0,
                      K1)(jnp.uint32(9))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("block,num_warps", [(32, 1), (128, 4),
                                             (1024, 8)])
def test_launch_config_does_not_change_the_estimate(block, num_warps):
    """Block size and warps move work between programs, never the
    draws: every launch prices the same paths to REL."""
    N, n = 8, 1024
    ref = fe_moments_pallas(P.as_array(), SW, jnp.uint32(0),
                            jnp.uint32(0), N=N, n_paths=n, rot=4,
                            interpret=True)
    got = fe_moments_pallas(P.as_array(), SW, jnp.uint32(0),
                            jnp.uint32(0), N=N, n_paths=n, rot=4,
                            block=block, num_warps=num_warps,
                            interpret=True)
    for a, b in zip(got, ref):
        assert float(a) == pytest.approx(float(b), rel=REL)


def test_base_path_offsets_the_kernel_streams():
    """base_path shifts the stream indices (the mesh's per-device
    ranges): two halves priced from their bases sum to the whole."""
    N, n = 8, 512
    whole = fe_moments_pallas(P.as_array(), SW, jnp.uint32(0),
                              jnp.uint32(0), N=N, n_paths=n,
                              interpret=True)
    halves = [fe_moments_pallas(P.as_array(), SW, jnp.uint32(0),
                                jnp.uint32(b), N=N, n_paths=n // 2,
                                interpret=True) for b in (0, n // 2)]
    for i in range(2):
        both = (float(halves[0][i]) + float(halves[1][i])) / 2
        assert both == pytest.approx(float(whole[i]), rel=REL)


def test_kernel_rejects_bad_launch_and_rng():
    with pytest.raises(ValueError, match="power of two"):
        fe_moments_pallas(P.as_array(), SW, jnp.uint32(0), jnp.uint32(0),
                          N=4, n_paths=256, block=96, interpret=True)
    with pytest.raises(ValueError, match="rng"):
        fe_moments_pallas(P.as_array(), SW, jnp.uint32(0), jnp.uint32(0),
                          N=4, n_paths=256, rng="xorwow", interpret=True)
    with pytest.raises(ValueError, match="rng"):
        em_moments_pallas(P.as_array(), SW, jnp.uint32(0), jnp.uint32(0),
                          N=4, n_paths=256, rng="threefry", interpret=True)


@pytest.mark.parametrize("g", [1, 7, 128, 300])
def test_fixed_order_sum_matches_float64(g):
    """The second pass: row-wise Kahan + a fixed lane tree over the
    zero-padded partials equals the float64 sum of the f32 partials
    (the padding rows add nothing)."""
    rng = np.random.default_rng(g)
    parts = (rng.random((g, 2)) * 1e3).astype(np.float32)
    got = np.asarray(fixed_order_sum(jnp.asarray(parts), interpret=True))
    want = parts.astype(np.float64).sum(axis=0)
    np.testing.assert_allclose(got, want, rtol=2e-7)


def test_fixed_order_sum_is_order_fixed():
    """Same partials, same bits — and a permutation of them may differ
    only in the last ulps (the order is fixed by position, which is
    what makes reruns bitwise equal)."""
    rng = np.random.default_rng(5)
    parts = jnp.asarray((rng.random((513, 2)) * 1e3).astype(np.float32))
    a = np.asarray(fixed_order_sum(parts, interpret=True))
    b = np.asarray(fixed_order_sum(parts, interpret=True))
    assert a.tobytes() == b.tobytes()
    c = np.asarray(fixed_order_sum(parts[::-1], interpret=True))
    np.testing.assert_allclose(c, a, rtol=1e-6)


def test_block_payoff_sums_masks_ragged_block():
    """Paths past n_paths in the last program contribute nothing: a
    body that pays 1 per path sums to exactly n_paths."""
    def ones(params, k0, k1, epoch, path_lo):
        return jnp.ones(path_lo.shape, jnp.float32)

    s = block_payoff_sums(ones, P.as_array(), SW, 0, 0, n_paths=300,
                          block=128, num_warps=4, interpret=True,
                          name="ones")
    assert [float(x) for x in s] == [300.0, 300.0]
