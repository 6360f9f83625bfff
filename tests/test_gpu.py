"""Card tests: the compiled Triton kernels against the XLA engines.

Run on a machine with a GPU:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

(chip_smoke.py runs them too.)  Everywhere else they skip through the
``gpu`` fixture.  The ordinary suite runs every kernel with
``interpret=True``, which checks the kernel *logic* but not Triton's
lowering and code generation; these tests check the golden==kernel
contract with the compiled kernels: the scan engine and the kernel
consume bitwise-identical counter draws, so the moments agree to the
float32 summation-order tolerance.
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

pytestmark = pytest.mark.gpu

P = HestonParams()
K0, K1 = split_seed(1234)
SW = jnp.stack([jnp.uint32(K0), jnp.uint32(K1)])
# same draws, float32 sums in another order (per-block tree + fixed-
# order Kahan vs XLA's reduction) and FMA contraction: measured <= 2e-7
# on the H100 (PERF.md)
REL = 1e-6


@pytest.mark.parametrize("rng", ["philox", "threefry", "threefry4"])
def test_draw_words_bitwise_on_gpu(gpu, rng):
    n = 8192
    got = draw_words_pallas(SW, jnp.uint32(3), jnp.uint32(11), rng=rng,
                            n_paths=n)
    lo = jnp.arange(n, dtype=jnp.uint32)
    want = make_draw4(rng, lo, jnp.zeros_like(lo), jnp.uint32(3), K0,
                      K1)(jnp.uint32(11))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("N,n_paths", [(64, 8192), (257, 2048)])
def test_fe_golden_equals_kernel_on_gpu(gpu, rng, N, n_paths):
    m_s, m2_s = jax.jit(fe_moments_scan, static_argnums=(1, 6))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(3),
        K0, K1, rng)
    m_p, m2_p = fe_moments_pallas(
        P.as_array(), SW, jnp.uint32(3), jnp.uint32(0), N=N,
        n_paths=n_paths, rng=rng)
    assert float(m_p) == pytest.approx(float(m_s), rel=REL)
    assert float(m2_p) == pytest.approx(float(m2_s), rel=REL)


@pytest.mark.parametrize("rot", [2, 4, 8])
def test_fe_rot_golden_equals_kernel_on_gpu(gpu, rot):
    N, n_paths = 64, 4096
    m_s, m2_s = jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(1),
        K0, K1, "philox", rot)
    m_p, m2_p = fe_moments_pallas(
        P.as_array(), SW, jnp.uint32(1), jnp.uint32(0), N=N,
        n_paths=n_paths, rng="philox", rot=rot)
    assert float(m_p) == pytest.approx(float(m_s), rel=REL)
    assert float(m2_p) == pytest.approx(float(m2_s), rel=REL)


def test_fe_kernel_deterministic_across_runs_on_gpu(gpu):
    """Per-block partials + fixed-order second pass: bitwise-stable
    re-runs (no float atomics)."""
    N, n_paths = 64, 1 << 16
    outs = [jax.device_get(fe_moments_pallas(
        P.as_array(), SW, jnp.uint32(5), jnp.uint32(0), N=N,
        n_paths=n_paths, rng="threefry4", rot=4)) for _ in range(2)]
    assert [float(x) for x in outs[0]] == [float(x) for x in outs[1]]


@pytest.mark.parametrize("rng", ["philox", "threefry4"])
@pytest.mark.parametrize("conditional", [False, True])
def test_em_golden_equals_kernel_on_gpu(gpu, rng, conditional):
    N, n_paths = 32, 4096
    m_s, m2_s = jax.jit(em_moments_scan, static_argnums=(1, 6, 7))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(2),
        K0, K1, rng, conditional)
    m_p, m2_p = em_moments_pallas(
        P.as_array(), SW, jnp.uint32(2), jnp.uint32(0), N=N,
        n_paths=n_paths, rng=rng, conditional=conditional)
    assert float(m_p) == pytest.approx(float(m_s), rel=REL)
    assert float(m2_p) == pytest.approx(float(m2_s), rel=REL)


def test_mrg32k3a_bitexact_on_gpu(gpu):
    """The u32 modular ladder (16-bit-partial mulhilo + 2^32-c folds)
    must match the big-int oracle on the GPU's integer ops, not just
    on the CPU."""
    from nmch.rng.mrg32k3a import (
        M1, M2, A12, A13N, A21, A23N, seed_state, mrg_state_at, mrg_step,
    )
    pidx = path_index_grid(128)
    s1, s2 = mrg_state_at(77, pidx, jnp.uint32(0))
    zs = []
    for _ in range(6):
        z, s1, s2 = mrg_step(s1, s2)
        zs.append(int(np.asarray(z)[0, 0]))
    o1, o2 = seed_state(77)
    for i in range(6):
        x1 = (A12 * o1[1] - A13N * o1[0]) % M1
        o1 = (o1[1], o1[2], x1)
        x2 = (A21 * o2[2] - A23N * o2[0]) % M2
        o2 = (o2[1], o2[2], x2)
        assert zs[i] == (x1 - x2) % M1, i


def test_greeks_grad_on_gpu(gpu):
    """jax.grad through the N-step scan compiles and prices on the card;
    ATM-homogeneity identity dP/dS_0 == P pins correctness."""
    from nmch.ops.greeks import fe_price_and_greeks, PARAM_NAMES
    price, g = fe_price_and_greeks(P.as_array(), jnp.uint32(0), K0, K1,
                                   N=64, n_paths=8192)
    vals = jax.device_get((price, g))
    assert float(vals[1]["S_0"]) == pytest.approx(float(vals[0]),
                                                  rel=1e-4)
    for k in PARAM_NAMES:
        assert abs(float(vals[1][k])) < 10.0, k


def test_em_xorwow_prices_sanely_on_gpu(gpu):
    """EM x the stateful default family on the card (the reference's
    exploration.cu:54-55 configuration class)."""
    n_paths, N = 2048, 16
    fn = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8, 9))
    m, m2 = jax.device_get(fn(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0),
        jnp.uint32(K0), jnp.uint32(K1), "xorwow", False, None, 7))
    from nmch.oracle import heston_call_undiscounted
    from nmch.results import SimResult
    res = SimResult(float(m), float(m2), n_paths)
    assert abs(res.price - heston_call_undiscounted(P)) < 4 * res.ci_error


@pytest.mark.parametrize("conditional", [False, True])
def test_em_bench_config_prices_sanely_on_gpu(gpu, conditional):
    """bench.py's EM section shapes (2^18 paths x N=10^3 — the
    reference's 512x512 grid config): the exact (N, n_paths, rng,
    poisson_cut) the benchmark times prices within the oracle CI."""
    from nmch.oracle import heston_call_undiscounted
    from nmch.results import SimResult
    from nmch.ops.em import FAST_POISSON_CUT
    N, n_paths = 1000, 1 << 18
    m, m2 = jax.device_get(em_moments_pallas(
        P.as_array(), SW, jnp.uint32(0), jnp.uint32(0), N=N,
        n_paths=n_paths, rng="threefry4", conditional=conditional,
        poisson_cut=FAST_POISSON_CUT))
    res = SimResult(float(m), float(m2), n_paths)
    # exact scheme: no discretization bias term needed
    assert abs(res.price - heston_call_undiscounted(P)) < 4 * res.ci_error


@pytest.mark.parametrize("rot", [1, 4, 8])
def test_fe_bench_config_prices_sanely_on_gpu(gpu, rot):
    """bench.py's FE shapes (2^19 groups x N=10^4, threefry4)."""
    from nmch.oracle import heston_call_undiscounted
    from nmch.results import SimResult
    n = 1 << 19
    m, m2 = jax.device_get(fe_moments_pallas(
        P.as_array(), SW, jnp.uint32(0), jnp.uint32(0), N=10_000,
        n_paths=n, rng="threefry4", rot=rot))
    res = SimResult(float(m), float(m2), n)
    # CI + the O(dt) Euler bias allowance
    assert abs(res.price - heston_call_undiscounted(P)) \
        < 3 * res.ci_error + 2e-3
