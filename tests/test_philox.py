"""RNG layer tests: Philox4x32-10 correctness + stream semantics.

Strategy per SURVEY.md §4: an independent arbitrary-precision Python
implementation is the correctness oracle for the 16-bit-split vector
implementation; distributional and stream-separation properties are
checked statistically (the reference had no RNG tests at all).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nmch.rng import (
    philox4x32, mulhilo32, split_seed, uniform_open01, boxmuller,
    PathStreams,
)

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def ref_philox(ctr, key, rounds=10):
    """Independent big-int reference (per Salmon et al. SC'11 spec)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(rounds):
        p0, p1 = M0 * c0, M1 * c2
        hi0, lo0 = p0 >> 32, p0 & MASK
        hi1, lo1 = p1 >> 32, p1 & MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def test_mulhilo32_exhaustive_random():
    rng = np.random.default_rng(42)
    a = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
    hi, lo = mulhilo32(jnp.asarray(a), jnp.asarray(b))
    full = a.astype(np.uint64) * b.astype(np.uint64)
    np.testing.assert_array_equal(np.asarray(hi), (full >> 32).astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(lo), (full & MASK).astype(np.uint32))


def test_philox_matches_bigint_reference():
    rng = np.random.default_rng(7)
    ctrs = rng.integers(0, 2**32, size=(64, 4), dtype=np.uint32)
    keys = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint32)
    got = philox4x32(*(jnp.asarray(ctrs[:, i]) for i in range(4)),
                     jnp.asarray(keys[:, 0]), jnp.asarray(keys[:, 1]))
    for row in range(64):
        exp = ref_philox([int(x) for x in ctrs[row]],
                         [int(x) for x in keys[row]])
        assert tuple(int(np.asarray(g)[row]) for g in got) == exp


def test_philox_edge_counters():
    for ctr in ([0, 0, 0, 0], [MASK] * 4, [1, 0, 0, 0], [0, 0, 0, 1]):
        for key in ([0, 0], [MASK, MASK], [1234, 0]):
            exp = ref_philox(list(ctr), list(key))
            got = philox4x32(*(jnp.uint32(c) for c in ctr),
                             jnp.uint32(key[0]), jnp.uint32(key[1]))
            assert tuple(int(g) for g in got) == exp


def test_streams_disjoint_across_paths_and_epochs():
    """No collisions between (path, epoch) streams over a decent sample."""
    paths = jnp.arange(4096, dtype=jnp.uint32)
    k0, k1 = split_seed(1234)
    outs = []
    for epoch in (0, 1):
        x = philox4x32(jnp.zeros_like(paths), jnp.uint32(epoch),
                       paths, jnp.zeros_like(paths), k0, k1)
        outs.append(np.stack([np.asarray(v) for v in x], -1))
    allv = np.concatenate(outs).reshape(-1)
    assert len(np.unique(allv)) == len(allv)


def test_uniform_range_and_moments():
    c = jnp.arange(1 << 16, dtype=jnp.uint32)
    k0, k1 = split_seed(99)
    x0, x1, _, _ = philox4x32(c, jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
                              k0, k1)
    u = np.asarray(uniform_open01(x0))
    assert (u > 0).all() and (u <= 1).all()
    n = len(u)
    assert abs(u.mean() - 0.5) < 4 / np.sqrt(12 * n)
    assert abs(u.std() - np.sqrt(1 / 12)) < 5e-3


def test_boxmuller_moments_and_correlation():
    c = jnp.arange(1 << 17, dtype=jnp.uint32)
    k0, k1 = split_seed(5)
    x0, x1, _, _ = philox4x32(c, jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
                              k0, k1)
    g1, g2 = boxmuller(uniform_open01(x0), uniform_open01(x1))
    g1, g2 = np.asarray(g1), np.asarray(g2)
    n = len(g1)
    for g in (g1, g2):
        assert abs(g.mean()) < 4 / np.sqrt(n)
        assert abs(g.std() - 1) < 0.01
        # kurtosis of a normal is 3
        assert abs((g**4).mean() - 3) < 0.15
    assert abs(np.corrcoef(g1, g2)[0, 1]) < 4 / np.sqrt(n)


def test_pathstreams_epoch_advance():
    s = PathStreams(seed=1234, n_paths=100)
    assert s.next_epoch() == 0
    assert s.next_epoch() == 1
    s.init(777)
    assert s.seed == 777
    assert s.next_epoch() == 0


def test_fast_sincos_accuracy():
    """boxmuller's turns-based sincos must match numpy to ~1e-6."""
    from nmch.rng.normal import sincos_2pi
    import jax
    u = np.linspace(0, 1, 200_001, dtype=np.float64)[:-1]
    c, s = jax.jit(sincos_2pi)(jnp.asarray(u, jnp.float32))
    assert np.abs(np.asarray(c, np.float64) - np.cos(2 * np.pi * u)).max() < 1e-6
    assert np.abs(np.asarray(s, np.float64) - np.sin(2 * np.pi * u)).max() < 1e-6
    # unit circle invariant
    rad = np.asarray(c) ** 2 + np.asarray(s) ** 2
    assert np.abs(rad - 1.0).max() < 3e-6


def test_threefry_bitwise_matches_jax():
    """Our threefry2x32 must be bit-exact with jax's own PRNG core."""
    import jax
    from jax._src.prng import threefry_2x32
    from nmch.rng.threefry import threefry2x32
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, size=(32, 2), dtype=np.uint32)
    ctrs = rng.integers(0, 2**32, size=(32, 2), dtype=np.uint32)
    for (k0, k1), (x0, x1) in zip(keys, ctrs):
        exp = threefry_2x32((jnp.uint32(k0), jnp.uint32(k1)),
                            jnp.array([x0, x1], jnp.uint32))
        got = threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                           jnp.uint32(x0), jnp.uint32(x1))
        assert (int(got[0]), int(got[1])) == tuple(
            int(v) for v in np.asarray(exp))


def test_threefry_draw4_stream_stats():
    from nmch.rng.threefry import draw4_threefry
    paths = jnp.arange(1 << 15, dtype=jnp.uint32)
    k0, k1 = split_seed(77)
    w = draw4_threefry(jnp.uint32(0), jnp.uint32(0), paths, k0, k1)
    g1, g2 = boxmuller(uniform_open01(w[0]), uniform_open01(w[1]))
    g1 = np.asarray(g1)
    assert abs(g1.mean()) < 4 / np.sqrt(g1.size)
    assert abs(g1.std() - 1) < 0.02
    # near-distinct words across the block (131072 u32 samples expect
    # ~2 birthday collisions; a broken generator would show thousands)
    allw = np.concatenate([np.asarray(x) for x in w])
    assert len(np.unique(allw)) >= len(allw) - 8


def test_half_circle_normal_pair_distribution():
    """normal_pair_hc (the kernels' fast path): exact N(0,1) moments,
    tails, and independence."""
    from nmch.rng.normal import normal_pair_hc
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, size=(2, 1 << 21), dtype=np.uint32)
    g1, g2 = normal_pair_hc(jnp.asarray(w[0]), jnp.asarray(w[1]))
    g1 = np.asarray(g1, np.float64)
    g2 = np.asarray(g2, np.float64)
    n = g1.size
    for g in (g1, g2):
        assert abs(g.mean()) < 4 / np.sqrt(n)
        assert abs(g.std() - 1) < 4e-3
        assert abs((g ** 4).mean() - 3) < 0.05          # kurtosis
        assert abs((np.abs(g) > 3).mean() - 0.0027) < 3e-4
    assert abs(np.corrcoef(g1, g2)[0, 1]) < 4 / np.sqrt(n)


def test_neg2log_fast_path_accuracy():
    """bits-level -2 ln u: full f32 relative accuracy on the radius."""
    from nmch.rng.normal import neg2log, uniform_open01
    rng = np.random.default_rng(1)
    w = rng.integers(0, 2**32, size=1 << 20, dtype=np.uint32)
    u = np.asarray(uniform_open01(jnp.asarray(w)))
    q = np.asarray(neg2log(jnp.asarray(u)), np.float64)
    qt = -2 * np.log(u.astype(np.float64))
    assert (q >= 0).all()
    r, rt = np.sqrt(q), np.sqrt(qt)
    # radius: relative accuracy away from u -> 1 (there the exact
    # e*ln2 + ln m split cancels and f32 rounding dominates; the
    # absolute error stays bounded and the affected normals are ~0)
    mid = rt > 0.5
    assert np.abs((r[mid] - rt[mid]) / rt[mid]).max() < 1e-5
    big = rt > 1.5
    assert np.abs((r[big] - rt[big]) / rt[big]).max() < 3e-6
    assert np.abs(r - rt).max() < 2e-3
