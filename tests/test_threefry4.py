"""Threefry-4x32 correctness: independent big-int oracle + stream stats.

Same strategy as test_philox.py: an arbitrary-precision Python
transcription of the Salmon et al. SC'11 spec (written independently of
the vector code in rng/threefry4.py) pins the bitstream; distributional
and stream-separation properties are checked statistically.
"""

import numpy as np
import jax.numpy as jnp

from nmch.rng.philox import split_seed
from nmch.rng.threefry4 import threefry4x32, draw4_threefry4

M32 = 0xFFFFFFFF
ROTS = ((10, 26), (11, 21), (13, 27), (23, 5),
        (6, 20), (17, 11), (25, 10), (18, 20))


def ref_threefry4x32(ctr, key, rounds=12):
    """Independent big-int reference (Threefish-256 structure, 4x32
    rotation table, parity 0x1BD11BDA, subkey every 4 rounds)."""
    k = list(key) + [key[0] ^ key[1] ^ key[2] ^ key[3] ^ 0x1BD11BDA]
    x = [(ctr[i] + k[i]) & M32 for i in range(4)]
    for r in range(rounds):
        r0, r1 = ROTS[r % 8]
        x[0] = (x[0] + x[1]) & M32
        x[1] = ((x[1] << r0) | (x[1] >> (32 - r0))) & M32
        x[1] ^= x[0]
        x[2] = (x[2] + x[3]) & M32
        x[3] = ((x[3] << r1) | (x[3] >> (32 - r1))) & M32
        x[3] ^= x[2]
        x[1], x[3] = x[3], x[1]
        if r % 4 == 3:
            s = r // 4 + 1
            for i in range(4):
                x[i] = (x[i] + k[(s + i) % 5]) & M32
            x[3] = (x[3] + s) & M32
    return tuple(x)


def test_threefry4_matches_bigint_reference():
    rng = np.random.default_rng(11)
    ctrs = rng.integers(0, 2**32, size=(64, 4), dtype=np.uint32)
    keys = rng.integers(0, 2**32, size=(64, 4), dtype=np.uint32)
    for rounds in (12, 20):
        got = threefry4x32(*(jnp.asarray(keys[:, i]) for i in range(4)),
                           *(jnp.asarray(ctrs[:, i]) for i in range(4)),
                           rounds=rounds)
        got = np.stack([np.asarray(g) for g in got], -1)
        for row in range(64):
            exp = ref_threefry4x32([int(v) for v in ctrs[row]],
                                   [int(v) for v in keys[row]],
                                   rounds=rounds)
            assert tuple(int(v) for v in got[row]) == exp, (row, rounds)


def test_threefry4_edge_counters():
    for ctr in ([0] * 4, [M32] * 4, [1, 0, 0, 0], [0, 0, 0, 1]):
        for key in ([0] * 4, [M32] * 4, [1234, 0, 0, 0]):
            exp = ref_threefry4x32(list(ctr), list(key))
            got = threefry4x32(*(jnp.uint32(k) for k in key),
                               *(jnp.uint32(c) for c in ctr))
            assert tuple(int(g) for g in got) == exp


def test_threefry4_avalanche():
    """Single-bit counter flips must flip ~half the output bits."""
    base = threefry4x32(*(jnp.uint32(0),) * 4, *(jnp.uint32(0),) * 4)
    base = np.array([int(b) for b in base], dtype=np.uint64)
    flips = []
    for word in range(4):
        for bit in (0, 7, 31):
            ctr = [0, 0, 0, 0]
            ctr[word] = 1 << bit
            out = threefry4x32(*(jnp.uint32(0),) * 4,
                               *(jnp.uint32(c) for c in ctr))
            out = np.array([int(v) for v in out], dtype=np.uint64)
            flips.append(sum(bin(int(a ^ b)).count("1")
                             for a, b in zip(base, out)))
    flips = np.array(flips)
    assert (np.abs(flips - 64) < 30).all(), flips  # 128 bits, expect ~64


def test_draw4_stream_stats_and_disjointness():
    paths = jnp.arange(1 << 15, dtype=jnp.uint32)
    k0, k1 = split_seed(77)
    w = draw4_threefry4(jnp.uint32(0), jnp.uint32(0), paths, k0, k1)
    allw = np.concatenate([np.asarray(x) for x in w])
    # 131072 u32 words: expect ~2 birthday collisions, not thousands
    assert len(np.unique(allw)) >= len(allw) - 8
    u = allw.astype(np.float64) / 2**32
    assert abs(u.mean() - 0.5) < 4 / np.sqrt(12 * len(u))
    assert abs(u.std() - np.sqrt(1 / 12)) < 2e-3


def test_draw4_epochs_and_blocks_differ():
    paths = jnp.arange(256, dtype=jnp.uint32)
    k0, k1 = split_seed(5)
    a = draw4_threefry4(jnp.uint32(0), jnp.uint32(0), paths, k0, k1)
    b = draw4_threefry4(jnp.uint32(0), jnp.uint32(1), paths, k0, k1)
    c = draw4_threefry4(jnp.uint32(1), jnp.uint32(0), paths, k0, k1)
    sets = [set(np.concatenate([np.asarray(x) for x in t]).tolist())
            for t in (a, b, c)]
    assert not (sets[0] & sets[1]) and not (sets[0] & sets[2])
