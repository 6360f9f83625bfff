"""Threefry-2x32 counter-based PRNG — the multiply-free alternative.

Philox's 10 rounds of 32-bit multiplies are expensive as written here
(each mulhilo is four 16-bit partial products, rng/philox.py).
Threefry uses only add/xor/rotate, which is why JAX's own default PRNG
is threefry2x32 — and that gives us a trusted bitwise oracle:
``jax._src.prng.threefry_2x32`` (tests assert exact equality).

Stream layout (4 words per (path, epoch, block), mirroring
rng/philox.py's contract): two 2-word blocks with distinct derived
keys,

    words 0,1 = threefry2x32(key=(k0 ^ epoch*GOLD, k1),        ctr=(block, path))
    words 2,3 = threefry2x32(key=(k0 ^ epoch*GOLD, k1 ^ GOLD2), ctr=(block, path))

Threefry is a PRF over (key, counter), so distinct keys give
independent streams; epochs/paths/blocks never collide.

Constants from Salmon et al. SC'11: rotations (13,15,26,6) and
(17,29,16,24) alternating per 4-round group, 20 rounds, key-schedule
parity word 0x1BD11BDA.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)
_GOLD = np.uint32(0x9E3779B9)
_GOLD2 = np.uint32(0xBB67AE85)


def _rotl(x, d: int):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k0, k1, x0, x1, rounds: int = 20):
    """One Threefry-2x32-20 block; broadcasts elementwise like philox4x32.

    Bit-exact with jax._src.prng.threefry_2x32 (asserted in tests).
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(x0, jnp.uint32)
    x1 = jnp.asarray(x1, jnp.uint32)
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = x0 + k0
    x1 = x1 + k1
    ks = (k1, ks2, k0)
    rots = (_ROT_A, _ROT_B)
    n_groups = rounds // 4
    for i in range(n_groups):
        for d in rots[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, d)
            x1 = x0 ^ x1
        x0 = x0 + ks[i % 3]
        x1 = x1 + ks[(i + 1) % 3] + np.uint32(i + 1)
    return x0, x1


def draw4_threefry(block_idx, epoch, path_lo, k0, k1):
    """Four uint32 words for (path, epoch, block) — the threefry
    analogue of philox draw blocks (two distinct-key 2-word calls)."""
    ep = jnp.asarray(epoch, jnp.uint32)
    ka = jnp.asarray(k0, jnp.uint32) ^ (ep * _GOLD)
    w0, w1 = threefry2x32(ka, k1, block_idx, path_lo)
    w2, w3 = threefry2x32(ka, jnp.asarray(k1, jnp.uint32) ^ _GOLD2,
                          block_idx, path_lo)
    return w0, w1, w2, w3
