"""Philox4x32-10 counter-based PRNG in pure JAX integer ops.

Why this generator: the reference's default kernels draw from curand's
``curandStatePhilox4_32_10_t`` (``src/NMCH/test/nmch.cu:119,130``), with
one *subsequence per path* initialized as ``curand_init(seed, path_idx,
0)`` (``src/NMCH/random/random.cu:6-16``).  A counter-based generator is
also the natural choice for fused kernels: there is no mutable per-lane state to
store/reload — a (counter, key) pair is hashed on the fly with pure
vector integer ops, so the *same code* runs in the pure-JAX golden model
and inside Pallas kernels, making the two engines bitwise comparable.

Stream layout (mirrors curand's (seed, subsequence, offset) contract):

    key     = (seed_lo, seed_hi)                  -- one seed per run
    counter = (c0, epoch, path_lo, path_hi)       -- one stream per path

``epoch`` is bumped once per ``compute()`` call: the reference persists
curand states across kernel launches precisely so repeated ``compute()``
calls continue the streams with fresh randomness (``NMCH_FE.cu:81,303``,
``exploration.cu:14-17``).  Advancing the epoch gives the same guarantee
(fresh, non-overlapping draws per call) in counter-based form; each
epoch provides 2^32 blocks of 4 uint32s per path.

Algorithm constants are from Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3" (SC'11): multipliers 0xD2511F53 / 0xCD9E8D57 and
Weyl key increments 0x9E3779B9 / 0xBB67AE85, 10 rounds.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

PHILOX_M0 = np.uint32(0xD2511F53)
PHILOX_M1 = np.uint32(0xCD9E8D57)
PHILOX_W0 = np.uint32(0x9E3779B9)
PHILOX_W1 = np.uint32(0xBB67AE85)

_MASK16 = np.uint32(0xFFFF)


def mulhilo32(a, b):
    """(hi, lo) 32-bit halves of the 64-bit product a*b.

    Built from 16-bit partial products (4 muls, all intermediates fit
    in uint32) so the XLA engines and the kernels run the same integer
    ops and draw bitwise-identical words; a native mul.hi would be
    faster on the GPU (ROADMAP).
    """
    a = a.astype(jnp.uint32) if hasattr(a, "astype") else jnp.uint32(a)
    al = a & _MASK16
    ah = a >> 16
    bl = b & _MASK16
    bh = b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    # carry chain: t collects the middle 16-bit column (max ~3*2^16, fits)
    t = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)
    lo = (t << 16) | (ll & _MASK16)
    hi = hh + (lh >> 16) + (hl >> 16) + (t >> 16)
    return hi, lo


def _round(c0, c1, c2, c3, k0, k1):
    hi0, lo0 = mulhilo32(PHILOX_M0, c0)
    hi1, lo1 = mulhilo32(PHILOX_M1, c2)
    return (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """One Philox4x32 block: 4 uint32 counters + 2 uint32 keys -> 4 uint32.

    All arguments broadcast elementwise, so feeding (R, 128)-shaped
    counters produces (R, 128)-shaped independent outputs.
    """
    # keys wrap modulo 2^32 each round; route the adds through jnp so
    # numpy scalar inputs don't raise overflow warnings
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    for _ in range(rounds):
        c0, c1, c2, c3 = _round(c0, c1, c2, c3, k0, k1)
        k0 = k0 + PHILOX_W0
        k1 = k1 + PHILOX_W1
    return c0, c1, c2, c3


def split_seed(seed: int):
    """64-bit seed -> (lo, hi) uint32 pair (curand keys the seed the same way)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.uint32(seed & 0xFFFFFFFF), np.uint32(seed >> 32)


def path_counter_hi(path_idx):
    """Per-path high counter words (path_lo, path_hi) from a uint32 index.

    path_idx can be any-shaped uint32 array (lane layout of the paths);
    we keep path_hi = 0 (supports 2^32 paths — plenty; reference maxes at
    2^19)."""
    p = path_idx.astype(jnp.uint32)
    return p, jnp.zeros_like(p)


def draw4(block_idx, epoch, path_lo, path_hi, k0, k1):
    """Draw the ``block_idx``-th block of 4 uint32s for each path stream.

    block_idx: uint32 scalar or array — intra-call block counter.
    epoch:     uint32 scalar — per-compute()-call stream epoch.
    """
    bi = jnp.asarray(block_idx, dtype=jnp.uint32)
    ep = jnp.asarray(epoch, dtype=jnp.uint32)
    return philox4x32(bi, ep, path_lo, path_hi, k0, k1)
