"""Threefry-4x32 counter-based PRNG — the fast reproducible generator.

One 4-word block per call (vs two 2-word threefry2x32 calls in
rng/threefry.py, i.e. ~1.6x fewer ops per word), add/xor/rotate
only (no multiplies — Philox's 32-bit mulhilo is four 16-bit partial
products here, rng/philox.py).

Spec: Salmon, Moraes, Dror & Shaw, "Parallel random numbers: as easy
as 1, 2, 3" (SC'11) — the Threefish-256 mix/permute structure with the
4x32 rotation table and the 0x1BD11BDA key-schedule parity word.
``rounds=12`` is the paper's Crush-resistance threshold for
Threefry-4x32 (Table 2: passes BigCrush with all tests at 12 rounds);
20 is the full-margin default of Random123.  We default to 12 — Monte
Carlo streams need statistical quality, not cryptographic margin —
and the independent big-int oracle in tests/test_threefry4.py pins the
bitstream at both 12 and 20 rounds.

Stream layout (the (seed, path, epoch) contract of rng/streams.py):

    counter = (block, epoch, path_lo, path_hi), key = (k0, k1, 0, 0)

All four counter words are real coordinates — no derived keys are
needed, unlike the 2x32 wrapper (threefry.py:70-78).

Reference parity: this is the analogue of the reference's curand
generator ladder (``src/NMCH/random/random.cu:12-16`` templates its
kernels over XORWOW/MRG32k3a/Philox; ``profilings/timings.txt:31-34``
benchmarks them) — we ladder philox/threefry/threefry4 as well.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

_PARITY = np.uint32(0x1BD11BDA)
# rotation distances, Random123 threefry.h (R_32x4): one (r0, r1) pair
# per round, cycling with period 8
_ROTS = ((10, 26), (11, 21), (13, 27), (23, 5),
         (6, 20), (17, 11), (25, 10), (18, 20))


def _rotl(x, d: int):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry4x32(k0, k1, k2, k3, x0, x1, x2, x3, rounds: int = 12):
    """One Threefry-4x32 block; broadcasts elementwise like philox4x32.

    Returns 4 uint32 words.  Bit-checked against an independent big-int
    transcription of the spec (tests/test_threefry4.py).
    """
    if rounds % 4 or not 4 <= rounds <= 72:
        raise ValueError(f"rounds must be a multiple of 4 in [4,72], "
                         f"got {rounds}")
    ks = [jnp.asarray(k, jnp.uint32) for k in (k0, k1, k2, k3)]
    ks.append(ks[0] ^ ks[1] ^ ks[2] ^ ks[3] ^ _PARITY)
    x = [jnp.asarray(v, jnp.uint32) + ks[i]
         for i, v in enumerate((x0, x1, x2, x3))]

    for r in range(rounds):
        r0, r1 = _ROTS[r % 8]
        x[0] = x[0] + x[1]
        x[1] = _rotl(x[1], r0)
        x[1] = x[1] ^ x[0]
        x[2] = x[2] + x[3]
        x[3] = _rotl(x[3], r1)
        x[3] = x[3] ^ x[2]
        # Threefish-256 word permutation (0,3,2,1): swap x1 <-> x3
        x[1], x[3] = x[3], x[1]
        if r % 4 == 3:
            s = r // 4 + 1
            for i in range(4):
                x[i] = x[i] + ks[(s + i) % 5]
            x[3] = x[3] + np.uint32(s)
    return x[0], x[1], x[2], x[3]


def draw4_threefry4(block_idx, epoch, path_lo, k0, k1, path_hi=None,
                    rounds: int = 12):
    """Four uint32 words for (path, epoch, block) — one fused call.

    Threefry is a PRF over (key, counter): distinct (block, epoch,
    path) tuples give independent words; epochs/paths/blocks never
    collide (cf. the stream contract in rng/streams.py)."""
    if path_hi is None:
        path_hi = jnp.zeros_like(jnp.asarray(path_lo, jnp.uint32))
    return threefry4x32(k0, k1, np.uint32(0), np.uint32(0),
                        block_idx, epoch, path_lo, path_hi,
                        rounds=rounds)
