"""XORWOW (Marsaglia 2003) with O(1) skip-ahead over GF(2)^160 — the
reference's *default* curand family, in skippable-stream form.

The reference instantiates ``curandStateXORWOW_t`` as the default
template argument of every kernel family
(``src/NMCH/random/random.cu:6-16``), uses it for the exploration
sweep (``src/NMCH/test/exploration.cu:24-25``) and for the fastest row
of the RNG timing ladder (``profilings/timings.txt:31-34``).  Rounds
1-3 substituted it (PARITY.md deviation 7) because the xorshift+Weyl
recurrence has no *cheap* log-time jump; this module retires that
deviation the same way curand itself does — precomputed jump matrices,
here over GF(2)^160 with curand's own 2^67 subsequence spacing:

    recurrence (one step, u32 words; Marsaglia, "Xorshift RNGs",
    J. Stat. Software 8(14), 2003, xorwow variant):
        t = x ^ (x >> 2)
        x, y, z, w = y, z, w, v
        v = (v ^ (v << 4)) ^ (t ^ (t << 1))
        d = d + 362437                      (Weyl counter, mod 2^32)
        output = v + d

The 160-bit (x, y, z, w, v) half is linear over GF(2): the state after
n steps is F^n s0 for a 160x160 bit matrix F.  The Weyl half is affine
mod 2^32: d_n = d_0 + 362437 n.  Stream layout mirrors
rng/mrg32k3a.py's contract exactly:

    state(seed, path, epoch) = F^(path * 2^67 + epoch * 2^40) s(seed)

with 2^67 = curand's XORWOW subsequence spacing (so ``path`` semantics
match ``curand_init(seed, path, 0)``), epochs advancing by 2^40 draws
within a path block (nests for epoch < 2^27, path < 2^31 — both
checked at the method layer).  Because every jump exponent here is a
multiple of 2^32, the Weyl counter is *unchanged* by any jump
(362437 n === 0 mod 2^32): d(seed, path, epoch) = d(seed), exactly as
in curand's own skipahead_sequence.

Device-side jump: new_bit_vector = M s over GF(2), computed word-wise
— for each of the 5 input words and each of its 32 bits, XOR a
precomputed 5-word column into the accumulator when the bit is set
(mask = 0 - bit).  ~160 masked 5-word XORs per jump matrix, <= 58
conditional matrices per init — init-time only (the reference pays a
comparable one-off: its curand-init kernel costs 7 ms,
``profilings/FE_B_MMng:19``), zero cost per draw.  The ~25x arithmetic
ratio vs MRG32k3a's 3x3 mat-vecs quoted in rng/mrg32k3a.py is real but
amortizes over N steps x epochs of draws.

s(seed) is derived host-side by splitmix64 (same recipe as
rng/mrg32k3a.py::seed_state; we deliberately do NOT clone curand's
seed-scrambling constants — the *family* and its stream geometry are
the parity target, the seeding hash is an implementation detail), with
the all-zero 160-bit state (the xorshift fixed point) excluded.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

from .bits import splitmix64, u23_to_f32

WEYL = 362437              # Weyl increment (Marsaglia 2003, xorwow)
PATH_LOG2 = 67               # curand's XORWOW subsequence spacing
EPOCH_LOG2 = 40              # our epoch spacing within a path block
MAX_EPOCH = 1 << (PATH_LOG2 - EPOCH_LOG2)
N_WORDS = 5                  # xorshift state words (x, y, z, w, v)
N_BITS = 32 * N_WORDS        # GF(2) dimension


# ---------------------------------------------------------------------------
# host-side exact GF(2) algebra (python ints as 160-bit vectors)

def _step_words(x, y, z, w, v):
    """One exact xorshift step on python-int words (no Weyl)."""
    M = 0xFFFFFFFF
    t = (x ^ (x >> 2)) & M
    v_new = ((v ^ ((v << 4) & M)) ^ (t ^ ((t << 1) & M))) & M
    return y, z, w, v, v_new


def _pack(words):
    """5 u32 words -> one 160-bit int; word w holds bits [32w, 32w+32),
    bit b of word w at position 32*w + b."""
    acc = 0
    for i, wd in enumerate(words):
        acc |= int(wd) << (32 * i)
    return acc


def _unpack(bits):
    return tuple((bits >> (32 * i)) & 0xFFFFFFFF for i in range(N_WORDS))


@functools.lru_cache(maxsize=1)
def _step_matrix():
    """F as a tuple of 160 columns (each a 160-bit int): column j is
    the image of unit vector e_j under one recurrence step."""
    cols = []
    for j in range(N_BITS):
        cols.append(_pack(_step_words(*_unpack(1 << j))))
    return tuple(cols)


def _mat_vec(cols, s):
    """M s over GF(2): XOR the columns selected by the bits of s."""
    acc = 0
    while s:
        j = (s & -s).bit_length() - 1
        acc ^= cols[j]
        s &= s - 1
    return acc


def _mat_mul(A, B):
    """(A B) column j = A (B column j)."""
    return tuple(_mat_vec(A, bj) for bj in B)


def _mat_sq(A):
    return _mat_mul(A, A)


def _mat_pow(n: int):
    """F^n as a column tuple (exact, host-side — test oracle)."""
    R = tuple(1 << j for j in range(N_BITS))     # identity
    A = _step_matrix()
    while n:
        if n & 1:
            R = _mat_mul(A, R)
        A = _mat_sq(A)
        n >>= 1
    return R


@functools.lru_cache(maxsize=None)
def _jump_tables():
    """F^(2^b) for b in [EPOCH_LOG2, PATH_LOG2 + 31), as a u32 array
    of shape (58, N_WORDS, 32, N_WORDS): [matrix, input word, input
    bit, output words] — the 5-word column XORed in when input bit
    (word, bit) of the state is set.

    Bits [40, 67) of the jump exponent select the epoch jump, bits
    [67, 98) the path jump (paths < 2^31) — same layout as
    rng/mrg32k3a.py::_jump_tables.  Built once by repeated squaring of
    the exact step matrix (~98 squarings of a 160x160 bit matrix,
    a couple of seconds, cached).
    """
    F = _step_matrix()
    P = F
    for _ in range(EPOCH_LOG2):
        P = _mat_sq(P)
    n_mats = PATH_LOG2 + 31 - EPOCH_LOG2
    out = np.empty((n_mats, N_WORDS, 32, N_WORDS), dtype=np.uint32)
    for m in range(n_mats):
        for wi in range(N_WORDS):
            for b in range(32):
                col = P[32 * wi + b]
                for wo in range(N_WORDS):
                    out[m, wi, b, wo] = (col >> (32 * wo)) & 0xFFFFFFFF
        P = _mat_sq(P)
    return out


def seed_state(seed: int):
    """Host: integer seed -> ((x, y, z, w, v), d0) python-int words.

    splitmix64-derived like rng/mrg32k3a.py::seed_state; the all-zero
    xorshift state (fixed point of the linear recurrence) is excluded.
    """
    x, words = int(seed) & (2**64 - 1), []
    for _ in range(N_WORDS + 1):
        x, w = splitmix64(x)
        words.append(int(w & 0xFFFFFFFF))
    st = words[:N_WORDS]
    if not any(st):
        st[0] = 1
    return tuple(st), words[N_WORDS]


# ---------------------------------------------------------------------------
# device-side stream initialization and drawing

def xorwow_state_at(seed: int, path_idx, epoch):
    """State of stream (seed, path, epoch): ((x,y,z,w,v) u32 arrays
    shaped like path_idx, d u32 array).

    seed is a python int (resolved at trace time); path_idx u32
    arrays; epoch a (traced) u32 scalar < 2^27.  Cost: <= 58
    conditional GF(2)^160 mat-vecs (58 x 32 fori iterations of ~25
    masked word-XORs) — init-time only.  The Weyl word is jump
    -invariant (module docstring) so d = d0 everywhere.
    """
    J = jnp.asarray(_jump_tables())          # (58, 5, 32, 5) u32
    base, d0 = seed_state(seed)
    p = path_idx.astype(jnp.uint32)
    e = jnp.asarray(epoch, jnp.uint32)
    s = tuple(jnp.zeros_like(p) + np.uint32(w) for w in base)
    neb = np.uint32(PATH_LOG2 - EPOCH_LOG2)

    def outer(i, s):
        iu = i.astype(jnp.uint32)
        # bit i of n = p*2^67 + e*2^40: epoch bits first (shift
        # amounts clamped below 32 — XLA leaves >=width shifts
        # undefined; clamped lanes are masked out by the where)
        bite = (e >> jnp.minimum(iu, np.uint32(31))) & np.uint32(1)
        bitp = (p >> jnp.minimum(iu - neb, np.uint32(31))) & np.uint32(1)
        on = jnp.where(iu < neb, bite, bitp).astype(jnp.bool_)
        Jm = J[i]                            # (5, 32, 5)

        def inner(b, acc):
            cols = Jm[:, b, :]               # (5 in-words, 5 out-words)
            new = acc
            for wi in range(N_WORDS):
                bit = (s[wi] >> b) & np.uint32(1)
                mask = np.uint32(0) - bit    # all-ones where bit set
                new = tuple(aw ^ (mask & cols[wi, wo])
                            for wo, aw in enumerate(new))
            return new

        jumped = lax.fori_loop(0, 32, inner,
                               tuple(jnp.zeros_like(w) for w in s))
        return tuple(jnp.where(on, jw, sw) for jw, sw in zip(jumped, s))

    s = lax.fori_loop(0, J.shape[0], outer, s)
    return s, jnp.zeros_like(p) + np.uint32(d0)


def xorwow_step(s, d):
    """One recurrence step: (out, s', d'), out u32 = v + d."""
    x, y, z, w, v = s
    t = x ^ (x >> np.uint32(2))
    v_new = (v ^ (v << np.uint32(4))) ^ (t ^ (t << np.uint32(1)))
    d = d + np.uint32(WEYL)
    return v_new + d, (y, z, w, v, v_new), d


_TWO_NEG23 = np.float32(2.0 ** -23)


def u01_from_out(o):
    """u32 output -> float32 uniform strictly inside (0, 1).

    Top 23 bits centered: ((o >> 9) + 0.5) * 2^-23.  A naive
    (o + 0.5) * 2^-32 is NOT open at 1: any o >= 2^32 - 128 rounds to
    2^32 in f32 (the ulp there is 256) and the product lands on
    exactly 1.0.

    The integer->float conversion goes through the shared
    exponent-bias bitcast (rng/bits.py::u23_to_f32) instead of an
    astype: Mosaic has no u32->f32 convert lowering, and the bitcast form is bitwise-identical everywhere."""
    return (u23_to_f32(o >> np.uint32(9)) + np.float32(0.5)) * _TWO_NEG23
