"""MRG32k3a (L'Ecuyer 1999) with O(1) skip-ahead — the reference's
third curand family, in skippable-stream form.

The reference instantiates three curand generator families
(``src/NMCH/random/random.cu:6-16``): XORWOW, MRG32k3a and
Philox4_32_10, each initialized as ``curand_init(seed, path_idx, 0)``
— one *subsequence* per path — and benchmarks them against each other
(``profilings/timings.txt:31-34``).  Philox is counter-based and was
rebuilt exactly (rng/philox.py).  XORWOW and MRG32k3a are *stateful*
recurrences; carrying 6-word states per path through HBM is exactly
what counter-based RNG exists to avoid.  This module closes the family-parity gap for
MRG32k3a without per-path state arrays: the recurrence is GF-linear, so the state
at any (path, epoch) is a *matrix power* applied to the seed state —
random access costs ~58 conditional 3x3 mat-vecs mod m at init and
zero per draw, preserving the repo's (seed, path, epoch) stream
contract without per-path state arrays.

(XORWOW gets the same treatment — rng/xorwow.py jumps the
xorshift+Weyl recurrence with precomputed 2^67-step matrices over
GF(2)^160, exactly how curand itself implements XORWOW skip-ahead;
its ~25x arithmetic vs MRG32k3a's two 3-vectors is init-only and
amortized.  All three curand families are now rebuilt; PARITY.md
deviation 7 records only the splitmix64-vs-curand seeding hash.)

The generator (L'Ecuyer, "Good parameters and implementations for
combined multiple recursive random number generators", Oper. Res.
47(1), 1999):

    m1 = 2^32 - 209,  m2 = 2^32 - 22853
    x1_n = (1403580 x1_{n-2} -  810728 x1_{n-3}) mod m1
    x2_n = ( 527612 x2_{n-1} - 1370589 x2_{n-3}) mod m2
    z_n  = (x1_n - x2_n) mod m1          (z in [0, m1))

Stream layout (mirrors rng/philox.py's contract):

    state(seed, path, epoch) = A^(path * 2^67 + epoch * 2^40) s(seed)

where A is the 3x3 companion matrix of each recurrence (mod its m).
2^67 is curand's own MRG32k3a subsequence spacing (so ``path``
semantics match ``curand_init(seed, path, 0)``); epochs advance by
2^40 draws *within* a path's block, which nests correctly for
epoch < 2^27 (checked at the method layer) and any simulation shorter than 2^40 draws.
s(seed) is derived host-side from the integer seed by splitmix64,
folded into [1, m-1] so neither recurrence starts at the forbidden
all-zero state.

All device arithmetic is u32: 32x32->64 products via
rng/philox.py::mulhilo32 (16-bit partials), then modular folding with
2^32 === c (mod m) for m = 2^32 - c.  Everything is pure functional
XLA — usable inside scan engines; per-draw cost is ~2 modmuls + 2
modsubs per recurrence step.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

from .bits import splitmix64, u23_to_f32
from .philox import mulhilo32

M1 = 4294967087          # 2^32 - 209
M2 = 4294944443          # 2^32 - 22853
_C1 = 209
_C2 = 22853
A12 = 1403580
A13N = 810728            # x1 coefficient is -A13N
A21 = 527612
A23N = 1370589           # x2 coefficient is -A23N

# companion matrices acting on (x_{n-3}, x_{n-2}, x_{n-1})
_A1 = ((0, 1, 0),
       (0, 0, 1),
       (M1 - A13N, A12, 0))
_A2 = ((0, 1, 0),
       (0, 0, 1),
       (M2 - A23N, 0, A21))

PATH_LOG2 = 67           # curand's MRG32k3a subsequence spacing
EPOCH_LOG2 = 40          # our epoch spacing within a path block
MAX_EPOCH = 1 << (PATH_LOG2 - EPOCH_LOG2)


# ---------------------------------------------------------------------------
# host-side exact matrix algebra (python ints — used once, cached)

def _mat_mul(A, B, m):
    return tuple(tuple(sum(A[i][k] * B[k][j] for k in range(3)) % m
                       for j in range(3)) for i in range(3))


def _mat_pow(A, n, m):
    R = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    while n:
        if n & 1:
            R = _mat_mul(R, A, m)
        A = _mat_mul(A, A, m)
        n >>= 1
    return R


@functools.lru_cache(maxsize=None)
def _jump_tables():
    """A^(2^b) for b in [EPOCH_LOG2, PATH_LOG2 + 31), both recurrences.

    Bits [40, 67) select the epoch jump, bits [67, 98) the path jump
    (paths < 2^31).  Returned as np.uint32[(58, 3, 3)] per recurrence.
    """
    bits = range(EPOCH_LOG2, PATH_LOG2 + 31)
    out = []
    for A, m in ((_A1, M1), (_A2, M2)):
        mats, P = [], _mat_pow(A, 1 << EPOCH_LOG2, m)
        for _ in bits:
            mats.append(P)
            P = _mat_mul(P, P, m)
        out.append(np.array(mats, dtype=np.uint32))
    return out[0], out[1]


def seed_state(seed: int):
    """Host: integer seed -> ((s1 triple), (s2 triple)), each word in
    [1, m-1] (never the forbidden all-zero state)."""
    x, words = int(seed) & (2**64 - 1), []
    for m in (M1, M1, M1, M2, M2, M2):
        x, w = splitmix64(x)
        words.append(int(w % (m - 1)) + 1)
    return tuple(words[:3]), tuple(words[3:])


# ---------------------------------------------------------------------------
# device-side modular u32 arithmetic (m = 2^32 - c, c < 2^15)

def _modfold(hi, lo, c, m):
    """(hi * 2^32 + lo) mod m, for m = 2^32 - c."""
    c = np.uint32(c)
    hi2, lo2 = mulhilo32(hi, c)          # hi*c < 2^47: hi2 <= c < 2^15
    t = lo + lo2
    w = (t < lo).astype(jnp.uint32)      # number of 2^32 wraps so far
    t2 = t + hi2 * c                     # hi2*c <= c^2 < 2^30
    w = w + (t2 < t).astype(jnp.uint32)
    t3 = t2 + w * c                      # fold the wraps: 2^32 === c
    t3 = t3 + (t3 < t2).astype(jnp.uint32) * c   # t3 tiny if wrapped
    return jnp.where(t3 >= np.uint32(m), t3 - np.uint32(m), t3)


def modmul(a, b, m, c):
    """a * b mod m for u32 a, b < m, m = 2^32 - c."""
    hi, lo = mulhilo32(a, b)
    return _modfold(hi, lo, c, m)


def modadd(a, b, m, c):
    t = a + b
    t = t + (t < a).astype(jnp.uint32) * np.uint32(c)
    return jnp.where(t >= np.uint32(m), t - np.uint32(m), t)


def modsub(a, b, m, c):
    """(a - b) mod m; u32 wrap of a-b adds 2^32, so subtract c."""
    t = a - b
    return jnp.where(a >= b, t, t - np.uint32(c))


def _matvec_dyn(M, s, m, c):
    """Traced 3x3 u32 matrix times state triple (vector arrays) mod m."""
    out = []
    for i in range(3):
        acc = modmul(jnp.zeros_like(s[0]) + M[i, 0], s[0], m, c)
        acc = modadd(acc, modmul(jnp.zeros_like(s[1]) + M[i, 1],
                                 s[1], m, c), m, c)
        acc = modadd(acc, modmul(jnp.zeros_like(s[2]) + M[i, 2],
                                 s[2], m, c), m, c)
        out.append(acc)
    return tuple(out)


# ---------------------------------------------------------------------------
# stream initialization and drawing

def mrg_state_at(seed: int, path_idx, epoch):
    """State of stream (seed, path, epoch): ((s1 x3), (s2 x3)) u32
    arrays shaped like path_idx.

    seed is a python int (resolved at trace time); path_idx u32 arrays;
    epoch a (traced) u32 scalar < 2^27.  Cost: <= 58 conditional 3x3
    mat-vecs mod m per recurrence — init-time only, like the
    reference's 7 ms curand-init kernel (profilings/FE_B_MMng) but
    recomputed on the fly instead of stored per path.  The 58 jump
    matrices ride a ``fori_loop`` (an unrolled version traced to ~70k
    jaxpr eqns and took minutes to compile).
    """
    J1, J2 = _jump_tables()
    b1, b2 = seed_state(seed)
    p = path_idx.astype(jnp.uint32)
    e = jnp.asarray(epoch, jnp.uint32)
    s1 = tuple(jnp.zeros_like(p) + np.uint32(w) for w in b1)
    s2 = tuple(jnp.zeros_like(p) + np.uint32(w) for w in b2)
    J1c = jnp.asarray(J1)
    J2c = jnp.asarray(J2)
    neb = np.uint32(PATH_LOG2 - EPOCH_LOG2)

    def body(i, carry):
        s1, s2 = carry[:3], carry[3:]
        iu = i.astype(jnp.uint32)
        # bit i of the exponent n = p*2^67 + e*2^40: epoch bits first
        # (shift amounts clamped below 32 — XLA leaves >=width shifts
        # undefined; the clamped lanes are masked out by the where)
        bite = (e >> jnp.minimum(iu, np.uint32(31))) & np.uint32(1)
        bitp = (p >> jnp.minimum(iu - neb, np.uint32(31))) & np.uint32(1)
        on = jnp.where(iu < neb, bite, bitp).astype(jnp.bool_)
        c1 = _matvec_dyn(J1c[i], s1, M1, _C1)
        c2 = _matvec_dyn(J2c[i], s2, M2, _C2)
        s1 = tuple(jnp.where(on, cn, sn) for cn, sn in zip(c1, s1))
        s2 = tuple(jnp.where(on, cn, sn) for cn, sn in zip(c2, s2))
        return s1 + s2

    out = lax.fori_loop(0, J1.shape[0], body, s1 + s2)
    return out[:3], out[3:]


def mrg_step(s1, s2):
    """One recurrence step: (z, s1', s2'), z u32 in [0, m1)."""
    x1 = modsub(modmul(jnp.uint32(A12) + jnp.zeros_like(s1[1]), s1[1],
                       M1, _C1),
                modmul(jnp.uint32(A13N) + jnp.zeros_like(s1[0]), s1[0],
                       M1, _C1), M1, _C1)
    s1 = (s1[1], s1[2], x1)
    x2 = modsub(modmul(jnp.uint32(A21) + jnp.zeros_like(s2[2]), s2[2],
                       M2, _C2),
                modmul(jnp.uint32(A23N) + jnp.zeros_like(s2[0]), s2[0],
                       M2, _C2), M2, _C2)
    s2 = (s2[1], s2[2], x2)
    return modsub(x1, x2, M1, _C1), s1, s2


_INV_M1 = np.float32(1.0 / M1)
_F16 = np.float32(2.0 ** 16)


def _u32_to_f32(z):
    """Round-to-nearest u32 -> f32 without a convert op (Mosaic has no
    u32->f32 lowering).  Two exact 16-bit halves via
    the exponent-bias bitcast (rng/bits.py::u23_to_f32), one exact
    *2^16 scale, one final rounding add — bitwise-identical to XLA's
    own cast."""
    hi = u23_to_f32(z >> np.uint32(16))
    lo = u23_to_f32(z & np.uint32(0xFFFF))
    return hi * _F16 + lo


def u01_from_z(z):
    """z in [0, m1) -> float32 uniform in (0, 1): (z + 0.5) / m1."""
    return (_u32_to_f32(z) + np.float32(0.5)) * _INV_M1
