"""Sobol' low-discrepancy sequences with digital-shift scrambling.

The quasi-Monte Carlo engine's point generator (ops/fe_qmc.py).  The
CUDA reference is plain pseudo-random MC; QMC is a rebuild-mandate
capability: with Brownian-bridge ordering the integration error decays
~n^-0.8 instead of n^-0.5 (measured in benchmarks/RESULTS.md).

Construction (Joe–Kuo direction numbers, via scipy.stats.qmc's table):

    x_{i,j} = XOR_b gray(i)_b * V[j, b];  u01_from_words keeps the top
    23 bits of the (shifted) 30-bit word: u = (x >> 7 + 0.5) / 2^23
    (float32 cannot hold 30-bit integers exactly — see u01_from_words)

* gray(i) = i ^ (i >> 1) makes consecutive points differ by one
  direction number; we evaluate the XOR form directly (30 select-XORs
  per dimension, vectorized over points AND over the dimensions of a
  Brownian-bridge level — see ops/fe_qmc.py).
* ``shift_j`` is a per-dimension digital shift drawn from the same
  Philox streams as everything else, keyed by (seed, epoch):
  digitally-shifted Sobol' is an *unbiased* estimator, and epochs give
  the independent randomizations whose spread yields a valid CI
  (randomized QMC).  The +0.5/2^23 offset keeps u in (0, 1) strictly —
  point 0 of the raw sequence is the origin, which would send the
  inverse normal CDF to -inf.

Validated bit-for-bit against scipy.stats.qmc.Sobol(scramble=False)
in tests/test_qmc.py.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .philox import philox4x32

BITS = 30
_INV = np.float32(2.0 ** -BITS)
_MASK = np.uint32((1 << BITS) - 1)


def direction_numbers(d: int) -> np.ndarray:
    """(d, 30) uint32 Joe–Kuo direction numbers from scipy's table."""
    from scipy.stats import qmc
    s = qmc.Sobol(d=d, scramble=False)
    sv = getattr(s, "_sv", None)
    if sv is None:  # scipy internals moved — fail loudly, not wrongly
        raise RuntimeError("scipy.stats.qmc.Sobol no longer exposes _sv; "
                           "update nmch.rng.sobol.direction_numbers")
    return np.ascontiguousarray(sv[:, :BITS], dtype=np.uint32)


def gray_codes(n: int, base=0):
    """Gray codes of point indices base..base+n-1 as a (n,) uint32
    (base may be traced)."""
    i = jnp.arange(n, dtype=jnp.uint32) + jnp.asarray(base, jnp.uint32)
    return i ^ (i >> np.uint32(1))


def sobol_dims_u32(gray, v_block):
    """Raw Sobol' words for a block of dimensions at the given points.

    gray: (n,) uint32 Gray codes; v_block: (L, 30) uint32 direction
    numbers for L dimensions.  Returns (L, n) uint32 — 30 select-XORs
    total, shared across the L dimensions (vectorized broadcast).
    """
    v = jnp.asarray(v_block, jnp.uint32)
    L = v.shape[0]
    x = jnp.zeros((L, gray.shape[0]), jnp.uint32)
    for b in range(BITS):
        bit = (gray >> np.uint32(b)) & np.uint32(1)
        x = x ^ (bit[None, :] * v[:, b][:, None])
    return x


def sobol_dims_u32_hilo(n: int, v_block, lo_bits: int | None = None,
                        base=0):
    """Raw Sobol' words for points 0..n-1 via hi/lo index factoring.

    Sobol' generation is GF(2)-LINEAR in the Gray code: with
    y(c) = XOR of direction columns over c's set bits,

        x(i) = y(gray(i)) = y(code_hi(h)) ^ y(glo(l)),
        i = h * 2^b + l,  l < 2^b,

    because gray(i) splits bit-disjointly into a low part glo(l) =
    l ^ (l >> 1) (within b bits, treating bit b of l as 0) and a high
    part code_hi(h) = (h ^ (h >> 1)) << b  |  (h & 1) << (b-1)  (the
    boundary bit b-1 of gray(i) is l_{b-1} ^ h_0).  So instead of 30
    select-XOR passes over all n points (compute-bound), build y over the 2^b low codes and the
    n/2^b high codes separately and combine with ONE broadcast XOR per
    element — the generation drops to HBM-write speed.  Bit-identical
    to sobol_dims_u32(gray_codes(n), v_block) (asserted in
    tests/test_qmc.py).

    v_block: (L, 30) uint32; returns (L, n) uint32 for points
    base..base+n-1.  n must be a multiple of 2^lo_bits (default:
    min(13, log2-floor of n)); ``base`` may be a TRACED uint32 (the
    multi-chip sharding passes chip_index * n) but must be a multiple
    of 2^lo_bits — point-range sharding is then exact: chip c's block
    is bit-identical to the same slice of a single-device run.
    """
    v = jnp.asarray(v_block, jnp.uint32)
    L = v.shape[0]
    if lo_bits is None:
        lo_bits = min(13, max((n & -n).bit_length() - 1, 0))
    b = lo_bits
    nlo = 1 << b
    if b == 0 or n % nlo:
        # degenerate/unaligned: fall back to the direct ladder
        return sobol_dims_u32(gray_codes(n, base=base), v_block)
    nhi = n >> b

    lo = jnp.arange(nlo, dtype=jnp.uint32)
    glo = lo ^ (lo >> np.uint32(1))             # bit b of lo treated as 0
    xlo = jnp.zeros((L, nlo), jnp.uint32)
    for k in range(b):
        bit = (glo >> np.uint32(k)) & np.uint32(1)
        xlo = xlo ^ (bit[None, :] * v[:, k][:, None])

    hi = jnp.asarray(base, jnp.uint32) // np.uint32(nlo) \
        + jnp.arange(nhi, dtype=jnp.uint32)
    code_hi = ((hi ^ (hi >> np.uint32(1))) << np.uint32(b)) \
        | ((hi & np.uint32(1)) << np.uint32(b - 1))
    xhi = jnp.zeros((L, nhi), jnp.uint32)
    for k in range(b - 1, BITS):
        bit = (code_hi >> np.uint32(k)) & np.uint32(1)
        xhi = xhi ^ (bit[None, :] * v[:, k][:, None])

    x = xhi[:, :, None] ^ xlo[:, None, :]
    return x.reshape(L, n)


def digital_shifts(dim_idx, epoch, k0, k1):
    """Per-dimension 30-bit digital shifts from the (seed, epoch)
    Philox streams (dimension index as the counter word)."""
    d = jnp.asarray(dim_idx, jnp.uint32)
    # path_hi word = ASCII "SOBL": path streams always have path_hi = 0
    # (ops/fe.py::fe_terminal, ops/fe_pallas.py), so this plane is
    # disjoint from every path stream by construction — no assumption
    # on path-index magnitudes needed.
    w0, _, _, _ = philox4x32(d, jnp.asarray(epoch, jnp.uint32),
                             jnp.zeros_like(d),
                             jnp.zeros_like(d) + np.uint32(0x534F424C),
                             k0, k1)
    return w0 & _MASK


def lms_scramble_directions(v, epoch, k0, k1):
    """Owen-style linear matrix scrambling (Matousek's LMS) of the
    direction numbers, keyed by (seed, epoch).

    Each dimension's generating matrix C_j is left-multiplied by a
    random nonsingular lower-triangular GF(2) matrix M_j (ones on the
    diagonal, strictly-lower bits from the Philox streams):

        v'[j] bit k  =  parity(mask_{j,k} & v[j])

    Digit order: bit 29 is the MOST significant output digit, so
    "lower triangular" means output digit i may mix only digits
    coarser-or-equal to i — mask_{j,k} = (random bits above k) |
    bit k.  (Mixing in *finer* digits instead destroys coarse-level
    equidistribution and with it the whole QMC gain — caught by
    tests/test_qmc.py::test_lms_scramble_preserves_net_property.)
    Combined with the per-dimension digital shift this is the classic
    "LMS + shift" randomization — unbiased like the plain shift, with
    Owen-like equidistribution guarantees on the scrambled net.  Cost:
    a one-off (d, 30) table transform per randomization; point
    generation is unchanged.

    v: (d, 30) uint32 direction numbers; returns the same shape.
    """
    v = jnp.asarray(v, jnp.uint32)
    d = v.shape[0]
    dims = jnp.arange(d, dtype=jnp.uint32)[:, None]
    ep = jnp.asarray(epoch, jnp.uint32)
    out = []
    for k in range(BITS):
        # one random word per (dim, bit-row); path_hi = "LMS\0" + k
        # labels the stream in the high counter word — path streams
        # keep path_hi = 0, so this plane (like the shift plane) is
        # disjoint from every path stream by construction
        w0, _, _, _ = philox4x32(dims, ep,
                                 jnp.zeros_like(dims),
                                 jnp.zeros_like(dims)
                                 + np.uint32(0x4C4D5300 + k),
                                 k0, k1)
        above = np.uint32(((1 << BITS) - 1) & ~((1 << (k + 1)) - 1))
        mask = (w0[:, 0:1] & above) | np.uint32(1 << k)    # (d, 1)
        bit_k = jax.lax.population_count(mask & v) & np.uint32(1)
        out.append(bit_k << np.uint32(k))
    vp = out[0]
    for o in out[1:]:
        vp = vp | o
    return vp


def _reverse_bits32(x):
    """Bitwise reverse of u32 (classic 5-pass masked-swap ladder)."""
    x = ((x >> np.uint32(1)) & np.uint32(0x55555555)) \
        | ((x & np.uint32(0x55555555)) << np.uint32(1))
    x = ((x >> np.uint32(2)) & np.uint32(0x33333333)) \
        | ((x & np.uint32(0x33333333)) << np.uint32(2))
    x = ((x >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) \
        | ((x & np.uint32(0x0F0F0F0F)) << np.uint32(4))
    x = ((x >> np.uint32(8)) & np.uint32(0x00FF00FF)) \
        | ((x & np.uint32(0x00FF00FF)) << np.uint32(8))
    return (x >> np.uint32(16)) | (x << np.uint32(16))


def owen_seeds(dim_idx, rep, k0, k1):
    """Per-(dimension, replicate) scramble seeds from the (seed, epoch=
    replicate) Philox streams; path_hi = ASCII "OWEN" labels the plane
    (path streams keep path_hi = 0, so it is disjoint by construction,
    like the SOBL/LMS planes above)."""
    d = jnp.asarray(dim_idx, jnp.uint32)
    w0, _, _, _ = philox4x32(d, jnp.asarray(rep, jnp.uint32),
                             jnp.zeros_like(d),
                             jnp.zeros_like(d) + np.uint32(0x4F57454E),
                             k0, k1)
    return w0


def owen_scramble(x, seed):
    """Hash-based nested-uniform (Owen) scramble of 30-bit Sobol'
    words, elementwise; ``seed`` broadcasts against ``x``.

    Laine–Karras-style hash (Laine & Karras 2011, "Stratified sampling
    for stochastic transparency"; constants and seeding per Burley
    2020, "Practical Hash-based Owen Scrambling", JCGT 9(4)) applied
    in the reversed-bit domain: adds and even-constant multiply-xors
    only propagate carries toward HIGHER bits, which after the
    surrounding reversals are the FINER digits — so output digit i
    depends only on input digits coarser-or-equal to i plus the seed,
    exactly Owen's nested uniform permutation tree (hash-realized).
    Unlike LMS+shift (linear in GF(2)), this is a *nonlinear* per-node
    permutation — the full Owen randomization whose RMS error scales
    ~n^-1.5 on smooth integrands instead of ~n^-1.

    30-bit words are lifted to 32-bit fractions (<< 2) for the hash;
    the final ``>> 2`` drops whatever the hash put in the two
    sub-30-bit digit slots, so the output is again an exact 30-bit
    word — full-resolution for the symmetric tail map
    (pm_sign_from_words), which consumes all 30 bits.
    """
    v = _reverse_bits32(x << np.uint32(2))
    v = v + seed
    v = v ^ v * np.uint32(0x6C50B47C)
    v = v ^ v * np.uint32(0xB82F1E52)
    v = v ^ v * np.uint32(0xC7AFE638)
    v = v ^ v * np.uint32(0x8D22F6E6)
    return _reverse_bits32(v) >> np.uint32(2)


def u01_from_words(x):
    """uint32 Sobol' words (< 2^30) -> float32 uniforms in (0, 1).

    Only the top 23 bits reach the float (float32 cannot represent
    30-bit integers exactly — keeping them all rounds the largest
    words to u == 1.0, which the inverse CDF maps to +inf).  The
    center offset +0.5/2^23 keeps u in [2^-24, 1 - 2^-24].
    """
    t = (x >> np.uint32(BITS - 23)).astype(jnp.float32)
    return (t + np.float32(0.5)) * np.float32(2.0 ** -23)


def pm_sign_from_words(x):
    """Full-resolution symmetric uniform map: (pm, neg) from uint32
    Sobol' words (< 2^BITS).

    pm = min(u, 1-u) computed on the INTEGER side with all 30 bits —
    u01_from_words keeps only the top 23 (the f32 mantissa), which
    quantizes the *upper* tail of the inverse CDF 128x coarser than
    the lower (near u = 1, f32 granularity is 2^-24; near u = 0 it is
    relative).  Both dyadic halves are exact in f32 here because small
    pm has full relative precision.  neg = True where u < 1/2 (the
    z < 0 half).  The tail-resolution fix of the f32 plateau work
    (RESULTS.md soak)."""
    xm = jnp.minimum(x, _MASK - x)
    pm = (xm.astype(jnp.float32) + np.float32(0.5)) * _INV
    return pm, x < np.uint32(1 << (BITS - 1))
