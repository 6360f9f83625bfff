"""Uniform/normal variate generation from raw uint32 bits.

The reference draws correlated pairs with ``curand_normal2`` /
``curand_normal4`` (Box–Muller under the hood, ``NMCH_FE.cu:43``,
``:211``).  We implement the same Box–Muller construction on raw bits so
the pure-JAX golden model and the Pallas kernels share one code path
(and therefore produce bitwise-identical draws for identical counters).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


# --- near-minimax polynomial coefficients (benchmarks/fit_polys.py) ---
# sin(z) = z * P(z^2) on |z| <= pi/2, max abs err 5.9e-7
_SIN_HC = tuple(np.float32(c) for c in
                (0.99999662, -0.16664828, 8.3063252e-3, -1.8363653e-4))
# cos(z) = Q(z^2) on |z| <= pi/2, max abs err 4.7e-8
_COS_HC = tuple(np.float32(c) for c in
                (0.99999995, -0.49999905, 4.1663585e-2, -1.38537043e-3,
                 2.31539307e-5))
# -2*ln(1+t) = t * M(t) on t in [0,1), relative err 1.9e-7
_NEG2LOG = tuple(np.float32(-2.0 * c) for c in
                 (0.99999981, -0.49997405, 0.33275475, -0.24495434,
                  0.17745159, -0.1076805, 0.04408875, -0.00853896))
_NEG2LN2 = np.float32(-2.0 * np.log(2.0))       # -1.3862944
_C254LN2 = np.float32(-127.0 * float(_NEG2LN2))  # exactly cancels at u=1

def uniform_open01(bits):
    """uint32 bits -> float32 uniform in (0, 1].

    Bit trick: keep the top 23 bits as the mantissa of a float in
    [1, 2), subtract from 2 to land in (0, 1] — the half-open side we
    need is (0,1] because Box–Muller takes log(u).
    """
    f = ((bits >> 9) | np.uint32(0x3F800000)).view(jnp.float32)
    return np.float32(2.0) - f


def uniform_halfopen01(bits):
    """uint32 bits -> float32 uniform in [0, 1)."""
    f = ((bits >> 9) | np.uint32(0x3F800000)).view(jnp.float32)
    return f - np.float32(1.0)


def sincos_2pi(u):
    """(cos(2 pi u), sin(2 pi u)) for u in [0, 1) — fast path.

    Generic sin/cos spend most of their time on argument reduction.
    Here the argument is a *phase in turns*, so the
    quadrant reduction is exact and cheap: u = (q + r)/4 with
    q = round(4u) and r in [-1/2, 1/2], then degree-4/degree-3 odd/even
    Taylor polynomials in z = (pi/2) r (|z| <= pi/4, truncation error
    < 3e-9, below f32 resolution), and a quadrant swap/sign fixup.
    Max abs error vs numpy's sin/cos: ~1e-7 (see tests/test_philox.py).
    """
    x = u * np.float32(4.0)
    q = jnp.floor(x + np.float32(0.5))
    r = x - q                               # [-0.5, 0.5]
    qi = q.astype(jnp.int32)
    r2 = r * r
    # cos((pi/2) r): even Taylor through r^8
    c = np.float32(9.1926027483e-4)
    c = c * r2 - np.float32(2.0863480763e-2)
    c = c * r2 + np.float32(2.5366950790e-1)
    c = c * r2 - np.float32(1.2337005501)
    c = c * r2 + np.float32(1.0)
    # sin((pi/2) r) / r: odd Taylor through r^7
    s = np.float32(-4.6817541353e-3)
    s = s * r2 + np.float32(7.9692626247e-2)
    s = s * r2 - np.float32(6.4596409750e-1)
    s = s * r2 + np.float32(1.5707963268)
    s = s * r
    odd = (qi & np.int32(1)) != 0
    cos_base = jnp.where(odd, s, c)
    sin_base = jnp.where(odd, c, s)
    cos_neg = ((qi + np.int32(1)) & np.int32(2)) != 0
    sin_neg = (qi & np.int32(2)) != 0
    cosv = jnp.where(cos_neg, -cos_base, cos_base)
    sinv = jnp.where(sin_neg, -sin_base, sin_base)
    return cosv, sinv


def neg2log(u):
    """-2*ln(u) for float32 u in (0, 1] — bits-level fast path.

    XLA's generic ``log`` pays for special-case handling (0, inf, NaN,
    denormals, negatives) that a Box–Muller radius never needs: our u
    is a dyadic rational in (0, 1] built from 23 random bits.  Decompose
    u = m * 2^(e-127) directly from its own bit pattern (m in [1, 2)),
    then -2 ln u = e * (-2 ln 2) + 254 ln 2 - 2 ln m with a degree-8
    relative-minimax polynomial for ln m (1.9e-7 relative, so the
    radius keeps full f32 accuracy even as u -> 1, q -> 0).

    The biased exponent is converted exactly to float with the classic
    1.5*2^23 magic-number trick — no int->float convert instruction, so
    the golden engine (XLA) and the kernels (Triton) run the same
    integer and float operations and stay bitwise identical.
    """
    b = u.view(jnp.uint32)
    # float(biased_exponent) via magic number: eb < 2^9, so OR == ADD
    ebf = ((b >> np.uint32(23)) | np.uint32(0x4B400000)).view(jnp.float32) \
        - np.float32(12582912.0)
    m = ((b & np.uint32(0x007FFFFF)) | np.uint32(0x3F800000)) \
        .view(jnp.float32)
    t = m - np.float32(1.0)
    p = _NEG2LOG[-1]
    for c in _NEG2LOG[-2::-1]:
        p = p * t + c
    q = ebf * _NEG2LN2 + _C254LN2 + t * p
    # polynomial + rounding residue can dip ~1 ulp below zero at u ~ 1
    return jnp.maximum(q, np.float32(0.0))


def _halfcircle_pair(w_r, f, sign_bits):
    """Shared half-circle Box–Muller core.

    w_r: uint32 radius word; f: float32 phase carrier in [1, 2);
    sign_bits: uint32 with the pair's random sign in bit 31 (all other
    bits zero)."""
    u = uniform_open01(w_r)
    q = neg2log(u)
    R = jnp.sqrt(q)
    R = (R.view(jnp.uint32) ^ sign_bits).view(jnp.float32)
    z = f * np.float32(np.pi) - np.float32(1.5 * np.pi)
    z2 = z * z
    s = _SIN_HC[-1]
    for c in _SIN_HC[-2::-1]:
        s = s * z2 + c
    s = s * z
    c_ = _COS_HC[-1]
    for c in _COS_HC[-2::-1]:
        c_ = c_ * z2 + c
    return R * c_, R * s


def normal_pair_hc(w_r, w_p):
    """Two uint32 words -> two iid N(0,1) floats (half-circle Box–Muller).

    A lean restructuring of Box–Muller that removes the quadrant
    selects and the uniform conversion for the phase entirely:

    * radius   R = sqrt(-2 ln u), u in (0,1] from w_r's top 23 bits
      (``neg2log`` fast path);
    * phase    z = pi*(f - 1.5) in [-pi/2, pi/2), f in [1,2) built by
      masking w_p's low 23 bits straight into a float mantissa;
    * sign     w_p's bit 31, folded into R by XOR on the sign bit.

    (±cos z, ±sin z) with z uniform on a half-circle and an independent
    sign covers the full circle uniformly, so (R±cos z, R±sin z) is an
    exact iid normal pair — same math as the reference's curand_normal2
    (NMCH_FE.cu:43), different (cheaper) angle bookkeeping.  sin/cos use
    degree-7/8 near-minimax polynomials (5.9e-7 max err, below the MC
    noise floor by ~3 orders of magnitude).
    """
    f = ((w_p & np.uint32(0x007FFFFF)) | np.uint32(0x3F800000)) \
        .view(jnp.float32)
    return _halfcircle_pair(w_r, f, w_p & np.uint32(0x80000000))


def boxmuller(u1, u2):
    """Two (0,1] uniforms -> two independent N(0,1) floats.

    Matches curand_normal2's construction: r = sqrt(-2 ln u1),
    (g1, g2) = r * (cos, sin)(2 pi u2) — with the turns-based fast
    sincos above (u2 is already a phase in turns).
    """
    r = jnp.sqrt(np.float32(-2.0) * jnp.log(u1))
    c, s = sincos_2pi(u2)
    return r * c, r * s


# Fast inverse normal CDF — the QMC engine's monotone u -> z map.
# XLA's jax.scipy.special.ndtri (Wichura AS241, rationals + divides)
# costs ~50-60 ops per evaluation.
# Construction: substitute s = sqrt(-2 ln(min(u, 1-u))) — the exact
# tail asymptote — and fit |z| = g(s) with TWO degree-7 polynomials
# (benchmarks/fit_polys.py fitter; split at s = 2.6, i.e. |z| ~ 2.1).
# g is smooth on the whole range (g -> 0 as u -> 1/2), so no central
# branch, no divisions, and all coefficients are O(1) — f32-stable
# (Acklam's classic rational has +-276 alternating coefficients that
# lose ~1e-4 to f32 cancellation).  Max |z| error 2.3e-6.
_NDTRI_LO = tuple(np.float32(x) for x in        # s in [sqrt(2 ln 2), 2.6]
                  (-2.5742833614349365, 3.7063958644866943,
                   -2.4668259620666504, 1.5879123210906982,
                   -0.6822224855422974, 0.18576109409332275,
                   -0.028967037796974182, 0.0019696212839335203))
_NDTRI_HI = tuple(np.float32(x) for x in        # s in [2.6, 6.5]
                  (-1.9839493036270142, 2.074390172958374,
                   -0.4344251751899719, 0.11815280467271805,
                   -0.02104499191045761, 0.002353857271373272,
                   -0.00014995710807852447, 4.1502166823192965e-06))


def ndtri_fast_pm(pm):
    """|z| = g(min(u, 1-u)) — the magnitude half of ndtri_fast.

    pm must be in (0, 1/2]; values below 2^-30 are clamped (the HI
    polynomial is fit for s <= 6.5, and pm = 2^-30 gives s = 6.45).
    Intentional tail truncation: pm_sign_from_words can emit
    pm = 2^-31 (Sobol word 0 under MASK), whose exact |z| would be
    ~6.55 — that single most extreme point saturates at ~6.45 instead
    (one representable value, probability 2^-31 per draw;
    accepted).
    Split out so callers that know pm at FULL precision (the
    symmetric Sobol' map, rng/sobol.py::pm_sign_from_words) can skip
    the 1-u subtraction, whose f32 rounding quantizes the upper tail
    ~128x coarser than the lower."""
    s = jnp.sqrt(neg2log(jnp.maximum(pm, np.float32(2.0 ** -30))))
    lo = _NDTRI_LO[-1]
    for c_ in _NDTRI_LO[-2::-1]:
        lo = lo * s + c_
    hi = _NDTRI_HI[-1]
    for c_ in _NDTRI_HI[-2::-1]:
        hi = hi * s + c_
    return jnp.where(s < np.float32(2.6), lo, hi)


def ndtri_fast(u):
    """Inverse normal CDF, float32, max abs error 2.3e-6 on z.

    Valid for u in [2^-26, 1 - 2^-26] (|z| <= 6.24; the Sobol' map
    u01_from_words emits [2^-24, 1 - 2^-24]).  ~2x fewer ops than
    jax.scipy.special.ndtri; distortion is two orders below the RQMC
    CI at any measured size (tests/test_qmc.py)."""
    u = u.astype(jnp.float32)
    pm = jnp.minimum(u, np.float32(1.0) - u)
    g = ndtri_fast_pm(pm)
    return jnp.where(u > np.float32(0.5), g, -g)


def normal4_from_bits(x0, x1, x2, x3, box: str = "hc"):
    """Four uint32 words -> four N(0,1) floats via two Box–Muller pairs.

    This is the analogue of ``curand_normal4`` (the reference's
    fastest Philox variant, FE_k2_philox, ``NMCH_FE.cu:192-245``): one
    counter block feeds two time steps.

    box="hc" (default): the half-circle construction (normal_pair_hc)
    — the fast path both engines share.  box="turns": the original
    full-circle turns-based construction, kept for A/B measurement."""
    if box == "hc":
        g0, g1 = normal_pair_hc(x0, x1)
        g2, g3 = normal_pair_hc(x2, x3)
    elif box == "turns":
        g0, g1 = boxmuller(uniform_open01(x0), uniform_open01(x1))
        g2, g3 = boxmuller(uniform_open01(x2), uniform_open01(x3))
    else:
        raise ValueError(f"unknown box {box!r} (expected 'hc' or 'turns')")
    return g0, g1, g2, g3
