"""Vectorized Poisson and Gamma samplers on per-path Philox streams.

These are the vectorized re-design of the reference EM kernel's per-thread
samplers (``src/NMCH/methods/NMCH_EM.cu``):

* ``curand_poisson`` (``NMCH_EM.cu:102,325``) -> a three-regime ladder
  mirroring curand's algorithm selection: Knuth multiplication for
  small lambda, Hörmann's PTRS transformed rejection for the mid range,
  and a normal approximation for lambda >= 4000;
* ``gamma_distribution`` (Marsaglia–Tsang, ``NMCH_EM.cu:11-55``) ->
  the same algorithm with the alpha < 1 "boost" U^(1/alpha) hoisted
  before the loop exactly as the reference does to avoid divergence
  (``NMCH_EM.cu:29-38``).

SIMD rejection strategy ("the hard part", SURVEY.md §7.6): on a CUDA
SIMT machine each thread loops privately; here a block of lanes runs
*masked rounds* — every round, still-active lanes draw one fresh Philox block
from their own stream and try to accept; accepted lanes freeze their
result and their stream counter.  Consumption is lane-local (a lane's
draw sequence is a pure function of its own stream), so results are
independent of tile size and identical across the golden and Pallas
engines.  Loops are capped (escape probability < 1e-12 per lane) with
a mean fallback for the astronomically-rare stragglers.

Kernel-lowering notes: the active mask is carried as uint32 0/1 (not
a bool vector), the "any lane still active" test is a max-reduction
(the Triton lowering has max/min/sum reductions but no logical-or
reduction), and every vector carry starts from a zero derived from
the path-index iota (``anchored_zeros``) rather than a splat — an
earlier compiler needed the per-lane layout; all three are bitwise
neutral.

All code is plain jnp on uint32/float32 arrays: it runs unmodified
inside Pallas kernels and in the pure-JAX golden engine.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

from ..rng.philox import philox4x32
from ..rng.threefry4 import draw4_threefry4
from ..rng.normal import uniform_open01, uniform_halfopen01, boxmuller

_HALF_LN_2PI = np.float32(0.9189385332046727)  # 0.5*ln(2*pi)


def anchored_zeros(path_lo):
    """(uint32 zeros, float32 zeros) with a lane layout Mosaic can't
    fold to a replicated splat (see module docstring)."""
    znr = path_lo >> np.uint32(31)          # all zero, iota-derived
    fznr = znr.view(jnp.float32)            # bitcast: still all zero
    return znr, fznr


def _stirling_corr(zz):
    """Three-term Stirling correction 1/12z - 1/360z^3 + 1/1260z^5.

    Truncation error < 1.3e-7 relative for zz >= 3 (next term is
    -1/(1680 z^7))."""
    i2 = (np.float32(1.0) / zz) * (np.float32(1.0) / zz)
    c = np.float32(1.0 / 12.0) - i2 * (np.float32(1.0 / 360.0)
                                       - i2 * np.float32(1.0 / 1260.0))
    return c / zz


def lgamma_kp1(kf):
    """log(k!) = lgamma(k+1) for float-valued k >= 0.

    Three-term Stirling on z >= 3, with a 2-step upward shift below
    (lgamma(z) = lgamma(z+2) - log(z(z+1))).  Algorithmic (truncation)
    error < 2e-7 relative everywhere; total float32 error is bounded
    by evaluation rounding: < 1e-4 absolute for k <= 100, < 1e-6
    relative over the whole PTRS range (asserted in
    tests/test_sampling.py::test_lgamma_accuracy).
    The PTRS acceptance test no longer calls this (it uses the
    cancellation-free form in ``ptrs_log_accept_rhs``); kept as the
    tested public utility.
    """
    z = kf + np.float32(1.0)
    shift = z < np.float32(3.0)
    logm = jnp.where(shift, jnp.log(z * (z + np.float32(1.0))),
                     np.float32(0.0))
    zz = jnp.where(shift, z + np.float32(2.0), z)
    lz = jnp.log(zz)
    stirling = ((zz - np.float32(0.5)) * lz - zz + _HALF_LN_2PI
                + _stirling_corr(zz))
    return stirling - logm


def ptrs_log_accept_rhs(kf, lam, loglam):
    """kf*log(lam) - lam - lgamma(kf+1), cancellation-free.

    Evaluated directly, the three terms are O(lam*log(lam)) (~3.7e4 at
    lam = 4000) and cancel to O(1) — float32 rounding of each term
    (~2e-3) would dominate the PTRS acceptance test.  Substituting the
    Stirling form of lgamma and pairing the large terms:

        rhs = -(w - 0.5)*log1p((w - lam)/lam) + (kf - w + 0.5)*loglam
              + (w - lam) - ln(2*pi)/2 - corr(w) + logm

    where w = kf+1 shifted up by 2 when kf+1 < 3 (logm = the shift
    product, as in lgamma_kp1).  Both O(sqrt(lam)) terms are now
    computed relative to lam, so the total float32 error is ~1e-5
    absolute over the whole PTRS range — vs ~1e-2 for the direct form.
    """
    z = kf + np.float32(1.0)
    shift = z < np.float32(3.0)
    logm = jnp.where(shift, jnp.log(z * (z + np.float32(1.0))),
                     np.float32(0.0))
    w = jnp.where(shift, z + np.float32(2.0), z)
    t = (w - lam) / lam
    # jnp.log1p, NOT log(1+t): the compensation is the whole point
    # (t is small, and the coefficient w amplifies any argument
    # rounding by ~4e-4 at lam ~ 4000); Mosaic lowers lax.log1p_p
    # natively, and hand-rolled Goldberg compensation gets folded away
    # by XLA's algebraic simplifier under jit.
    return (-(w - np.float32(0.5)) * jnp.log1p(t)
            + (kf - w + np.float32(0.5)) * loglam
            + (w - lam) - _HALF_LN_2PI - _stirling_corr(w) + logm)


def make_lane_draw4(rng: str):
    """One 4-word block per lane at that lane's current counter.

    Any counter-based PRF fits the lane-local consumption contract
    (the draw is a pure function of (ctr, epoch, path, key)); the
    rejection samplers below take the resulting callable."""
    if rng == "philox":
        return philox4x32
    if rng == "threefry4":
        return lambda ctr, ep, lo, hi, k0, k1: \
            draw4_threefry4(ctr, ep, lo, k0, k1, path_hi=hi)
    raise ValueError(f"unknown lane rng {rng!r} (expected 'philox' or "
                     f"'threefry4')")


STATEFUL_RNGS = ("mrg32k3a", "xorwow")


def _sel(pred, new, old):
    """Per-lane select over a stream state (u32 array or tuple of)."""
    if isinstance(new, tuple):
        return tuple(jnp.where(pred, n, o) for n, o in zip(new, old))
    return jnp.where(pred, new, old)


def make_stream_draw4(rng: str, epoch, path_lo, path_hi, k0, k1):
    """Uniform draw protocol over all four RNG families:
    ``draw4s(st) -> (w0, w1, w2, w3, st_next)``.

    Counter families (philox/threefry4): st is the lane's u32 block
    counter; the words are a pure function of (st, epoch, path, key)
    and st_next = st + 1 — bitwise identical to the historical
    ``make_lane_draw4`` + ``ctr + 1`` pairing, so golden==kernel
    parity is untouched.

    Stateful families (mrg32k3a/xorwow): st is the flat tuple of
    recurrence state words (6 u32 arrays either way) and the four
    words come from four sequential recurrence steps — exactly
    curand's per-thread consumption order (``NMCH_EM.cu:96-124``
    draws sequentially from one ``curandState`` per thread).  The
    samplers below commit st_next only for lanes still active, so a
    lane's draw sequence stays a pure function of its own stream
    regardless of tile shape.  MRG32k3a's z in [0, m1) is consumed
    directly as the u32 word: m1 = 2^32 - 209, so the top-23-bit
    uniformization in rng/normal.py sees a defect of 209/2^32 ~ 5e-8
    — far below any sampler tolerance (and curand's own
    curand_uniform(mrg) uses z directly the same way).
    """
    if rng in ("philox", "threefry4"):
        draw4 = make_lane_draw4(rng)

        def draw4s(st):
            w0, w1, w2, w3 = draw4(st, epoch, path_lo, path_hi, k0, k1)
            return w0, w1, w2, w3, st + jnp.uint32(1)
        return draw4s
    if rng == "mrg32k3a":
        from ..rng.mrg32k3a import mrg_step

        def draw4s(st):
            s1, s2 = st[:3], st[3:]
            ws = []
            for _ in range(4):
                z, s1, s2 = mrg_step(s1, s2)
                ws.append(z)
            return (*ws, s1 + s2)
        return draw4s
    if rng == "xorwow":
        from ..rng.xorwow import xorwow_step

        def draw4s(st):
            s, d = st[:5], st[5]
            ws = []
            for _ in range(4):
                o, s, d = xorwow_step(s, d)
                ws.append(o)
            return (*ws, s + (d,))
        return draw4s
    raise ValueError(f"unknown lane rng {rng!r}")


def stream_state_init(rng: str, seed: int, path_lo, epoch):
    """Initial stream state for a STATEFUL family at (seed, path,
    epoch) — the flat tuple ``make_stream_draw4`` advances.  One
    matrix skip-ahead per path per epoch (init-time only; the
    reference pays the analogous one-off in its 7 ms curand-init
    kernel, profilings/FE_B_MMng:19)."""
    if rng == "mrg32k3a":
        from ..rng.mrg32k3a import mrg_state_at
        s1, s2 = mrg_state_at(seed, path_lo, epoch)
        return s1 + s2
    if rng == "xorwow":
        from ..rng.xorwow import xorwow_state_at
        s, d = xorwow_state_at(seed, path_lo, epoch)
        return s + (d,)
    raise ValueError(f"{rng!r} is not a stateful family")


# regime thresholds (mirrors curand's published algorithm switching)
_POISSON_SMALL = 10.0
_POISSON_LARGE = 4000.0


def poisson_from_stream(lam, ctr, epoch, path_lo, path_hi, k0, k1,
                        max_rounds: int = 64, rng: str = "philox",
                        large_cut: float | None = None):
    """Sample N_p ~ Poisson(lam) per lane; returns (N_p_f32, new_ctr).

    lam, ctr: equally-shaped f32/u32 arrays for the counter families;
    for rng in STATEFUL_RNGS, ctr is the flat state tuple from
    ``stream_state_init``.  Each active lane consumes one 4-word block
    per round from its own stream.

    large_cut: lambda above which the continuity-corrected normal
    approximation replaces PTRS (default _POISSON_LARGE = 4000, the
    curand-parity switch).  The normal branch always accepts in one
    round, whereas a PTRS tile needs the *max* of its lanes' geometric
    round counts (~4-6 rounds at 8k lanes), so lowering the cut is the
    EM speed lever; callers that can tolerate a documented O(1/sqrt(
    lam)) distributional error (the EM gamma mixture smooths it below
    price noise — see ops/em.py) pass a smaller cut.
    """
    lam = lam.astype(jnp.float32)
    draw4s = make_stream_draw4(rng, epoch, path_lo, path_hi, k0, k1)
    znr, fznr = anchored_zeros(path_lo)
    cut = _POISSON_LARGE if large_cut is None else float(large_cut)
    small = lam < np.float32(_POISSON_SMALL)
    large = lam >= np.float32(cut)
    sqrt_lam = jnp.sqrt(lam)
    target = jnp.exp(-lam)                      # Knuth product threshold
    # PTRS constants (Hörmann 1993, transformed rejection with squeeze)
    b = np.float32(0.931) + np.float32(2.53) * sqrt_lam
    a = np.float32(-0.059) + np.float32(0.02483) * b
    invalpha = np.float32(1.1239) + np.float32(1.1328) / (b - np.float32(3.4))
    vr = np.float32(0.9277) - np.float32(3.6224) / (b - np.float32(2.0))
    loglam = jnp.log(lam)

    def cond(st):
        actu, _, _, _, _, rnd = st
        return jnp.logical_and(jnp.max(actu) > np.uint32(0),
                               rnd < max_rounds)

    def body(st):
        actu, result, t, cnt, c, rnd = st
        active = actu > np.uint32(0)
        w0, w1, w2, w3, c_next = draw4s(c)

        # --- large lambda: one normal-approximation draw
        g, _ = boxmuller(uniform_open01(w0), uniform_open01(w1))
        k_large = jnp.maximum(
            jnp.floor(lam + sqrt_lam * g + np.float32(0.5)), np.float32(0.0))

        # --- mid lambda: PTRS round
        U = uniform_halfopen01(w0) - np.float32(0.5)
        V = uniform_halfopen01(w1)
        us = np.float32(0.5) - jnp.abs(U)
        kf = jnp.floor((np.float32(2.0) * a / us + b) * U + lam
                       + np.float32(0.43))
        squeeze = jnp.logical_and(us >= np.float32(0.07), V <= vr)
        rej = jnp.logical_or(kf < np.float32(0.0),
                             jnp.logical_and(us < np.float32(0.013), V > us))
        logacc = jnp.log(V * invalpha / (a / (us * us) + b))
        full = logacc <= ptrs_log_accept_rhs(kf, lam, loglam)
        mid_ok = jnp.logical_or(
            squeeze, jnp.logical_and(jnp.logical_not(rej), full))
        k_mid = jnp.maximum(kf, np.float32(0.0))

        # --- small lambda: Knuth, 4 uniforms per round
        tt, cc2 = t, cnt
        for w in (w0, w1, w2, w3):
            u = uniform_open01(w)
            still = tt >= target
            tt = jnp.where(still, tt * u, tt)
            cc2 = cc2 + jnp.where(still, np.float32(1.0), np.float32(0.0))
        small_done = tt < target
        k_small = jnp.maximum(cc2 - np.float32(1.0), np.float32(0.0))

        # done = small ? small_done : (large ? True : mid_ok)
        done = jnp.logical_or(
            jnp.logical_and(small, small_done),
            jnp.logical_and(jnp.logical_not(small),
                            jnp.logical_or(large, mid_ok)))
        kd = jnp.where(small, k_small, jnp.where(large, k_large, k_mid))

        newly = jnp.logical_and(active, done)
        result = jnp.where(newly, kd, result)
        c = _sel(active, c_next, c)
        keep = jnp.logical_and(active, jnp.logical_not(done))
        actu = jnp.where(keep, np.uint32(1), np.uint32(0))
        return (actu, result, tt, cc2, c, rnd + 1)

    st0 = (znr + np.uint32(1), fznr, fznr + np.float32(1.0), fznr,
           ctr, jnp.int32(0))
    actu, result, _, _, c, _ = lax.while_loop(cond, body, st0)
    # straggler fallback (P < 1e-12/lane): distribution mode
    result = jnp.where(actu > np.uint32(0),
                       jnp.floor(lam + np.float32(0.5)), result)
    return result, c


def gamma_ms_from_stream(alpha0, ctr, epoch, path_lo, path_hi, k0, k1,
                         max_rounds: int = 32, rng: str = "philox"):
    """Sample Gamma(alpha0, 1) per lane via Marsaglia–Tsang;
    returns (gamma_f32, new_ctr).

    The alpha < 1 case multiplies by U^(1/alpha) with U drawn once in
    the first round and alpha boosted by 1 — exactly the reference's
    pre-loop hoist (NMCH_EM.cu:29-38).
    """
    alpha0 = alpha0.astype(jnp.float32)
    draw4s = make_stream_draw4(rng, epoch, path_lo, path_hi, k0, k1)
    znr, fznr = anchored_zeros(path_lo)
    need_boost = alpha0 < np.float32(1.0)
    alpha = alpha0 + jnp.where(need_boost, np.float32(1.0), np.float32(0.0))
    d = alpha - np.float32(1.0 / 3.0)
    cmul = lax.rsqrt(np.float32(9.0) * d)

    def cond(st):
        actu, _, _, _, rnd = st
        return jnp.logical_and(jnp.max(actu) > np.uint32(0),
                               rnd < max_rounds)

    def body(st):
        actu, result, C, c, rnd = st
        active = actu > np.uint32(0)
        w0, w1, w2, w3, c_next = draw4s(c)
        x, _ = boxmuller(uniform_open01(w0), uniform_open01(w1))
        v1 = np.float32(1.0) + cmul * x
        v = v1 * v1 * v1
        u = uniform_open01(w2)
        x2 = x * x
        squeeze = u < np.float32(1.0) - np.float32(0.0331) * x2 * x2
        logv = jnp.log(jnp.maximum(v, np.float32(1e-37)))
        full = jnp.log(u) < (np.float32(0.5) * x2
                             + d * (np.float32(1.0) - v + logv))
        ok = jnp.logical_and(v > np.float32(0.0),
                             jnp.logical_or(squeeze, full))

        # boost factor drawn once, in each lane's first round
        C = jnp.where(
            rnd == 0,
            jnp.where(need_boost,
                      jnp.exp(jnp.log(uniform_open01(w3)) / alpha0),
                      fznr + np.float32(1.0)),
            C)

        newly = jnp.logical_and(active, ok)
        result = jnp.where(newly, d * v * C, result)
        c = _sel(active, c_next, c)
        keep = jnp.logical_and(active, jnp.logical_not(ok))
        actu = jnp.where(keep, np.uint32(1), np.uint32(0))
        return (actu, result, C, c, rnd + 1)

    st0 = (znr + np.uint32(1), fznr, fznr + np.float32(1.0), ctr,
           jnp.int32(0))
    actu, result, C, c, _ = lax.while_loop(cond, body, st0)
    # straggler fallback: distribution mean
    result = jnp.where(actu > np.uint32(0), alpha * C, result)
    return result, c
