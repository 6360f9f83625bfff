"""Forward-Euler Heston scheme — shared step math + pure-JAX golden engine.

Discretization (reference README.md:30-40, kernel at
``src/NMCH/methods/NMCH_FE.cu:41-48``), per time step with correlated
standard normals (G1, G2):

    S <- S + r S dt + sqrt(v) S sqrt(dt) (rho G1 + sqrt(1-rho^2) G2)
    v <- | v + k (theta - v) dt + sigma sqrt(v) sqrt(dt) G1 |

Note the *reflection* ``g(.) = |.|`` (the reference uses ``abs``, not
truncation) and that the S update reads the pre-update v.  The payoff is
the undiscounted ATM call ``max(S_T - K, 0)`` — the reference never
applies ``exp(-rT)`` in the framework path (only the pre-framework
playbooks did), so neither do we.

RNG consumption contract (shared with the Pallas kernel so both engines
are bitwise-identical): counter block ``j`` of each path's Philox stream
yields 4 uint32 words -> 4 normals via two Box–Muller pairs; words
(0, 1) drive step ``2j`` and words (2, 3) drive step ``2j+1`` (the
analogue of the reference's ``curand_normal4`` trick, FE_k2_philox,
``NMCH_FE.cu:192-245``).  For odd N the final half-block is masked out.

Lane layout: the golden engines hold paths in (R, 128) float32 arrays,
path index = row * 128 + lane; the kernels use 1-D blocks of paths
(ops/path_blocks.py).  The step code is shape-agnostic.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..rng.philox import philox4x32
from ..rng.threefry import draw4_threefry
from ..rng.threefry4 import draw4_threefry4
from ..rng.normal import normal4_from_bits


def path_index_grid(n_paths: int, base: int = 0):
    """(R, 128) uint32 path indices, base-offset for sharded meshes."""
    if n_paths % 128:
        raise ValueError(f"n_paths={n_paths} must be a multiple of 128")
    rows = n_paths // 128
    r = lax.broadcasted_iota(jnp.uint32, (rows, 128), 0)
    c = lax.broadcasted_iota(jnp.uint32, (rows, 128), 1)
    return r * np.uint32(128) + c + np.uint32(base)


def fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt):
    """Precombined loop-invariant constants for ``fe_step``.

    The reference evaluates the raw formula per step per thread
    (``NMCH_FE.cu:41-48``); here the scalar algebra is hoisted
    once so the per-step vector work is minimal:

        S <- S * (one_rdt + sqrt(v) * (rho_sd g1 + rhoc_sd g2))
        v <- | B v + A + sqrt(v) * (C g1) |

    — algebraically identical to the reference update (different f32
    rounding order; both engines share this exact code so the bitwise
    golden==kernel contract is preserved).
    Returns (A, B, C, rho_sd, rhoc_sd, one_rdt); every entry broadcasts
    against the path layout (scalars, or (1, 128) per-lane columns in
    the batched sweep kernels)."""
    one = np.float32(1.0)
    return (k * theta * dt,              # A
            one - k * dt,                # B
            sigma * sqrt_dt,             # C
            rho * sqrt_dt,               # rho_sd
            sqrt_rho_c * sqrt_dt,        # rhoc_sd
            one + r * dt)                # one_rdt


def fe_step(S, v, g1, g2, cst):
    """One Euler step (both engines call this exact function).

    cst: the ``fe_consts`` tuple.  8 vector ops + 1 sqrt per step."""
    A, B, C, rho_sd, rhoc_sd, one_rdt = cst
    sqv = jnp.sqrt(v)
    zc = rho_sd * g1 + rhoc_sd * g2
    S = S * (one_rdt + sqv * zc)
    v = jnp.abs(B * v + A + sqv * (C * g1))
    return S, v


def make_draw4(rng: str, path_lo, path_hi, epoch, k0, k1):
    """Block-index -> 4 uint32 words for the chosen counter-based RNG.

    rng="philox": curand-family default; rng="threefry": multiply-free,
    ~35% faster in-kernel, bit-exact with JAX's own threefry2x32
    (rng/threefry.py); rng="threefry4": one fused 4-word block per
    call, the fastest reproducible generator (rng/threefry4.py)."""
    if rng == "philox":
        return lambda j: philox4x32(j, epoch, path_lo, path_hi, k0, k1)
    if rng == "threefry":
        return lambda j: draw4_threefry(j, epoch, path_lo, k0, k1)
    if rng == "threefry4":
        return lambda j: draw4_threefry4(j, epoch, path_lo, k0, k1,
                                         path_hi=path_hi)
    raise ValueError(f"unknown counter rng {rng!r}")


def fe_two_steps(S, v, g0, g1, g2, g3, j, cst, N: int):
    """Advance the two Euler steps of counter block ``j`` (steps 2j
    and 2j+1), masking the trailing half-block for odd N.

    The one place the block contract lives: the philox/threefry scan
    engine (fe_block_body), the MRG32k3a engine (ops/fe_mrg.py) and
    the differentiable greeks engine (ops/greeks.py) all call this, so
    the draw-consumption parity rule cannot drift between them."""
    S, v = fe_step(S, v, g0, g1, cst)
    if N % 2 == 0:
        return fe_step(S, v, g2, g3, cst)
    do = (2 * j + 1) < N
    S2, v2 = fe_step(S, v, g2, g3, cst)
    return jnp.where(do, S2, S), jnp.where(do, v2, v)


def fe_block_body(j, S, v, path_lo, path_hi, epoch, k0, k1, cst, N: int,
                  rng: str = "philox"):
    """Advance steps 2j and 2j+1 from one counter block."""
    draw = make_draw4(rng, path_lo, path_hi, epoch, k0, k1)
    bits = draw(jnp.uint32(0) + j.astype(jnp.uint32))
    g0, g1, g2, g3 = normal4_from_bits(*bits)
    return fe_two_steps(S, v, g0, g1, g2, g3, j, cst, N)


def fe_terminal(params_vec, N: int, path_idx, epoch, k0, k1,
                rng: str = "philox"):
    """Simulate all paths to maturity; returns (S_T, v_T) as (R, 128) f32.

    params_vec: f32[8] = (T, S_0, v_0, r, k, rho, theta, sigma) — traced,
    so parameter sweeps reuse one compilation.
    """
    T, S_0, v_0, r, k, rho, theta, sigma = (params_vec[i] for i in range(8))
    dt = T / jnp.float32(N)
    sqrt_dt = jnp.sqrt(dt)
    sqrt_rho_c = jnp.sqrt(jnp.float32(1.0) - rho * rho)
    cst = fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt)

    path_lo = path_idx.astype(jnp.uint32)
    path_hi = jnp.zeros_like(path_lo)
    ep = jnp.asarray(epoch, dtype=jnp.uint32)

    S0 = jnp.full(path_idx.shape, 1.0, jnp.float32) * S_0
    v0 = jnp.full(path_idx.shape, 1.0, jnp.float32) * v_0

    n_blocks = (N + 1) // 2

    def body(j, carry):
        S, v = carry
        return fe_block_body(j, S, v, path_lo, path_hi, ep, k0, k1,
                             cst, N, rng=rng)

    S, v = lax.fori_loop(0, n_blocks, body, (S0, v0))
    return S, v


def fe_moments_scan(params_vec, N: int, path_idx, epoch, k0, k1,
                    rng: str = "philox"):
    """Golden engine: (E[X], E[X^2]) with X = (S_T - K)^+, K = S_0.

    The reference scales each payoff by 1/n before reduction
    (``NMCH_FE.cu:174-175``); we compute sum/n — identical up to
    summation order.
    """
    S_T, _ = fe_terminal(params_vec, N, path_idx, epoch, k0, k1, rng=rng)
    K = params_vec[1]  # ATM strike = S_0 (NMCH.cu:7)
    payoff = jnp.maximum(S_T - K, 0.0)
    n = jnp.float32(payoff.size)
    return jnp.sum(payoff) / n, jnp.sum(payoff * payoff) / n


_SQRT_HALF = np.float32(np.sqrt(0.5))


def radius_antithetic_scale(a, b):
    """s such that (s a, s b) is the *radius-antithetic* image of the
    isotropic normal pair (a, b).

    In polar form a = R cos(phi), b = R sin(phi) with R^2 ~ Exp(1/2),
    so u := exp(-R^2/2) ~ U(0,1) — the Box–Muller radius uniform
    recovered from the pair itself (works for ANY isotropic pair, no
    matter which sampler produced it).  The antithetic radius is
    R' = sqrt(-2 ln(1-u)) (u -> 1-u on the radius CDF) at the same
    angle, i.e. the image is (s a, s b) with

        s = R'/R = sqrt( -ln(-expm1(-t)) / t ),   t = R^2/2.

    Exactness: 1-u ~ U(0,1), so R' has the correct radius law and the
    image is again exactly N(0,1)^2 — while (R, R') straddle the
    radius median (small radii pair with large ones), stratifying the
    polar coordinate that plain quarter-turn rotations leave
    untouched.

    f32 care (the small-t guard is a Taylor branch, which every
    compiler lowers): for t < 0.01, 1-e^-t is computed as
    t(1 - t/2 + t^2/6 - t^3/24) (relative error < t^4/120 ~ 1e-10;
    the naive 1-exp(-t) would carry eps/t ~ 6e-8/t relative error and
    blow up the log for tiny radii); for t > 10 the branch switches to
    the asymptote -ln(1-e^-t) ~= e^-t (its relative error e^-t/2 is
    ~2.3e-5 at the switch point, decaying to < 2e-8 by t ~ 17 where
    the direct form would round 1-e^-t to 1.0 and the log to -0 —
    either branch's error at t ~ 10 scales draws of magnitude
    s ~ 2e-3, i.e. ~5e-8 absolute on the image)."""
    t = jnp.maximum((a * a + b * b) * np.float32(0.5), np.float32(1e-35))
    emt = jnp.exp(-t)
    poly = t * (np.float32(1.0) + t * (np.float32(-0.5)
                + t * (np.float32(1.0 / 6.0)
                       + t * np.float32(-1.0 / 24.0))))
    em = jnp.where(t < np.float32(0.01), poly,
                   np.float32(1.0) - emt)    # = 1 - u
    lg = jnp.where(t > np.float32(10.0), emt,
                   -jnp.log(jnp.maximum(em, np.float32(1e-38))))
    return jnp.sqrt(lg / t)


def rotation_images(a, b, rot: int):
    """``rot`` distribution-preserving images of an iid normal pair.

    rot=2: (a,b), (-a,-b) — classic antithetic variates.
    rot=4: + (b,-a), (-b,a) — quarter-turn stratification of the
           Box–Muller angle.
    rot=8: + the four quarter-turns of the radius-antithetic image
           (s a, s b), s = radius_antithetic_scale(a, b) — the 8
           copies stratify BOTH polar coordinates (4 angles x 2
           antithetic radii).  (Rounds 2-3 used 45-degree turns here;
           those stratify the angle only — measured group variance
           ratio ~0.96, i.e. no error-matched credit.  The radius
           pairing replaces them.)

    Each image is an exact iid N(0,1)^2 pair (the isotropic Gaussian
    is invariant under orthogonal maps, and the radius-antithetic map
    preserves the polar factorization), so every copy drives a
    marginally-exact Euler path.  One draw's bits amortize over rot
    simulated paths (the throughput lever) while the group mean has
    *lower* variance than iid paths of the same count (measured in
    benchmarks/RESULTS.md; asserted in tests/test_fe.py)."""
    imgs = [(a, b), (-a, -b), (b, -a), (-b, a)]
    if rot > 4:
        s = radius_antithetic_scale(a, b)
        c = s * a
        d = s * b
        imgs += [(c, d), (-c, -d), (d, -c), (-d, c)]
    return imgs[:rot]



def fe_rot_group_step(Ss, vs, a, b, cst, rot: int):
    """One Euler step for ``rot`` rotation-coupled copies, with the
    rotation algebra SHARED across copies.

    Copy t sees rotation_images(a, b, rot)[t] — but every image is a
    sign/swap of (a, b), so the two draw-dependent quantities per copy
    (the correlated mix zc = rho_sd g1 + rhoc_sd g2 and the variance
    kick C g1) take only 2 distinct magnitudes each:

        images (a,b), (-a,-b):  zc = ±(rho_sd a + rhoc_sd b), Cg1 = ±Ca
        images (b,-a), (-b,a):  zc = ±(rho_sd b - rhoc_sd a), Cg1 = ±Cb

    (rot=8 adds the radius-antithetic pair (s a, s b) whose two mixes
    are just s-scalings of the first four's: zc = ±s za / ±s zs,
    Cg1 = ±s Ca / ±s Cb — one radius_antithetic_scale evaluation + 4
    scalings per draw pair, amortized over 4 more copies).  Computing
    them once per pair instead of per copy cuts the per-copy step to
    7 vector ops + 1 sqrt: at rot=4 the Euler portion of the kernel
    nearly halves.  Same estimator as mapping fe_step over rotation_images
    (the identity is algebraic; rounding order is the engines' shared
    choice)."""
    A, B, C, rho_sd, rhoc_sd, one_rdt = cst
    za = rho_sd * a + rhoc_sd * b
    zs = rho_sd * b - rhoc_sd * a
    ca = C * a
    cb = C * b
    specs = [(za, ca, True), (za, ca, False), (zs, cb, True), (zs, cb, False)]
    if rot > 4:
        s_ = radius_antithetic_scale(a, b)
        specs += [(s_ * za, s_ * ca, True), (s_ * za, s_ * ca, False),
                  (s_ * zs, s_ * cb, True), (s_ * zs, s_ * cb, False)]
    outS, outv = [], []
    for t in range(rot):
        zc, cg, pos = specs[t]
        sqv = jnp.sqrt(vs[t])
        if pos:
            outS.append(Ss[t] * (one_rdt + sqv * zc))
            outv.append(jnp.abs(B * vs[t] + A + sqv * cg))
        else:
            outS.append(Ss[t] * (one_rdt - sqv * zc))
            outv.append(jnp.abs(B * vs[t] + A - sqv * cg))
    return outS, outv


def fe_rot_block_body(j, Ss, vs, path_lo, path_hi, epoch, k0, k1,
                      cst, N: int, rot: int, rng: str = "philox"):
    """Advance ``rot`` rotation-coupled path copies through steps
    2j and 2j+1 from one counter block (same draws as rot=1)."""
    draw = make_draw4(rng, path_lo, path_hi, epoch, k0, k1)
    bits = draw(jnp.uint32(0) + j.astype(jnp.uint32))
    g0, g1, g2, g3 = normal4_from_bits(*bits)

    Ss, vs = fe_rot_group_step(Ss, vs, g0, g1, cst, rot)
    if N % 2 == 0:
        Ss, vs = fe_rot_group_step(Ss, vs, g2, g3, cst, rot)
    else:
        do = (2 * j + 1) < N
        S2, v2 = fe_rot_group_step(Ss, vs, g2, g3, cst, rot)
        Ss = [jnp.where(do, s2, s) for s2, s in zip(S2, Ss)]
        vs = [jnp.where(do, w2, w) for w2, w in zip(v2, vs)]
    return Ss, vs


def fe_group_payoff(params_vec, N: int, path_lo, epoch, k0, k1,
                    rng: str = "philox", rot: int = 1):
    """Group-mean payoff Y = (1/rot) sum_t (S_T^t - K)^+ per stream.

    The one FE path body shared by the rotation golden engine
    (fe_moments_rot_scan, on a (R, 128) layout) and the fused kernel
    (ops/fe_pallas.py, on one block of paths), so both draw the same
    words and run the same step arithmetic.  params_vec: f32[8] or an
    8-tuple of scalars; path_lo: uint32 stream indices of any shape."""
    T, S_0, v_0, r, k, rho, theta, sigma = (params_vec[i] for i in range(8))
    dt = T / jnp.float32(N)
    sqrt_dt = jnp.sqrt(dt)
    sqrt_rho_c = jnp.sqrt(jnp.float32(1.0) - rho * rho)
    cst = fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt)
    path_lo = path_lo.astype(jnp.uint32)
    path_hi = jnp.zeros_like(path_lo)
    ep = jnp.asarray(epoch, dtype=jnp.uint32)
    ones = jnp.full(path_lo.shape, 1.0, jnp.float32)
    n_blocks = (N + 1) // 2

    def body(j, carry):
        Ss, vs = list(carry[:rot]), list(carry[rot:])
        Ss, vs = fe_rot_block_body(
            j, Ss, vs, path_lo, path_hi, ep, k0, k1, cst, N,
            rot=rot, rng=rng)
        return tuple(Ss) + tuple(vs)

    init = tuple(ones * S_0 for _ in range(rot)) \
        + tuple(ones * v_0 for _ in range(rot))
    out = lax.fori_loop(0, n_blocks, body, init)
    K = S_0                      # ATM strike (NMCH.cu:7)
    y = jnp.maximum(out[0] - K, 0.0)
    for t in range(1, rot):
        y = y + jnp.maximum(out[t] - K, 0.0)
    if rot > 1:
        y = y * np.float32(1.0 / rot)
    return y


def fe_moments_rot_scan(params_vec, N: int, path_idx, epoch, k0, k1,
                        rng: str = "philox", rot: int = 2):
    """Rotation-sampling estimator (variance reduction beyond the CUDA
    reference).  Each lane simulates ``rot`` orthogonally-coupled
    copies driven by rotation_images of one stream's draws; the sample is
    the group mean Y = (1/rot) sum X_t, so the returned (E[Y], E[Y^2])
    feed the standard CI formulas with n = number of groups (one group
    consumes the randomness of one plain path)."""
    if rot not in (2, 4, 8):
        raise ValueError(f"rot must be 2, 4 or 8, got {rot}")
    y = fe_group_payoff(params_vec, N, path_idx, epoch, k0, k1, rng=rng,
                        rot=rot)
    n = jnp.float32(y.size)
    return jnp.sum(y) / n, jnp.sum(y * y) / n


def fe_moments_antithetic_scan(params_vec, N: int, path_idx, epoch, k0, k1,
                               rng: str = "philox"):
    """Antithetic variates == rotation sampling with rot=2."""
    return fe_moments_rot_scan(params_vec, N, path_idx, epoch, k0, k1,
                               rng=rng, rot=2)


def fe_sweep_scan(params_matrix, seed: int, epoch0: int, *, N: int,
                  n_paths: int):
    """Batched parameter sweep: vmap of the scan engine over parameter
    rows, row ``p`` at stream epoch ``epoch0 + p`` (the epochs
    sequential compute() calls would use).  params_matrix:
    f32[n_points, 8]; returns two f32[n_points] arrays."""
    from ..rng.philox import split_seed
    k0, k1 = split_seed(seed)
    pidx = path_index_grid(n_paths)

    def one(pv, ep):
        return fe_moments_scan(pv, N, pidx, ep, k0, k1)

    eps = jnp.uint32(epoch0) + jnp.arange(params_matrix.shape[0],
                                          dtype=jnp.uint32)
    return jax.vmap(one)(params_matrix.astype(jnp.float32), eps)
