"""Quasi-Monte Carlo FE engine: scrambled Sobol' + Brownian bridge.

The rebuild-mandate capability beyond the CUDA reference's plain MC
(SURVEY §7): integration error ~ n^-0.8 instead
of n^-0.5, so error-matched throughput grows with accuracy targets
(measured table in benchmarks/RESULTS.md).

Design (pure XLA — no kernel needed, the work is a handful
of large fused elementwise passes plus one scan):

1. **Dimension ordering / Brownian bridge.**  A Euler path consumes
   2N normals.  Plain time ordering spreads the payoff's variance over
   all of them, which defeats QMC in high dimension; the Brownian
   bridge re-orders so dimension 0 is the *terminal* value W_T,
   dimension 1 the midpoint, etc. (variance halves each level), giving
   a low effective dimension.  ``bb_plan`` precomputes the bridge as
   numpy level arrays: per node (m, a, b): W_m = wl*W_a + wr*W_b +
   sig*sqrt(dt)*z.  The two Brownian factors interleave Sobol'
   dimensions (factor f, bridge node k -> dim 2k+f).
2. **Point set.**  rng/sobol.py: Joe–Kuo direction numbers, one
   30-XOR pass per bridge level generates ALL that level's dimensions
   at once; per-dimension digital shifts keyed by (seed, epoch) make
   the estimator unbiased (randomized QMC).
3. **Normals.** inverse CDF via the symmetric full-resolution map
   (rng/sobol.py::pm_sign_from_words keeps all 30 Sobol' bits in both
   tails) feeding rng/normal.py::ndtri_fast_pm (divisionless
   two-piece polynomial, |z| error ~2.3e-6, ~2x fewer ops than
   jax.scipy's AS241 — which measured as the single largest cost of
   the whole engine; ndtri_mode="precise" swaps AS241 back in) —
   Box–Muller would entangle dimension pairs and break the
   low-discrepancy structure.  The scatter cross-validation path
   (_bridge_factor) keeps jax.scipy ndtri as the independent
   reference map.
4. **Simulation.**  The increments matrix (N, 2, n) feeds the exact
   same ``fe_step`` as the other engines through one ``lax.scan``.
5. **CI.**  ``n_shifts`` independently randomized replicates of
   n/n_shifts points each; the estimate is the replicate mean and the
   CI comes from the replicate-to-replicate spread (the only valid
   error estimate for QMC — within-point-set variance is meaningless
   for correlated points).  The returned (m, m2) are synthesized so
   SimResult(m, m2, n_paths) reproduces exactly that CI through the
   standard formula.  Randomization is scramble="lms-shift" (shared
   LMS + per-replicate digital shifts) or "owen" (independent
   nested-uniform scrambles per replicate) — the method layer's
   "auto" picks by the measured 2^21-point crossover: the shared-LMS
   CI decay stalls at ~n^-0.4 beyond it while owen holds 76-78x
   error-matched through 2^24 (RESULTS.md QMC attribution).

Reference contrast: ``NMCH_FE.cu`` draws curand_normal4 time-ordered;
there is no QMC anywhere in the reference.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import ndtri

from ..rng.normal import ndtri_fast_pm

from ..rng.sobol import (
    direction_numbers, gray_codes, sobol_dims_u32, sobol_dims_u32_hilo,
    digital_shifts, lms_scramble_directions, owen_seeds, owen_scramble,
    u01_from_words, pm_sign_from_words,
)
from .fe import fe_consts, fe_step

# default replicate count for the randomized-QMC CI (module docstring
# point 5).  The method layer and the mesh layer's point-range
# sharding both derive from THIS constant — a
# literal 8 at those sites would silently desync if it ever changed.
DEFAULT_N_SHIFTS = 8

# The bridge product's algorithm, named explicitly: Precision.HIGH means
# TF32 on an H100, whose ~1e-3 relative increment error is the 1-pass
# bf16 error class that the QMC CI cannot absorb.  Three bf16 passes
# with f32 accumulation keep the increments at f32 grade (error
# measured against a float64 NumPy bridge in PERF.md).
BRIDGE_PRECISION = lax.DotAlgorithmPreset.BF16_BF16_F32_X3


@functools.lru_cache(maxsize=8)
def bb_plan(N: int):
    """Brownian-bridge construction plan for N steps (host, cached).

    Returns a list of levels; each level is a dict of numpy arrays
    {m, a, b, wl, wr, sig, dims} where ``dims`` are the bridge-node
    indices (Sobol' dimension = 2*node + factor) and ``sig`` is in
    units of sqrt(dt).  Level 0 is the terminal node (special-cased:
    W_N = sig * z with sig = sqrt(N)).
    """
    levels = [dict(m=np.array([N]), a=np.array([0]), b=np.array([0]),
                   wl=np.array([[0.0]], np.float32),
                   wr=np.array([[0.0]], np.float32),
                   sig=np.array([[np.sqrt(N)]], np.float32),
                   dims=np.array([0]))]
    k = 1
    segs = [(0, N)]
    while segs:
        nxt, m_, a_, b_, wl_, wr_, sg_, dm_ = [], [], [], [], [], [], [], []
        for a, b in segs:
            if b - a <= 1:
                continue
            m = (a + b) // 2
            m_.append(m); a_.append(a); b_.append(b)
            wl_.append((b - m) / (b - a))
            wr_.append((m - a) / (b - a))
            sg_.append(np.sqrt((m - a) * (b - m) / (b - a)))
            dm_.append(k)
            k += 1
            nxt += [(a, m), (m, b)]
        if m_:
            levels.append(dict(m=np.array(m_), a=np.array(a_),
                               b=np.array(b_),
                               wl=np.array(wl_, np.float32)[:, None],
                               wr=np.array(wr_, np.float32)[:, None],
                               sig=np.array(sg_, np.float32)[:, None],
                               dims=np.array(dm_)))
        segs = nxt
    assert k == N, (k, N)
    return levels


@functools.lru_cache(maxsize=8)
def bb_increment_matrix(N: int):
    """(N, N) float32 A with dW = sqrt(dt) * (A @ z): the Brownian
    bridge is a LINEAR map from bridge-ordered unit normals z to the
    time-ordered increments, so it is one matrix product instead of
    ~2 log2(N) scatter/gather passes (the scatter path remains as
    _bridge_factor for cross-validation — tests assert both give the
    same Brownian law).

    Built by running bb_plan's exact recursion on the identity: column
    k is the path response to z_k = 1 (a hat function between node k's
    parents), in units of sqrt(dt)."""
    W = np.zeros((N + 1, N), np.float64)
    for lev in bb_plan(N):
        for i in range(len(lev["m"])):
            m, a, b = int(lev["m"][i]), int(lev["a"][i]), int(lev["b"][i])
            k = int(lev["dims"][i])
            W[m] = lev["wl"][i] * W[a] + lev["wr"][i] * W[b]
            W[m, k] += float(lev["sig"][i].squeeze()
                             if hasattr(lev["sig"][i], "squeeze")
                             else lev["sig"][i])
    return np.ascontiguousarray((W[1:] - W[:-1]).astype(np.float32))


def _bridge_factor(levels, V, gray, shifts, sqrt_dt, n, N, factor):
    """W (N+1, n) for one Brownian factor from its Sobol' dimensions."""
    W = jnp.zeros((N + 1, n), jnp.float32)
    for lev in levels:
        dims = 2 * lev["dims"] + factor
        x = sobol_dims_u32(gray, V[dims])            # (L, n)
        x = x ^ shifts[dims][:, None]
        z = ndtri(u01_from_words(x))
        upd = (lev["wl"] * W[lev["a"]] + lev["wr"] * W[lev["b"]]
               + (lev["sig"] * sqrt_dt) * z)
        W = W.at[lev["m"]].set(upd)
    return W


def qmc_increments(N: int, n: int, epoch, k0, k1, T, v_np=None):
    """(N, n) increment matrices (dW1, dW2) via Sobol' + scatter bridge
    (the reference construction; fe_moments_qmc uses the faster matmul
    matmul form below — both produce the same Brownian law)."""
    v_np = direction_numbers(2 * N) if v_np is None else v_np
    V = jnp.asarray(v_np)
    levels = bb_plan(N)
    gray = gray_codes(n)
    shifts = digital_shifts(jnp.arange(2 * N, dtype=jnp.uint32),
                            epoch, k0, k1)
    sqrt_dt = jnp.sqrt(T / jnp.float32(N))
    dws = []
    for f in (0, 1):
        W = _bridge_factor(levels, V, gray, shifts, sqrt_dt, n, N, f)
        dws.append(W[1:] - W[:-1])
    return dws[0], dws[1]


def qmc_normals_mxu(N: int, n: int, epoch, k0, k1, v_np=None,
                    n_shifts: int = 1, scramble: str = "lms-shift",
                    base=0, ndtri_mode: str = "fast"):
    """(z1, z2): the (N, n_shifts*n) bridge-ordered unit-normal
    matrices of qmc_increments_mxu BEFORE the bridge matmul
    (qmc_increments_mxu applies sqrt_dt * A @ z to these)."""
    v_np = direction_numbers(2 * N) if v_np is None else v_np
    V = jnp.asarray(v_np)
    if scramble == "lms-shift":
        # Owen-style linear matrix scramble, keyed by (seed, epoch);
        # the n_shifts digital-shift replicates share one scramble (the
        # shift randomization alone already unbiases each replicate, so
        # the replicate CI stays valid conditional on the scramble)
        V = lms_scramble_directions(V, epoch, k0, k1)
    elif scramble not in ("shift", "owen"):
        raise ValueError(f"unknown scramble {scramble!r}")
    ep0 = jnp.asarray(epoch, jnp.uint32) * np.uint32(n_shifts)
    reps = ep0 + jnp.arange(n_shifts, dtype=jnp.uint32)
    if scramble == "owen":
        # full nested-uniform (Owen) randomization, hash-based: every
        # replicate is an INDEPENDENT nonlinear scramble (rng/sobol.py
        # ::owen_scramble), so the t-CI over replicate means holds with
        # no shared-scramble conditioning; RMS error ~n^-1.5 on smooth
        # integrands (vs ~n^-1 for LMS+shift)
        keys = owen_seeds(jnp.arange(2 * N, dtype=jnp.uint32)[:, None],
                          reps[None, :], k0, k1)                 # (2N, R)
    else:
        shifts = digital_shifts(
            jnp.arange(2 * N, dtype=jnp.uint32)[:, None], reps[None, :],
            k0, k1)                                              # (2N, R)
    zs = []
    for f in (0, 1):
        dims = np.arange(N) * 2 + f
        # hi/lo-factored generation (one broadcast XOR per element
        # instead of 30 select-XOR passes — HBM-speed, rng/sobol.py),
        # with the n_shifts replicates randomized by broadcast
        # (replicate-major along the point axis, same ordering as
        # before)
        x = sobol_dims_u32_hilo(n, V[dims], base=base)           # (N, n)
        if scramble == "owen":
            xs = owen_scramble(x[:, None, :], keys[dims][:, :, None])
        else:
            xs = x[:, None, :] ^ shifts[dims][:, :, None]        # (N,R,n)
        # symmetric full-resolution uniform map: pm = min(u, 1-u) on
        # the integer side keeps all 30 Sobol' bits in BOTH tails
        # (u01_from_words' f32 u quantizes the upper tail 128x
        # coarser), then one inverse-CDF magnitude + a sign select.
        # ndtri_mode="precise": full AS241 (jax.scipy) instead of the
        # divisionless polynomial — ndtri_fast's ~2.3e-6 |z| error is
        # a shift-dependent smooth perturbation of the integrand that
        # does NOT average down with n; both knobs attack the f32 CI
        # plateau at >= 2^20 points (RESULTS.md soak).  ndtri(pm) <= 0 for pm <= 1/2, so |z| = -ndtri.
        pm, neg = pm_sign_from_words(xs.reshape(N, n_shifts * n))
        g = ndtri_fast_pm(pm) if ndtri_mode == "fast" else -ndtri(pm)
        zs.append(jnp.where(neg, -g, g))
    return zs[0], zs[1]


def qmc_increments_mxu(N: int, n: int, epoch, k0, k1, T, v_np=None,
                       n_shifts: int = 1, scramble: str = "lms-shift",
                       base=0, ndtri_mode: str = "fast"):
    """(N, n_shifts*n) increment matrices (dW1, dW2): Sobol' points ->
    inverse-CDF normals (bridge-ordered, qmc_normals_mxu) -> ONE
    matmul per factor (bb_increment_matrix).  All n_shifts digitally-
    shifted replicates ride the same matmul (replicate-major along the
    point axis; replicate r's shift key is epoch*n_shifts + r).

    base: first Sobol' point index (traced ok; multiple of the hilo
    block, see rng/sobol.py) — the multi-chip sharding gives each chip
    a disjoint index range of the SAME randomized point set."""
    z1, z2 = qmc_normals_mxu(N, n, epoch, k0, k1, v_np=v_np,
                             n_shifts=n_shifts, scramble=scramble,
                             base=base, ndtri_mode=ndtri_mode)
    A = jnp.asarray(bb_increment_matrix(N))
    sqrt_dt = jnp.sqrt(T / jnp.float32(N))
    return (sqrt_dt * jnp.dot(A, z1, precision=BRIDGE_PRECISION),
            sqrt_dt * jnp.dot(A, z2, precision=BRIDGE_PRECISION))


def _dyadic_refine(z_f, T_total, levels: int):
    """Bridge-ordered unit normals -> Brownian increments by dyadic
    refinement, O(N log N) with NO matmul and NO scatters.

    z_f: (2^levels, m) ladder-ordered normals — row 0 drives the total
    increment over [0, T_total], rows [2^l, 2^(l+1)) drive level l's
    interval splits.  The conditional-split identity: an increment D
    over duration tau splits into halves D/2 +- G with G ~
    N(0, tau/4), i.e. G = sqrt(tau)/2 * z.  Each level doubles the
    row count by interleaving (left, right) — a stack+reshape on the
    sublane axis, which XLA executes as cheap relayouts (the
    level-wise scatter construction this replaces cost ~2000 dynamic
    slices; the dense-matrix form costs an O(N^2) matmul that
    dominated the QMC pipeline at ~45% of runtime).

    Returns (2^levels, m) increments, each ~ N(0, T_total/2^levels),
    with exactly the Brownian joint law (the map is the bridge's
    Cholesky-like factorization, level-major = the same coarse-to-fine
    variance ordering QMC needs).
    """
    D = jnp.sqrt(T_total) * z_f[0:1]
    for l in range(levels):
        c = np.float32(0.5) * jnp.sqrt(T_total / np.float32(1 << l))
        zs = z_f[1 << l:2 << l]
        half = D * np.float32(0.5)
        left = half + c * zs
        right = half - c * zs
        m = D.shape[1]
        D = jnp.stack([left, right], axis=1).reshape((2 << l), m)
    return D


def qmc_increments_dyadic(N: int, n: int, epoch, k0, k1, T, v_np=None,
                          n_shifts: int = 1, scramble: str = "lms-shift",
                          base=0, ndtri_mode: str = "fast"):
    """(N, n_shifts*n) increment matrices (dW1, dW2) via the dyadic
    refinement instead of the dense bridge matmul.

    The time axis is padded to Npad = 2^ceil(log2 N) leaf intervals of
    the SAME dt = T/N; the first N increments of the padded Brownian
    path have exactly the right joint law (a BM marginal), the tail
    Npad - N is discarded (<= 2.4% wasted draws at N=1000).  Dimension
    ordering stays coarse-to-fine (dim 0 ~ the full-horizon increment,
    correlation with W_T is sqrt(N/Npad) ~ 0.99 at N=1000), so the
    QMC effective-dimension structure matches the exact-N bridge to
    within that factor.  Consumes 2*Npad Sobol' dimensions (vs 2*N).

    Same scramble/shift/ndtri semantics as qmc_increments_mxu; NOT
    bitwise-comparable with it (different construction), validated by
    the exact-covariance test (B B^T = dt I) and statistically.
    """
    levels = max((N - 1).bit_length(), 0)
    Npad = 1 << levels
    v_np = direction_numbers(2 * Npad) if v_np is None else v_np
    V = jnp.asarray(v_np)
    if scramble == "lms-shift":
        V = lms_scramble_directions(V, epoch, k0, k1)
    elif scramble not in ("shift", "owen"):
        raise ValueError(f"unknown scramble {scramble!r}")
    ep0 = jnp.asarray(epoch, jnp.uint32) * np.uint32(n_shifts)
    reps = ep0 + jnp.arange(n_shifts, dtype=jnp.uint32)
    if scramble == "owen":
        keys = owen_seeds(jnp.arange(2 * Npad, dtype=jnp.uint32)[:, None],
                          reps[None, :], k0, k1)               # (2Npad, R)
    else:
        shifts = digital_shifts(
            jnp.arange(2 * Npad, dtype=jnp.uint32)[:, None],
            reps[None, :], k0, k1)                             # (2Npad, R)
    T_total = T * jnp.float32(Npad) / jnp.float32(N)
    dws = []
    for f in (0, 1):
        dims = np.arange(Npad) * 2 + f
        x = sobol_dims_u32_hilo(n, V[dims], base=base)         # (Npad, n)
        if scramble == "owen":
            xs = owen_scramble(x[:, None, :], keys[dims][:, :, None])
        else:
            xs = x[:, None, :] ^ shifts[dims][:, :, None]
        pm, neg = pm_sign_from_words(xs.reshape(Npad, n_shifts * n))
        g = ndtri_fast_pm(pm) if ndtri_mode == "fast" else -ndtri(pm)
        z = jnp.where(neg, -g, g)
        dws.append(_dyadic_refine(z, T_total, levels)[:N])
    return dws[0], dws[1]


def _largest_divisor_leq(m: int, cap: int) -> int:
    """Largest divisor of m that is <= cap (cap >= 1)."""
    best = 1
    d = 1
    while d * d <= m:
        if m % d == 0:
            for c in (d, m // d):
                if best < c <= cap:
                    best = c
        d += 1
    return best


def _sim_payoff(params_vec, N, dW1, dW2):
    """Per-path ATM-call payoff over paths driven by given increments.

    The increments arrive as Brownian increments (already scaled by
    sqrt(dt)); fe_step takes unit normals and multiplies by sqrt_dt,
    so we pre-divide — keeping fe_step shared verbatim with the other
    engines."""
    T, S_0, v_0, r, k, rho, theta, sigma = (params_vec[i] for i in range(8))
    dt = T / jnp.float32(N)
    sqrt_dt = jnp.sqrt(dt)
    sqrt_rho_c = jnp.sqrt(jnp.float32(1.0) - rho * rho)
    cst = fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt)
    n = dW1.shape[1]
    S0 = jnp.full((n,), 1.0, jnp.float32) * S_0
    v0 = jnp.full((n,), 1.0, jnp.float32) * v_0

    def body(carry, gs):
        S, v = carry
        g1, g2 = gs
        S, v = fe_step(S, v, g1, g2, cst)
        return (S, v), None

    (S, _), _ = lax.scan(body, (S0, v0),
                         (dW1 / sqrt_dt, dW2 / sqrt_dt))
    return jnp.maximum(S - S_0, 0.0)


def qmc_replicate_payoff_sums(params_vec, epoch, k0, k1, *, N: int,
                              count: int, n_shifts: int = 8,
                              scramble: str = "lms-shift", base=0,
                              ndtri_mode: str = "fast",
                              bridge: str = "mxu"):
    """Per-replicate payoff sums over Sobol' points [base, base+count)
    of each of the n_shifts shifted replicates — the shardable unit of
    the QMC engine (parallel/mesh.py gives each chip a disjoint
    ``base`` range and psums the (n_shifts,) results).  Returns a
    f32[n_shifts] array of payoff SUMS (divide by the total point
    count per replicate to get the replicate means).

    bridge: "mxu" (dense bridge matmul) or "dyadic" (O(N log N)
    refinement, qmc_increments_dyadic — no matmul; a measured
    negative result, RESULTS.md)."""
    T = params_vec[0]
    if bridge == "dyadic":
        dW1, dW2 = qmc_increments_dyadic(
            N, count, epoch, k0, k1, T, n_shifts=n_shifts,
            scramble=scramble, base=base, ndtri_mode=ndtri_mode)
    else:
        dW1, dW2 = qmc_increments_mxu(
            N, count, epoch, k0, k1, T, v_np=direction_numbers(2 * N),
            n_shifts=n_shifts, scramble=scramble, base=base,
            ndtri_mode=ndtri_mode)
    payoff = _sim_payoff(params_vec, N, dW1, dW2)
    return jnp.sum(payoff.reshape(n_shifts, count), axis=1)


def point_chunk(n: int, n_shifts: int, N: int,
                max_chunk: int | None = None) -> int:
    """Points per replicate handled in one pass of fe_moments_qmc.

    The point axis is chunked so the (N, n_shifts*chunk) increment
    matrices stay well under device memory (an unchunked 2^22-point x
    N=1000 run wants ~34 GB of temps); each chunk is a disjoint
    point-index range of the same randomized set, exactly like the
    multi-device sharding (parallel/mesh.py), so chunking changes the
    schedule, not the estimate."""
    chunk = n if max_chunk is None else min(n, max_chunk)
    while chunk * n_shifts * N > (1 << 29):   # ~2 GB of f32 per factor
        if chunk % 2:
            break
        chunk //= 2
    if n % chunk:
        # round a non-dividing (user-supplied or auto-halved) chunk
        # DOWN to the largest divisor of n that fits — the memory cap
        # stays honored and the chunk count stays minimal (gcd would
        # collapse e.g. (n=2048, chunk=1500) to 4 instead of 1024)
        chunk = _largest_divisor_leq(n, chunk)
    return chunk


def rqmc_moments_from_means(means, n_paths: int, n_shifts: int):
    """(m, m2) synthesized so SimResult(m, m2, n_paths) reproduces the
    honest RQMC CI: var(shift means)/(R-1) is the unbiased variance of
    the estimate, and the (t_{R-1}/z)^2 factor bakes the small-sample
    Student-t 95% quantile into the standard 1.96-based formula.

    Caveat: only ``SimResult.ci_error`` is meaningful for these
    synthesized moments.  The reference-parity ``err`` field (the
    NMCH_FE.hpp:50-55 formula, printed by print_stats) degenerates to
    ~1.96|m|/sqrt(n) here — it assumes plain-MC within-sample moments,
    which correlated QMC points do not have.  The CLI prints the RQMC
    CI alongside the stats block for the qmc engine."""
    from scipy.stats import t as _t
    m = jnp.mean(means)
    t_over_z = float(_t.ppf(0.975, n_shifts - 1)) / 1.959963984540054
    var_of_mean = jnp.var(means) * np.float32(
        t_over_z ** 2 / (n_shifts - 1))
    m2 = m * m + var_of_mean * jnp.float32(n_paths)
    return m, m2


@functools.partial(jax.jit, static_argnames=("N", "n_paths", "n_shifts",
                                             "scramble", "max_chunk",
                                             "ndtri_mode", "bridge"))
def fe_moments_qmc(params_vec, epoch, k0, k1, *, N: int, n_paths: int,
                   n_shifts: int = DEFAULT_N_SHIFTS,
                   scramble: str = "lms-shift",
                   max_chunk: int | None = None, ndtri_mode: str = "fast",
                   bridge: str = "mxu"):
    """(m, m2) for the QMC engine; SimResult(m, m2, n_paths) yields the
    randomized-QMC CI (see module docstring, point 5).

    n_paths points are split into ``n_shifts`` independently-randomized
    replicates of n_paths/n_shifts Sobol' points (same index range,
    different digital shifts — or independent nested-uniform scrambles
    with scramble="owen").

    scramble: "lms-shift" (default: linear matrix scramble + digital
    shifts), "shift" (shifts only), "owen" (hash-based full Owen
    scrambling, rng/sobol.py::owen_scramble — fully independent
    nonlinear replicates; asymptotically ~n^-1.5 on smooth integrands,
    measured comparable to lms-shift at 2^14-2^20 on this problem —
    benchmarks/RESULTS.md).
    """
    if n_shifts < 2:
        raise ValueError(f"n_shifts={n_shifts} must be >= 2: the RQMC CI "
                         f"is the spread of independent shift replicates "
                         f"(one replicate has no spread — t.ppf(., 0) is "
                         f"NaN)")
    if n_paths % n_shifts:
        raise ValueError(f"n_paths={n_paths} must be divisible by "
                         f"n_shifts={n_shifts}")
    n = n_paths // n_shifts
    chunk = point_chunk(n, n_shifts, N, max_chunk)
    if n == chunk:
        sums = qmc_replicate_payoff_sums(
            params_vec, epoch, k0, k1, N=N, count=chunk,
            n_shifts=n_shifts,
            scramble=scramble, base=np.uint32(0),
            ndtri_mode=ndtri_mode, bridge=bridge)
    else:
        # a python-unrolled chunk loop lets XLA schedule independent
        # chunks CONCURRENTLY and their increment buffers coexist (a
        # 2^22-point run still allocated 27 GB); fori_loop's sequential
        # carry forces one chunk in flight, so peak memory is one
        # chunk's temps.  The accumulation is Kahan-compensated: at
        # 2^24 points the growing-magnitude plain-f32 chunk adds put a
        # ~2e-6-relative noise floor UNDER the RQMC CI itself (measured
        # CI *rose* from 4.4e-6 at 2^22 to 7.4e-6 at 2^24 before the
        # compensation).
        def body(c, carry):
            acc, comp = carry
            s = qmc_replicate_payoff_sums(
                params_vec, epoch, k0, k1, N=N, count=chunk,
                n_shifts=n_shifts,
                scramble=scramble,
                base=c.astype(jnp.uint32) * jnp.uint32(chunk),
                ndtri_mode=ndtri_mode, bridge=bridge)
            y = s - comp
            t = acc + y
            comp = (t - acc) - y
            return (t, comp)
        z = jnp.zeros((n_shifts,), jnp.float32)
        sums, _ = lax.fori_loop(0, n // chunk, body, (z, z))
    means = sums / jnp.float32(n)
    # m2 synthesized so SimResult's 1.96*sqrt((m2-m^2)/n) returns the
    # honest RQMC 95% CI (Student-t over the R shift replicates)
    return rqmc_moments_from_means(means, n_paths, n_shifts)
