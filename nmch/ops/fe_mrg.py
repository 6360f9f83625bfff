"""Forward-Euler golden engine driven by MRG32k3a streams.

Same Euler math and block layout as ops/fe.py (shared ``fe_consts`` /
``fe_step``), but draws come from the *stateful* MRG32k3a recurrence
(rng/mrg32k3a.py) carried through the loop — the analogue
of the reference's ``NMCH_FE_K3_MM<curandStateMRG32k3a_t>``
instantiation (``src/NMCH/random/random.cu:12-13``): the state lives
in the loop carry instead of a global-memory state
array, and stream resume across ``compute()`` calls is a matrix jump
(epoch) instead of a state write-back.

Block contract mirrors ops/fe.py: 4 draws per block drive two
Box–Muller pairs for steps 2j and 2j+1 (odd-N tail masked), so draw
*count* per path per epoch is identical to the philox engine's.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..rng.mrg32k3a import mrg_state_at, mrg_step, u01_from_z
from ..rng.normal import boxmuller
from .fe import fe_consts, fe_two_steps


def _draw_normal4(s1, s2):
    """Four recurrence steps -> 4 N(0,1) draws (two BM pairs)."""
    z0, s1, s2 = mrg_step(s1, s2)
    z1, s1, s2 = mrg_step(s1, s2)
    z2, s1, s2 = mrg_step(s1, s2)
    z3, s1, s2 = mrg_step(s1, s2)
    g0, g1 = boxmuller(u01_from_z(z0), u01_from_z(z1))
    g2, g3 = boxmuller(u01_from_z(z2), u01_from_z(z3))
    return (g0, g1, g2, g3), s1, s2


def fe_terminal_mrg(params_vec, N: int, path_idx, epoch, seed: int):
    """(S_T, v_T) for (R, 128) path indices, MRG32k3a streams.

    seed: python int (static — selects the host-derived seed state);
    epoch may be traced (u32 scalar).
    """
    T, S_0, v_0, r, k, rho, theta, sigma = (params_vec[i]
                                            for i in range(8))
    dt = T / jnp.float32(N)
    sqrt_dt = jnp.sqrt(dt)
    sqrt_rho_c = jnp.sqrt(jnp.float32(1.0) - rho * rho)
    cst = fe_consts(r, k, theta, sigma, rho, sqrt_rho_c, dt, sqrt_dt)

    s1, s2 = mrg_state_at(seed, path_idx, epoch)
    S0 = jnp.full(path_idx.shape, 1.0, jnp.float32) * S_0
    v0 = jnp.full(path_idx.shape, 1.0, jnp.float32) * v_0

    n_blocks = (N + 1) // 2

    def body(j, carry):
        S, v, s1, s2 = carry
        (g0, g1, g2, g3), s1, s2 = _draw_normal4(s1, s2)
        S, v = fe_two_steps(S, v, g0, g1, g2, g3, j, cst, N)
        return (S, v, s1, s2)

    S, v, _, _ = lax.fori_loop(0, n_blocks, body, (S0, v0, s1, s2))
    return S, v


def fe_moments_mrg(params_vec, N: int, path_idx, epoch, seed: int):
    """Golden engine: (E[X], E[X^2]), X = (S_T - K)^+, K = S_0."""
    K = params_vec[1]
    S_T, _ = fe_terminal_mrg(params_vec, N, path_idx, epoch, seed)
    payoff = jnp.maximum(S_T - K, 0.0)
    n = jnp.float32(payoff.size)
    return jnp.sum(payoff) / n, jnp.sum(payoff * payoff) / n
