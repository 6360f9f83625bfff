"""Fused Broadie–Kaya "Exact Method" kernel (Pallas through Triton).

The reference's EM kernel ladder (``src/NMCH/methods/NMCH_EM.cu:63-369``)
runs one thread per path through N exact variance transitions, each a
Poisson draw and a Gamma draw by rejection, with warps diverging in the
rejection loops (``NMCH_EM.cu:327``).  Here one program simulates a
block of paths (ops/path_blocks.py) with v_t and the integrated
variance in registers for all N steps.  The rejection samplers are the
golden engine's own code (ops/em.py::em_terminal_core,
ops/sampling.py): masked rounds that loop inside the program until no
lane of the block is still rejecting — the warp divergence of the
reference, block-wide — instead of one XLA while-loop iteration (a
launch and a host-read predicate) per round.  Draw counts are
lane-local, so kernel and golden engine draw identical words.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .em import em_terminal_core, em_path_law, em_conditional_payoff
from .path_blocks import block_payoff_sums

# paths per program and warps, from the launch ladder on the H100
# (benchmarks/triton_ladder.py, PERF.md): small blocks keep the
# block-wide rejection rounds short
EM_BLOCK = 64
EM_WARPS = 2


def em_payoff(params, N: int, path_lo, epoch, k0, k1, *, rng: str,
              conditional: bool, poisson_cut: float | None):
    """Per-path EM payoff (sampled or conditional) for one block."""
    path_hi = jnp.zeros_like(path_lo)
    if conditional:
        m, sig_eff, _, _, _ = em_path_law(params, N, path_lo, path_hi,
                                          epoch, k0, k1, rng=rng,
                                          poisson_cut=poisson_cut)
        return em_conditional_payoff(m, sig_eff, params[1])
    S_T, _, _, _ = em_terminal_core(params, N, path_lo, path_hi, epoch,
                                    k0, k1, rng=rng,
                                    poisson_cut=poisson_cut)
    return jnp.maximum(S_T - params[1], 0.0)     # ATM strike K = S_0


@functools.partial(jax.jit, static_argnames=("N", "n_paths", "interpret",
                                             "rng", "conditional",
                                             "poisson_cut", "block",
                                             "num_warps"))
def em_moments_pallas(params_vec, seed_words, epoch, base_path, *,
                      N: int, n_paths: int, interpret: bool = False,
                      rng: str = "philox", conditional: bool = False,
                      poisson_cut: float | None = None,
                      block: int = EM_BLOCK, num_warps: int = EM_WARPS):
    """(E[X], E[X^2]) over n_paths exact-scheme paths.

    rng: "philox" (default, curand-family parity) or "threefry4" (the
    fast reproducible generator, rng/threefry4.py) — both engines draw
    identically (lane-local counters, ops/sampling.py).
    poisson_cut: see ops/em.py::em_path_law (EM speed/accuracy knob)."""
    if rng not in ("philox", "threefry4"):
        raise ValueError(f"unknown rng {rng!r} for the EM kernel "
                         f"(expected 'philox' or 'threefry4')")
    if n_paths % 128:
        raise ValueError(f"n_paths={n_paths} must be a multiple of 128")

    def body(params, k0, k1, epoch_, path_lo):
        return em_payoff(params, N, path_lo, epoch_, k0, k1, rng=rng,
                         conditional=conditional, poisson_cut=poisson_cut)

    name = f"nmch_em_{'cond' if conditional else 'plain'}_{rng}"
    s = block_payoff_sums(body, params_vec, seed_words, epoch, base_path,
                          n_paths=n_paths, block=block,
                          num_warps=num_warps, interpret=interpret,
                          name=name)
    n = jnp.float32(n_paths)
    return s[0] / n, s[1] / n
