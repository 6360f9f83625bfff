"""Fused Forward-Euler kernel (Pallas through Triton).

The reference's FE kernel ladder (``src/NMCH/methods/NMCH_FE.cu:6-307``)
runs one thread per path with the N-step recurrence in registers and
curand states in memory.  Here:

* one program per block of paths (ops/path_blocks.py), S and v for all
  ``rot`` rotation copies held in registers for all N steps — no
  per-step round trip through device memory, which is what the XLA
  scan engine (ops/fe.py) pays at every counter block;
* curand states -> stateless counter-based streams (Philox4x32-10,
  Threefry): a draw is a pure function of (key, block, epoch, path), so
  nothing is loaded or stored per path;
* blockReduceSum + atomicAdd -> per-program partial sums and a
  fixed-order second pass (deterministic, unlike float atomics);
* curand_normal4 -> one counter block = 4 words = two Box–Muller pairs
  = two time steps, exactly as the golden engine consumes them
  (ops/fe.py::fe_group_payoff is the shared body), so kernel and scan
  draw bitwise-identical words.

Parameters and stream words are runtime inputs, so parameter sweeps
reuse one compilation, like the reference's persistent kernel across
``set_k/set_theta/set_sigma`` calls.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from .fe import fe_group_payoff, make_draw4
from .path_blocks import block_payoff_sums, _compiler_params

COUNTER_RNGS = ("philox", "threefry", "threefry4")

# (paths per program, warps) per rot, from the launch ladder on the
# H100 (benchmarks/triton_ladder.py, PERF.md); the spread across the
# ladder is ~5%.
_LAUNCH = {1: (256, 4), 2: (256, 4), 4: (256, 8), 8: (512, 8)}


@functools.partial(jax.jit, static_argnames=("N", "n_paths", "rng",
                                             "antithetic", "rot",
                                             "interpret", "block",
                                             "num_warps"))
def fe_moments_pallas(params_vec, seed_words, epoch, base_path, *,
                      N: int, n_paths: int, rng: str = "philox",
                      antithetic: bool = False, rot: int | None = None,
                      interpret: bool = False, block: int | None = None,
                      num_warps: int | None = None):
    """(E[X], E[X^2]) over n_paths FE path groups via the fused kernel.

    seed_words: uint32[2]; epoch/base_path: uint32 scalars (traced).
    base_path offsets the per-path stream indices — used by the
    multi-chip sharding so every chip owns a disjoint stream range.

    rot in {1, 2, 4, 8}: rotation-coupled copies per stream (see
    ops/fe.py::rotation_images) — rot=2 is antithetic variates (the
    ``antithetic`` flag is a synonym), rot=4 adds quarter-turn angle
    stratification.  Moments are over the n_paths *group means*; the
    kernel simulates rot * n_paths paths' worth of Euler steps.
    block / num_warps override the launch configuration (_LAUNCH).
    """
    if rot is None:
        rot = 2 if antithetic else 1
    elif antithetic and rot == 1:
        raise ValueError("antithetic=True contradicts rot=1 "
                         "(antithetic IS rot=2; pass one of them)")
    if rot not in (1, 2, 4, 8):
        raise ValueError(f"rot must be 1, 2, 4 or 8, got {rot}")
    if rng not in COUNTER_RNGS:
        raise ValueError(f"unknown rng {rng!r} (expected 'philox', "
                         f"'threefry' or 'threefry4')")
    if n_paths % 128:
        raise ValueError(f"n_paths={n_paths} must be a multiple of 128")
    dflt_block, dflt_warps = _LAUNCH[rot]

    def body(params, k0, k1, epoch_, path_lo):
        return fe_group_payoff(params, N, path_lo, epoch_, k0, k1,
                               rng=rng, rot=rot)

    s = block_payoff_sums(body, params_vec, seed_words, epoch, base_path,
                          n_paths=n_paths, block=block or dflt_block,
                          num_warps=num_warps or dflt_warps,
                          interpret=interpret,
                          name=f"nmch_fe_rot{rot}_{rng}")
    n = jnp.float32(n_paths)
    return s[0] / n, s[1] / n


def _draw_words_kernel(sc_ref, w0_ref, w1_ref, w2_ref, w3_ref, *, rng: str,
                       block: int):
    i = pl.program_id(0)
    path_lo = (lax.broadcasted_iota(jnp.uint32, (block,), 0)
               + i.astype(jnp.uint32) * np.uint32(block))
    draw = make_draw4(rng, path_lo, jnp.zeros_like(path_lo), sc_ref[2],
                      sc_ref[0], sc_ref[1])
    words = draw(sc_ref[3])
    for ref, w in zip((w0_ref, w1_ref, w2_ref, w3_ref), words):
        ref[...] = w


@functools.partial(jax.jit, static_argnames=("rng", "n_paths",
                                             "interpret", "block"))
def draw_words_pallas(seed_words, epoch, block_idx, *, rng: str,
                      n_paths: int, interpret: bool = False,
                      block: int = 256):
    """The 4 draw words of counter block ``block_idx`` for paths
    [0, n_paths), generated inside a kernel by the same code the FE
    kernel runs — compared bitwise with ops/fe.py::make_draw4 under
    XLA to pin that both compilers produce the same integer stream."""
    if n_paths % block:
        raise ValueError(f"n_paths={n_paths} must be a multiple of "
                         f"block={block}")
    sc = jnp.stack([seed_words[0].astype(jnp.uint32),
                    seed_words[1].astype(jnp.uint32),
                    jnp.asarray(epoch, jnp.uint32),
                    jnp.asarray(block_idx, jnp.uint32)])
    spec = pl.BlockSpec((block,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(_draw_words_kernel, rng=rng, block=block),
        out_shape=[jax.ShapeDtypeStruct((n_paths,), jnp.uint32)] * 4,
        grid=(n_paths // block,),
        in_specs=[pl.BlockSpec((4,), lambda i: (0,))],
        out_specs=[spec] * 4,
        compiler_params=_compiler_params(4),
        backend="triton",
        interpret=interpret,
        name=f"nmch_draw_words_{rng}",
    )(sc)
