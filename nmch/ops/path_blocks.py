"""The shared shell of the fused path kernels (Pallas through Triton).

The reference runs one CUDA thread per path with the whole N-step
recurrence in registers inside one launch, then reduces each block in
shared memory and adds the block sum into two global floats with
``atomicAdd`` (``NMCH_FE.cu:74-78,296-300``).  The kernels here keep
that shape: one program per block of ``block`` paths, the recurrence in
registers for all N steps, one launch per pricing call.  Float atomics
would make the sum depend on the order blocks finish in, which breaks
the repo's determinism contract, so each program writes its own
(sum, sum of squares) pair and a second one-program kernel adds the
pairs in a fixed order:

* pass 1 (``block_payoff_sums``): program ``i`` simulates paths
  ``base + i*block + [0, block)`` and stores ``f32[2]`` partials; paths
  past ``n_paths`` (a ragged last block) are masked to zero;
* pass 2 (``fixed_order_sum``): the partials, zero-padded to a
  ``(rows, 256)`` power-of-two array, are summed row by row with a
  per-lane Kahan compensation, then the 128 lanes of each moment are
  added by a fixed-shape tree.  Same inputs, same bits, every run.

The path body is any function ``body(params, k0, k1, epoch, path_lo)``
-> per-path payoff of ``path_lo``'s shape, where ``params`` is the
8-tuple of scalars (T, S_0, v_0, r, k, rho, theta, sigma).  The golden
XLA engines call the same step functions on a (R, 128) layout, so
kernel and golden engine draw bitwise-identical words.

``interpret=True`` runs both passes through the Pallas interpreter
(CPU tests); otherwise they are compiled by Triton for the GPU.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

SUM_LANES = 256       # pass-2 row width: 128 (sum, sum^2) pairs


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _compiler_params(num_warps: int):
    # one pipeline stage: the kernels load two small parameter vectors
    # and loop in registers; there are no tile loads to pipeline
    return pl_triton.CompilerParams(num_warps=num_warps, num_stages=1)


def _paths_kernel(pv_ref, sc_ref, out_ref, *, body, block: int,
                  n_paths: int):
    """Program i: one block of paths -> out_ref = (sum X, sum X^2)."""
    i = pl.program_id(0)
    params = tuple(pv_ref[j] for j in range(8))
    k0 = sc_ref[0]
    k1 = sc_ref[1]
    epoch = sc_ref[2]
    local = (lax.broadcasted_iota(jnp.uint32, (block,), 0)
             + i.astype(jnp.uint32) * np.uint32(block))
    payoff = body(params, k0, k1, epoch, sc_ref[3] + local)
    if n_paths % block:
        payoff = jnp.where(local < np.uint32(n_paths), payoff,
                           np.float32(0.0))
    s = jnp.sum(payoff)
    s2 = jnp.sum(payoff * payoff)
    slot = lax.broadcasted_iota(jnp.int32, (2,), 0)
    out_ref[...] = jnp.where(slot == 0, s, s2)


def _fixed_order_sum_kernel(p_ref, out_ref, *, rows: int):
    """Kahan over the rows of the (rows, 256) partials, then a tree
    over the 128 lanes of each moment."""
    def step(r, carry):
        acc, comp = carry
        y = p_ref[r, :] - comp
        t = acc + y
        return t, (t - acc) - y

    zero = jnp.zeros((SUM_LANES,), jnp.float32)
    acc, comp = lax.fori_loop(0, rows, step, (zero, zero))
    tot = acc - comp
    lane = lax.broadcasted_iota(jnp.int32, (SUM_LANES,), 0)
    even = (lane & 1) == 0
    s = jnp.sum(jnp.where(even, tot, np.float32(0.0)))
    s2 = jnp.sum(jnp.where(even, np.float32(0.0), tot))
    slot = lax.broadcasted_iota(jnp.int32, (2,), 0)
    out_ref[...] = jnp.where(slot == 0, s, s2)


def fixed_order_sum(partials, *, interpret: bool = False):
    """f32[G, 2] per-block partials -> f32[2] totals, in a fixed order."""
    g = partials.shape[0]
    per_row = SUM_LANES // 2
    rows = _next_pow2(-(-g // per_row))
    flat = jnp.pad(partials.reshape(-1), (0, rows * SUM_LANES - 2 * g))
    return pl.pallas_call(
        functools.partial(_fixed_order_sum_kernel, rows=rows),
        out_shape=jax.ShapeDtypeStruct((2,), jnp.float32),
        grid=(1,),
        in_specs=[pl.BlockSpec((rows, SUM_LANES), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((2,), lambda i: (0,)),
        compiler_params=_compiler_params(4),
        backend="triton",
        interpret=interpret,
        name="nmch_fixed_order_sum",
    )(flat.reshape(rows, SUM_LANES))


def block_payoff_sums(body, params_vec, seed_words, epoch, base_path, *,
                      n_paths: int, block: int, num_warps: int,
                      interpret: bool, name: str):
    """Pass 1 + pass 2: (sum X, sum X^2) over paths
    ``base_path + [0, n_paths)`` as f32[2]."""
    if block & (block - 1) or block < 32:
        raise ValueError(f"block={block} must be a power of two >= 32")
    grid = -(-n_paths // block)
    sc = jnp.stack([
        seed_words[0].astype(jnp.uint32),
        seed_words[1].astype(jnp.uint32),
        jnp.asarray(epoch, jnp.uint32),
        jnp.asarray(base_path, jnp.uint32),
    ])
    partials = pl.pallas_call(
        functools.partial(_paths_kernel, body=body, block=block,
                          n_paths=n_paths),
        out_shape=jax.ShapeDtypeStruct((grid, 2), jnp.float32),
        grid=(grid,),
        in_specs=[pl.BlockSpec((8,), lambda i: (0,)),
                  pl.BlockSpec((4,), lambda i: (0,))],
        out_specs=pl.BlockSpec((None, 2), lambda i: (i, 0)),
        compiler_params=_compiler_params(num_warps),
        backend="triton",
        interpret=interpret,
        name=name,
    )(params_vec.astype(jnp.float32), sc)
    return fixed_order_sum(partials, interpret=interpret)
