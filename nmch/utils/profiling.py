"""Profiling/tracing utilities — the reference's aux subsystem §5.

The reference ships cudaEvent timers around every init/compute plus
offline Nsight Systems reports (``profilings/``).  Equivalents here:

* wall timing (utils/timing.py) — per-run numbers already baked into
  every SimResult;
* ``trace(logdir)`` — a context manager around ``jax.profiler`` that
  captures a TensorBoard-loadable device trace (the nsys analogue);
* ``variant_ladder(...)`` — times every (method, engine, rng) variant
  under one config, the analogue of the reference's kernel-ladder
  comparisons recorded in profilings/timings.txt and the NMCH_FE.hpp
  header comments.
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace into ``logdir``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _time_queued(fn, reps: int) -> float:
    """Mean ms/run over ``reps`` dispatches after a discarded warm-up."""
    jax.block_until_ready(fn(0))       # compile + warm-up, discarded
    t0 = time.perf_counter()
    outs = [fn(i + 1) for i in range(reps)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / reps * 1e3


def variant_ladder(n_paths: int = 1 << 18, N: int = 1000, seed: int = 1234,
                   reps: int = 5, include_em: bool = True,
                   include_fe: bool = True,
                   interpret: bool | None = None):
    """Time every engine variant; returns a list of dict rows.

    The analogue of the reference's K1/K2/K3 x memory-mode ladder
    (profilings/timings.txt) — our ladder is engine x rng.
    """
    from ..params import HestonParams
    from ..rng.philox import split_seed
    from ..ops.fe import fe_moments_scan, path_index_grid
    from ..ops.fe_pallas import fe_moments_pallas
    from ..ops.em_pallas import em_moments_pallas

    if interpret is None:
        from .backend import kernel_interpret
        interpret = kernel_interpret()
    params = HestonParams()
    pv = params.as_array()
    k0, k1 = split_seed(seed)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    pidx = path_index_grid(n_paths)

    variants = []
    if include_fe:
        variants += [
            ("fe", "pallas", "threefry", lambda e: fe_moments_pallas(
                pv, sw, jnp.uint32(e), jnp.uint32(0), N=N, n_paths=n_paths,
                rng="threefry", interpret=interpret)),
            ("fe", "pallas", "threefry4", lambda e: fe_moments_pallas(
                pv, sw, jnp.uint32(e), jnp.uint32(0), N=N, n_paths=n_paths,
                rng="threefry4", interpret=interpret)),
            ("fe", "pallas", "philox", lambda e: fe_moments_pallas(
                pv, sw, jnp.uint32(e), jnp.uint32(0), N=N, n_paths=n_paths,
                rng="philox", interpret=interpret)),
            ("fe", "scan", "philox", lambda e: jax.jit(
                fe_moments_scan, static_argnums=1)(pv, N, pidx,
                                                   jnp.uint32(e), k0, k1)),
        ]

    if include_em:
        variants.append(("em", "pallas", "philox", lambda e:
                         em_moments_pallas(pv, sw, jnp.uint32(e),
                                           jnp.uint32(0), N=N,
                                           n_paths=n_paths,
                                           interpret=interpret)))

    rows = []
    for method, engine, rng, fn in variants:
        ms = _time_queued(fn, reps)
        rows.append({
            "method": method, "engine": engine, "rng": rng,
            "n_paths": n_paths, "N": N, "ms": ms,
            "gpathsteps_per_s": n_paths * N / ms / 1e6,
        })
    return rows
