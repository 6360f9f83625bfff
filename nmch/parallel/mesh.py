"""Multi-device path-sharded pricing over a 1-D mesh of GPUs.

The reference is single-GPU: its only "cross-worker" communication is
intra-device (shared-memory reductions + atomicAdd, SURVEY.md §2).
This module is the scale-out the reference lacks: Monte Carlo paths
are data-parallel, so we shard the path axis over a 1-D
``jax.sharding.Mesh`` with ``shard_map``; each device runs the fused
kernel (or golden engine) on its shard with a *disjoint stream range*
(base_path offset = device_index * paths_per_device, so the sharded
run draws exactly the same per-path randomness as a single-device
run), and two scalars (sum payoff, sum payoff^2) are combined with
``jax.lax.psum`` — over NVLink between GPUs, the deterministic
analogue of the reference's float atomicAdd (``NMCH_FE.cu:74-78``),
cf. SURVEY.md §5.

Scaling model: zero cross-device traffic during simulation and one
2-float psum at the end make throughput linear in devices by
construction, so the 2^26-path BASELINE.json config is
paths_per_device = 2^26/n_devices with identical statistics to the
single-device run.  Correctness is tested on virtual CPU-device meshes
(tests/test_parallel.py) and a 2-process run (test_multihost.py);
``chip_smoke.py --chips 4`` measures it on four GPUs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.fe import fe_moments_scan, path_index_grid
from ..ops.fe_pallas import fe_moments_pallas
from ..ops.em import em_moments_scan
from ..ops.em_pallas import em_moments_pallas

PATH_AXIS = "paths"


def make_mesh(devices=None, axis_name: str = PATH_AXIS) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    import numpy as np
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def sharded_moments(mesh: Mesh, params_vec, seed: int, epoch, *,
                    N: int, n_paths: int, method: str = "fe",
                    engine: str = "pallas", interpret: bool = False,
                    rng: str = "philox", rot: int = 1,
                    conditional: bool = False,
                    scramble: str = "auto",
                    poisson_cut: float | None = None):
    """(E[X], E[X^2]) over n_paths sharded across the mesh's path axis.

    Every device simulates n_paths/n_devices paths whose stream indices
    are offset by its mesh position, then the two partial sums ride one
    psum.  Identical results to a single-device run with the same
    (seed, epoch) up to float32 summation order — sharding changes the
    schedule, not the math.

    poisson_cut (EM only): None resolves to NMCH_EM's default (the
    measured fast cut, methods/em.py) so a default sharded EM run
    draws the SAME randomness as a default single-chip NMCH_EM run —
    the ops layer's own None would mean the strict curand cut 4000
    and silently break that parity; pass 4000.0
    explicitly for curand-parity switching.
    """
    n_dev = mesh.devices.size
    if n_paths % (n_dev * 128):
        raise ValueError(
            f"n_paths={n_paths} must be a multiple of 128*n_devices"
            f"={128 * n_dev}")
    if method == "em" and rng not in ("philox", "threefry4",
                                      "mrg32k3a", "xorwow"):
        raise ValueError("method='em' supports rng='philox'/'threefry4'/"
                         "'mrg32k3a'/'xorwow'")
    if rng in ("mrg32k3a", "xorwow"):
        # the stateful parity families shard exactly like the counter
        # rngs: their matrix skip-ahead gives random access to any
        # (path, epoch), so disjoint per-chip base-path ranges draw the
        # same per-path streams as a single-chip run, for FE and EM
        # (the samplers advance the carried state lane-locally,
        # ops/sampling.py)
        if engine != "scan":
            raise ValueError(f"rng={rng!r} shards with engine='scan' "
                             f"only (the stateful recurrences live in "
                             f"the scan carry)")
        if rot != 1:
            raise ValueError(f"rng={rng!r} has no rot variants")
        if n_paths >= (1 << 31):
            raise ValueError(f"rng={rng!r} supports n_paths < 2^31 "
                             f"(path-jump bit range)")
        from ..rng.streams import stateful_max_epoch
        bound = stateful_max_epoch(rng)
        if int(epoch) >= bound:
            raise ValueError(f"epoch={int(epoch)} exceeds the {rng} "
                             f"stream layout's {bound} epochs per "
                             f"path block")
    if scramble not in ("auto", "lms-shift") and engine != "qmc":
        raise ValueError("scramble= applies to engine='qmc' only")
    if scramble == "auto":
        # measured crossover (RESULTS.md QMC attribution): shared
        # LMS below ~2^21 points, independent Owen scrambles above
        scramble = ("owen" if n_paths >= (1 << 21) else "lms-shift")
    if engine not in ("pallas", "scan", "qmc"):
        raise ValueError(
            f"unknown engine {engine!r} for sharded_moments (expected "
            "'pallas', 'scan' or 'qmc')")
    if engine == "qmc" and method != "fe":
        raise ValueError("engine='qmc' is FE-only")
    if engine == "qmc" and rot != 1:
        raise ValueError("engine='qmc' has no rot variants")
    if method == "em" and rot != 1:
        raise ValueError("rot is FE-only")
    if method == "fe" and conditional:
        raise ValueError("conditional is EM-only")
    if poisson_cut is not None and method != "em":
        raise ValueError("poisson_cut is EM-only")
    if method == "em" and poisson_cut is None:
        from ..ops.em import FAST_POISSON_CUT
        poisson_cut = FAST_POISSON_CUT   # NMCH_EM's default (docstring)
    from ..rng.philox import split_seed
    k0, k1 = split_seed(seed)
    seed_words = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    # the seed enters the traced program only where it is static: the
    # QMC point randomization and the stateful skip-ahead
    static_seed = (seed if engine == "qmc" or rng in ("mrg32k3a", "xorwow")
                   else None)
    fn = _sharded_fn(mesh, N=N, n_paths=n_paths, method=method,
                     engine=engine, interpret=interpret, rng=rng, rot=rot,
                     conditional=conditional, scramble=scramble,
                     poisson_cut=poisson_cut, seed=static_seed)
    return fn(params_vec, seed_words, jnp.uint32(epoch))


@functools.lru_cache(maxsize=64)
def _sharded_fn(mesh: Mesh, *, N: int, n_paths: int, method: str,
                engine: str, interpret: bool, rng: str, rot: int,
                conditional: bool, scramble: str,
                poisson_cut: float | None, seed: int | None):
    """The jitted shard_map program for one validated configuration,
    built once so repeated calls reuse its compilation."""
    n_dev = mesh.devices.size
    per_chip = n_paths // n_dev

    if engine == "qmc":
        # Sobol' POINT-INDEX ranges are sharded: device c simulates
        # points [c*count, (c+1)*count) of every shift replicate —
        # bit-identical slices of the single-device point set
        # (rng/sobol.py hilo base offset) — and the (n_shifts,)
        # per-replicate payoff sums ride one psum.  Requires
        # n_paths/n_shifts divisible by n_dev (and the hilo block).
        from ..ops.fe_qmc import (
            qmc_replicate_payoff_sums, rqmc_moments_from_means,
            DEFAULT_N_SHIFTS,
        )
        from ..rng.philox import split_seed
        k0, k1 = split_seed(seed)
        n_shifts = DEFAULT_N_SHIFTS
        n = n_paths // n_shifts
        if n % n_dev:
            raise ValueError(f"n_paths/n_shifts={n} must be divisible "
                             f"by n_devices={n_dev}")
        count = n // n_dev

        def qmc_shard_fn(pv, sw, ep):
            idx = jax.lax.axis_index(PATH_AXIS)
            base = idx.astype(jnp.uint32) * jnp.uint32(count)
            sums = qmc_replicate_payoff_sums(
                pv, ep, k0, k1, N=N, count=count, n_shifts=n_shifts,
                scramble=scramble, base=base)
            means = jax.lax.psum(sums, PATH_AXIS) / jnp.float32(n)
            return rqmc_moments_from_means(means, n_paths, n_shifts)

        return jax.jit(jax.shard_map(
            qmc_shard_fn, mesh=mesh, in_specs=(P(), P(), P()),
            out_specs=(P(), P()), check_vma=False))

    def shard_fn(pv, sw, ep):
        idx = jax.lax.axis_index(PATH_AXIS)
        base = (idx.astype(jnp.uint32) * jnp.uint32(per_chip))
        if engine == "pallas":
            if method == "fe":
                m, m2 = fe_moments_pallas(pv, sw, ep, base, N=N,
                                          n_paths=per_chip, rng=rng,
                                          rot=rot, interpret=interpret)
            else:
                m, m2 = em_moments_pallas(pv, sw, ep, base, N=N,
                                          n_paths=per_chip, rng=rng,
                                          conditional=conditional,
                                          poisson_cut=poisson_cut,
                                          interpret=interpret)
        else:
            pidx = path_index_grid(per_chip) + base
            if method == "fe" and rng in ("mrg32k3a", "xorwow"):
                if rng == "mrg32k3a":
                    from ..ops.fe_mrg import fe_moments_mrg as stateful
                else:
                    from ..ops.fe_xorwow import fe_moments_xorwow \
                        as stateful
                m, m2 = stateful(pv, N, pidx, ep, seed)
            elif method == "fe" and rot > 1:
                from ..ops.fe import fe_moments_rot_scan
                m, m2 = fe_moments_rot_scan(pv, N, pidx, ep, sw[0], sw[1],
                                            rng=rng, rot=rot)
            elif method == "fe":
                m, m2 = fe_moments_scan(pv, N, pidx, ep, sw[0], sw[1],
                                        rng=rng)
            else:
                m, m2 = em_moments_scan(
                    pv, N, pidx, ep, sw[0], sw[1], rng=rng,
                    conditional=conditional, poisson_cut=poisson_cut,
                    seed=seed if rng in ("mrg32k3a", "xorwow") else None)
        # per-chip means -> global means (equal shard sizes)
        nd = jnp.float32(n_dev)
        return (jax.lax.psum(m, PATH_AXIS) / nd,
                jax.lax.psum(m2, PATH_AXIS) / nd)

    # check_vma=False: pallas_call outputs carry no varying-manual-axes
    # metadata (jax 0.9), so the vma type-checker cannot see through the
    # kernels; correctness is covered by the sharded-vs-single tests.
    return jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    ))
