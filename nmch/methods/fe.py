"""Forward-Euler pricing method (reference L4: NMCH_FE_* family).

The reference's kernel-variant ladder (K1 shared-mem tree reduction,
K2 warp shuffle, K2_PHILOX normal4, K3 states-in-shared-memory —
``include/NMCH/methods/NMCH_FE.hpp``) and its memory-management ladder
(MM/PgM/PiM) map onto a small set of interchangeable *engines*:

    engine="pallas" (default) — the fused kernel (ops/fe_pallas.py,
                                Pallas through Triton), the analogue
                                of K3: paths in registers for all N
                                steps, one launch per compute();
    engine="scan"             — the pure-JAX golden model (ops/fe.py),
                                the analogue of the K1 baseline and the
                                oracle for kernel tests;
    engine="qmc"              — scrambled Sobol' + Brownian bridge
                                (ops/fe_qmc.py), beyond the reference;

and *rng* backends:

    rng="philox" (default)    — counter-based Philox4x32-10 (what the
                                reference's default kernels use), same
                                bitstream in both engines;
    rng="threefry"/"threefry4" — multiply-free counter generators,
                                same bitstream in both engines;
    rng="mrg32k3a"            — L'Ecuyer combined MRG with matrix
                                skip-ahead — the reference's third
                                curand family (random.cu:12-13,
                                rng/mrg32k3a.py);
    rng="xorwow"              — xorshift+Weyl with GF(2)^160 matrix
                                skip-ahead — the reference's *default*
                                curand family (random.cu:6-8,
                                rng/xorwow.py).

    The stateful pair runs on the scan engine, which carries the
    recurrence state through the step loop (ops/fe_xorwow.py,
    ops/fe_mrg.py) with the (seed, path, epoch) skip-ahead layout.

The MM/PgM/PiM memory ladder has no counterpart (results live in
device memory and stream back as two floats) — documented rather than
faked, per SURVEY.md §7.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..params import HestonParams, SimConfig
from ..results import SimResult
from ..rng.streams import PathStreams
from ..ops.fe import (
    fe_moments_scan, fe_moments_rot_scan, path_index_grid,
)
from ..ops.fe_pallas import fe_moments_pallas
from ..ops.fe_qmc import fe_moments_qmc
from ..utils.timing import Timer
from ..utils.backend import kernel_interpret
from .base import NMCH

# module-level jit wrappers so every compute() call hits the same
# trace cache (a fresh jax.jit(...) per call would retrace each time)
_scan_jit = jax.jit(fe_moments_scan, static_argnums=(1, 6))
_scan_rot_jit = jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))


@functools.lru_cache(maxsize=2)
def _stateful_jitted(rng: str):
    # lazy: the family's jump tables are only built when it is actually
    # used; cached so every compute() hits the same trace cache (a
    # fresh jax.jit per call would retrace each time)
    if rng == "mrg32k3a":
        from ..ops.fe_mrg import fe_moments_mrg as fn
    else:
        from ..ops.fe_xorwow import fe_moments_xorwow as fn
    return jax.jit(fn, static_argnums=(1, 4))


def _stateful_jit(rng, pv, N, pidx, epoch, seed):
    from ..rng.streams import stateful_max_epoch
    bound = stateful_max_epoch(rng)
    if int(epoch) >= bound:
        raise ValueError(
            f"epoch={int(epoch)} exceeds the {rng} stream layout's "
            f"{bound} epochs per path block (rng/{rng}.py docstring)")
    return _stateful_jitted(rng)(pv, N, pidx, epoch, seed)


class NMCH_FE(NMCH):
    """Euler-scheme pricer with the reference's 5-step lifecycle."""

    method_name = "FORWARD-EULER"

    def __init__(self, cfg: SimConfig, params: HestonParams,
                 engine: str = "pallas", rng: str = "philox",
                 antithetic: bool = False, rot: int | None = None,
                 interpret: bool | None = None,
                 scramble: str = "auto"):
        """rot in {1, 2, 4, 8}: rotation-coupled copies per lane (variance
        reduction beyond the reference, ops/fe.py::rotation_images).
        rot=2 == antithetic=True (a +/-G pair per lane); rot=4 adds
        quarter-turn angle stratification.  n_paths counts GROUPS; each
        group consumes one plain path's randomness and simulates rot
        paths."""
        super().__init__(cfg, params)
        if engine not in ("pallas", "scan", "qmc"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "qmc":
            if rot not in (None, 1) or antithetic:
                raise ValueError("engine='qmc' has no rot/antithetic "
                                 "variants (the point set is already "
                                 "variance-optimal)")
            if rng != "philox":
                raise ValueError("engine='qmc' uses Sobol' points with "
                                 "Philox digital shifts; rng must stay "
                                 "'philox'")
            if scramble not in ("auto", "lms-shift", "shift", "owen"):
                raise ValueError(f"unknown scramble {scramble!r}")
            if scramble == "auto":
                # measured crossover (benchmarks/RESULTS.md QMC
                # attribution): shared-LMS + shifts is marginally
                # better below ~2^21 points, but its CI decay stalls
                # at ~n^-0.4 beyond; independent per-replicate Owen
                # scrambles keep the n^-0.5..-0.64 trend going
                # (77x+ error-matched at 2^22-2^24 vs 33-48x) for
                # ~6% extra generation cost
                scramble = ("owen" if cfg.n_paths >= (1 << 21)
                            else "lms-shift")
        elif scramble not in ("auto", "lms-shift"):
            raise ValueError("scramble= applies to engine='qmc' only")
        else:
            scramble = "lms-shift"
        self.scramble = scramble
        if rng not in ("philox", "threefry", "threefry4",
                       "mrg32k3a", "xorwow"):
            raise ValueError(f"unknown rng {rng!r}")
        if rng in ("mrg32k3a", "xorwow"):
            # stateful recurrences: the scan engine carries the state
            # through the step loop; the fused kernel draws from
            # counter streams only
            if engine != "scan":
                raise ValueError(f"rng={rng!r} requires engine='scan'")
            if rot not in (None, 1) or antithetic:
                raise ValueError(f"rng={rng!r} has no rot/antithetic "
                                 "variants (parity family; use the "
                                 "counter rngs for rotation sampling)")
            if cfg.n_paths >= (1 << 31):
                # the skip-ahead jump tables cover path-index bits
                # 0..30 (exponents 67..97); larger indices would alias
                # onto lower streams (ADVICE r3)
                raise ValueError(
                    f"rng={rng!r} supports n_paths < 2^31 (stream "
                    f"layout, rng/mrg32k3a.py docstring); got "
                    f"{cfg.n_paths}")
        if rot is None:
            rot = 2 if antithetic else 1
        elif antithetic and rot == 1:
            raise ValueError("antithetic=True contradicts rot=1 "
                             "(antithetic IS rot=2; pass one of them)")
        if rot not in (1, 2, 4, 8):
            raise ValueError(f"rot must be 1, 2, 4 or 8, got {rot}")
        self.engine = engine
        self.rng = rng
        self.rot = rot
        self.antithetic = rot >= 2
        # compiled on a GPU, interpreted on a CPU that was asked for
        # (utils/backend.py); only the fused kernel needs the choice
        if interpret is None:
            interpret = engine == "pallas" and kernel_interpret()
        self.interpret = interpret

    # -- lifecycle --------------------------------------------------------
    def init(self, seed: int | None = None) -> None:
        """Create the persistent per-path streams (reference init(seed):
        alloc + curand_init grid, NMCH_FE.cu:368-386). Counter-based RNG
        needs no state arrays, so this is O(1). The one-off compile cost
        lands in the FIRST compute() call instead — discard it like the
        reference's warm-up (exploration.cu:65-67); the CLI does this
        automatically unless --no-warmup.
        """
        seed = self.cfg.seed if seed is None else seed
        with Timer() as t:
            self.streams = PathStreams(seed=seed, n_paths=self.cfg.n_paths)
        self.init_time_ms = t.ms

    def _moments(self, epoch: int):
        pv = self.params.as_array()
        k0, k1 = self.streams.key_words
        if self.engine == "qmc":
            return fe_moments_qmc(pv, jnp.uint32(epoch), k0, k1,
                                  N=self.cfg.N, n_paths=self.cfg.n_paths,
                                  scramble=self.scramble)
        if self.engine == "pallas":
            sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
            return fe_moments_pallas(
                pv, sw, jnp.uint32(epoch), jnp.uint32(0),
                N=self.cfg.N, n_paths=self.cfg.n_paths,
                rng=self.rng, rot=self.rot,
                interpret=self.interpret)
        pidx = path_index_grid(self.cfg.n_paths)
        if self.rng in ("mrg32k3a", "xorwow"):
            return _stateful_jit(self.rng, pv, self.cfg.N, pidx,
                                 jnp.uint32(epoch), self.streams.seed)
        return self._scan_moments(pv, epoch, k0, k1, pidx)

    def _scan_moments(self, pv, epoch: int, k0, k1, pidx):
        if self.rot > 1:
            return _scan_rot_jit(pv, self.cfg.N, pidx, jnp.uint32(epoch),
                                 k0, k1, self.rng, self.rot)
        return _scan_jit(pv, self.cfg.N, pidx, jnp.uint32(epoch), k0, k1,
                         self.rng)

    def greeks(self, fix_strike: bool = False) -> dict:
        """(price, sensitivities): pathwise Greeks by jax.grad through
        the simulator (ops/greeks.py) — a capability beyond the CUDA
        reference.  Consumes one epoch (same stream contract as
        compute()); works with the counter rngs on the scan-engine
        math regardless of this object's engine= setting.

        Returns {"price": float, "delta": dP/dS_0, ...} over
        ops/greeks.py::PARAM_NAMES.  fix_strike=True freezes K for the
        classic fixed-strike delta instead of the reference's K = S_0
        coupling."""
        if self.streams is None:
            raise RuntimeError("call init(seed) before greeks()")
        if self.rng not in ("philox", "threefry", "threefry4"):
            raise ValueError("greeks() needs a counter rng "
                             "(philox/threefry/threefry4)")
        from ..ops.greeks import fe_price_and_greeks
        epoch = self.streams.next_epoch()
        k0, k1 = self.streams.key_words
        price, grads = fe_price_and_greeks(
            self.params.as_array(), jnp.uint32(epoch), k0, k1,
            N=self.cfg.N, n_paths=self.cfg.n_paths, rng=self.rng,
            fix_strike=fix_strike)
        vals = jax.device_get((price, grads))
        return {"price": float(vals[0]),
                **{k: float(v) for k, v in vals[1].items()}}

    def compute(self) -> SimResult:
        if self.streams is None:
            raise RuntimeError("call init(seed) before compute()")
        epoch = self.streams.next_epoch()
        with Timer() as t:
            m, m2 = self._moments(epoch)
            # one batched device fetch for both moments
            m, m2 = (float(x) for x in jax.device_get((m, m2)))
        self.result = SimResult(price=m, price_squared=m2,
                                n_paths=self.cfg.n_paths,
                                exec_time_ms=t.ms,
                                init_time_ms=self.init_time_ms,
                                synthesized_moments=(self.engine == "qmc"))
        return self.result
