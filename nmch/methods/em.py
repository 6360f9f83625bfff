"""Broadie–Kaya exact-method pricer (reference L4: NMCH_EM_* family).

Same engine/rng structure as methods/fe.py; the reference's
NMCH_EM_K{1,2,3}_MM ladder (``src/NMCH/methods/NMCH_EM.cu:373-582``)
maps to engine="pallas" (fused kernel, ≙ K3) and engine="scan"
(pure-JAX golden, ≙ K1 baseline).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import HestonParams, SimConfig
from ..results import SimResult
from ..rng.streams import PathStreams
from ..ops.em import em_moments_scan
from ..ops.fe import path_index_grid
from ..ops.em_pallas import em_moments_pallas
from ..utils.timing import Timer
from ..utils.backend import kernel_interpret
from .base import NMCH

# module-level jit wrapper — one trace cache across all compute() calls
# (seed is static: the stateful families resolve it host-side into the
# skip-ahead base state; None for the counter families)
_em_scan_jit = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8, 9))


class NMCH_EM(NMCH):
    """Exact-scheme pricer with the reference's 5-step lifecycle."""

    method_name = "EXACT-METHOD"  # NMCH_EM.cu:405

    def __init__(self, cfg: SimConfig, params: HestonParams,
                 engine: str = "pallas", rng: str = "philox",
                 conditional: bool = False,
                 interpret: bool | None = None,
                 poisson_cut: float | None = None):
        """conditional=True replaces the sampled terminal payoff with
        its exact Black–Scholes conditional expectation given the
        variance path (ops/em.py::em_conditional_payoff) — identical
        mean, measured ~1.9x smaller CI, one fewer draw per path; a
        variance-reduction capability the CUDA reference lacks.

        poisson_cut: lambda above which the variance transition's
        Poisson mixture index uses the one-round normal approximation
        instead of PTRS rejection.  None = the shipping default 128
        (price shift below the 95% CI — ops/em.py::em_path_law for the
        accuracy analysis, tests/test_em.py::
        test_em_poisson_cut_price_parity for the assertion).  Pass
        4000.0 for strict curand-parity switching (the reference's
        curand_poisson regime, NMCH_EM.cu:102)."""
        super().__init__(cfg, params)
        if engine not in ("pallas", "scan"):
            raise ValueError(f"unknown engine {engine!r}")
        if rng not in ("philox", "threefry4", "mrg32k3a", "xorwow"):
            raise ValueError(f"unknown rng {rng!r} (NMCH_EM supports "
                             "philox/threefry4/mrg32k3a/xorwow)")
        if rng in ("mrg32k3a", "xorwow"):
            # stateful recurrences carried through the sampler rounds
            # (the reference prices EM with XORWOW,
            # exploration.cu:54-55); scan engine hosts the state carry,
            # the Pallas kernels keep the counter-based ladder
            if engine != "scan":
                raise ValueError(f"rng={rng!r} requires engine='scan'")
            if cfg.n_paths >= (1 << 31):
                # jump tables cover path-index bits 0..30 (exponents
                # 67..97); larger indices would alias onto lower streams
                raise ValueError(
                    f"rng={rng!r} supports n_paths < 2^31 (stream "
                    f"layout, rng/mrg32k3a.py docstring); got "
                    f"{cfg.n_paths}")
        self.engine = engine
        self.rng = rng
        self.conditional = conditional
        # method-level fast default; ops-level None stays curand's 4000
        from ..ops.em import FAST_POISSON_CUT
        self.poisson_cut = (FAST_POISSON_CUT if poisson_cut is None
                            else poisson_cut)
        if interpret is None:
            interpret = engine == "pallas" and kernel_interpret()
        self.interpret = interpret

    def init(self, seed: int | None = None) -> None:
        seed = self.cfg.seed if seed is None else seed
        with Timer() as t:
            self.streams = PathStreams(seed=seed, n_paths=self.cfg.n_paths)
        self.init_time_ms = t.ms

    def _moments(self, epoch: int):
        pv = self.params.as_array()
        k0, k1 = self.streams.key_words
        if self.engine == "pallas":
            sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
            return em_moments_pallas(
                pv, sw, jnp.uint32(epoch), jnp.uint32(0),
                N=self.cfg.N, n_paths=self.cfg.n_paths,
                interpret=self.interpret, rng=self.rng,
                conditional=self.conditional,
                poisson_cut=self.poisson_cut)
        pidx = path_index_grid(self.cfg.n_paths)
        seed = None
        if self.rng in ("mrg32k3a", "xorwow"):
            from ..rng.streams import stateful_max_epoch
            bound = stateful_max_epoch(self.rng)
            if int(epoch) >= bound:
                raise ValueError(
                    f"epoch={int(epoch)} exceeds the {self.rng} stream "
                    f"layout's {bound} epochs per path block "
                    f"(rng/{self.rng}.py docstring)")
            seed = self.streams.seed
        return _em_scan_jit(pv, self.cfg.N, pidx, jnp.uint32(epoch), k0, k1,
                            self.rng, self.conditional, self.poisson_cut,
                            seed)

    def greeks(self, fix_strike: bool = False,
               fd: bool = False, lrm: bool = False) -> dict:
        """EM sensitivities (a capability beyond the CUDA
        reference).  Default: the exactly-pathwise subset — delta
        (dP/dS_0), dP/dr, dP/drho — by jax.grad through the
        conditional payoff with the variance path held fixed (valid
        because the variance randomness is independent of those three
        parameters; full analysis in ops/em_greeks.py).  fd=True adds
        central-difference CRN estimates for (T, v_0, k, theta,
        sigma), whose Poisson/Gamma rejection sampling breaks pathwise
        differentiation; lrm=True estimates the same five by the
        score-function (likelihood-ratio) method instead —
        derivative-free AND bump-free (ops/em_lrm.py; measured in
        benchmarks/RESULTS.md: ~3x tighter than CRN-FD on (k, theta)
        at every N, but the (T, sigma) score variance grows ~ N, so
        CRN-FD stays the default).  Consumes one epoch (two with
        fd/lrm)."""
        if fd and lrm:
            raise ValueError("pass fd=True or lrm=True, not both (they "
                             "estimate the same five parameters)")
        if self.streams is None:
            raise RuntimeError("call init(seed) before greeks()")
        if self.rng not in ("philox", "threefry4"):
            raise ValueError("greeks() needs a counter rng "
                             "(philox/threefry4)")
        from ..ops.em_greeks import em_price_and_greeks, em_greeks_fd
        k0, k1 = self.streams.key_words
        price, grads = em_price_and_greeks(
            self.params.as_array(), jnp.uint32(self.streams.next_epoch()),
            k0, k1, N=self.cfg.N, n_paths=self.cfg.n_paths, rng=self.rng,
            poisson_cut=self.poisson_cut, fix_strike=fix_strike)
        extra = {}
        if fd:
            extra = em_greeks_fd(
                self.params.as_array(),
                jnp.uint32(self.streams.next_epoch()), k0, k1,
                N=self.cfg.N, n_paths=self.cfg.n_paths, rng=self.rng,
                poisson_cut=self.poisson_cut)
        elif lrm:
            from ..ops.em_lrm import em_greeks_lrm
            # strict curand poisson switching (None -> 4000): the
            # scored density must match the sampled law (em_lrm.py)
            _, extra = em_greeks_lrm(
                self.params.as_array(),
                jnp.uint32(self.streams.next_epoch()), k0, k1,
                N=self.cfg.N, n_paths=self.cfg.n_paths, rng=self.rng)
        # ONE batched device fetch (same batching as compute() and
        # FE.greeks())
        price, grads, extra = jax.device_get((price, grads, extra))
        return {"price": float(price),
                **{k: float(v) for k, v in grads.items()},
                **{k: float(v) for k, v in extra.items()}}

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
                                init_time_ms=self.init_time_ms)
        return self.result
