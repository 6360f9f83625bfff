"""NMCH: a GPU Monte Carlo engine for Heston option pricing, in JAX.

JAX/XLA/Pallas implementation with the capabilities of the CUDA
reference edo01/NMCH (see SURVEY.md): Forward-Euler and Broadie–Kaya
exact-method schemes, persistent per-path RNG streams, on-device
payoff mean/variance reduction with 95%-CI error reporting, a
semi-analytic Heston oracle, a CLI, a parameter-exploration sweep,
and multi-device path-sharded scale-out over a mesh of GPUs.

Canonical 5-step usage (reference README.md:57-94):

    from nmch import NMCH_FE, HestonParams, SimConfig
    m = NMCH_FE(SimConfig(), HestonParams())
    m.init(seed=1234)
    m.compute()
    m.print_stats()
    m.finalize()
"""

from .params import HestonParams, SimConfig, DEFAULT_PARAMS, DEFAULT_CONFIG
from .results import SimResult, reference_err, correct_ci_error
from .methods.base import NMCH
from .methods.fe import NMCH_FE
from .methods.em import NMCH_EM

__version__ = "0.1.0"

__all__ = [
    "HestonParams", "SimConfig", "DEFAULT_PARAMS", "DEFAULT_CONFIG",
    "SimResult", "reference_err", "correct_ci_error",
    "NMCH", "NMCH_FE", "NMCH_EM",
    "__version__",
]
