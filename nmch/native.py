"""ctypes bindings to the native C++ runtime library (native/).

The library is optional: it auto-builds on first use if a toolchain is
available (``make -C native``), and every entry point has a pure-Python
fallback, so the framework works without it.  Its role is independent
cross-validation (different language, different RNG family, different
quadrature code) of the Python oracle and the JAX Monte Carlo engines —
see native/nmch_native.cpp.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libnmch_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=300)
        return True
    except Exception:
        return False


def _bind(lib):
    """Declare signatures; raises AttributeError on a stale library
    that predates a symbol."""
    D = ctypes.c_double
    lib.nmch_heston_call.restype = D
    lib.nmch_heston_call.argtypes = [D] * 10 + [ctypes.c_int]
    lib.nmch_norm_cdf_as.restype = D
    lib.nmch_norm_cdf_as.argtypes = [D]
    lib.nmch_reference_true_price.restype = D
    lib.nmch_reference_true_price.argtypes = [D] * 4
    lib.nmch_reference_err.restype = D
    lib.nmch_reference_err.argtypes = [D, D, ctypes.c_longlong]
    lib.nmch_cpu_fe_moments.restype = None
    lib.nmch_cpu_fe_moments.argtypes = (
        [D] * 9 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64,
                   ctypes.POINTER(D)])
    lib.nmch_cpu_em_moments.restype = None
    lib.nmch_cpu_em_moments.argtypes = (
        [D] * 9 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64,
                   ctypes.c_int, ctypes.POINTER(D)])


def load():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            _bind(lib)
        except OSError:
            return None
        except AttributeError:
            # a cached build from before a newly-added symbol.
            # Rebuild so the NEXT process gets a fresh library (an
            # in-process retry is futile: dlopen name-caches the
            # already-loaded stale image and we never dlclose), and
            # degrade to the Python fallbacks for this process
            # instead of poisoning every native entry point.
            _build()
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def heston_call(params, K: float | None = None, u_max: float = 200.0,
                n_nodes: int = 2000) -> float:
    """Native semi-analytic Heston call; falls back to the Python oracle."""
    lib = load()
    K = params.K if K is None else K
    if lib is None:
        from .oracle.heston import heston_call as py_oracle
        return py_oracle(params, K, u_max=u_max, n_nodes=n_nodes)
    return lib.nmch_heston_call(params.T, params.S_0, params.v_0, params.r,
                                params.k, params.rho, params.theta,
                                params.sigma, K, u_max, n_nodes)


def cpu_fe_moments(params, N: int, n_paths: int, seed: int = 1234):
    """Independent CPU Monte Carlo (E[X], E[X^2]); None if lib missing."""
    lib = load()
    if lib is None:
        return None
    out = (ctypes.c_double * 2)()
    lib.nmch_cpu_fe_moments(params.T, params.S_0, params.v_0, params.r,
                            params.k, params.rho, params.theta, params.sigma,
                            params.K, N, n_paths, seed, out)
    return float(out[0]), float(out[1])


def cpu_em_moments(params, N: int, n_paths: int, seed: int = 1234,
                   conditional: bool = False):
    """Independent CPU Broadie-Kaya exact-method Monte Carlo
    (E[X], E[X^2]) using libstdc++'s own poisson/gamma samplers —
    cross-validates the JAX EM engines; None if lib missing."""
    lib = load()
    if lib is None:
        return None
    out = (ctypes.c_double * 2)()
    lib.nmch_cpu_em_moments(params.T, params.S_0, params.v_0, params.r,
                            params.k, params.rho, params.theta,
                            params.sigma, params.K, N, n_paths, seed,
                            1 if conditional else 0, out)
    return float(out[0]), float(out[1])


def reference_err_native(mean: float, mean_sq: float, n: int) -> float:
    lib = load()
    if lib is None:
        from .results import reference_err
        return reference_err(mean, mean_sq, n)
    return lib.nmch_reference_err(mean, mean_sq, n)
