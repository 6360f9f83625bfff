"""Compile check and launch-configuration ladder for the Triton kernels.

    python benchmarks/triton_ladder.py --check    # compile + parity
    python benchmarks/triton_ladder.py --ladder   # times vs the scan

--check compiles every kernel variant at its real widths (FE at 2^19
groups x N=10^4, EM at 2^18 x N=10^3), prints its memory analysis and
compile time, compares kernel and scan engine at a small size, checks
the in-kernel draw words bitwise against XLA's, and measures the QMC
bridge product's error under each dot algorithm against a float64
NumPy product.

--ladder times the kernels over (block, num_warps) launch
configurations and the XLA scan engines at the same shapes, in steady
state (compile and warm-up excluded, each call ended with
block_until_ready).  Needs a GPU; results go to stdout, one JSON
object per line, and are appended to the file ``--out`` names.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmch.params import HestonParams  # noqa: E402
from nmch.rng.philox import split_seed  # noqa: E402
from nmch.ops.fe import (  # noqa: E402
    fe_moments_scan, fe_moments_rot_scan, path_index_grid, make_draw4)
from nmch.ops.fe_pallas import fe_moments_pallas, draw_words_pallas  # noqa
from nmch.ops.em import em_moments_scan, FAST_POISSON_CUT  # noqa: E402
from nmch.ops.em_pallas import em_moments_pallas  # noqa: E402
from nmch.utils.cache import setup_compile_cache  # noqa: E402

P = HestonParams()
PV = P.as_array()
K0, K1 = split_seed(1234)
SW = jnp.stack([jnp.uint32(K0), jnp.uint32(K1)])


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def record(**kw):
    kw["card"] = CARD
    line = json.dumps(kw)
    print(line, flush=True)
    if OUT:
        with open(OUT, "a") as f:
            f.write(line + "\n")


def steady_ms(fn, reps: int):
    """min and mean ms of fn(epoch) over reps calls after a warm-up."""
    jax.block_until_ready(fn(0))
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(1 + i))
        ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts), sum(ts) / len(ts)


_scan_fe = jax.jit(fe_moments_scan, static_argnums=(1, 6))
_scan_rot = jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))
_scan_em = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8))


def fe_scan(N, n, rng, rot, epoch):
    pidx = path_index_grid(n)
    if rot == 1:
        return _scan_fe(PV, N, pidx, jnp.uint32(epoch), K0, K1, rng)
    return _scan_rot(PV, N, pidx, jnp.uint32(epoch), K0, K1, rng, rot)


def fe_kernel(N, n, rng, rot, epoch, **kw):
    return fe_moments_pallas(PV, SW, jnp.uint32(epoch), jnp.uint32(0), N=N,
                             n_paths=n, rng=rng, rot=rot, **kw)


def em_scan(N, n, rng, cond, epoch):
    return _scan_em(PV, N, path_index_grid(n), jnp.uint32(epoch), K0, K1,
                    rng, cond, FAST_POISSON_CUT)


def em_kernel(N, n, rng, cond, epoch, **kw):
    return em_moments_pallas(PV, SW, jnp.uint32(epoch), jnp.uint32(0), N=N,
                             n_paths=n, rng=rng, conditional=cond,
                             poisson_cut=FAST_POISSON_CUT, **kw)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


FE_CASES = [("threefry4", 1), ("threefry4", 4), ("threefry4", 8),
            ("philox", 1), ("philox", 4), ("philox", 8), ("threefry", 4)]
EM_CASES = [("threefry4", False), ("threefry4", True), ("philox", False),
            ("philox", True)]


def check():
    for rng, rot in FE_CASES:
        t0 = time.perf_counter()
        comp = jax.jit(lambda e, rng=rng, rot=rot: fe_kernel(
            10_000, 1 << 19, rng, rot, e)).lower(jnp.uint32(0)).compile()
        record(kind="compile_fe", rng=rng, rot=rot,
               compile_s=time.perf_counter() - t0,
               memory=str(comp.memory_analysis()))
        for N in (64, 33):
            k = jax.device_get(fe_kernel(N, 8192, rng, rot, 3))
            s = jax.device_get(fe_scan(N, 8192, rng, rot, 3))
            record(kind="parity_fe", rng=rng, rot=rot, N=N,
                   kernel=[float(x) for x in k], scan=[float(x) for x in s],
                   rel_m=rel(k[0], s[0]), rel_m2=rel(k[1], s[1]))
    for rng, cond in EM_CASES:
        t0 = time.perf_counter()
        comp = jax.jit(lambda e, rng=rng, cond=cond: em_kernel(
            1000, 1 << 18, rng, cond, e)).lower(jnp.uint32(0)).compile()
        record(kind="compile_em", rng=rng, conditional=cond,
               compile_s=time.perf_counter() - t0,
               memory=str(comp.memory_analysis()))
        k = jax.device_get(em_kernel(16, 8192, rng, cond, 2))
        s = jax.device_get(em_scan(16, 8192, rng, cond, 2))
        record(kind="parity_em", rng=rng, conditional=cond,
               kernel=[float(x) for x in k], scan=[float(x) for x in s],
               rel_m=rel(k[0], s[0]), rel_m2=rel(k[1], s[1]))
    n = 1 << 16
    lo = jnp.arange(n, dtype=jnp.uint32)
    for rng in ("philox", "threefry", "threefry4"):
        w = draw_words_pallas(SW, jnp.uint32(5), jnp.uint32(7), rng=rng,
                              n_paths=n)
        ref = jax.jit(lambda lo, rng=rng: make_draw4(
            rng, lo, jnp.zeros_like(lo), jnp.uint32(5), K0, K1)(
                jnp.uint32(7)))(lo)
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(w, ref))
        record(kind="draw_words", rng=rng, n=n, bitwise_equal=same)
    bridge_precision()


def bridge_precision():
    from jax import lax
    from nmch.ops.fe_qmc import bb_increment_matrix
    N = 1000
    A = bb_increment_matrix(N)
    z = np.random.default_rng(0).standard_normal((N, 4096)).astype(
        np.float32)
    ref = A.astype(np.float64) @ z.astype(np.float64)
    zbig = jax.random.normal(jax.random.key(0), (N, 1 << 20), jnp.float32)
    for name in ("BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "F32_F32_F32",
                 "TF32_TF32_F32_X3", "TF32_TF32_F32", "DEFAULT"):
        alg = getattr(lax.DotAlgorithmPreset, name)
        f = jax.jit(lambda a, b, alg=alg: jnp.dot(a, b, precision=alg))
        try:
            out = np.asarray(f(jnp.asarray(A), jnp.asarray(z)), np.float64)
            err = float(np.max(np.abs(out - ref)) / np.sqrt(np.mean(
                ref * ref)))
            ms = steady_ms(lambda e, f=f: f(jnp.asarray(A), zbig), 3)
            record(kind="bridge_dot", algorithm=name,
                   max_err_over_rms=err, ms_min_mean_2p20=ms)
        except Exception as e:  # an algorithm the card refuses
            record(kind="bridge_dot", algorithm=name,
                   error=f"{type(e).__name__}: {str(e)[:200]}")


LADDER_FE = [(128, 4), (256, 4), (256, 8), (512, 4), (512, 8)]
LADDER_EM = [(64, 2), (128, 4), (256, 4)]
# FE cases timed over the whole LADDER_FE; the others at their default
FE_LADDER_CASES = {("threefry4", 4), ("philox", 1), ("threefry4", 8)}


def ladder():
    N, n = 10_000, 1 << 19
    for rng, rot in FE_CASES:
        if rng == "threefry":
            continue
        ms = steady_ms(lambda e: fe_scan(N, n, rng, rot, e), 3)
        record(kind="time_fe_scan", rng=rng, rot=rot, N=N, n=n, ms=ms)
        confs = LADDER_FE if (rng, rot) in FE_LADDER_CASES else [None]
        for c in confs:
            kw = {} if c is None else {"block": c[0], "num_warps": c[1]}
            ms = steady_ms(lambda e: fe_kernel(N, n, rng, rot, e, **kw), 5)
            record(kind="time_fe_kernel", rng=rng, rot=rot, N=N, n=n,
                   launch=c, ms=ms)
    N, n = 1000, 1 << 18
    for rng, cond in EM_CASES:
        ms = steady_ms(lambda e: em_scan(N, n, rng, cond, e), 2)
        record(kind="time_em_scan", rng=rng, conditional=cond, N=N, n=n,
               ms=ms)
        confs = LADDER_EM if rng == "threefry4" else [None]
        for c in confs:
            kw = {} if c is None else {"block": c[0], "num_warps": c[1]}
            ms = steady_ms(lambda e: em_kernel(N, n, rng, cond, e, **kw), 3)
            record(kind="time_em_kernel", rng=rng, conditional=cond, N=N,
                   n=n, launch=c, ms=ms)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--check", action="store_true")
    p.add_argument("--ladder", action="store_true")
    p.add_argument("--out", default=None,
                   help="also append each JSON line to this file")
    args = p.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit("no GPU found: this script measures the GPU")
    global CARD, OUT
    CARD = card()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        OUT = args.out
    cache = setup_compile_cache()
    d = jax.devices()[0]
    record(kind="device", platform=d.platform, device_kind=d.device_kind,
           count=len(jax.devices()), jax=jax.__version__, cache=cache)
    if args.check:
        check()
    if args.ladder:
        ladder()


CARD = ""
OUT = None

if __name__ == "__main__":
    main()
