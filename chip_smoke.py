"""End-to-end smoke run on the GPU: the main path, at the reference's sizes.

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --chips 4  # only the mesh path, on four cards

One card, one process:

1. device   — platform, device_kind, count, JAX version, compile cache;
2. compile  — every Triton kernel lowered and compiled at its real
              widths, with its memory analysis;
3. fe       — NMCH_FE init -> compute -> print_stats -> finalize at 2^19
              groups x N=10^4 for rot in {1, 4, 8} x rng in {threefry4,
              philox}: price within the oracle CI, kernel == scan engine
              (draw words bitwise, moments to a stated tolerance), two
              runs bitwise equal, both engines timed;
4. em       — NMCH_EM at 2^18 x N=10^3 (the reference's 512x512 config),
              plain and conditional, threefry4 and philox, the same
              checks;
5. qmc      — NMCH_FE(engine="qmc") at 2^20 x 10^3, the bridge
              increments against a float64 NumPy bridge, the time and
              the simulator scan's share of it;
6. entry    — cli.run for FE and EM, explore.run --batched, in process;
7. tests    — the gpu-marked tests (tests/test_gpu.py), in process.

--chips 4 runs sharded_moments on four GPUs (FE kernel, threefry4,
rot=4, 2^26 groups x N=10^4; EM conditional at 2^20 x 10^3), each
compared with the same call on a one-device mesh of this process.

Every line carries the card's name and power limit.  Any failed check
raises, so the exit code is non-zero; without a GPU the script exits
non-zero before any phase.  The last stdout line is the JSON object
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

# the kernels need the GPU: let JAX fail at start-up without one
os.environ.setdefault("JAX_PLATFORMS", "cuda")

CARD = "?"

FE_N, FE_GROUPS = 10_000, 1 << 19
EM_N, EM_PATHS = 1000, 1 << 18
QMC_N, QMC_POINTS = 1000, 1 << 20
SEED = 1234

# Kernel vs scan engine, same (seed, epoch), same draw words: the
# moments differ only by float32 summation order (per-block tree +
# fixed-order Kahan vs XLA's reduction) and by where each compiler
# contracts a*b+c into an FMA over the N-step recurrence.  Measured on
# the H100 (PERF.md): <= 2e-7 relative at every tested size.
KERNEL_VS_SCAN_REL = 1e-6
# sharded vs one-device mesh: per-device sums then a psum (float32
# order only)
SHARDED_REL = 2e-5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg} | card: {CARD}", flush=True)


def echoed(phase: str, fn, *args):
    """Run fn(*args) with its stdout captured, then print each of its
    lines through say(), so library output carries the card too."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args)
    finally:
        for line in buf.getvalue().splitlines():
            say(phase, line)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_device():
    import jax
    from nmch.utils.cache import setup_compile_cache
    cache = setup_compile_cache()
    d = jax.devices()[0]
    say("device", f"platform={d.platform} kind={d.device_kind} "
                  f"count={len(jax.devices())} jax={jax.__version__} "
                  f"compile_cache={cache}")
    return d


def phase_compile():
    import jax
    import jax.numpy as jnp
    from nmch.params import HestonParams
    from nmch.ops.fe_pallas import fe_moments_pallas
    from nmch.ops.em_pallas import em_moments_pallas
    from nmch.ops.em import FAST_POISSON_CUT
    pv = HestonParams().as_array()
    sw = jnp.zeros((2,), jnp.uint32)
    z = jnp.uint32(0)
    for rng in ("threefry4", "philox"):
        for rot in (1, 4, 8):
            t0 = time.perf_counter()
            c = jax.jit(lambda p: fe_moments_pallas(
                p, sw, z, z, N=FE_N, n_paths=FE_GROUPS, rng=rng,
                rot=rot)).lower(pv).compile()
            say("compile", f"fe rng={rng} rot={rot} "
                           f"{time.perf_counter() - t0:.2f}s "
                           f"{c.memory_analysis()}")
        for cond in (False, True):
            t0 = time.perf_counter()
            c = jax.jit(lambda p: em_moments_pallas(
                p, sw, z, z, N=EM_N, n_paths=EM_PATHS, rng=rng,
                conditional=cond,
                poisson_cut=FAST_POISSON_CUT)).lower(pv).compile()
            say("compile", f"em rng={rng} conditional={cond} "
                           f"{time.perf_counter() - t0:.2f}s "
                           f"{c.memory_analysis()}")


def _lifecycle(make, name, reps=2):
    """init -> compute (warm-up, epoch 0) -> reps timed computes
    (epochs 1..reps) -> print_stats -> finalize; returns (the timed
    results, their mean ms)."""
    m = make()
    m.init(SEED)
    m.compute()
    results = [m.compute() for _ in range(reps)]
    echoed(name, m.print_stats)
    m.finalize()
    return results, sum(r.exec_time_ms for r in results) / reps


def _draw_words_equal(rng, n_paths, block_idx):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from nmch.rng.philox import split_seed
    from nmch.ops.fe import make_draw4
    from nmch.ops.fe_pallas import draw_words_pallas
    from nmch.utils.backend import kernel_interpret
    k0, k1 = split_seed(SEED)
    sw = jnp.stack([jnp.uint32(k0), jnp.uint32(k1)])
    lo = jnp.arange(n_paths, dtype=jnp.uint32)
    got = draw_words_pallas(sw, jnp.uint32(1), jnp.uint32(block_idx),
                            rng=rng, n_paths=n_paths,
                            interpret=kernel_interpret())
    want = jax.jit(lambda lo: make_draw4(
        rng, lo, jnp.zeros_like(lo), jnp.uint32(1), k0, k1)(
            jnp.uint32(block_idx)))(lo)
    return all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(got, want))


def _compare(phase, tag, ks, k2s, ss, oracle, bias):
    """Oracle, kernel-vs-scan and rerun checks on per-epoch results."""
    for k, k2, s in zip(ks, k2s, ss):
        off = abs(k.price - oracle)
        say(phase, f"{tag} price={k.price:.7f} oracle={oracle:.7f} "
                   f"|diff|={off:.2e} ci={k.ci_error:.2e}")
        check(off < 3 * k.ci_error + bias, f"{phase} {tag}: price off")
        r1 = rel(k.price, s.price)
        r2 = rel(k.price_squared, s.price_squared)
        say(phase, f"{tag} kernel vs scan rel m={r1:.2e} m2={r2:.2e} "
                   f"(bound {KERNEL_VS_SCAN_REL:g})")
        check(max(r1, r2) <= KERNEL_VS_SCAN_REL,
              f"{phase} {tag}: kernel != scan")
        bitwise = (k.price, k.price_squared) == (k2.price,
                                                 k2.price_squared)
        say(phase, f"{tag} rerun bitwise equal: {bitwise}")
        check(bitwise, f"{phase} {tag}: reruns differ")


def phase_fe():
    from nmch import NMCH_FE, HestonParams, SimConfig
    from nmch.oracle import heston_call_undiscounted
    P = HestonParams()
    oracle = heston_call_undiscounted(P)
    cfg = SimConfig(NTPB=512, NB=FE_GROUPS // 512, N=FE_N, seed=SEED)
    for rng in ("threefry4", "philox"):
        same = _draw_words_equal(rng, FE_GROUPS, (FE_N + 1) // 2 - 1)
        say("fe", f"rng={rng} draw words kernel == XLA bitwise: {same}")
        check(same, f"fe {rng}: kernel draw words differ from XLA's")
        for rot in (1, 4, 8):
            tag = f"rng={rng} rot={rot}"
            ks, k_ms = _lifecycle(lambda: NMCH_FE(
                cfg, P, engine="pallas", rng=rng, rot=rot), f"fe {tag}")
            k2s, _ = _lifecycle(lambda: NMCH_FE(
                cfg, P, engine="pallas", rng=rng, rot=rot),
                f"fe {tag} rerun")
            ss, s_ms = _lifecycle(lambda: NMCH_FE(
                cfg, P, engine="scan", rng=rng, rot=rot), f"fe {tag} scan")
            _compare("fe", tag, ks, k2s, ss, oracle, 2e-3)
            say("fe", f"{tag} time kernel={k_ms:.3f} ms scan={s_ms:.3f} ms "
                      f"speedup={s_ms / k_ms:.2f}x "
                      f"({rot * FE_GROUPS * FE_N / k_ms / 1e6:.1f} "
                      f"G path-steps/s)")


def phase_em():
    from nmch import NMCH_EM, HestonParams, SimConfig
    from nmch.oracle import heston_call_undiscounted
    P = HestonParams()
    oracle = heston_call_undiscounted(P)
    cfg = SimConfig(NTPB=512, NB=EM_PATHS // 512, N=EM_N, seed=SEED)
    for rng in ("threefry4", "philox"):
        for cond in (False, True):
            tag = f"rng={rng} conditional={cond}"
            ks, k_ms = _lifecycle(lambda: NMCH_EM(
                cfg, P, engine="pallas", rng=rng, conditional=cond),
                f"em {tag}")
            k2s, _ = _lifecycle(lambda: NMCH_EM(
                cfg, P, engine="pallas", rng=rng, conditional=cond),
                f"em {tag} rerun")
            ss, s_ms = _lifecycle(lambda: NMCH_EM(
                cfg, P, engine="scan", rng=rng, conditional=cond),
                f"em {tag} scan")
            # the exact scheme has no discretization bias
            _compare("em", tag, ks, k2s, ss, oracle, 0.0)
            say("em", f"{tag} time kernel={k_ms:.3f} ms scan={s_ms:.3f} ms "
                      f"speedup={s_ms / k_ms:.2f}x")


def phase_qmc():
    import numpy as np
    import jax
    import jax.numpy as jnp
    from nmch import NMCH_FE, HestonParams, SimConfig
    from nmch.oracle import heston_call_undiscounted
    from nmch.rng.philox import split_seed
    from nmch.ops.fe_qmc import (
        qmc_normals_mxu, qmc_increments_mxu, bb_increment_matrix,
        point_chunk, _sim_payoff, DEFAULT_N_SHIFTS, BRIDGE_PRECISION)
    P = HestonParams()
    cfg = SimConfig(NTPB=512, NB=QMC_POINTS // 512, N=QMC_N, seed=SEED)
    (res, _), ms = _lifecycle(lambda: NMCH_FE(cfg, P, engine="qmc"), "qmc")
    oracle = heston_call_undiscounted(P)
    off = abs(res.price - oracle)
    say("qmc", f"price={res.price:.7f} oracle={oracle:.7f} "
               f"|diff|={off:.2e} rqmc_ci={res.ci_error:.2e} "
               f"time={ms:.3f} ms")
    check(off < 3 * res.ci_error + 2e-3, "qmc: price off")
    # bridge increments on a slice vs a float64 NumPy bridge
    k0, k1 = split_seed(SEED)
    n = 4096
    T = jnp.float32(P.T)
    z1, _ = jax.jit(lambda: qmc_normals_mxu(QMC_N, n, jnp.uint32(0), k0,
                                            k1))()
    dw1, _ = jax.jit(lambda: qmc_increments_mxu(
        QMC_N, n, jnp.uint32(0), k0, k1, T))()
    A = bb_increment_matrix(QMC_N).astype(np.float64)
    ref = np.sqrt(P.T / QMC_N) * (A @ np.asarray(z1, np.float64))
    err = float(np.max(np.abs(np.asarray(dw1, np.float64) - ref))
                / np.sqrt(np.mean(ref * ref)))
    say("qmc", f"bridge {BRIDGE_PRECISION.name}: max |dW - dW_f64| / "
               f"rms = {err:.2e} (bound 1e-4)")
    check(err < 1e-4, "qmc: bridge increments off")
    # the simulator scan's share of the call: one chunk's scan, times
    # the chunk count, over the whole call
    n_rep = QMC_POINTS // DEFAULT_N_SHIFTS
    chunk = point_chunk(n_rep, DEFAULT_N_SHIFTS, QMC_N)
    d1, d2 = jax.jit(lambda: qmc_increments_mxu(
        QMC_N, chunk, jnp.uint32(0), k0, k1, T,
        n_shifts=DEFAULT_N_SHIFTS))()
    sim = jax.jit(lambda a, b: _sim_payoff(P.as_array(), QMC_N, a, b))
    jax.block_until_ready(sim(d1, d2))
    t0 = time.perf_counter()
    for _ in range(3):
        jax.block_until_ready(sim(d1, d2))
    sim_ms = (time.perf_counter() - t0) / 3 * 1e3 * (n_rep // chunk)
    say("qmc", f"simulator scan {sim_ms:.3f} ms of {ms:.3f} ms "
               f"(share {sim_ms / ms:.1%}, {n_rep // chunk} chunk(s))")


def phase_entry():
    from nmch import cli, explore
    for method in ("fe", "em"):
        t0 = time.perf_counter()
        rc = echoed("entry", cli.run, ["--method", method, "--oracle"])
        say("entry", f"cli --method {method} rc={rc} "
                     f"{time.perf_counter() - t0:.1f}s")
        check(rc == 0, f"cli {method} failed")
    t0 = time.perf_counter()
    rc = echoed("entry", explore.run,
                ["--batched", "--NB", "2", "--N", "200"])
    say("entry", f"explore --batched rc={rc} "
                 f"{time.perf_counter() - t0:.1f}s")
    check(rc == 0, "explore --batched failed")


def phase_tests():
    import pytest
    here = os.path.dirname(os.path.abspath(__file__))
    rc = echoed("tests", pytest.main,
                ["-q", "-m", "gpu", "-p", "no:cacheprovider",
                 os.path.join(here, "tests", "test_gpu.py")])
    say("tests", f"pytest -m gpu tests/test_gpu.py rc={int(rc)}")
    check(int(rc) == 0, "gpu tests failed")


def phase_mesh(devices, *, fe_groups, fe_N, em_paths, em_N,
               interpret=False, timed=True):
    """Sharded vs one-device mesh for the FE kernel (threefry4, rot=4)
    and EM conditional; returns the per-call times."""
    import jax
    from nmch.params import HestonParams
    from nmch.parallel.mesh import make_mesh, sharded_moments
    pv = HestonParams().as_array()
    mesh_n, mesh_1 = make_mesh(devices), make_mesh(devices[:1])
    n_dev = len(devices)
    times = {}
    for tag, kw in (
        ("fe threefry4 rot=4", dict(method="fe", rng="threefry4", rot=4,
                                   N=fe_N, n_paths=fe_groups)),
        ("em conditional", dict(method="em", rng="threefry4",
                                conditional=True, N=em_N,
                                n_paths=em_paths)),
    ):
        def run(mesh, epoch):
            return jax.block_until_ready(sharded_moments(
                mesh, pv, SEED, epoch, engine="pallas",
                interpret=interpret, **kw))

        out = {}
        for name, mesh in (("sharded", mesh_n), ("one-device", mesh_1)):
            run(mesh, 0)                       # compile + warm-up
            t0 = time.perf_counter()
            m, m2 = run(mesh, 1)
            out[name] = (float(m), float(m2),
                         (time.perf_counter() - t0) * 1e3)
        (a, a2, ta), (b, b2, tb) = out["sharded"], out["one-device"]
        r1, r2 = rel(a, b), rel(a2, b2)
        say("mesh", f"{tag} n={kw['n_paths']} N={kw['N']}: sharded "
                    f"m={a:.7f} one-device m={b:.7f} rel m={r1:.2e} "
                    f"m2={r2:.2e} (bound {SHARDED_REL:g})")
        check(max(r1, r2) <= SHARDED_REL, f"mesh {tag}: sharded != 1dev")
        if timed:
            say("mesh", f"{tag} time {n_dev} devices={ta:.3f} ms "
                        f"one device={tb:.3f} ms speedup={tb / ta:.2f}x "
                        f"scaling efficiency={tb / (n_dev * ta):.1%}")
        times[tag] = (ta, tb)
    return times


def main() -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, choices=[1, 4], default=1)
    args = p.parse_args()
    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    CARD = card_line()
    t_start = time.perf_counter()
    dev = phase_device()
    if args.chips == 4:
        devices = jax.devices()
        check(len(devices) >= 4, f"--chips 4 needs 4 GPUs, found "
                                 f"{len(devices)}")
        phase_mesh(devices[:4], fe_groups=1 << 26, fe_N=FE_N,
                   em_paths=1 << 20, em_N=EM_N)
    else:
        for name, fn in (("compile", phase_compile), ("fe", phase_fe),
                         ("em", phase_em), ("qmc", phase_qmc),
                         ("entry", phase_entry), ("tests", phase_tests)):
            t0 = time.perf_counter()
            fn()
            say(name, f"phase done in {time.perf_counter() - t0:.1f}s")
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.chips == 4 else len(jax.devices())}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
