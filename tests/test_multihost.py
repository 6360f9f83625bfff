"""Multi-process (simulated multi-host) mesh test.

Runs examples/multihost.py with 2 CPU processes x 4 virtual devices
(jax.distributed + gloo collectives) and asserts the 8-way-sharded
price equals the single-device golden run — the "sharding is schedule,
not math" invariant, now across process boundaries (SURVEY.md §5
distributed backend; the CUDA reference has no multi-device story).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from nmch.params import HestonParams
from nmch.ops.fe import fe_moments_scan, path_index_grid
from nmch.rng.philox import split_seed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_multihost(processes: int, local_devices: int, paths_per_chip: int,
                   N: int, port: int, method: str = "fe",
                   engine: str = "scan", extra=()):
    n_dev = processes * local_devices
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "multihost.py"),
         "--cpu", f"--processes={processes}",
         f"--local-devices={local_devices}",
         f"--paths-per-device={paths_per_chip}", f"--N={N}",
         f"--method={method}", f"--engine={engine}", f"--port={port}",
         *extra],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    n_paths = paths_per_chip * n_dev
    m = re.search(
        rf"processes={processes} devices={n_dev} paths={n_paths} "
        rf"{method}/{engine}: price=([0-9.]+)", out.stdout)
    assert m, out.stdout[-2000:] + out.stderr[-1000:]
    return float(m.group(1))


@pytest.mark.slow
def test_two_process_mesh_matches_single_device():
    n_paths, N = 8192, 50
    sharded_price = _run_multihost(2, 4, n_paths // 8, N, port=9745)

    k0, k1 = split_seed(1234)
    ms, _ = jax.jit(fe_moments_scan, static_argnums=1)(
        HestonParams().as_array(), N, path_index_grid(n_paths),
        jnp.uint32(0), k0, k1)
    assert sharded_price == pytest.approx(float(ms), rel=2e-6)


@pytest.mark.slow
def test_four_process_mesh_matches_single_device():
    """4 processes x 2 virtual devices: >2 coordinator participants."""
    n_paths, N = 4096, 25
    sharded_price = _run_multihost(4, 2, n_paths // 8, N, port=9746)

    k0, k1 = split_seed(1234)
    ms, _ = jax.jit(fe_moments_scan, static_argnums=1)(
        HestonParams().as_array(), N, path_index_grid(n_paths),
        jnp.uint32(0), k0, k1)
    assert sharded_price == pytest.approx(float(ms), rel=2e-6)


@pytest.mark.slow
def test_two_process_em_matches_single_device():
    """EM across the process boundary (lane-local sampler draws are
    tile-invariant, so sharding must not change the price)."""
    n_paths, N = 4096, 12
    sharded_price = _run_multihost(2, 4, n_paths // 8, N, port=9747,
                                   method="em")

    from nmch.ops.em import em_moments_scan
    k0, k1 = split_seed(1234)
    ms, _ = jax.jit(em_moments_scan, static_argnums=1)(
        HestonParams().as_array(), N, path_index_grid(n_paths),
        jnp.uint32(0), k0, k1)
    assert sharded_price == pytest.approx(float(ms), rel=2e-6)


@pytest.mark.slow
def test_two_process_qmc_matches_single_device():
    """QMC point-range sharding across processes: bit-identical point
    slices -> the single-device RQMC price to reduction tolerance."""
    n_paths, N = 4096, 16          # 8 shifts x 64 points x 8 chips
    sharded_price = _run_multihost(2, 4, n_paths // 8, N, port=9748,
                                   engine="qmc")

    from nmch.ops.fe_qmc import fe_moments_qmc
    k0, k1 = split_seed(1234)
    ms, _ = fe_moments_qmc(HestonParams().as_array(), jnp.uint32(0),
                           k0, k1, N=N, n_paths=n_paths, n_shifts=8)
    assert sharded_price == pytest.approx(float(ms), rel=2e-5)


@pytest.mark.slow
def test_two_process_stateful_family_matches_single_device():
    """The stateful xorwow family across the process boundary: the
    matrix skip-ahead gives each host's chips disjoint path ranges of
    the SAME per-path streams, so the 8-way multi-process price equals
    the single-device golden run."""
    n_paths, N = 4096, 12
    sharded_price = _run_multihost(2, 4, n_paths // 8, N, port=9749,
                                   extra=("--rng=xorwow",))

    from nmch.ops.fe_xorwow import fe_moments_xorwow
    ms, _ = jax.jit(fe_moments_xorwow, static_argnums=(1, 4))(
        HestonParams().as_array(), N, path_index_grid(n_paths),
        jnp.uint32(0), 1234)
    assert sharded_price == pytest.approx(float(ms), rel=2e-6)
