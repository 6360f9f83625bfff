"""Contract tests for the measuring entry points (bench.py, chip_smoke.py).

Both measure the GPU: without one they exit non-zero and print no
result, instead of falling back to the CPU.  chip_smoke.py's four-card
mesh phase is rehearsed here on four virtual CPU devices, with the
kernels in interpret mode.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=cwd)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_measuring_script_fails_without_gpu(script):
    r = _run_cpu([os.path.join(REPO, script)], REPO)
    assert r.returncode != 0
    assert r.stdout.strip() == ""          # no result line
    assert "GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo
    must not produce a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_cpu(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_mesh_phase_on_virtual_devices():
    """The --chips 4 path at a tiny size: sharded == one-device mesh
    for the FE kernel and EM conditional, on four CPU devices."""
    smoke = _load("chip_smoke")
    devices = jax.devices()[:4]
    assert len(devices) == 4
    times = smoke.phase_mesh(devices, fe_groups=1024, fe_N=6,
                             em_paths=1024, em_N=4, interpret=True,
                             timed=False)
    assert set(times) == {"fe threefry4 rot=4", "em conditional"}


def test_bench_card_line_and_moments_helpers():
    bench = _load("bench")
    m, var = bench._mean_var([(0.1, 0.02), (0.3, 0.1)])
    assert m == pytest.approx(0.2)
    assert var == pytest.approx(((0.02 - 0.01) + (0.1 - 0.09)) / 2)
    line = json.dumps({"ok": True})
    assert json.loads(line)["ok"] is True
