"""CLI + exploration sweep tests (reference L6 drivers)."""

import io
import re

import pytest

from nmch.cli import run as cli_run, build_parser
from nmch.explore import feasible, _grid, sweep, run as explore_run
from nmch.params import HestonParams, SimConfig
from nmch.methods.fe import NMCH_FE


def test_cli_fe_scan(capsys):
    rc = cli_run(["--method", "fe", "--engine", "scan", "--NB", "8",
                  "--N", "50", "--oracle"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "METHOD: FORWARD-EULER" in out
    assert "Semi-analytic Heston price" in out
    price = float(re.search(r"E\[X\] is equal to ([\d.]+)", out).group(1))
    assert 0.05 < price < 0.25


def test_cli_em_scan(capsys):
    rc = cli_run(["--method", "em", "--engine", "scan", "--NB", "4",
                  "--N", "20"])
    assert rc == 0
    assert "METHOD: EXACT-METHOD" in capsys.readouterr().out


def test_cli_defaults_match_reference():
    a = build_parser().parse_args([])
    # nmch.cu:52-64 actual defaults (NOT the buggy --help text)
    assert (a.NTPB, a.NB, a.N, a.seed) == (512, 512, 1000, 1234)
    assert (a.T, a.S_0, a.v_0, a.r) == (1.0, 1.0, 0.1, 0.0)
    assert (a.k, a.rho, a.theta, a.sigma) == (0.5, -0.7, 0.1, 0.3)
    assert a.method == "fe"


def test_feasibility_filter():
    # exploration.cu:76 — skip when 20*k*theta < sigma^2
    assert not feasible(0.1, 0.01, 1.0)
    assert feasible(10.0, 0.5, 0.1)


def test_grid_is_inclusive_stepped():
    g = _grid(0.1, 1.0)
    assert len(g) == 6               # lo + 5 steps, inclusive
    assert g[0] == pytest.approx(0.1)
    assert g[-1] == pytest.approx(1.0, abs=1e-6)


def test_sweep_csv_shape():
    cfg = SimConfig(NTPB=512, NB=2, N=10)
    m = NMCH_FE(cfg, HestonParams(), engine="scan")
    m.init(1)
    buf = io.StringIO()
    sweep(m, "fe", out=buf)
    lines = [l for l in buf.getvalue().splitlines() if l.strip()]
    assert len(lines) > 50           # most of the 6^3 grid is feasible
    for line in lines:
        parts = [p.strip() for p in line.split(",")]
        assert parts[0] == "fe" and len(parts) == 6
        k, theta, sigma, t_ms, err = map(float, parts[1:])
        assert feasible(k, theta, sigma)
        assert t_ms > 0 and err >= 0


def test_explore_main_writes_csv(tmp_path):
    out = tmp_path / "sweep.csv"
    rc = explore_run(["--NB", "1", "--N", "5", "--engine", "scan",
                      "--methods", "fe", "--out", str(out)])
    assert rc == 0
    text = out.read_text()
    assert text.splitlines()[0].startswith("method, k, theta, sigma")
    assert len(text.splitlines()) > 10


def test_heatmap_from_sweep(tmp_path):
    out = tmp_path / "sweep.csv"
    explore_run(["--NB", "1", "--N", "5", "--engine", "scan",
                 "--methods", "fe", "--out", str(out)])
    from nmch.analysis.heatmap import load_sweep, plot_heatmaps
    data = load_sweep(str(out))
    paths = plot_heatmaps(data, value="err", outdir=str(tmp_path))
    assert len(paths) >= 2
    import os
    assert all(os.path.getsize(p) > 1000 for p in paths)


def test_batched_sweep_matches_loop_grid():
    """fe_sweep_scan (the vmapped grid behind explore --batched) must
    equal pricing each point on its own at its own epoch."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from nmch.ops.fe import fe_sweep_scan, fe_moments_scan, path_index_grid
    from nmch.rng.philox import split_seed
    from nmch.explore import grid_points

    pts = grid_points()[:5]
    base = HestonParams()
    pm = jnp.asarray([[base.T, base.S_0, base.v_0, base.r, k, base.rho,
                       theta, sigma] for (k, theta, sigma) in pts],
                     jnp.float32)
    n_paths, N = 1024, 16
    ms_g, m2_g = fe_sweep_scan(pm, 1234, 3, N=N, n_paths=n_paths)
    k0, k1 = split_seed(1234)
    one = jax.jit(fe_moments_scan, static_argnums=1)
    for i in range(len(pts)):
        m, m2 = one(pm[i], N, path_index_grid(n_paths), jnp.uint32(3 + i),
                    k0, k1)
        # same draws; vmap may reorder the float32 sums
        np.testing.assert_allclose(float(ms_g[i]), float(m), rtol=1e-6)
        np.testing.assert_allclose(float(m2_g[i]), float(m2), rtol=1e-6)


def test_explore_batched_csv(tmp_path):
    out = tmp_path / "sweep.csv"
    rc = explore_run(["--NB", "1", "--N", "6", "--engine", "scan",
                      "--methods", "fe", "--batched", "--out", str(out)])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert len(lines) > 50
    for line in lines[1:]:
        parts = [p.strip() for p in line.split(",")]
        assert parts[0] == "fe" and len(parts) == 6


def test_em_batched_sweep_matches_golden():
    """em_sweep_scan == per-point em_moments_scan at each point's
    epoch, conditional and plain."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from nmch.ops.em import em_sweep_scan, em_moments_scan, path_index_grid
    from nmch.rng.philox import split_seed
    pm = jnp.asarray([[1, 1, 0.1, 0, k, -0.7, 0.1, 0.3]
                      for k in (0.5, 2.0)], jnp.float32)
    k0, k1 = split_seed(11)
    one = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8))
    for cond in (False, True):
        mg, m2g = em_sweep_scan(pm, 11, 0, N=5, n_paths=256,
                                rng="threefry4", conditional=cond,
                                poisson_cut=128.0)
        for i in range(2):
            m, m2 = one(pm[i], 5, path_index_grid(256), jnp.uint32(i),
                        k0, k1, "threefry4", cond, 128.0)
            np.testing.assert_allclose(float(mg[i]), float(m), rtol=1e-6)
            np.testing.assert_allclose(float(m2g[i]), float(m2),
                                       rtol=1e-6)


def test_explore_batched_em_csv(tmp_path):
    out = tmp_path / "sweep.csv"
    rc = explore_run(["--NB", "1", "--N", "4", "--engine", "scan",
                      "--methods", "em", "--batched", "--out", str(out)])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert len(lines) > 50
    assert all(l.startswith("em,") for l in lines[1:])


def test_explore_batched_em_conditional_threefry4(capsys):
    """Batched EM sweep composes with conditional EM and threefry4."""
    from nmch.explore import run
    rc = run(["--batched", "--methods", "em", "--NTPB", "128", "--NB", "1",
              "--N", "4", "--rng", "threefry4", "--conditional"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("em,")]
    assert len(lines) == 200       # the reference's feasible grid size
    import math
    errs = [float(l.split(",")[5]) for l in lines]
    assert all(math.isfinite(e) and e >= 0 for e in errs)


def test_cli_em_stateful_explicit_pallas_is_parser_error(capsys):
    """--method em --rng xorwow --engine pallas must exit with a parser
    error, not a raw ValueError traceback (the engine=None
    auto-resolution only protects the default path)."""
    with pytest.raises(SystemExit) as ex:
        cli_run(["--method", "em", "--rng", "xorwow",
                 "--engine", "pallas", "--NB", "2", "--N", "8"])
    assert ex.value.code == 2
    assert "scan" in capsys.readouterr().err
