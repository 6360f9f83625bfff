"""Multi-chip sharding tests on the 8-virtual-device CPU mesh.

The key invariant: sharding is schedule, not math — an n-chip run must
reproduce the single-device run exactly (identical per-path Philox
streams via base_path offsets, deterministic psum), a property the
reference's atomicAdd reduction could not offer (SURVEY.md §5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nmch.params import HestonParams
from nmch.parallel.mesh import make_mesh, sharded_moments
from nmch.ops.fe import fe_moments_scan, path_index_grid
from nmch.ops.em import em_moments_scan
from nmch.rng.philox import split_seed

P = HestonParams()


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(jax.devices()[:8])


def _single(method, n_paths, N, seed=1234, epoch=0):
    k0, k1 = split_seed(seed)
    if method == "fe":
        m, m2 = jax.jit(fe_moments_scan, static_argnums=1)(
            P.as_array(), N, path_index_grid(n_paths), jnp.uint32(epoch),
            k0, k1)
    else:
        # sharded_moments' EM default resolves to NMCH_EM's fast
        # poisson cut (mesh.py docstring) — the golden must draw the
        # same randomness
        from nmch.ops.em import FAST_POISSON_CUT
        m, m2 = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8))(
            P.as_array(), N, path_index_grid(n_paths), jnp.uint32(epoch),
            k0, k1, "philox", False, FAST_POISSON_CUT)
    return float(m), float(m2)


@pytest.mark.parametrize("method", ["fe", "em"])
def test_sharded_matches_single_device(mesh8, method):
    n_paths, N = 8192, 20
    m1, m21 = _single(method, n_paths, N)
    m8, m28 = sharded_moments(mesh8, P.as_array(), seed=1234, epoch=0,
                              N=N, n_paths=n_paths, method=method,
                              engine="scan")
    # same draws; only the reduction grouping differs (8 partial means)
    assert float(m8) == pytest.approx(m1, rel=2e-6)
    assert float(m28) == pytest.approx(m21, rel=2e-6)


def test_sharded_n_paths_validation(mesh8):
    with pytest.raises(ValueError):
        sharded_moments(mesh8, P.as_array(), seed=1, epoch=0,
                        N=4, n_paths=128 * 3, method="fe", engine="scan")


def test_two_device_mesh(mesh8):
    mesh2 = make_mesh(jax.devices()[:2])
    m2_, _ = sharded_moments(mesh2, P.as_array(), seed=1234, epoch=0,
                             N=20, n_paths=8192, method="fe",
                             engine="scan")
    m1, _ = _single("fe", 8192, 20)
    assert float(m2_) == pytest.approx(m1, rel=2e-6)


def test_sharded_fe_pallas_interpret(mesh8):
    """FE + engine='pallas' under shard_map — the production scale-out
    configuration (fused kernel per chip, disjoint stream ranges)."""
    m8, m28 = sharded_moments(mesh8, P.as_array(), seed=1234, epoch=0,
                              N=16, n_paths=4096, method="fe",
                              engine="pallas", interpret=True)
    m1, m21 = _single("fe", 4096, 16)
    assert float(m8) == pytest.approx(m1, rel=2e-6)
    assert float(m28) == pytest.approx(m21, rel=2e-6)


def test_sharded_rejects_bad_combos(mesh8):
    with pytest.raises(ValueError, match="philox"):
        sharded_moments(mesh8, P.as_array(), seed=1, epoch=0,
                        N=4, n_paths=1024, method="em", engine="scan",
                        rng="threefry")


def test_sharded_scan_threefry_respects_rng(mesh8):
    """rng='threefry' with engine='scan' must give threefry draws (was
    silently philox once)."""
    k0, k1 = split_seed(1234)
    m1, _ = jax.jit(fe_moments_scan, static_argnums=(1, 6))(
        P.as_array(), 16, path_index_grid(4096), jnp.uint32(0), k0, k1,
        "threefry")
    m8, _ = sharded_moments(mesh8, P.as_array(), seed=1234, epoch=0,
                            N=16, n_paths=4096, method="fe",
                            engine="scan", rng="threefry")
    assert float(m8) == pytest.approx(float(m1), rel=2e-6)
    m_ph, _ = sharded_moments(mesh8, P.as_array(), seed=1234, epoch=0,
                              N=16, n_paths=4096, method="fe",
                              engine="scan", rng="philox")
    assert float(m8) != float(m_ph)


def test_sharded_em_pallas_interpret(mesh8):
    """EM + engine='pallas' must actually use the EM kernel (was
    silently downgraded to scan once)."""
    m8, _ = sharded_moments(mesh8, P.as_array(), seed=1234, epoch=0,
                            N=8, n_paths=2048, method="em",
                            engine="pallas", interpret=True)
    m1, _ = _single("em", 2048, 8)
    assert float(m8) == pytest.approx(m1, rel=2e-6)


def test_sharded_rot4_matches_single(mesh8):
    """The headline rot=4 config under shard_map reproduces the
    single-device rot=4 run (pallas interpret + scan)."""
    from nmch.ops.fe import fe_moments_rot_scan
    k0, k1 = split_seed(1234)
    m1, _ = jax.jit(fe_moments_rot_scan, static_argnums=(1, 6, 7))(
        P.as_array(), 16, path_index_grid(4096), jnp.uint32(0), k0, k1,
        "philox", 4)
    for engine in ("scan", "pallas"):
        m8, _ = sharded_moments(mesh8, P.as_array(), seed=1234, epoch=0,
                                N=16, n_paths=4096, method="fe",
                                engine=engine, rot=4, interpret=True)
        assert float(m8) == pytest.approx(float(m1), rel=2e-6), engine


def test_sharded_em_conditional_matches_single(mesh8):
    from nmch.ops.em import em_moments_scan
    k0, k1 = split_seed(1234)
    m1, _ = jax.jit(em_moments_scan, static_argnums=(1, 6, 7))(
        P.as_array(), 8, path_index_grid(2048), jnp.uint32(0), k0, k1,
        "philox", True)
    m8, _ = sharded_moments(mesh8, P.as_array(), seed=1234, epoch=0,
                            N=8, n_paths=2048, method="em",
                            engine="pallas", conditional=True,
                            interpret=True)
    assert float(m8) == pytest.approx(float(m1), rel=2e-6)


def test_sharded_qmc_matches_single(mesh8):
    """Point-index-range sharding of the QMC engine: the 8-chip run consumes bit-identical slices of the
    single-device randomized point set, so the psum'd replicate means
    reproduce the single-device result to f32 summation tolerance."""
    from nmch.ops.fe_qmc import fe_moments_qmc
    k0, k1 = split_seed(1234)
    m1, m21 = fe_moments_qmc(P.as_array(), jnp.uint32(3), k0, k1,
                             N=16, n_paths=8 * 4096)
    m8, m28 = sharded_moments(mesh8, P.as_array(), seed=1234, epoch=3,
                              N=16, n_paths=8 * 4096, engine="qmc",
                              interpret=True)
    assert float(m8) == pytest.approx(float(m1), rel=2e-6)
    assert float(m28) == pytest.approx(float(m21), rel=2e-4)


def test_sharded_qmc_validation(mesh8):
    with pytest.raises(ValueError, match="qmc"):
        sharded_moments(mesh8, P.as_array(), seed=1, epoch=0, N=8,
                        n_paths=8 * 16 * 8, method="em", engine="qmc",
                        interpret=True)
    with pytest.raises(ValueError, match="rot"):
        sharded_moments(mesh8, P.as_array(), seed=1, epoch=0, N=8,
                        n_paths=8 * 16 * 8, engine="qmc", rot=4,
                        interpret=True)


@pytest.mark.parametrize("rng", ["mrg32k3a", "xorwow"])
def test_sharded_stateful_family_matches_single(mesh8, rng):
    """The stateful parity families shard via their skip-ahead: each
    chip jumps to its disjoint path range, so n-chip == 1-chip
    bitwise."""
    if rng == "mrg32k3a":
        from nmch.ops.fe_mrg import fe_moments_mrg as single_fn
    else:
        from nmch.ops.fe_xorwow import fe_moments_xorwow as single_fn
    n_paths, N = 2048, 10
    m8, m28 = sharded_moments(mesh8, P.as_array(), seed=1234, epoch=0,
                              N=N, n_paths=n_paths, method="fe",
                              engine="scan", rng=rng)
    m1, m21 = jax.jit(single_fn, static_argnums=(1, 4))(
        P.as_array(), N, path_index_grid(n_paths), jnp.uint32(0), 1234)
    assert float(m8) == pytest.approx(float(m1), rel=1e-6)
    assert float(m28) == pytest.approx(float(m21), rel=1e-6)


def test_sharded_stateful_family_rejects_bad_combos(mesh8):
    # method="em" with engine="scan" is allowed (the samplers advance
    # the carried state); pallas sharding of the stateful families and
    # rot variants are invalid
    for bad in ({"engine": "pallas"}, {"rot": 4}):
        kw = dict(N=4, n_paths=1024, method="fe", engine="scan",
                  rng="mrg32k3a")
        kw.update(bad)
        with pytest.raises(ValueError):
            sharded_moments(mesh8, P.as_array(), seed=1, epoch=0, **kw)


def test_sharded_em_default_poisson_cut_matches_method_layer(mesh8):
    """Default sharded EM must draw the SAME randomness as a default
    single-chip NMCH_EM run: the mesh layer must not fall through to
    the ops-layer curand cut 4000 while NMCH_EM defaults to the
    measured fast cut, or in the lambda in (128, 4000) regime sharded
    and single-chip default runs silently diverge."""
    from nmch.ops.em import em_moments_scan, FAST_POISSON_CUT
    # sigma=0.05 puts lambda ~ 6e2 between the two cuts at N=8
    p = HestonParams(sigma=0.05)
    n_paths, N = 2048, 8
    m8, _ = sharded_moments(mesh8, p.as_array(), seed=1234, epoch=0,
                            N=N, n_paths=n_paths, method="em",
                            engine="scan")
    k0, k1 = split_seed(1234)
    fn = jax.jit(em_moments_scan, static_argnums=(1, 6, 7, 8))
    m_fast, _ = fn(p.as_array(), N, path_index_grid(n_paths),
                   jnp.uint32(0), k0, k1, "philox", False,
                   FAST_POISSON_CUT)
    m_curand, _ = fn(p.as_array(), N, path_index_grid(n_paths),
                     jnp.uint32(0), k0, k1, "philox", False, None)
    assert float(m8) == pytest.approx(float(m_fast), rel=2e-6)
    assert float(m_fast) != float(m_curand)   # the regimes do differ
    with pytest.raises(ValueError, match="EM-only"):
        sharded_moments(mesh8, p.as_array(), seed=1, epoch=0, N=4,
                        n_paths=1024, method="fe", engine="scan",
                        poisson_cut=128.0)
