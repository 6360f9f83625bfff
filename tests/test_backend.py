"""Where the kernels run (nmch/utils/backend.py) and where compiled
programs are cached (nmch/utils/cache.py)."""

import os

import pytest

from nmch.utils import backend, cache


def _platform(monkeypatch, platform, platforms_cfg):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: platform)
    monkeypatch.setattr(backend, "_configured_platforms",
                        lambda: platforms_cfg or "")


def test_gpu_compiles_the_kernels(monkeypatch):
    _platform(monkeypatch, "gpu", None)
    assert backend.kernel_interpret() is False


@pytest.mark.parametrize("cfg", ["cpu", " CPU ", "cpu,cpu"])
def test_cpu_that_was_asked_for_interprets(monkeypatch, cfg):
    _platform(monkeypatch, "cpu", cfg)
    assert backend.cpu_requested() is True
    assert backend.kernel_interpret() is True


@pytest.mark.parametrize("cfg", [None, "", "cuda,cpu"])
def test_cpu_that_was_not_asked_for_raises(monkeypatch, cfg):
    _platform(monkeypatch, "cpu", cfg)
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        backend.kernel_interpret()


def test_other_platform_raises(monkeypatch):
    _platform(monkeypatch, "rocm", None)
    with pytest.raises(RuntimeError, match="unsupported platform"):
        backend.kernel_interpret()


def test_methods_resolve_interpret_through_backend(monkeypatch):
    """NMCH_FE/NMCH_EM take the decision from the one resolver, and
    only the fused engine needs it."""
    from nmch import NMCH_FE, NMCH_EM, HestonParams, SimConfig
    cfg = SimConfig(NTPB=128, NB=1, N=4)
    assert NMCH_FE(cfg, HestonParams()).interpret is True
    assert NMCH_EM(cfg, HestonParams()).interpret is True
    _platform(monkeypatch, "cpu", None)
    with pytest.raises(RuntimeError):
        NMCH_FE(cfg, HestonParams(), engine="pallas")
    assert NMCH_FE(cfg, HestonParams(), engine="scan").interpret is False


def test_cache_env_directory_is_honoured(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cache.jax.config, "update",
                        lambda *a: calls.append(a))
    assert cache.setup_compile_cache() == str(tmp_path)
    assert calls == []                 # JAX's own reading stands


def test_cache_defaults_to_fixed_path_in_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache.jax.config, "update",
                        lambda *a: calls.append(a))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert cache.setup_compile_cache() == want
    assert cache.setup_compile_cache() == want     # same path every run
    assert calls == [("jax_compilation_cache_dir", want)] * 2
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
