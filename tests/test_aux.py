"""Auxiliary subsystem tests: checkpoint/resume, JSON output, profiling
ladder, determinism (SURVEY.md §5)."""

import json

import pytest

from nmch import NMCH_FE, HestonParams, SimConfig
from nmch.cli import run as cli_run


CFG = SimConfig(NTPB=512, NB=4, N=50)


def test_checkpoint_resume_reproduces_stream(tmp_path):
    """A resumed pricer must draw exactly what the saved one would."""
    a = NMCH_FE(CFG, HestonParams(), engine="scan")
    a.init(1234)
    a.compute()                       # epoch 0 consumed
    ckpt = tmp_path / "state.json"
    a.save_state(str(ckpt))
    expected = a.compute().price      # epoch 1

    b = NMCH_FE(CFG, HestonParams(), engine="scan")
    b.load_state(str(ckpt))
    assert b.compute().price == expected


def test_checkpoint_roundtrips_params(tmp_path):
    a = NMCH_FE(CFG, HestonParams(sigma=0.42), engine="scan")
    a.init(7)
    ckpt = tmp_path / "s.json"
    a.save_state(str(ckpt))
    b = NMCH_FE(CFG, HestonParams(), engine="scan")
    b.load_state(str(ckpt))
    assert b.params.sigma == 0.42
    assert b.streams.seed == 7


def test_save_before_init_raises(tmp_path):
    m = NMCH_FE(CFG, HestonParams(), engine="scan")
    with pytest.raises(RuntimeError):
        m.save_state(str(tmp_path / "x.json"))


def test_cli_json_output(capsys):
    rc = cli_run(["--method", "fe", "--engine", "scan", "--NB", "4",
                  "--N", "20", "--json", "--oracle"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip())
    for key in ("price", "price_squared", "err", "ci_error",
                "exec_time_ms", "heston_oracle", "n_paths"):
        assert key in rec
    assert abs(rec["price"] - rec["heston_oracle"]) < 5 * rec["ci_error"] + 5e-3


def test_variant_ladder_cpu():
    from nmch.utils.profiling import variant_ladder
    rows = variant_ladder(n_paths=1024, N=10, reps=1, include_em=False,
                          interpret=True)
    # pallas-{threefry,threefry4,philox} + scan-philox
    assert len(rows) == 4
    assert {r["rng"] for r in rows} == {"threefry", "threefry4", "philox"}
    assert all(r["ms"] > 0 for r in rows)


def test_pallas_engine_deterministic_across_runs():
    """SURVEY.md §5: the reference's float atomicAdd made results
    non-deterministic at ULP level; our reduction must be bitwise
    stable run-to-run."""
    m = NMCH_FE(CFG, HestonParams(), engine="pallas", interpret=True)
    m.init(99)
    p1 = m.compute().price
    m2 = NMCH_FE(CFG, HestonParams(), engine="pallas", interpret=True)
    m2.init(99)
    p2 = m2.compute().price
    assert p1 == p2                    # bitwise equal, not approx
