"""Method-layer lifecycle tests (declare/init/compute/print_stats/finalize)."""

import pytest

from nmch import NMCH_FE, NMCH_EM, HestonParams, SimConfig


CFG = SimConfig(NTPB=512, NB=16, N=100)  # 8192 paths — fast on CPU


def test_lifecycle_and_stats(capsys):
    m = NMCH_FE(CFG, HestonParams(), engine="scan")
    m.init(1234)
    res = m.compute()
    assert 0.05 < res.price < 0.2
    assert res.price_squared > res.price ** 2 * 0.9
    m.print_stats()
    out = capsys.readouterr().out
    assert "METHOD: FORWARD-EULER" in out
    assert "The estimated price E[X]" in out
    assert "confidence interval of 95%" in out
    assert "Execution time" in out
    m.finalize()
    assert m.streams is None


def test_compute_before_init_raises():
    m = NMCH_FE(CFG, HestonParams(), engine="scan")
    with pytest.raises(RuntimeError):
        m.compute()


def test_setters_continue_streams():
    """The exploration contract (exploration.cu:14-17): set_* then
    compute() continues the RNG streams — same params but a later epoch
    must give a different (fresh) estimate."""
    m = NMCH_FE(CFG, HestonParams(), engine="scan")
    m.init(1234)
    p1 = m.compute().price
    p2 = m.compute().price          # stream continued, new draws
    assert p1 != p2
    m.set_theta(0.2)
    m.set_sigma(0.5)
    m.set_k(2.0)
    assert m.params.theta == 0.2 and m.params.sigma == 0.5 and m.params.k == 2.0
    p3 = m.compute().price
    assert p3 == p3  # finite
    # re-init with the same seed restarts the streams: first compute
    # reproduces p1 exactly
    m2 = NMCH_FE(CFG, HestonParams(), engine="scan")
    m2.init(1234)
    assert m2.compute().price == p1


def test_reference_getter_names():
    m = NMCH_FE(CFG, HestonParams(), engine="scan")
    m.init(1)
    m.compute()
    assert m.get_strike_price() == m.result.price
    assert m.get_price_squared() == m.result.price_squared
    assert m.get_err() >= 0
    assert m.get_execution_time() > 0


def test_pallas_engine_interpret_lifecycle():
    m = NMCH_FE(SimConfig(NTPB=512, NB=2, N=50), HestonParams(),
                engine="pallas", interpret=True)
    m.init(1234)
    res = m.compute()
    assert 0.02 < res.price < 0.3


def test_stateful_rng_rejects_pallas_engine():
    """The fused kernel draws from counter streams only: the stateful
    families name the scan engine in their error (FE and EM alike)."""
    for rng in ("xorwow", "mrg32k3a"):
        with pytest.raises(ValueError, match="engine='scan'"):
            NMCH_FE(CFG, HestonParams(), engine="pallas", rng=rng)
        with pytest.raises(ValueError, match="engine='scan'"):
            NMCH_EM(CFG, HestonParams(), engine="pallas", rng=rng)


def test_print_stats_reference_format(capsys):
    """Field-for-field parity with the reference's stats block
    (NMCH.cu:16-27 base dump + NMCH_FE.cu:341-349 method part)."""
    m = NMCH_FE(SimConfig(NTPB=512, NB=2, N=100), HestonParams(),
                engine="scan")
    m.init(1)
    m.compute()
    m.print_stats()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Base parameters:"
    assert lines[1] == "NTPB    = 512"
    assert lines[2] == "NB      = 2"
    assert lines[3] == "T       = 1.000000"
    assert lines[4] == "S_0,K   = 1.000000"
    assert lines[5] == "v_0     = 0.100000"
    assert lines[6] == "r       = 0.000000"
    assert lines[7] == "k       = 0.500000"
    assert lines[8] == "theta   = 0.100000"
    assert lines[9] == "sigma   = 0.300000"
    assert lines[10] == "N       = 100"
    assert lines[11] == "dt      = 0.010000"
    assert lines[12] == "METHOD: FORWARD-EULER"
    assert lines[13].startswith("The estimated price E[X] is equal to ")
    assert lines[14].startswith("The estimated E[X^2] is equal to ")
    assert lines[15].startswith("The true price ")
    assert lines[16].startswith(
        "error associated to a confidence interval of 95% = ")
    assert lines[17].startswith("Execution time ")
    assert lines[18].startswith("Initialization time ")


@pytest.mark.parametrize("name", ["fe", "em"])
def test_print_stats_golden_file(name, capsys):
    """The full stats block is a parity artifact (NMCH.cu:13-28 +
    NMCH_FE.cu:333-350 / NMCH_EM.cu:398-414): byte-for-byte golden
    comparison (timing lines normalized; the scan engine on CPU is
    deterministic for a fixed seed).  Regenerate with the snippet in
    the golden file's sibling README if the stream contract ever
    changes intentionally."""
    import re
    import pathlib
    from nmch.methods.em import NMCH_EM
    cls = {"fe": NMCH_FE, "em": NMCH_EM}[name]
    m = cls(SimConfig(NTPB=512, NB=2, N=100), HestonParams(),
            engine="scan")
    m.init(1)
    m.compute()
    m.print_stats()
    out = capsys.readouterr().out
    out = re.sub(r"^(Execution time ).*( ms)$", r"\1<TIME>\2", out,
                 flags=re.M)
    out = re.sub(r"^(Initialization time ).*( ms)$", r"\1<TIME>\2", out,
                 flags=re.M)
    golden = (pathlib.Path(__file__).parent / "golden"
              / f"print_stats_{name}.txt").read_text()
    assert out == golden
