"""CI/statistics formula tests — parity with the reference's get_err()."""

import math

import pytest

from nmch.results import SimResult, reference_err, correct_ci_error


def test_reference_err_formula_verbatim():
    """Hand-evaluate the reference expression (NMCH_FE.hpp:50-55):
    1.96*sqrt((1/(n-1))*(n*E[X^2] - E[X]^2))/sqrt(n)."""
    mean, mean_sq, n = 0.12, 0.045, 262144
    expected = 1.96 * math.sqrt((1.0 / (n - 1)) * (n * mean_sq - mean**2)) \
        / math.sqrt(n)
    assert reference_err(mean, mean_sq, n) == pytest.approx(expected)


def test_correct_ci_is_textbook_sample_variance():
    mean, mean_sq, n = 0.12, 0.045, 10000
    var = (n / (n - 1)) * (mean_sq - mean**2)
    assert correct_ci_error(mean, mean_sq, n) == pytest.approx(
        1.96 * math.sqrt(var / n))


def test_formulas_agree_for_small_mean():
    """For payoff distributions with mean^2 << E[X^2] and large n, the
    reference formula ~ equals the correct one (why their plots looked
    right despite the missing factor n on the mean term)."""
    mean, mean_sq, n = 0.12, 0.045, 262144
    a = reference_err(mean, mean_sq, n)
    b = correct_ci_error(mean, mean_sq, n)
    assert abs(a - b) / b < 0.25


def test_degenerate_cases():
    assert math.isnan(reference_err(0.1, 0.04, 1))
    assert math.isnan(correct_ci_error(0.1, 0.04, 0))
    # negative variance guard (can happen at tiny n with the ref formula)
    assert math.isnan(reference_err(1.0, 0.0, 2))
    assert correct_ci_error(1.0, 0.0, 2) == 0.0


def test_simresult_accessors():
    r = SimResult(price=0.12, price_squared=0.045, n_paths=1024)
    assert r.strike_price == r.price
    assert r.std_error == pytest.approx(r.ci_error / 1.96)
    assert r.err > 0


def test_synthesized_moments_err_is_nan():
    """QMC results carry synthesized (replicate-CI) moments; the
    reference-parity err formula has no meaning there and must
    hard-fail to NaN instead of returning ~1.96|m|/sqrt(n).
    ci_error stays the honest RQMC CI."""
    import math
    from nmch.results import SimResult
    r = SimResult(0.12, 0.0145, 1 << 20, synthesized_moments=True)
    assert math.isnan(r.err)
    assert r.ci_error > 0
    plain = SimResult(0.12, 0.0145, 1 << 20)
    assert plain.err > 0


def test_fe_qmc_result_flagged_synthesized():
    import math
    import jax
    from nmch.params import HestonParams, SimConfig
    from nmch.methods.fe import NMCH_FE
    m = NMCH_FE(SimConfig(NTPB=128, NB=8, N=16), HestonParams(),
                engine="qmc")
    m.init(3)
    res = m.compute()
    assert res.synthesized_moments
    assert math.isnan(res.err)
    assert res.ci_error > 0
