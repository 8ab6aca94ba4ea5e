"""``noahmp_tpu_torch.utils``: the budget check names the worst column,
the NaN report finds a planted NaN, the timer counts, the profiler
wrapper writes a trace."""

import os

import numpy as np
import pytest
import torch

from noahmp_tpu_torch import Options, load_params, make_step, utils
from noahmp_tpu_torch.cases import hetero_case, to_device


@pytest.fixture(scope="module")
def stepped():
    static, forcing, state = to_device(hetero_case("warm_day", 8), "cpu")
    step = make_step(load_params(device="cpu"), Options(), 900.0,
                     device="cpu")
    new_state, flux = step(static, forcing, state)
    return static, new_state, flux


def test_check_budgets_passes_a_clean_step(stepped):
    static, _state, flux = stepped
    utils.check_budgets(flux, ist=static.ist)
    assert (utils.SW_TOL, utils.ENG_TOL, utils.WAT_TOL) == (0.01, 0.05, 0.5)


@pytest.mark.parametrize("name, tol", [("errsw", utils.SW_TOL),
                                       ("erreng", utils.ENG_TOL),
                                       ("errwat", utils.WAT_TOL)])
def test_check_budgets_names_the_worst_column(stepped, name, tol):
    static, _state, flux = stepped
    leaf = getattr(flux, name).clone()
    leaf[1] = 2.0 * tol
    leaf[6] = -5.0 * tol
    bad = flux._replace(**{name: leaf})
    with pytest.raises(utils.ConservationError,
                       match=f"{name} = .* at column 6") as err:
        utils.check_budgets(bad, ist=static.ist)
    assert isinstance(err.value, AssertionError)
    assert f"tolerance {tol}" in str(err.value)


def test_check_budgets_ignores_water_residual_off_land(stepped):
    static, _state, flux = stepped
    lake = int((static.ist != 1).nonzero()[0])
    leaf = flux.errwat.clone()
    leaf[lake] = 99.0
    bad = flux._replace(errwat=leaf)
    utils.check_budgets(bad, ist=static.ist)
    with pytest.raises(utils.ConservationError, match=f"column {lake}"):
        utils.check_budgets(bad)


def test_nan_report_finds_a_planted_nan(stepped):
    _static, state, flux = stepped
    utils.assert_finite(state)
    assert utils.nan_report(state) == {}
    stc = state.stc.clone()
    stc[3, 2] = float("nan")
    stc[5, 0] = float("inf")
    bad = state._replace(stc=stc, tg=torch.full_like(state.tg, float("nan")))
    assert utils.nan_report(bad) == {"State.stc": 2, "State.tg": 8}
    assert utils.nan_report((bad, {"x": np.array([np.nan, 1.0])}),
                            prefix="run") == {
        "run[0].State.stc": 2, "run[0].State.tg": 8, "run[1]['x']": 1}
    with pytest.raises(FloatingPointError, match="State.stc"):
        utils.assert_finite(bad, what="the state after step 3")
    # the vegetated tile's diagnostics are NaN where nothing grows; the
    # int leaves are not looked at
    assert set(utils.nan_report(flux)) <= {
        "Flux." + k for k in ("irc", "irg", "shc", "shg", "evc", "evg", "ghv",
                              "tr", "chleaf", "chuc", "chv2", "t2mv", "q2v")}


def test_step_timer_counts_steps():
    timer = utils.StepTimer(1000)
    for _ in range(3):
        with timer:
            pass
    assert timer.steps == 3 and timer.elapsed >= 0.0
    assert timer.points_per_sec > 0 and timer.ms_per_step >= 0
    assert timer.summary().startswith("3 steps, ")


def test_profile_step_writes_a_trace(tmp_path, stepped):
    _static, state, _flux = stepped
    with utils.profile_step(str(tmp_path / "prof")) as prof:
        (state.tg * 2.0).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert any("mul" in e.key for e in prof.key_averages())
