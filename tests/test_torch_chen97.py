"""The Chen97 carry switch (``physics/flux.py:CHEN97_FIXED_CARRY``, the
JAX package's ``tuning.CHEN97_FIXED_CARRY``) on, in both packages, on
the case of ``tests/test_conservation.py::test_chen97_fixed_carry``: 4
points of land use 7 and soil 6, ``Options(sfc=2)``, 10 steps of the
same warm-day forcing.  The port's eager step and the fused step's plain
version (``column_plain``) end within the step's bars (``cases.py``) of
the JAX step; the budgets close and ``ch`` moves away from the default
run, as the JAX test asserts.  The host build of the kernels is held
with the switch on in ``test_torch_column_host.py``.

One JAX compile (the jitted step with the switch on), shared by the
module.  Both switches are set through ``MonkeyPatch``, so that they are
restored whatever happens.
"""

import numpy as np
import pytest

from noahmp_tpu import state as jstate
from noahmp_tpu import tuning
from noahmp_tpu.driver.step import make_step as jax_make_step
from noahmp_tpu.options import Options as JOptions
from noahmp_tpu.params import load_params as jax_load_params

from noahmp_tpu_torch import Options, load_params, make_fused_step, make_step
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, STATE_BAR,
                                    STATE_CEILING, bar_ratio)
from noahmp_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from noahmp_tpu_torch.physics import flux as tflux
from noahmp_tpu_torch.state import Forcing, init_state, init_static

N = 4
STEPS = 10
DT = 900.0
# tests/test_conservation.py's bounds for this case
SW_TOL, ENG_TOL, WAT_TOL = 0.01, 0.02, 0.05
FORCING = dict(sfctmp=295.0, sfcprs=90000.0, psfc=90000.0, uu=3.0, vv=1.0,
               q2=0.008, soldn=600.0, lwdn=350.0, prcp=0.0, cosz=0.7,
               co2air=39.0, o2air=18900.0, foln=1.0, julian=180.0,
               yearlen=366.0)


def _forcing():
    return {k: np.full((N,), v, np.float32) for k, v in FORCING.items()}


@pytest.fixture(scope="module")
def jax_run():
    """(state, flux) dicts of numpy leaves after STEPS jitted JAX steps
    with the switch on (read when the step is traced)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tuning, "CHEN97_FIXED_CARRY", True)
        step = jax_make_step(jax_load_params("USGS", "STAS"), JOptions(sfc=2),
                             dt=DT, donate=False)
        static = jstate.init_static(N, lutyp=7, sltyp=6)
        forcing = jstate.Forcing(**_forcing())
        state = jstate.init_state(N)
        for _ in range(STEPS):
            state, flux = step(static, forcing, state)
        return ({k: np.asarray(v) for k, v in state._asdict().items()},
                {k: np.asarray(v) for k, v in flux._asdict().items()})


def port_run(entry, fixed_carry, monkeypatch):
    monkeypatch.setattr(tflux, "CHEN97_FIXED_CARRY", fixed_carry)
    params = load_params("USGS", "STAS", device="cpu")
    static = init_static(N, lutyp=7, sltyp=6, device="cpu")
    forcing = tree_from_numpy(Forcing, _forcing(), "cpu")
    state = init_state(N, device="cpu")
    if entry == "make_step":
        step = make_step(params, Options(sfc=2), DT, device="cpu")
    else:
        step = make_fused_step(params, Options(sfc=2), DT, static,
                               device="cpu")
    for _ in range(STEPS):
        state, flux = step(static, forcing, state)
    return tree_to_numpy(state), tree_to_numpy(flux)


@pytest.mark.parametrize("entry", ["make_step", "column_plain"])
def test_chen97_fixed_carry_matches_jax(jax_run, entry, monkeypatch):
    got = port_run(entry, True, monkeypatch)
    for ref, new, bar, ceiling in ((jax_run[0], got[0], STATE_BAR,
                                    STATE_CEILING),
                                   (jax_run[1], got[1], FLUX_BAR,
                                    FLUX_CEILING)):
        assert list(ref) == list(new)
        for name, r in ref.items():
            if r.dtype == np.int32:
                np.testing.assert_array_equal(new[name], r, err_msg=name)
                continue
            ratio = bar_ratio(r, new[name], bar, ceiling)
            assert ratio <= 1.0, f"{entry} {name}: {ratio:.3g} x the bar"


@pytest.mark.parametrize("entry", ["make_step", "column_plain"])
def test_chen97_fixed_carry_closes_budgets_and_moves_ch(entry, monkeypatch):
    """What the JAX test asserts of its own step: budgets close, ``ch``
    differs from the default run, ``tg`` stays in the same regime."""
    state_q, _ = port_run(entry, False, monkeypatch)
    state_f, flux_f = port_run(entry, True, monkeypatch)
    assert np.all(np.abs(flux_f["errsw"]) < SW_TOL)
    assert np.all(np.abs(flux_f["erreng"]) < ENG_TOL)
    assert np.all(np.abs(flux_f["errwat"]) < WAT_TOL)
    assert not np.allclose(state_f["ch"], state_q["ch"])
    assert np.allclose(state_f["tg"], state_q["tg"], atol=2.0)
