"""The port's full model step against the JAX package's, on the CPU.

One step from the same state (a resync, never a free-running comparison:
the JAX package itself sees rare Newton iteration-count differences at
knife-edge states), on the heterogeneous 8-column block under the four
forcing regimes.  Every State and Flux leaf is compared; the bars and
their reasons are in ``noahmp_tpu_torch/cases.py``.
"""

import numpy as np
import pytest
import torch

from noahmp_tpu import state as jstate
from noahmp_tpu.driver.step import make_step as jax_make_step
from noahmp_tpu.options import Options as JOptions
from noahmp_tpu.params import load_params as jax_load_params

from noahmp_tpu_torch import Options, load_params, make_step
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, REGIMES,
                                    STATE_BAR, STATE_CEILING, bar_ratio,
                                    hetero_case, to_device)
from noahmp_tpu_torch.convert import tree_to_numpy
from noahmp_tpu_torch import options as topt
from noahmp_tpu_torch.options import OPTION_VALUES, UNPORTED
from noahmp_tpu_torch.physics import flux as tflux

DT = 900.0
RESIDUAL_BOUND = 0.01    # the reference model aborts above (W/m2, mm)


def jax_step(case, opts=JOptions(), frzx_compat=True):
    """(state, flux) dicts of numpy leaves from the JAX package, run as
    its own CPU tests run it (no jit)."""
    params = jax_load_params(frzx_compat=frzx_compat)
    step = jax_make_step(params, opts, DT, jit=False)
    static, forcing, state = case
    s, f = step(jstate.Static(**static), jstate.Forcing(**forcing),
                jstate.State(**state))
    return ({k: np.asarray(v) for k, v in s._asdict().items()},
            {k: np.asarray(v) for k, v in f._asdict().items()})


def torch_step(case, opts=Options(), frzx_compat=True, steps=1):
    params = load_params(frzx_compat=frzx_compat, device="cpu")
    step = make_step(params, opts, DT, device="cpu")
    static, forcing, state = to_device(case, "cpu")
    flux = None
    for _ in range(steps):
        state, flux = step(static, forcing, state)
    return tree_to_numpy(state), tree_to_numpy(flux)


def assert_step_close(ref, got):
    """Every leaf of (state, flux): integers exactly, floats within the
    element-wise bar and the ceiling."""
    worst = 0.0
    for r_tree, g_tree, bar, ceiling in (
            (ref[0], got[0], STATE_BAR, STATE_CEILING),
            (ref[1], got[1], FLUX_BAR, FLUX_CEILING)):
        assert list(r_tree) == list(g_tree)
        for name, r in r_tree.items():
            g = g_tree[name]
            assert r.dtype == g.dtype and r.shape == g.shape, name
            if r.dtype == np.int32:
                np.testing.assert_array_equal(g, r, err_msg=name)
                continue
            ratio = bar_ratio(r, g, bar, ceiling)
            assert ratio <= 1.0, (
                f"{name}: {ratio:.3g} x the allowed error (bar {bar}, "
                f"ceiling {ceiling})")
            worst = max(worst, ratio)
    return worst


def assert_residuals(static, flux):
    land = static["ist"] == 1
    assert np.max(np.abs(flux["errsw"][land])) < RESIDUAL_BOUND
    assert np.max(np.abs(flux["erreng"][land])) < RESIDUAL_BOUND
    assert np.max(np.abs(flux["errwat"])) < RESIDUAL_BOUND


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references for the default options, computed once."""
    return {r: jax_step(hetero_case(r)) for r in REGIMES}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_step_matches_jax(jax_refs, regime):
    case = hetero_case(regime)
    got = torch_step(case)
    ref = jax_refs[regime]
    assert len(got[0]) == 36 and len(got[1]) == 61
    assert_step_close(ref, got)
    # integer outputs exactly: snow layer count (driven by imelt and the
    # re-layering)
    np.testing.assert_array_equal(got[0]["nsnow"], ref[0]["nsnow"])
    assert got[0]["nsnow"].dtype == np.int32
    assert_residuals(case[0], got[1])


def test_cold_snow_builds_a_layer(jax_refs):
    """The cold_snow regime starts with a 12 cm bulk pack: the step must
    turn it into snow layers, as the JAX step does."""
    ref_nsnow = jax_refs["cold_snow"][0]["nsnow"]
    assert ref_nsnow.max() >= 1
    got = torch_step(hetero_case("cold_snow"))
    np.testing.assert_array_equal(got[0]["nsnow"], ref_nsnow)


@pytest.mark.parametrize("name,value", [("veg", 2), ("veg", 5)])
def test_unported_option_raises(monkeypatch, name, value):
    """The refusal table is empty and stays in use: a value listed in it
    raises when a step is built, naming the value and what is missing;
    unlisted, the same value builds."""
    params = load_params(device="cpu")
    assert UNPORTED == {}
    make_step(params, Options(**{name: value}), DT, device="cpu")
    monkeypatch.setitem(topt.UNPORTED, name, {value: "a branch to come"})
    with pytest.raises(NotImplementedError,
                       match=f"opt_{name}={value}: a branch to come"):
        make_step(params, Options(**{name: value}), DT, device="cpu")


@pytest.mark.parametrize("name,value", [(n, v) for n, vals in
                                        OPTION_VALUES.items() for v in vals])
def test_every_option_value_builds(name, value):
    """Every value of every option builds the eager step; a value that
    is none of its option's raises."""
    params = load_params(device="cpu")
    make_step(params, Options(**{name: value}), DT, device="cpu")
    with pytest.raises(ValueError, match=f"opt_{name}=99"):
        make_step(params, Options(**{name: 99}), DT, device="cpu")


def test_default_options_are_ported():
    make_step(load_params(device="cpu"), Options(), DT, device="cpu")
    assert Options() == JOptions()
    assert Options._fields == JOptions._fields


def test_quirk_qsfc_comes_from_bare_flux(monkeypatch, jax_refs):
    """The persisted QSFC is the bare-tile value even on vegetated tiles
    (the reference threads one QSFC through both tile solves)."""
    seen = {}
    real = tflux.bare_flux

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen["qsfc"] = out.qsfc.numpy().copy()
        return out

    monkeypatch.setattr(tflux, "bare_flux", spy)
    case = hetero_case("warm_day")
    state, flux = torch_step(case)
    not_urban = case[0]["lutyp"] != 1      # urban QSFC is overridden later
    vegetated = flux["fveg"] > 0
    assert vegetated.any()
    np.testing.assert_array_equal(state["qsfc"][not_urban],
                                  seen["qsfc"][not_urban])
    ratio = bar_ratio(jax_refs["warm_day"][0]["qsfc"], state["qsfc"],
                      STATE_BAR, STATE_CEILING)
    assert ratio <= 1.0


def test_quirk_canres_psn_is_zero():
    """Jarvis resistance (opt_crs=2): PSN is 0 where the JAX package
    gives 0 (the reference leaves it undefined), never NaN."""
    case = hetero_case("warm_day")
    ref = jax_step(case, JOptions(crs=2))[1]["psn"]
    got = torch_step(case, Options(crs=2))[1]["psn"]
    np.testing.assert_array_equal(ref, np.zeros_like(ref))
    np.testing.assert_array_equal(got, np.zeros_like(got))


def test_quirk_canopy_buried_by_snow_is_clamped():
    """HCAN <= ZPD (grass and crops under 2 m of snow) aborts the
    reference; both packages clamp instead and stay finite."""
    case = hetero_case("cold_snow")
    case[2]["snowh"][:] = 2.0
    case[2]["sneqv"][:] = 500.0
    ref = jax_step(case)
    got = torch_step(case)
    assert_step_close(ref, got)
    for name, leaf in got[0].items():
        assert np.isfinite(leaf).all(), name


def test_free_run_builds_and_relayers_snow():
    """16 steps of the port alone under steady snowfall: layers build,
    combine and divide; everything stays finite and conserves."""
    case = hetero_case("cold_snow")
    params = load_params(device="cpu")
    step = make_step(params, Options(), DT, device="cpu")
    static, forcing, state = to_device(case, "cpu")
    counts = []
    for _ in range(16):
        state, flux = step(static, forcing, state)
        counts.append(state.nsnow.clone())
        f = tree_to_numpy(flux)
        assert_residuals(case[0], f)
    s = tree_to_numpy(state)
    for name, leaf in s.items():
        assert np.isfinite(leaf).all(), name
    counts = torch.stack(counts).numpy()
    assert counts.max() >= 2            # the pack was divided
    assert (s["sneqv"][case[0]["ist"] == 1] > 25.0).all()
    active = np.arange(3)[None, :] >= (3 - s["nsnow"])[:, None]
    assert (s["snice"][~active] == 0).all()
    assert (s["zsnso"][:, :3][~active] == 0).all()
