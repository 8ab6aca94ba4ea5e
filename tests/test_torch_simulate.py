"""``simulate`` and ``make_simulate`` of the port against the JAX
package's ``make_simulate`` on the CPU, with and without collected
fluxes, over the eager step and over the fused step's plain version.

Each JAX ``make_simulate`` is a jitted ``lax.scan`` that takes one to
several minutes to compile on the CPU, so the module compiles one: with
``collect_fluxes``, whose final state is also the reference of the runs
without fluxes (the same scan over the same steps).
"""

import numpy as np
import pytest
import torch

from noahmp_tpu import state as jstate
from noahmp_tpu.driver.step import make_simulate as jax_make_simulate
from noahmp_tpu.options import Options as JOptions
from noahmp_tpu.params import load_params as jax_load_params

from noahmp_tpu_torch import (Options, load_params, make_simulate, make_step,
                              simulate)
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, STATE_BAR,
                                    STATE_CEILING, bar_ratio,
                                    forcing_sequence, hetero_case)
from noahmp_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from noahmp_tpu_torch.state import Flux, Forcing, State, Static

DT = 900.0
N, T = 8, 4


def numpy_case():
    static, forcing, state = hetero_case("cold_snow", N)
    return static, forcing_sequence(forcing, T), state


def torch_case():
    static, forcings, state = numpy_case()
    return (tree_from_numpy(Static, static, "cpu"),
            tree_from_numpy(Forcing, forcings, "cpu"),
            tree_from_numpy(State, state, "cpu"))


@pytest.fixture(scope="module")
def jax_refs():
    """(state dict, flux dict) from the JAX package's jitted scan with
    collected fluxes, compiled once for the module."""
    static, forcings, state = numpy_case()
    sim = jax_make_simulate(jax_load_params(), JOptions(), DT,
                            collect_fluxes=True, donate=False)
    s, f = sim(jstate.Static(**static), jstate.Forcing(**forcings),
               jstate.State(**state))
    return ({k: np.asarray(v) for k, v in s._asdict().items()},
            {k: np.asarray(v) for k, v in f._asdict().items()})


def assert_tree_close(ref, got, bar, ceiling):
    assert list(ref) == list(got)
    for name, r in ref.items():
        g = got[name]
        assert r.dtype == g.dtype and r.shape == g.shape, name
        if r.dtype == np.int32:
            np.testing.assert_array_equal(g, r, err_msg=name)
            continue
        ratio = bar_ratio(r, g, bar, ceiling)
        assert ratio <= 1.0, f"{name}: {ratio:.3g} x the allowed error"


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_simulate_collects_what_jax_collects(jax_refs, fused):
    """Final state and every Flux leaf stacked (T, ...), step by step."""
    ref_state, ref_flux = jax_refs
    static, forcings, state = torch_case()
    params = load_params(device="cpu")
    if fused:
        got_state, got_flux = make_simulate(
            params, Options(), DT, static=static, device="cpu")(
                None, forcings, state)
    else:
        got_state, got_flux = simulate(params, Options(), DT, static,
                                       forcings, state, device="cpu")
    assert isinstance(got_flux, Flux)
    assert tuple(got_flux.fsh.shape) == (T, N)
    assert_tree_close(ref_state, tree_to_numpy(got_state), STATE_BAR,
                      STATE_CEILING)
    assert_tree_close(ref_flux, tree_to_numpy(got_flux), FLUX_BAR,
                      FLUX_CEILING)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_make_simulate_without_fluxes(jax_refs, fused):
    """``collect_fluxes=False`` gives (final_state, None), the state the
    JAX scan ends in, and the very bits of the run with fluxes."""
    ref_state, _ref_flux = jax_refs
    static, forcings, state = torch_case()
    sim = make_simulate(load_params(device="cpu"), Options(), DT,
                        collect_fluxes=False,
                        static=static if fused else None, device="cpu")
    got_state, got_flux = sim(static, forcings, state)
    assert got_flux is None and sim.device == torch.device("cpu")
    assert_tree_close(ref_state, tree_to_numpy(got_state), STATE_BAR,
                      STATE_CEILING)
    with_fluxes = make_simulate(load_params(device="cpu"), Options(), DT,
                                static=static if fused else None,
                                device="cpu")(static, forcings, state)[0]
    for a, b in zip(with_fluxes, got_state):
        assert torch.equal(a, b)


def test_simulate_is_the_steps_done_by_hand():
    """The very bits of T single steps, the fluxes stacked in order."""
    static, forcings, state0 = torch_case()
    params = load_params(device="cpu")
    step = make_step(params, Options(), DT, device="cpu")
    state, fluxes = state0, []
    for t in range(T):
        state, flux = step(static, Forcing(*[x[t] for x in forcings]), state)
        fluxes.append(flux)
    got_state, got_flux = make_simulate(params, Options(), DT, device="cpu")(
        static, forcings, state0)
    for a, b in zip(state, got_state):
        assert torch.equal(a, b)
    for name in Flux._fields:
        want = torch.stack([getattr(f, name) for f in fluxes])
        got = getattr(got_flux, name)
        assert torch.equal(want, got) or (
            torch.isnan(want) == torch.isnan(got)).all(), name


def test_simulate_default_device_is_the_card_and_empty_raises():
    static, forcings, state = torch_case()
    params = load_params(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            simulate(params, Options(), DT, static, forcings, state)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_simulate(params, Options(), DT)
    none = Forcing(*[leaf[:0] for leaf in forcings])
    with pytest.raises(ValueError, match="no step"):
        simulate(params, Options(), DT, static, none, state, device="cpu")
    got, flux = simulate(params, Options(), DT, static, none, state,
                         collect_fluxes=False, device="cpu")
    assert got is state and flux is None
