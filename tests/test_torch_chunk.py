"""``make_chunk_step`` of the port against the JAX package's, on the CPU:
state, ``"sum"`` and ``"absmax"`` accumulators, and strict mode
(``bad_step``, the frozen state, the frozen accumulators) with a
violation forced at a known step.

The JAX chunk is a jitted ``lax.scan`` that takes most of a minute to
compile on the CPU, so one compiled reference serves every comparison: it
is built in strict mode (without a violation it returns what the plain
chunk returns), around a ``column_step`` that adds 1 W/m2 to ``errsw``
wherever the forcing's ``julian`` carries a marker value.  The port's
``step_columns`` is wrapped the same way, so both sides see the same
violation at the same step and point.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from noahmp_tpu import state as jstate
from noahmp_tpu.driver import step as jstep_mod
from noahmp_tpu.options import Options as JOptions
from noahmp_tpu.params import load_params as jax_load_params

from noahmp_tpu_torch import (STRICT_SENTINEL, Options, load_params,
                              make_chunk_step, make_fused_step, make_step)
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, STATE_BAR,
                                    STATE_CEILING, bar_ratio,
                                    forcing_sequence, hetero_case)
from noahmp_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from noahmp_tpu_torch.driver import step as tstep_mod
from noahmp_tpu_torch.kernels import column as tcolumn_mod
from noahmp_tpu_torch.state import Forcing, State, Static

DT = 900.0
N, T = 8, 6
MARK = 181.0        # julian of a step that is made to violate
BIAS = 1.0          # W/m2 added to errsw there
ACC_SPEC = (("fsh", "sum"), ("ssoil", "sum"), ("fsh", "absmax"),
            ("ssoil", "absmax"), ("fgev", "absmax"), ("errsw", "absmax"),
            ("erreng", "absmax"), ("errwat", "absmax"))
ERRSW_AT = 5        # the errsw accumulator's place in ACC_SPEC
RESIDUALS = ("errsw", "erreng", "errwat")


def numpy_case(bad_at=None, point=2):
    """(static, forcings (T, N), state) as dicts of numpy leaves; with
    ``bad_at`` the marker sits at that step on one point."""
    static, forcing, state = hetero_case("warm_day", N)
    forcings = forcing_sequence(forcing, T)
    if bad_at is not None:
        forcings["julian"][bad_at, point] = MARK
    return static, forcings, state


def torch_case(case):
    static, forcings, state = case
    return (tree_from_numpy(Static, static, "cpu"),
            tree_from_numpy(Forcing, forcings, "cpu"),
            tree_from_numpy(State, state, "cpu"))


def zeros_acc():
    return tuple(torch.zeros(N) for _ in ACC_SPEC)


@pytest.fixture(scope="module")
def jax_chunk():
    """The JAX strict chunk around the marked ``column_step``, compiled
    once; run(case) -> (state dict, acc tuple, bad_step)."""
    real = jstep_mod.column_step

    def marked(params, opts, static, forcing, st, dt):
        s, f = real(params, opts, static, forcing, st, dt)
        return s, f._replace(errsw=f.errsw + jnp.where(
            forcing.julian == MARK, BIAS, 0.0))

    jstep_mod.column_step = marked
    try:
        chunk = jstep_mod.make_chunk_step(jax_load_params(), JOptions(), DT,
                                          ACC_SPEC, donate=False,
                                          strict_budgets=True)

        def run(case):
            static, forcings, state = case
            acc = tuple(jnp.zeros(N, jnp.float32) for _ in ACC_SPEC)
            s, a, bad = chunk(jstate.Static(**static),
                              jstate.Forcing(**forcings),
                              jstate.State(**state), acc)
            return ({k: np.asarray(v) for k, v in s._asdict().items()},
                    tuple(np.asarray(x) for x in a), int(bad))

        yield run
    finally:
        jstep_mod.column_step = real


@pytest.fixture
def marked_port(monkeypatch):
    """The port's ``step_columns`` with the same marker, under the eager
    chunk and under the fused chunk's plain version."""
    real = tstep_mod.step_columns

    def marked(params, opts, static, forcing, st, dt):
        s, f = real(params, opts, static, forcing, st, dt)
        bias = torch.where(forcing.julian == MARK, BIAS, 0.0)
        return s, f._replace(errsw=f.errsw + bias)

    monkeypatch.setattr(tstep_mod, "step_columns", marked)
    monkeypatch.setattr(tcolumn_mod, "step_columns", marked)


def port_chunk(case, fused, strict, spec=ACC_SPEC):
    static, forcings, state = torch_case(case)
    chunk = make_chunk_step(load_params(device="cpu"), Options(), DT, spec,
                            strict_budgets=strict,
                            static=static if fused else None, device="cpu")
    out = chunk(None if fused else static, forcings, state,
                tuple(torch.zeros(N) for _ in spec))
    return out


def assert_state_close(ref, got):
    for name, r in ref.items():
        g = got[name]
        assert r.dtype == g.dtype and r.shape == g.shape, name
        if r.dtype == np.int32:
            np.testing.assert_array_equal(g, r, err_msg=name)
            continue
        ratio = bar_ratio(r, g, STATE_BAR, STATE_CEILING)
        assert ratio <= 1.0, f"State.{name}: {ratio:.3g} x the allowed error"


def assert_acc_close(ref, got, steps):
    """An absmax within the flux bars.  A sum within the sum of what the
    bars allow its steps, each taken at the field's largest magnitude
    (the field's own absmax accumulator): the terms of a sum may cancel,
    their errors do not.  A residual's absmax is rounding noise on both
    sides and is held to half the reference's abort bound."""
    scale = {field: r for (field, op), r in zip(ACC_SPEC, ref)
             if op == "absmax"}
    for (field, op), r, g in zip(ACC_SPEC, ref, got):
        g = g.numpy()
        if field in RESIDUALS:
            np.testing.assert_allclose(g, r, atol=5.0e-3, err_msg=field)
        elif op == "sum":
            allowed = steps * FLUX_BAR * np.maximum(1.0, scale[field])
            assert (np.abs(g - r) <= allowed).all(), (field, g - r, allowed)
        else:
            ratio = bar_ratio(r, g, FLUX_BAR, FLUX_CEILING)
            assert ratio <= 1.0, f"{field} ({op}): {ratio:.3g} x allowed"


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_clean_chunk_matches_jax(jax_chunk, marked_port, fused):
    """No marker: state and accumulators of the port's plain chunk and
    of its strict chunk agree with the JAX chunk, and nothing aborted."""
    case = numpy_case()
    ref_state, ref_acc, ref_bad = jax_chunk(case)
    assert ref_bad == STRICT_SENTINEL
    state, acc = port_chunk(case, fused, strict=False)
    assert_state_close(ref_state, tree_to_numpy(state))
    assert_acc_close(ref_acc, acc, T)
    s_state, s_acc, bad = port_chunk(case, fused, strict=True)
    assert bad.dtype == torch.int32 and bad.dim() == 0
    assert int(bad) == STRICT_SENTINEL
    for a, b in zip(tuple(state) + acc, tuple(s_state) + s_acc):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("bad_at", [0, 3, T - 1])
def test_strict_chunk_stops_where_jax_stops(jax_chunk, marked_port, fused,
                                            bad_at):
    """A violation at a known step: the same ``bad_step``, the state
    after that step and no later one, accumulators that stop there."""
    case = numpy_case(bad_at)
    ref_state, ref_acc, ref_bad = jax_chunk(case)
    assert ref_bad == bad_at
    state, acc, bad = port_chunk(case, fused, strict=True)
    assert int(bad) == bad_at
    assert_state_close(ref_state, tree_to_numpy(state))
    assert_acc_close(ref_acc, acc, bad_at + 1)
    assert float(acc[ERRSW_AT][2]) >= BIAS - 0.01    # the marked point
    # the violating step is applied, later ones are not: the very bits
    # of a plain chunk over the first bad_at + 1 steps
    static, forcings, state0 = case
    head = (static, {k: v[:bad_at + 1] for k, v in forcings.items()}, state0)
    h_state, h_acc = port_chunk(head, fused, strict=False)
    for a, b in zip(tuple(state) + acc, tuple(h_state) + h_acc):
        assert torch.equal(a, b)


def test_first_violation_wins(marked_port):
    """Two marked steps: ``bad_step`` is the first."""
    case = numpy_case(2)
    case[1]["julian"][4, 5] = MARK
    _state, _acc, bad = port_chunk(case, fused=False, strict=True)
    assert int(bad) == 2


def test_energy_residual_aborts_too(monkeypatch):
    """Strict mode holds erreng to the same 0.01 W/m2 as errsw."""
    real = tstep_mod.step_columns

    def marked(params, opts, static, forcing, st, dt):
        s, f = real(params, opts, static, forcing, st, dt)
        bias = torch.where(forcing.julian == MARK, 0.02, 0.0)
        return s, f._replace(erreng=f.erreng - bias)

    monkeypatch.setattr(tstep_mod, "step_columns", marked)
    _state, _acc, bad = port_chunk(numpy_case(1), fused=False, strict=True)
    assert int(bad) == 1
    assert tstep_mod.STRICT_TOL == 0.01


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_corrupt_forcing_record_aborts(fused):
    """No wrapper at all: one step with an absurd shortwave record (1e7
    W/m2) breaks the energy budget by rounding alone, far above the
    bound, and the strict chunk stops there."""
    static, forcings, state = numpy_case()
    forcings["soldn"][4] = 1.0e7
    _state, acc, bad = port_chunk((static, forcings, state), fused,
                                  strict=True)
    assert int(bad) == 4
    worst = max(float(acc[ERRSW_AT].max()),
                float(acc[ERRSW_AT + 1].max()))
    assert worst > 10 * tstep_mod.STRICT_TOL


def test_chunk_is_the_steps_done_by_hand():
    """The chunk over either step gives the very bits of that many
    single steps with the accumulators kept by hand; the accumulators
    are updated in place and the caller's state is left alone."""
    case = numpy_case()
    params = load_params(device="cpu")
    for fused in (False, True):
        static, forcings, state0 = torch_case(case)
        before = [leaf.clone() for leaf in state0]
        single = (make_fused_step(params, Options(), DT, static, device="cpu")
                  if fused else make_step(params, Options(), DT,
                                          device="cpu"))
        want_acc = zeros_acc()
        state = state0
        for t in range(T):
            forcing = Forcing(*[leaf[t] for leaf in forcings])
            state, flux = single(static, forcing, state)
            for a, (field, op) in zip(want_acc, ACC_SPEC):
                leaf = getattr(flux, field)
                a.copy_(a + leaf if op == "sum"
                        else torch.maximum(a, leaf.abs()))
        chunk = make_chunk_step(params, Options(), DT, ACC_SPEC,
                                static=static if fused else None,
                                device="cpu")
        acc_in = zeros_acc()
        got_state, got_acc = chunk(static, forcings, state0, acc_in)
        assert all(a is b for a, b in zip(acc_in, got_acc))
        for a, b in zip(tuple(state) + want_acc, tuple(got_state) + got_acc):
            assert torch.equal(a, b)
        for a, b in zip(before, state0):
            assert torch.equal(a, b)
        assert chunk.acc_spec == ACC_SPEC
        assert chunk.device == torch.device("cpu")


def test_unknown_op_and_field_raise_at_build():
    params = load_params(device="cpu")
    with pytest.raises(ValueError, match="unknown op 'mean'"):
        make_chunk_step(params, Options(), DT, (("fsh", "mean"),),
                        device="cpu")
    with pytest.raises(ValueError, match="no field 'nonesuch'"):
        make_chunk_step(params, Options(), DT, (("nonesuch", "sum"),),
                        device="cpu")


def test_chunk_refuses_wrong_arguments():
    static, forcings, state = torch_case(numpy_case())
    chunk = make_chunk_step(load_params(device="cpu"), Options(), DT,
                            ACC_SPEC, device="cpu")
    with pytest.raises(ValueError, match="2 accumulators, acc_spec names 8"):
        chunk(static, forcings, state, zeros_acc()[:2])
    ragged = forcings._replace(uu=forcings.uu[:3])
    with pytest.raises(ValueError, match="stacked"):
        chunk(static, ragged, state, zeros_acc())
    single = Forcing(*[leaf[0] for leaf in forcings])
    with pytest.raises(ValueError, match="stacked"):
        chunk(static, single, state, zeros_acc())
    meta = state._replace(tg=state.tg.to("meta"))
    with pytest.raises(ValueError, match="built for"):
        chunk(static, forcings, meta, zeros_acc())


def test_chunk_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_chunk_step(load_params(device="cpu"), Options(), DT)


def test_empty_chunk_returns_its_inputs():
    static, forcings, state = torch_case(numpy_case())
    none = Forcing(*[leaf[:0] for leaf in forcings])
    chunk = make_chunk_step(load_params(device="cpu"), Options(), DT,
                            ACC_SPEC, strict_budgets=True, device="cpu")
    got, acc, bad = chunk(static, none, state, zeros_acc())
    assert got is state and int(bad) == STRICT_SENTINEL
    assert all(float(a.abs().max()) == 0.0 for a in acc)
