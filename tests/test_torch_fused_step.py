"""``make_fused_step`` on the CPU (where it runs the kernel's plain
version, ``column_plain``) against the JAX package's fused TPU kernel in
interpret mode and against the port's own eager step; the calling
convention; the option values the fused step refuses."""

import numpy as np
import pytest
import torch

from noahmp_tpu import state as jstate
from noahmp_tpu.options import Options as JOptions
from noahmp_tpu.pallas.column import make_pallas_step
from noahmp_tpu.params import load_params as jax_load_params

from noahmp_tpu_torch import (Options, init_state, init_static, load_params,
                              make_fused_step, make_step)
from noahmp_tpu_torch import options as topt
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, REGIMES,
                                    STATE_BAR, STATE_CEILING, bar_ratio,
                                    hetero_case, scaled_err, to_device,
                                    uniform_case)
from noahmp_tpu_torch.convert import tree_to_numpy
from noahmp_tpu_torch.kernels.column import (ColumnPlan, column_cuda,
                                             column_plain)

DT = 900.0
_DEFAULT_REGIMES = ("cold_snow", "frozen_morning")
# make_fused_step against make_step differ only by where the table
# gather happens: the same values reach the same arithmetic, so the
# state agrees to rounding of nothing at all; 1e-6 on |a-b|/max(1,|a|)
# leaves room for a reassociated gather only
GATHER_TOL = 1.0e-6


def pallas_step(case):
    """(state, flux) dicts from the JAX package's fused column kernel,
    run as its own CPU test runs it (block=4, interpret mode)."""
    static, forcing, state = case
    step = make_pallas_step(jax_load_params(), JOptions(), DT,
                            jstate.Static(**static), block=4, interpret=True)
    s, f = step(jstate.Forcing(**forcing), jstate.State(**state))
    return ({k: np.asarray(v) for k, v in s._asdict().items()},
            {k: np.asarray(v) for k, v in f._asdict().items()})


def fused_step(case, opts=Options()):
    static, forcing, state = to_device(case, "cpu")
    step = make_fused_step(load_params(device="cpu"), opts, DT, static,
                           device="cpu")
    s, f = step(None, forcing, state)
    return tree_to_numpy(s), tree_to_numpy(f)


@pytest.mark.parametrize(
    "regime",
    [r if r in _DEFAULT_REGIMES else pytest.param(r, marks=pytest.mark.slow)
     for r in sorted(REGIMES)])
def test_fused_step_matches_jax_pallas_interpret(regime):
    """Every State and Flux leaf of the port's fused step inside the
    step's bars (cases.py) of the JAX fused kernel, int leaves equal, on
    the heterogeneous 8-column block."""
    case = hetero_case(regime, 8)
    ref = pallas_step(case)
    got = fused_step(case)
    for r_tree, g_tree, bar, ceiling in (
            (ref[0], got[0], STATE_BAR, STATE_CEILING),
            (ref[1], got[1], FLUX_BAR, FLUX_CEILING)):
        assert list(r_tree) == list(g_tree)
        for name in r_tree:
            r, g = r_tree[name], g_tree[name]
            assert r.dtype == g.dtype and r.shape == g.shape, name
            if r.dtype == np.int32:
                np.testing.assert_array_equal(g, r, err_msg=name)
                continue
            ratio = bar_ratio(r, g, bar, ceiling)
            assert ratio <= 1.0, (
                f"{regime}: {name} is {ratio:.3g} times what bar {bar} "
                f"and ceiling {ceiling} allow")


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_fused_step_matches_eager_step(regime):
    """The fused step's plain version against ``make_step`` on the same
    inputs: only the place of the table gather differs."""
    case = hetero_case(regime, 8)
    static, forcing, state = to_device(case, "cpu")
    params = load_params(device="cpu")
    s_e, f_e = make_step(params, Options(), DT, device="cpu")(
        static, forcing, state)
    got_s, got_f = fused_step(case)
    for name, ref in tree_to_numpy(s_e).items():
        if ref.dtype == np.int32:
            np.testing.assert_array_equal(got_s[name], ref, err_msg=name)
        else:
            assert scaled_err(ref, got_s[name]) <= GATHER_TOL, name
    for name, ref in tree_to_numpy(f_e).items():
        assert scaled_err(ref, got_f[name]) <= GATHER_TOL, name


def test_static_argument_is_ignored():
    case = uniform_case(4)
    static, forcing, state = to_device(case, "cpu")
    step = make_fused_step(load_params(device="cpu"), Options(), DT, static,
                           device="cpu")
    other = init_static(4, device="cpu", lutyp=10, sltyp=3)
    a, _ = step(static, forcing, state)
    b, _ = step(other, forcing, state)
    c, _ = step(None, forcing, state)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert step.device == torch.device("cpu")
    assert tuple(step.gathered.fields["hvt"].shape) == (4,)


def test_fused_step_refuses_tensors_on_another_device():
    static, forcing, state = to_device(uniform_case(2), "cpu")
    params = load_params(device="cpu")
    step = make_fused_step(params, Options(), DT, static, device="cpu")
    meta = state._replace(tg=state.tg.to("meta"))
    with pytest.raises(ValueError, match="built for"):
        step(None, forcing, meta)
    with pytest.raises(ValueError, match="built for"):
        make_fused_step(params, Options(), DT,
                        static._replace(lutyp=static.lutyp.to("meta")),
                        device="cpu")


def test_fused_step_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    static = init_static(4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fused_step(load_params(device="cpu"), Options(), DT, static)


def test_column_cuda_refuses_cpu_tensor():
    """On a CPU tensor the wrapper raises and counts no launch: only
    ``make_fused_step(device='cpu')`` chooses the plain version."""
    static, forcing, state = to_device(uniform_case(4), "cpu")
    step = make_fused_step(load_params(device="cpu"), Options(), DT, static,
                           device="cpu")
    before = column_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ColumnPlan(step.gathered, Options(), DT, static)
    # a plan made for the host build still refuses to launch the kernel
    # on the tensors of a step
    plan = ColumnPlan(step.gathered, Options(), DT, static, need_cuda=False)
    plan.need_cuda = True
    with pytest.raises(ValueError, match="CUDA"):
        column_cuda(plan, forcing, state)
    assert column_cuda.launches == before
    assert plan.consts.opts == tuple(Options()) and plan.consts.dt == DT


def test_column_plan_checks_every_step_leaf():
    """Wrong dtype, shape or layout of a Forcing or State leaf raises
    before anything is launched."""
    static, forcing, state = to_device(uniform_case(4), "cpu")
    step = make_fused_step(load_params(device="cpu"), Options(), DT, static,
                           device="cpu")
    plan = ColumnPlan(step.gathered, Options(), DT, static, need_cuda=False)
    _s, _f, outputs = plan.outputs()
    plan.point_to(forcing, state, outputs)
    with pytest.raises(TypeError, match="state.tg"):
        plan.point_to(forcing, state._replace(tg=state.tg.double()), outputs)
    with pytest.raises(ValueError, match="forcing.uu"):
        plan.point_to(forcing._replace(uu=forcing.uu[:2]), state, outputs)
    with pytest.raises(ValueError, match="not contiguous"):
        plan.point_to(forcing,
                      state._replace(stc=state.stc.t().contiguous().t()),
                      outputs)
    with pytest.raises(TypeError, match="static.lutyp"):
        ColumnPlan(step.gathered, Options(), DT,
                   static._replace(lutyp=static.lutyp.long()),
                   need_cuda=False)
    new_state, flux, leaves = plan.outputs()
    assert len(leaves) == 97 and new_state.nsnow.dtype == torch.int32
    assert tuple(new_state.zsnso.shape) == (4, 7) and flux.fsa.is_contiguous()


def test_column_plain_is_step_columns_on_gathered_parameters():
    static, forcing, state = to_device(hetero_case("warm_day", 8), "cpu")
    step = make_fused_step(load_params(device="cpu"), Options(), DT, static,
                           device="cpu")
    with torch.no_grad():
        s1, f1 = column_plain(step.gathered, Options(), static, forcing,
                              state, torch.tensor(DT))
    s2, f2 = step(None, forcing, state)
    for x, y in zip(tuple(s1) + tuple(f1), tuple(s2) + tuple(f2)):
        assert torch.equal(x, y) or (torch.isnan(x) == torch.isnan(y)).all()


@pytest.mark.parametrize("name, value", [("veg", 2), ("veg", 5)])
def test_unported_option_raises_at_build(name, value):
    static = init_static(2, device="cpu")
    with pytest.raises(NotImplementedError, match=f"opt_{name}={value}"):
        make_fused_step(load_params(device="cpu"),
                        Options()._replace(**{name: value}), DT, static,
                        device="cpu")


def test_fused_refusal_table(monkeypatch):
    """A value listed in FUSED_UNPORTED raises when the fused step is
    built and still builds the eager step; an unknown value raises."""
    static = init_static(2, device="cpu")
    params = load_params(device="cpu")
    monkeypatch.setitem(topt.FUSED_UNPORTED, "run", {3: "Schaake96"})
    opts = Options(run=3)
    with pytest.raises(NotImplementedError, match="opt_run=3: Schaake96"):
        make_fused_step(params, opts, DT, static, device="cpu")
    make_step(params, opts, DT, device="cpu")
    assert opts not in topt.fused_option_sets()
    with pytest.raises(ValueError, match="opt_sfc=7"):
        make_fused_step(params, Options(sfc=7), DT, static, device="cpu")


def test_every_option_value_is_checked_or_refused():
    """Each value of each option is the default, or in one of the option
    sets that the on-card check walks, or refused at build."""
    sets = topt.fused_option_sets()
    for name, values in topt.OPTION_VALUES.items():
        for v in values:
            refused = (v in topt.UNPORTED.get(name, {})
                       or v in topt.FUSED_UNPORTED.get(name, {}))
            checked = (v == getattr(Options(), name)
                       or Options()._replace(**{name: v}) in sets)
            assert refused != checked, (name, v)
    assert set(topt.OPTION_VALUES) == set(Options._fields)
