"""The fused kernels' arithmetic, held against the plain step without a
card: ``csrc/column_host.cpp`` compiles the very headers the CUDA
kernels are built from as plain C++ (g++, contraction off) and walks the
same stages through the same scratch buffer, slab after slab.  Every
State and Flux leaf must come out inside the step's bars (cases.py) of
``column_plain``, int leaves equal, on all five cases, over several
steps, and for every option value the fused step accepts; and the
staged walk must give the very bits of a single pass in which a point
runs through every stage before the next point begins, whatever the
slab size; and the canopy loop in two passes, the points listed between
them, the very bits of the same sources built with one pass of every
trip.

This says nothing about the CUDA build, the launch or the card's math
library; ``chip_smoke.py`` holds the kernel itself against the plain
version on the card.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from benchmarks_torch.spinup import device_forcing, domain
from noahmp_tpu_torch import Options, load_params, make_step
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, REGIMES,
                                    STATE_BAR, STATE_CEILING, bar_ratio,
                                    hetero_case, to_device, uniform_case)
from noahmp_tpu_torch.convert import tree_to_numpy
from noahmp_tpu_torch.kernels import column
from noahmp_tpu_torch.kernels._build import CSRC_DIR
from noahmp_tpu_torch.options import fused_option_sets
from noahmp_tpu_torch.params.gathered import gather_params
from noahmp_tpu_torch.physics import flux as flux_physics
from noahmp_tpu_torch.state import init_state
from scripts.canopy_trips import step_trips

DT = 900.0
STEPS = 4


def _build_host(tmp_path_factory, *defines):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this machine")
    out = tmp_path_factory.mktemp("column_host") / "libcolumn_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", *defines, "-o", str(out),
                    os.path.join(CSRC_DIR, "column_host.cpp")], check=True)
    lib = ctypes.CDLL(str(out))
    args_type = column._args_type()
    column.check_layout()
    column.check_abi(lib, args_type)
    lib.noahmp_column_host.argtypes = [ctypes.POINTER(args_type)]
    lib.noahmp_column_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build_host(tmp_path_factory)


@pytest.fixture(scope="module")
def one_pass_lib(tmp_path_factory):
    """The same sources with the canopy loop in one pass of every trip
    (csrc/flux.cuh:NM_CANOPY_ONE_PASS), as before the loop was split."""
    return _build_host(tmp_path_factory, "-DNM_CANOPY_ONE_PASS")


@pytest.fixture(scope="module")
def params():
    return load_params(device="cpu")


def host_step(lib, plan, forcing, state):
    """What ``column_cuda`` does, with the host build in the kernels'
    place."""
    args = plan.point_to(forcing, state)
    new_state, flux = plan.outputs()
    assert lib.noahmp_column_host(ctypes.byref(args)) == 0
    return new_state, flux


def hold_against_plain(lib, params, opts, case, steps):
    """``steps`` steps along the plain version's trajectory; at each one
    the host build starts from the plain version's state."""
    static, forcing, state = to_device(case, "cpu")
    g = gather_params(params, static.lutyp, static.sltyp, static.isc,
                      static.slptyp)
    plan = column.ColumnPlan(g, opts, DT, static, need_cuda=False)
    dt = torch.tensor(DT)
    for step in range(steps):
        with torch.no_grad():
            ref_s, ref_f = column.column_plain(g, opts, static, forcing,
                                               state, dt)
        got_s, got_f = host_step(lib, plan, forcing, state)
        for ref, got, bar, ceiling in (
                (ref_s, got_s, STATE_BAR, STATE_CEILING),
                (ref_f, got_f, FLUX_BAR, FLUX_CEILING)):
            r_tree, g_tree = tree_to_numpy(ref), tree_to_numpy(got)
            for name, r in r_tree.items():
                if r.dtype == np.int32:
                    np.testing.assert_array_equal(
                        g_tree[name], r, err_msg=f"step {step}: {name}")
                    continue
                ratio = bar_ratio(r, g_tree[name], bar, ceiling)
                assert ratio <= 1.0, (
                    f"step {step}: {name} is {ratio:.3g} times what bar "
                    f"{bar} and ceiling {ceiling} allow")
        state = ref_s


def _case(name):
    return uniform_case(8) if name == "uniform" else hetero_case(name, 8)


@pytest.mark.parametrize("name", ["uniform"] + sorted(REGIMES))
def test_host_build_matches_plain_step(host_lib, params, name):
    hold_against_plain(host_lib, params, Options(), _case(name), STEPS)


@pytest.mark.parametrize("name", ["uniform"] + sorted(REGIMES))
def test_host_build_matches_plain_step_chen97_fixed_carry(host_lib, params,
                                                          name, monkeypatch):
    """``physics/flux.py:CHEN97_FIXED_CARRY`` on, ``opt_sfc = 2``: the
    plan reads the switch when it is built and the kernels multiply the
    carried conductances by the wind speed, as the plain step does; the
    carried ``ch`` is not what the default gives."""
    opts = Options(sfc=2)
    case = _case(name)
    static, forcing, state = to_device(case, "cpu")
    g = gather_params(params, static.lutyp, static.sltyp, static.isc,
                      static.slptyp)
    default = host_step(host_lib, column.ColumnPlan(
        g, opts, DT, static, need_cuda=False), forcing, state)[0].ch
    monkeypatch.setattr(flux_physics, "CHEN97_FIXED_CARRY", True)
    plan = column.ColumnPlan(g, opts, DT, static, need_cuda=False)
    assert plan.consts.chen97_fixed_carry == plan.args.chen97_fixed_carry == 1
    assert not torch.equal(host_step(host_lib, plan, forcing, state)[0].ch,
                           default)
    hold_against_plain(host_lib, params, opts, case, STEPS)


def _opt_id(opts):
    return ",".join(f"{k}={v}" for k, v in opts._asdict().items()
                    if v != getattr(Options(), k))


@pytest.mark.parametrize("regime", ["cold_snow", "hot_dry"])
@pytest.mark.parametrize("opts", fused_option_sets(), ids=_opt_id)
def test_host_build_matches_plain_step_under_option(host_lib, params, opts,
                                                    regime):
    hold_against_plain(host_lib, params, opts, hetero_case(regime, 8), 2)


def test_host_build_masks_ragged_n(host_lib, params):
    """n = 1 and n = 11 (no multiple of anything) write every point and
    nothing else."""
    for n in (1, 11):
        static, forcing, state = to_device(uniform_case(n), "cpu")
        g = gather_params(params, static.lutyp, static.sltyp, static.isc,
                          static.slptyp)
        plan = column.ColumnPlan(g, Options(), DT, static, need_cuda=False)
        s, f = host_step(host_lib, plan, forcing, state)
        assert tuple(s.stc.shape) == (n, 7) and s.nsnow.dtype == torch.int32
        assert torch.isfinite(s.tg).all() and torch.isfinite(f.fsa).all()
        assert (s.tg == s.tg[0]).all()


def _plan(params, case, slab=None):
    static, forcing, state = to_device(case, "cpu")
    g = gather_params(params, static.lutyp, static.sltyp, static.isc,
                      static.slptyp)
    plan = column.ColumnPlan(g, Options(), DT, static, need_cuda=False)
    if slab is not None:
        assert slab <= plan.slab        # the scratch holds plan.slab points
        plan.args.slab = slab
    return plan, forcing, state


def _bits(state, flux):
    return {name: leaf.view(np.int32) for tree in (state, flux)
            for name, leaf in tree_to_numpy(tree).items()}


@pytest.mark.parametrize("name", ["uniform"] + sorted(REGIMES))
def test_staged_walk_is_bit_equal_to_a_single_pass(host_lib, params, name):
    """All points through stage after stage (one slab) against every
    point through all stages in turn (slabs of one point), and slabs of
    three in between: the same bits in all 97 leaves, the poisoned
    scratch notwithstanding."""
    case = uniform_case(16) if name == "uniform" else hetero_case(name, 16)
    results = []
    for slab in (None, 1, 3):
        plan, forcing, state = _plan(params, case, slab)
        plan.scratch.fill_(float("nan"))
        results.append(_bits(*host_step(host_lib, plan, forcing, state)))
    for other in results[1:]:
        for leaf, want in results[0].items():
            np.testing.assert_array_equal(other[leaf], want, err_msg=leaf)


@pytest.mark.parametrize("n, slab", [(5, 4), (1, 1), (11, 4), (11, 10)])
def test_slab_boundary(host_lib, params, n, slab):
    """n = slab + 1 and other ragged sizes: the last slab is short, and
    every point still comes out as in one pass over all of them."""
    plan, forcing, state = _plan(params, uniform_case(n))
    whole = _bits(*host_step(host_lib, plan, forcing, state))
    plan, forcing, state = _plan(params, uniform_case(n), slab)
    slabs = _bits(*host_step(host_lib, plan, forcing, state))
    for leaf, want in whole.items():
        np.testing.assert_array_equal(slabs[leaf], want, err_msg=leaf)


def test_host_stage_entry_walks_one_stage(host_lib, params):
    """The stages one by one through ``noahmp_column_host_stage`` give
    the whole step; a stage number outside the list is refused."""
    host_lib.noahmp_column_host_stage.argtypes = [
        ctypes.POINTER(column._args_type()), ctypes.c_int]
    host_lib.noahmp_column_host_stage.restype = ctypes.c_int
    case = hetero_case("cold_snow", 8)
    plan, forcing, state = _plan(params, case)
    whole = _bits(*host_step(host_lib, plan, forcing, state))
    plan, forcing, state = _plan(params, case)
    args = plan.point_to(forcing, state)
    new_state, flux = plan.outputs()
    for stage in range(5):
        assert host_lib.noahmp_column_host_stage(ctypes.byref(args),
                                                 stage) == 0
    assert host_lib.noahmp_column_host_stage(ctypes.byref(args), 5) != 0
    for leaf, want in whole.items():
        np.testing.assert_array_equal(_bits(new_state, flux)[leaf], want,
                                      err_msg=leaf)


SPLIT_POINTS = 384        # of the spin-up cell's domain
SPLIT_STEPS = (30, 31, 32, 56, 57)   # since Jan 1 00:00: night and midday
SPLIT_OPTIONS = {"default": Options(), "opt_sfc_2": Options(sfc=2),
                 "opt_crs_2": Options(crs=2)}


@pytest.fixture(scope="module")
def spinup_states(params):
    """The cell's domain from a cold start on Jan 1, the State before
    each of SPLIT_STEPS by the plain step, and the plain step's canopy
    trips at each of them."""
    static = domain(SPLIT_POINTS, 0, "cpu")
    state = init_state(SPLIT_POINTS, device="cpu")
    step = make_step(params, Options(), DT, device="cpu")
    states, trips = {}, {}
    for k in range(SPLIT_STEPS[-1] + 1):
        forcing = device_forcing(k * DT, static)
        if k in SPLIT_STEPS:
            states[k] = state
            state, trips[k], _bare = step_trips(step, static, forcing,
                                                state)
        else:
            state, _flux = step(static, forcing, state)
    return static, states, trips


@pytest.mark.parametrize("slab", [None, 50])
@pytest.mark.parametrize("opts", sorted(SPLIT_OPTIONS))
def test_canopy_passes_are_bit_equal_to_one_pass(host_lib, one_pass_lib,
                                                 params, spinup_states,
                                                 opts, slab):
    """The canopy loop in the two passes of ``column.CANOPY_PASS_ENDS``,
    the points listed between them (those without a canopy at the list's
    back), against the same sources built with one pass of every trip:
    the same bits in all 97 leaves (NaN included), at each of
    SPLIT_STEPS steps of the spin-up cell's domain, in one slab and in
    slabs of 50 points (each slab's list emptied anew).  At every step
    the sample fills both ends of the list, and by the plain step's trip
    counts it has points that go on past the first pass's end and
    points that leave the loop in the second pass before its last trip
    and at it."""
    static, states, trips = spinup_states
    end = column.CANOPY_PASS_ENDS[0]
    for k in SPLIT_STEPS:
        t = trips[k]
        assert ((t > end) & (t < 20)).any() and (t == 20).any(), k
        forcing = device_forcing(k * DT, static)
        results = []
        for lib in (host_lib, one_pass_lib):
            g = gather_params(params, static.lutyp, static.sltyp, static.isc,
                              static.slptyp)
            plan = column.ColumnPlan(g, SPLIT_OPTIONS[opts], DT, static,
                                     need_cuda=False)
            if slab is not None:
                plan.args.slab = slab
            plan.scratch.fill_(float("nan"))
            results.append(_bits(*host_step(lib, plan, forcing, states[k])))
            if lib is host_lib and slab is None:
                front, back = plan.scratch[column.SEAM_WORDS * SPLIT_POINTS:][
                    :column.PASS_COUNTERS].view(torch.int32).tolist()
                assert front > 0 and back > 0, (k, front, back)
                assert front + back == SPLIT_POINTS, (k, front, back)
        split, one = results
        for leaf, want in one.items():
            np.testing.assert_array_equal(split[leaf], want,
                                          err_msg=f"step {k}: {leaf}")
