"""The fused kernel's arithmetic, held against the plain step without a
card: ``csrc/column_host.cpp`` compiles the very headers the CUDA kernel
is built from as plain C++ (g++, contraction off) and walks them over
the points in a loop.  Every State and Flux leaf must come out inside
the step's bars (cases.py) of ``column_plain``, int leaves equal, on all
five cases, over several steps, and for every option value the fused
step accepts.

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

from noahmp_tpu_torch import Options, load_params
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, REGIMES,
                                    STATE_BAR, STATE_CEILING, bar_ratio,
                                    hetero_case, to_device, uniform_case)
from noahmp_tpu_torch.convert import tree_to_numpy
from noahmp_tpu_torch.kernels import column
from noahmp_tpu_torch.kernels._build import CSRC_DIR
from noahmp_tpu_torch.options import fused_option_sets
from noahmp_tpu_torch.params.gathered import gather_params

DT = 900.0
STEPS = 4


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this machine")
    out = tmp_path_factory.mktemp("column_host") / "libcolumn_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out),
                    os.path.join(CSRC_DIR, "column_host.cpp")], check=True)
    lib = ctypes.CDLL(str(out))
    args_type = column._args_type()
    column.check_layout()
    column.check_abi(lib, args_type)
    lib.noahmp_column_host.argtypes = [ctypes.POINTER(args_type)]
    lib.noahmp_column_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def params():
    return load_params(device="cpu")


def host_step(lib, plan, forcing, state):
    """What ``column_cuda`` does, with the host build in the kernel's
    place."""
    new_state, flux, outputs = plan.outputs()
    args = plan.point_to(forcing, state, outputs)
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
