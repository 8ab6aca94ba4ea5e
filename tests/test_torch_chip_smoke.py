"""The parts of ``chip_smoke.py`` that need no card: how it reads the
operations out of the kernels' headers, the count by stage, and the list
of parameters the byte bound counts."""

import ctypes
import importlib.util
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from noahmp_tpu_torch import Options, load_params
from noahmp_tpu_torch.cases import hetero_case, to_device, uniform_case
from noahmp_tpu_torch.convert import tree_to_numpy
from noahmp_tpu_torch.kernels import column
from noahmp_tpu_torch.kernels._build import CSRC_DIR
from noahmp_tpu_torch.params.gathered import GATHERED_FIELDS, gather_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 900.0


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("code, kinds", [
    ("const float a = b * c + d / e;", {"mul": 1, "add": 1, "div": 1}),
    ("x = powf(mx(y, 0.01f) / z, -bexp);", {"powf": 1, "mx": 1, "div": 1}),
    ("x = clipf(y - 1.0f, 0.0f, 1.0f);", {"add": 1, "mx": 2}),
    ("q[k] = __fdiv_rn(__fsub_rn(d[k], __fmul_rn(a[k], q[k - 1])), denom);",
     {"div": 1, "add": 1, "mul": 1}),
    ("for (int k = 0; k < n + 1; ++k) w[2 * k] = 0.0f;  // a * b", {}),
    ("#define NM_X(a) a * b", {}),
    ("t = expf(logf(u) * 0.25f) - sqrtf(tanhf(v));",
     {"expf": 1, "logf": 1, "mul": 1, "add": 1, "sqrtf": 1, "tanhf": 1})])
def test_statement_kinds(smoke, code, kinds):
    got = {k: v for k, v in smoke.statement_kinds(code).items() if v}
    assert got == kinds
    assert smoke.statement_ops(code) == sum(kinds.values())


def test_every_counted_kind_has_a_probe(smoke):
    """issue_ms multiplies a kind's count by the probe's weight for it:
    every kind the count can name is one the probe measures, in the
    order of the enum in csrc/issue_probe.cu."""
    kinds = set(smoke._CALL_KIND.values()) | set(
        smoke._OPERATOR_KIND.values())
    assert kinds <= set(smoke.PROBE_OPS[1:])
    with open(os.path.join(CSRC_DIR, "issue_probe.cu")) as fh:
        text = fh.read()
    enum = text[text.index("enum Op {"):text.index("kNumOps")]
    names = [n.strip().split(" ")[0] for n in
             enum.split("{")[1].replace("\n", " ").split(",") if n.strip()]
    want = {"identity": "kIdentity", "sqrtf": "kSqrt", "rsqrtf": "kRsqrt",
            "expf": "kExp", "logf": "kLog", "log10f": "kLog10",
            "powf": "kPow", "tanhf": "kTanh", "atanf": "kAtan",
            "fmodf": "kFmod", "floorf": "kFloor", "fabsf": "kFabs",
            "mx": "kMax"}
    assert names == [want.get(op, "k" + op.capitalize())
                     for op in smoke.PROBE_OPS]
    weights = {op: 2.0 for op in smoke.PROBE_OPS[1:]}
    assert smoke.issue_ms({"add": 10.0, "powf": 1.0}, weights, 1000.0,
                          smoke.LANES_PER_CLOCK) == pytest.approx(22.0e-9 * 1e3)


def test_operations_by_stage_add_up(smoke):
    if not (shutil.which("g++") and shutil.which("gcov")):
        pytest.skip("needs g++ and gcov")
    params = load_params(device="cpu")
    static, forcing, state = to_device(uniform_case(2), "cpu")
    g = gather_params(params, static.lutyp, static.sltyp, static.isc,
                      static.slptyp)
    ops = smoke.count_operations(g, Options(), DT, static, forcing, state)
    assert list(ops["by_stage"]) == list(smoke.HOST_STAGES)
    assert sum(s["total"] for s in ops["by_stage"].values()) == ops["total"]
    assert sum(ops["by_kind"].values()) == ops["total"]
    assert sum(ops["by_file"].values()) == ops["total"]
    per_point = ops["total"] / 2
    assert 5000 < per_point < 20000
    # the vegetated tile's Newton loops are the largest share
    shares = {k: v["total"] for k, v in ops["by_stage"].items()}
    assert max(shares, key=shares.get) == "flux_vege"
    assert all(v > 0 for v in shares.values())


def test_default_options_read_only_the_parameters_the_bound_counts(smoke,
                                                                   tmp_path):
    """The byte bound counts the gathered parameters in
    DEFAULT_PARAM_READS.  With every other parameter poisoned the host
    build of the kernels gives the same bits, so the default options use
    no other."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this machine")
    assert set(smoke.DEFAULT_PARAM_READS) <= set(GATHERED_FIELDS)
    out = tmp_path / "libcolumn_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out),
                    os.path.join(CSRC_DIR, "column_host.cpp")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.noahmp_column_host.argtypes = [ctypes.POINTER(column._args_type())]
    lib.noahmp_column_host.restype = ctypes.c_int
    params = load_params(device="cpu")
    results = []
    for poison in (False, True):
        static, forcing, state = to_device(hetero_case("cold_snow", 8), "cpu")
        g = gather_params(params, static.lutyp, static.sltyp, static.isc,
                          static.slptyp)
        if poison:
            for name, leaf in g.fields.items():
                if name not in smoke.DEFAULT_PARAM_READS:
                    if leaf.dtype == torch.float32:
                        leaf.fill_(float("nan"))
                    else:
                        leaf.fill_(-12345)
        plan = column.ColumnPlan(g, Options(), DT, static, need_cuda=False)
        args = plan.point_to(forcing, state)
        new_state, flux = plan.outputs()
        assert lib.noahmp_column_host(ctypes.byref(args)) == 0
        results.append({k: v.view(np.int32) for tree in (new_state, flux)
                        for k, v in tree_to_numpy(tree).items()})
    for name, want in results[0].items():
        np.testing.assert_array_equal(results[1][name], want, err_msg=name)
