"""The helpers the cells of ``BENCHMARK.json`` and ``chip_smoke.py``
share (``benchmarks_torch``), where they need no card: how the
operations are read out of the kernels' headers and counted by stage,
the parameters the byte bound counts, the host's timers and the run's
residuals around an offline run, the run's summary line, and the judge
of a step against the serial C++ oracle."""

import ctypes
import importlib.util
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from benchmarks_torch import measure, oracle, work
from noahmp_tpu_torch import Options, load_params
from noahmp_tpu_torch.cases import hetero_case, to_device, uniform_case
from noahmp_tpu_torch.convert import tree_to_numpy
from noahmp_tpu_torch.kernels import column
from noahmp_tpu_torch.kernels._build import CSRC_DIR
from noahmp_tpu_torch.params.gathered import GATHERED_FIELDS, gather_params

DT = 900.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def test_statement_kinds(code, kinds):
    got = {k: v for k, v in work.statement_kinds(code).items() if v}
    assert got == kinds
    assert work.statement_ops(code) == sum(kinds.values())


def test_operations_by_stage_add_up():
    if not (shutil.which("g++") and shutil.which("gcov")):
        pytest.skip("needs g++ and gcov")
    params = load_params(device="cpu")
    static, forcing, state = to_device(uniform_case(2), "cpu")
    g = gather_params(params, static.lutyp, static.sltyp, static.isc,
                      static.slptyp)
    ops = work.count_operations(g, Options(), DT, static, forcing, state)
    assert list(ops["by_stage"]) == list(work.HOST_STAGES)
    assert sum(s["total"] for s in ops["by_stage"].values()) == ops["total"]
    assert sum(ops["by_kind"].values()) == ops["total"]
    assert sum(ops["by_file"].values()) == ops["total"]
    per_point = ops["total"] / 2
    assert 5000 < per_point < 20000
    # the vegetated tile's Newton loops are the largest share
    shares = {k: v["total"] for k, v in ops["by_stage"].items()}
    assert max(shares, key=shares.get) == "flux_vege"
    assert all(v > 0 for v in shares.values())


def test_default_options_read_only_the_parameters_the_bound_counts(
        tmp_path):
    """The byte bound counts the gathered parameters in
    DEFAULT_PARAM_READS.  With every other parameter poisoned the host
    build of the kernels gives the same bits, so the default options use
    no other."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this machine")
    assert set(work.DEFAULT_PARAM_READS) <= set(GATHERED_FIELDS)
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
                if name not in work.DEFAULT_PARAM_READS:
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


def test_host_split_times_the_offline_run_and_restores(tmp_path):
    """The timers go around what run_offline calls and come off again;
    the run's residual report holds, a point, the largest residual of
    every step of every chunk and the steps that broke the limit."""
    from noahmp_tpu_torch import utils
    from noahmp_tpu_torch.driver import io as dio, run as drun
    saved = (dio._upload, dio.compact_chunk, dio.FileForcing.__call__,
             dio.ChunkPrefetcher.get, dio.AsyncSink.submit,
             drun.make_chunk_step, utils.check_budgets)
    case = measure.write_case(8, 1, str(tmp_path), out_hours=1, hours=1)
    cfg = measure.offline_cfg(case, "t", 1)
    with measure.HostSplit() as split:
        _state, _files, residuals = drun.run_offline(
            cfg, verbose=False, device="cpu", check_budgets_every=1,
            chunk_steps=2, residual_limit=0.01)
    assert saved == (dio._upload, dio.compact_chunk,
                     dio.FileForcing.__call__, dio.ChunkPrefetcher.get,
                     dio.AsyncSink.submit, drun.make_chunk_step,
                     utils.check_budgets)
    out = split.report(8, 4)
    # 9 leaves per point; co2air, o2air, foln, julian and yearlen as one
    # value a step; psfc a copy of sfcprs made on the device
    assert out["h2d_bytes_per_step"] == 9 * 8 * 4 + 5 * 4
    assert all(v > 0 for v in out["host_ms_per_step"].values()), out
    assert sorted(residuals) == sorted(drun.RESIDUALS + ("steps_over",))
    assert all(v.shape == (8,) for v in residuals.values())
    worst = {k: float(residuals[k].max()) for k in drun.RESIDUALS}
    assert all(0 <= v < 0.5 for v in worst.values()), worst
    # with the limit under every step's residual, every step is over it
    _state, _files, low = drun.run_offline(
        measure.offline_cfg(case, "u", 1), verbose=False, device="cpu",
        chunk_steps=2, residual_limit=-1.0)
    assert (low["steps_over"] == 4).all()
    for name in drun.RESIDUALS:
        assert torch.equal(low[name], residuals[name]), name
    assert out["loop_seconds"] > 0


def test_residual_watch_counts_the_steps_over_the_limit():
    """A point-step counts once when any residual is at or over the
    limit, or not finite; the largest |value| keeps a NaN."""
    from noahmp_tpu_torch.driver.run import ResidualWatch
    watch = ResidualWatch(4, 0.01, "cpu")
    flux = type("Flux", (), {})
    for sw, eng, wat in ((0.0, 0.0, 0.0), (0.02, 0.0, 0.0),
                         (0.0, -0.01, 0.02), (0.0, 0.0, float("nan"))):
        flux.errsw, flux.erreng, flux.errwat = (
            torch.tensor([v, 0.0, 0.0, v]) for v in (sw, eng, wat))
        watch(flux)
    report = watch.report()
    assert report["steps_over"].tolist() == [3, 0, 0, 3]
    assert torch.equal(report["errsw"], torch.tensor([0.02, 0.0, 0.0, 0.02]))
    assert report["erreng"][0] == 0.01
    assert torch.isnan(report["errwat"][0])


def test_loop_ms_per_step_reads_the_run_summary():
    text = ("mesh: 2 ranks on cuda, backend gloo\n"
            "noahmp_tpu_torch: 48 steps x 131072 points on 2 ranks (cuda) "
            "in 0.61s  (10,485,760 point-steps/s)\n")
    steps, ms = measure.loop_ms_per_step(text)
    assert steps == 48 and ms == pytest.approx(12.5)
    with pytest.raises(AssertionError, match="no run summary"):
        measure.loop_ms_per_step("rank 1 printed nothing")


def _oracle_states(n=1000):
    """Two equal sets of the State fields native_oracle compares."""
    rng = np.random.default_rng(0)
    ref = {"tg": rng.uniform(260.0, 300.0, n), "tv": rng.uniform(
               260.0, 300.0, n), "swc": rng.uniform(0.1, 0.4, (n, 4)),
           "sneqv": rng.uniform(0.0, 50.0, n),
           "canliq": rng.uniform(0.0, 1.0, n),
           "nsnow": rng.integers(0, 4, n).astype(np.int32)}
    return ref, {k: v.copy() for k, v in ref.items()}


def _judge(got, ref, reference=None):
    lutyp = np.full(got["tg"].shape[0], 7, np.int32)
    return oracle.check_oracle("test", [oracle.oracle_step(0, got, ref, lutyp)],
                              reference)


def test_oracle_judge_fails_one_point_over_the_cap():
    ref, got = _oracle_states()
    assert _judge(got, ref)["outliers"] == 0
    got["tg"][17] += 4.5                    # FUZZ_CAP tg = 4.0
    with pytest.raises(AssertionError, match="beyond FUZZ_CAP.*point 17"):
        _judge(got, ref)
    ref, got = _oracle_states()
    got["swc"][3, 2] += 2e-3                # a layer of a layer field
    with pytest.raises(AssertionError, match="point 3"):
        _judge(got, ref)


def test_oracle_judge_fails_a_changed_layer_count():
    ref, got = _oracle_states()
    got["nsnow"][5] += 1
    with pytest.raises(AssertionError, match="nsnow changed.*point 5"):
        _judge(got, ref)


@pytest.mark.parametrize("outliers, passes", [(5, True), (6, False)])
def test_oracle_judge_allows_half_a_percent_beyond_tight(outliers, passes):
    """0.5% of 1,000 point-steps beyond FUZZ_TIGHT passes, 0.6% fails."""
    ref, got = _oracle_states()
    got["tv"][:outliers] += 0.5             # FUZZ_TIGHT tv = 0.3, cap 2.5
    if passes:
        summary = _judge(got, ref)
        assert summary["outliers"] == outliers
        assert summary["outlier_fields"] == ["tv"]
        assert summary["max_share_of_tight"] == pytest.approx(0.5 / 0.3)
    else:
        with pytest.raises(AssertionError, match="6 of 1000 point-steps"):
            _judge(got, ref)


def test_oracle_judge_passes_only_an_explained_crossing():
    """A point-step beyond FUZZ_CAP passes only beside the JAX step's own
    crossings over the same set and steps, within counting noise of
    them; with no such count, none passes.  It still counts as an
    outlier."""
    ref, got = _oracle_states()
    got["tv"][40] += 7.4
    with pytest.raises(AssertionError, match="at most 0.*point 40"):
        _judge(got, ref)
    summary = _judge(got, ref, reference=0)
    assert summary["outliers"] == 1
    assert summary["crossings"] == 1
    assert summary["crossings_of_jax"] == 0
    assert summary["crossed"] == ["step 0: point 40, land use 7, tv 24.7"]
    got["tv"][41:50] += 7.4                 # 10 crossings beside the JAX 1
    with pytest.raises(AssertionError, match="10 point-steps beyond FUZZ_CAP"
                       r".*at most 9; the JAX step's: 1"):
        _judge(got, ref, reference=1)


@pytest.mark.parametrize("reference, allowed", [
    (None, 0), (0, 6), (1, 9), (6, 18), (10, 24), (168, 214)])
def test_crossings_allowed_is_a_one_sided_binomial_test(reference, allowed):
    """The most crossings beside ``reference`` of the JAX step: the
    largest c whose tail P(X >= c), X ~ Binomial(c + reference, 1/2), is
    at least CROSSINGS_ALPHA."""
    assert oracle.CROSSINGS_ALPHA == 0.01
    assert oracle.crossings_allowed(reference) == allowed
    if reference is not None:
        n = allowed + 1 + reference
        tail = sum(math.comb(n, k) for k in range(allowed + 1, n + 1))
        assert tail / 2.0 ** n < oracle.CROSSINGS_ALPHA
        n -= 1
        tail = sum(math.comb(n, k) for k in range(allowed, n + 1))
        assert tail / 2.0 ** n >= oracle.CROSSINGS_ALPHA


def _outliers(n_points, outliers, steps=12):
    """oracle_step reports of ``steps`` steps of ``n_points`` points each,
    ``outliers`` point-steps beyond FUZZ_TIGHT in all."""
    ref, _got = _oracle_states(n_points)
    lutyp = np.full(n_points, 7, np.int32)
    reports = []
    for k in range(steps):
        got = {name: v.copy() for name, v in ref.items()}
        here = outliers // steps + (k < outliers % steps)
        got["tv"][:here] += 0.5             # FUZZ_TIGHT tv = 0.3, cap 2.5
        reports.append(oracle.oracle_step(k, got, ref, lutyp))
    return reports


@pytest.mark.parametrize("outliers, passes", [(403, True), (404, False)])
def test_oracle_limit_beside_the_jax_count(outliers, passes):
    """Beside the JAX step's 339 outliers on 49,152 point-steps (the
    offline cell's sample at seed 0) 403 pass and 404 fail; the 0.5%
    would allow 245."""
    reports = _outliers(4096, outliers)
    summary = oracle.oracle_summary(reports, outliers_of_jax=339)
    assert summary["point_steps"] == 49152
    assert summary["outliers"] == outliers
    assert summary["outliers_allowed"] == 403
    assert (summary["failure"] is None) == passes
    if not passes:
        assert "404 of 49152 point-steps beyond FUZZ_TIGHT" in (
            summary["failure"])
        assert "403 beside the JAX step's 339" in summary["failure"]


def test_oracle_limit_without_a_jax_count_is_half_a_percent():
    """Where no JAX count is recorded (another seed, size or span)
    jax_outliers gives None and the 0.5% of test_golden_native.py
    applies: 245 of 49,152 pass, 246 fail."""
    conf = {"oracle_jax": [{"seed": 0, "points": 131072, "steps": 192,
                            "outliers": 339}]}
    assert oracle.jax_outliers(conf, 0, 131072, 192) == 339
    for key in ((1, 131072, 192), (0, 65536, 192), (0, 131072, 96)):
        assert oracle.jax_outliers(conf, *key) is None
    assert oracle.jax_outliers({}, 0, 131072, 192) is None
    for outliers, passes in ((245, True), (246, False)):
        summary = oracle.oracle_summary(
            _outliers(4096, outliers),
            outliers_of_jax=oracle.jax_outliers(conf, 1, 131072, 192))
        assert summary["outliers_allowed"] == pytest.approx(245.76)
        assert (summary["failure"] is None) == passes


def _span(conf, cut):
    """The steps a cell runs under ``cut`` (chip_smoke's BENCH_CUTS)."""
    per_hour = 3600 // conf["dt_seconds"]
    if "hours" in cut:
        return cut["hours"] * per_hour
    return round(cut.get("days", conf["days"]) * 24 * per_hour)


def test_the_cells_find_their_jax_counts():
    """The oracle_jax entries the cells look up exist: each cell at its
    own size and seed, and at chip_smoke's cut (bench_cells), under the
    key run_cell passes (seed, points, steps); each recorded count is
    over oracle_points x oracle_steps point-steps.  (The CPU test's cut
    is checked where it runs, in test_torch_bench.py.)"""
    from benchmarks_torch import run
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for name, workload in run.workloads().items():
        conf = run.configuration(workload)
        cut = chip_smoke.BENCH_CUTS[name]
        for points, steps in ((conf["points"], _span(conf, {})),
                              (cut["points"], _span(conf, cut))):
            count = oracle.jax_outliers(conf, workload["seed"], points,
                                        steps)
            assert count is not None, (name, points, steps)
        for entry in conf["oracle_jax"]:
            assert entry["point_steps"] == (
                min(entry["points"], conf["oracle_points"])
                * conf["oracle_steps"]), entry


def _event(name, start, end, device):
    kind = (torch.autograd.DeviceType.CUDA if device
            else torch.autograd.DeviceType.CPU)
    return type("Event", (), {"name": name, "device_type": kind,
                              "is_user_annotation": False,
                              "time_range": type("Range", (), {
                                  "start": start, "end": end})})


def test_breakdown_reads_busy_share_kernels_and_labelled_gaps():
    """Over the window of the named host spans: the union of the card's
    operations, the column kernels' time, and each idle gap with the
    host span open when it began (times in microseconds, as the
    profiler gives them)."""
    events = [_event("forcing", 0.0, 100.0, False),
              _event("column_cuda", 100.0, 1000.0, False),
              _event("spin_up", 0.0, 1000.0, False),
              _event("fill", 10.0, 30.0, True),
              _event("flux_kernel(ColumnArgs, long, long)", 200.0, 600.0,
                     True),
              _event("water_kernel(ColumnArgs, long, long)", 550.0, 700.0,
                     True),
              _event("before the window", -50.0, -10.0, True)]
    prof = type("Prof", (), {"events": lambda self: events})()
    out = measure.breakdown(prof, ("forcing", "column_cuda"),
                            window=("spin_up",))
    assert out["window_ms"] == pytest.approx(1.0)
    assert out["device_busy_share"] == pytest.approx((20 + 500) / 1000)
    assert out["column_cuda_ms"] == pytest.approx(0.55)
    assert [op["name"][:5] for op in out["top_device_ops"]] == [
        "flux_", "water", "fill"]
    gaps = out["longest_idle_gaps"]
    assert [(g["at_ms"], g["ms"], g["host_spans"]) for g in gaps] == [
        (pytest.approx(0.7), pytest.approx(0.3), ["column_cuda"]),
        (pytest.approx(0.03), pytest.approx(0.17), ["forcing"]),
        (0.0, pytest.approx(0.01), ["forcing"])]
    with pytest.raises(RuntimeError, match="no device operation"):
        measure.breakdown(type("Prof", (), {
            "events": lambda self: events[:3]})(), ("spin_up",))
