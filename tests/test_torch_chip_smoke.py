"""The parts of ``chip_smoke.py`` that need no card: how it reads the
operations out of the kernels' headers, the count by stage, and the list
of parameters the byte bound counts."""

import ctypes
import importlib.util
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from noahmp_tpu_torch import Options, load_params, make_fused_step
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


def test_point_ratios_count_points_beyond_the_bars():
    from noahmp_tpu_torch.cases import (STATE_BAR, STATE_CEILING,
                                        bar_ratio, point_ratios, run_ratio)
    ref = np.array([[280.0, 1.0], [0.5, 0.5], [10.0, np.nan]], np.float32)
    got = ref.copy()
    got[0, 1] += np.float32(3e-4)          # 3 bars at 1.0
    got[2, 1] = np.nan                     # NaN in both: equal
    r = point_ratios(ref, got, STATE_BAR, STATE_CEILING)
    assert r.shape == (3,) and r[1] == 0.0 and r[2] == 0.0
    assert 2.9 < r[0] < 3.1
    assert r.max() == pytest.approx(bar_ratio(ref, got, STATE_BAR,
                                              STATE_CEILING))
    assert point_ratios(ref, got, STATE_BAR, STATE_CEILING, 4)[0] == \
        pytest.approx(run_ratio(ref, got, STATE_BAR, STATE_CEILING, 4))
    got[1, 0] = np.nan                     # NaN in one only
    assert np.isinf(point_ratios(ref, got, STATE_BAR, STATE_CEILING)[1])


def test_outside_the_bars_names_fields_points_and_classes(smoke):
    """Per-point ratios by field and the free run's summary: a point
    outside is counted, its field named, its ratio kept.  In a step from
    the same State, a leaf off at every point of one land-use class is
    what a wrong branch gives: no variant of the plain step explains it,
    the class is named and the limits refuse it."""
    n = 40
    ref = {"tg": np.full(n, 280.0, np.float32),
           "fsh": np.zeros(n, np.float32)}
    got = {"tg": ref["tg"].copy(), "fsh": ref["fsh"].copy()}
    got["tg"][3] += 1.0                    # 36 state bars at 280 K
    got["fsh"][1] = 0.004                  # within the flux bar
    table = smoke.outside_the_bars("w ", ref, got, 4, {"tg"})
    assert table["w tg"][3] == pytest.approx(1.0 / (0.028 * 4), rel=1e-3)
    assert (table["w fsh"] <= 1.0).all()
    summary = smoke.free_run_summary(table)
    assert summary["most_points_outside"] == 1
    assert summary["most_points_outside_at"] == "w tg"
    assert summary["fields_with_points_outside"] == ["w tg"]
    assert summary["worst_ratio"] == pytest.approx(table["w tg"][3])

    static, forcing, state = to_device(uniform_case(128), "cpu")
    fused = make_fused_step(load_params(device="cpu"), Options(), DT, static,
                            device="cpu")

    def plain(f, s):
        return fused(None, f, s)

    ref = plain(forcing, state)
    lutyp = static.lutyp.numpy()
    bad = ref[1]._replace(shg=ref[1].shg + 1.0)
    report = smoke.judge_resynced(plain, forcing, state, ref,
                                  (ref[0], bad), lutyp)
    assert report["points_outside"] == report["unexplained"] == 128
    assert report["worst_unexplained_at"].startswith("Flux.shg")
    assert report["unexplained_class_share"] == 1.0
    assert report["unexplained_class_share_at"] == int(lutyp[0])
    with pytest.raises(AssertionError, match="not explained"):
        smoke.check_resynced("t", [{"step": 0, **report}], 128)


def test_a_canopy_exit_at_another_trip_is_explained(smoke, tmp_path):
    """A step whose canopy loop leaves at other trips (the exit
    threshold moved, as two implementations that differ in the last bit
    do at some points of the generated CONUS case) differs from the
    plain step beyond the bars; every such point is explained and the
    limits pass.  The variants leave the threshold as it was."""
    from noahmp_tpu_torch.driver import io as dio
    from noahmp_tpu_torch.driver.config import Config
    from noahmp_tpu_torch.physics import flux as flux_physics
    case = smoke.write_case(256, 1, str(tmp_path))
    cfg = Config.from_namelist(os.path.join(case, "case.nml"))
    static = dio.load_domain(cfg.constfile, "cpu")
    fused = make_fused_step(load_params(device="cpu"), cfg.options, cfg.dt,
                            static, device="cpu")

    def plain(f, s):
        return fused(None, f, s)

    state = dio.load_init(cfg.initfile, 256, "cpu")
    forcing = smoke.file_forcing(cfg, dio.static_to_host(static),
                                 cfg.begdatetime, "cpu")
    ref = plain(forcing, state)
    with smoke.canopy_exit(flux_physics.DTV_EXIT * 1.2):
        got = plain(forcing, state)
    assert flux_physics.DTV_EXIT == 0.01
    report = smoke.judge_resynced(plain, forcing, state, ref, got,
                                  static.lutyp.numpy())
    assert report["points_outside"] > 0
    assert report["explained"] == report["points_outside"]
    smoke.check_resynced("t", [{"step": 0, **report}], 256)


def test_host_split_times_the_offline_run_and_restores(smoke, tmp_path):
    """The timers go around what run_offline calls and come off again;
    the residual recorder sees every advisory check."""
    from noahmp_tpu_torch import utils
    from noahmp_tpu_torch.driver import io as dio, run as drun
    saved = (dio._upload, dio.compact_chunk, dio.FileForcing.__call__,
             dio.ChunkPrefetcher.get, dio.AsyncSink.submit,
             drun.make_chunk_step, utils.check_budgets)
    case = smoke.write_case(8, 1, str(tmp_path), out_hours=1, hours=1)
    cfg = smoke.offline_cfg(case, "t", 1)
    with smoke.HostSplit() as split, smoke.ResidualRecorder() as rec:
        drun.run_offline(cfg, verbose=False, device="cpu",
                         check_budgets_every=1, chunk_steps=2)
    assert saved == (dio._upload, dio.compact_chunk,
                     dio.FileForcing.__call__, dio.ChunkPrefetcher.get,
                     dio.AsyncSink.submit, drun.make_chunk_step,
                     utils.check_budgets)
    out = split.report(8, 4)
    assert out["h2d_bytes_per_step"] == 15 * 8 * 4
    assert all(v > 0 for v in out["host_ms_per_step"].values()), out
    assert rec.calls == 2 and all(0 <= v < 0.5 for v in rec.worst.values())
    assert out["loop_seconds"] > 0


def test_loop_ms_per_step_reads_the_run_summary(smoke):
    text = ("mesh: 2 ranks on cuda, backend gloo\n"
            "noahmp_tpu_torch: 48 steps x 131072 points on 2 ranks (cuda) "
            "in 0.61s  (10,485,760 point-steps/s)\n")
    steps, ms = smoke.loop_ms_per_step(text)
    assert steps == 48 and ms == pytest.approx(12.5)
    with pytest.raises(AssertionError, match="no run summary"):
        smoke.loop_ms_per_step("rank 1 printed nothing")


def test_rank_abort_steps_needs_one_abort_line_a_rank(smoke):
    line = '{"rank": %d, "abort_step": 5, "abort_time": "x", "error": "e"}'
    assert smoke.rank_abort_steps([(1, line % 0), (1, "noise\n" + line % 1)
                                   ]) == [5, 5]
    with pytest.raises(AssertionError, match="exit 0"):
        smoke.rank_abort_steps([(1, line % 0), (0, "finished")])
    with pytest.raises(AssertionError, match="0 abort lines"):
        smoke.rank_abort_steps([(1, "a traceback")])


def test_dist_namelist_cuts_the_run_and_moves_the_outputs(smoke, tmp_path):
    from noahmp_tpu_torch.cases import conus_case
    from noahmp_tpu_torch.driver.config import Config
    case = conus_case(4, seed=0, days=1, outdir=str(tmp_path / "case"))
    cfg = Config.from_namelist(smoke.dist_namelist(case, "two", 12,
                                                   indir="/x/ldasin"))
    assert cfg.enddatetime - cfg.begdatetime == smoke.datetime.timedelta(
        hours=12)
    assert cfg.resfreq.seconds == 6 * 3600.0
    assert cfg.outdir == os.path.join(case, "two", "ldasout")
    assert cfg.resdir == os.path.join(case, "two", "restart")
    assert os.path.isdir(cfg.outdir) and os.path.isdir(cfg.resdir)
    assert cfg.indir == "/x/ldasin"
    assert Config.from_namelist(os.path.join(case, "case.nml")).outdir \
        == os.path.join(case, "ldasout")        # the case's own is kept


def test_launch_ranks_ends_a_hung_rank(smoke, monkeypatch, tmp_path):
    """A rank that outlives its time limit fails the phase, and no
    process of the launch is left running."""
    monkeypatch.setattr(smoke, "DIST_GROUP_TIMEOUT", 30)
    started = []
    real = subprocess.Popen

    def popen(argv, **kw):
        proc = real([smoke.sys.executable, "-c",
                     "import os, time\n"
                     "time.sleep(0 if os.environ['RANK'] == '0' else 60)"],
                    **kw)
        started.append(proc)
        return proc

    monkeypatch.setattr(smoke.subprocess, "Popen", popen)
    with pytest.raises(AssertionError, match="rank 1 of 2 did not end"):
        smoke.launch_ranks(["case.nml"], timeout=3)
    assert len(started) == 2
    assert all(proc.poll() is not None for proc in started)


def _oracle_states(n=1000):
    """Two equal sets of the State fields native_oracle compares."""
    rng = np.random.default_rng(0)
    ref = {"tg": rng.uniform(260.0, 300.0, n), "tv": rng.uniform(
               260.0, 300.0, n), "swc": rng.uniform(0.1, 0.4, (n, 4)),
           "sneqv": rng.uniform(0.0, 50.0, n),
           "canliq": rng.uniform(0.0, 1.0, n),
           "nsnow": rng.integers(0, 4, n).astype(np.int32)}
    return ref, {k: v.copy() for k, v in ref.items()}


def _judge(smoke, got, ref, reference=None):
    lutyp = np.full(got["tg"].shape[0], 7, np.int32)
    return smoke.check_oracle("test", [smoke.oracle_step(0, got, ref, lutyp)],
                              reference)


def test_oracle_judge_fails_one_point_over_the_cap(smoke):
    ref, got = _oracle_states()
    assert _judge(smoke, got, ref)["outliers"] == 0
    got["tg"][17] += 4.5                    # FUZZ_CAP tg = 4.0
    with pytest.raises(AssertionError, match="beyond FUZZ_CAP.*point 17"):
        _judge(smoke, got, ref)
    ref, got = _oracle_states()
    got["swc"][3, 2] += 2e-3                # a layer of a layer field
    with pytest.raises(AssertionError, match="point 3"):
        _judge(smoke, got, ref)


def test_oracle_judge_fails_a_changed_layer_count(smoke):
    ref, got = _oracle_states()
    got["nsnow"][5] += 1
    with pytest.raises(AssertionError, match="nsnow changed.*point 5"):
        _judge(smoke, got, ref)


@pytest.mark.parametrize("outliers, passes", [(5, True), (6, False)])
def test_oracle_judge_allows_half_a_percent_beyond_tight(smoke, outliers,
                                                         passes):
    """0.5% of 1,000 point-steps beyond FUZZ_TIGHT passes, 0.6% fails."""
    ref, got = _oracle_states()
    got["tv"][:outliers] += 0.5             # FUZZ_TIGHT tv = 0.3, cap 2.5
    if passes:
        summary = _judge(smoke, got, ref)
        assert summary["outliers"] == outliers
        assert summary["outlier_fields"] == ["tv"]
        assert summary["max_share_of_tight"] == pytest.approx(0.5 / 0.3)
    else:
        with pytest.raises(AssertionError, match="6 of 1000 point-steps"):
            _judge(smoke, got, ref)


def test_oracle_judge_passes_only_an_explained_crossing(smoke):
    """A point-step beyond FUZZ_CAP passes only beside the JAX step's own
    crossings over the same set and steps, within counting noise of
    them; with no such count, none passes.  It still counts as an
    outlier."""
    ref, got = _oracle_states()
    got["tv"][40] += 7.4
    with pytest.raises(AssertionError, match="at most 0.*point 40"):
        _judge(smoke, got, ref)
    summary = _judge(smoke, got, ref, reference=0)
    assert summary["outliers"] == 1
    assert summary["crossings"] == 1
    assert summary["crossings_of_jax"] == 0
    assert summary["crossed"] == ["step 0: point 40, land use 7, tv 24.7"]
    got["tv"][41:50] += 7.4                 # 10 crossings beside the JAX 1
    with pytest.raises(AssertionError, match="10 point-steps beyond FUZZ_CAP"
                       r".*at most 9; the JAX step's: 1"):
        _judge(smoke, got, ref, reference=1)


@pytest.mark.parametrize("reference, allowed", [
    (None, 0), (0, 6), (1, 9), (6, 18), (10, 24), (168, 214)])
def test_crossings_allowed_is_a_one_sided_binomial_test(smoke, reference,
                                                        allowed):
    """The most crossings beside ``reference`` of the JAX step: the
    largest c whose tail P(X >= c), X ~ Binomial(c + reference, 1/2), is
    at least CROSSINGS_ALPHA."""
    assert smoke.CROSSINGS_ALPHA == 0.01
    assert smoke.crossings_allowed(reference) == allowed
    if reference is not None:
        n = allowed + 1 + reference
        tail = sum(math.comb(n, k) for k in range(allowed + 1, n + 1))
        assert tail / 2.0 ** n < smoke.CROSSINGS_ALPHA
        n -= 1
        tail = sum(math.comb(n, k) for k in range(allowed, n + 1))
        assert tail / 2.0 ** n >= smoke.CROSSINGS_ALPHA


def test_crossings_reference_reads_the_jax_count(smoke):
    """Every FUZZ_COMBOS set has the JAX step's crossings for each step
    the phase runs, summed over the steps run, at the phase's size
    only."""
    names = [name for name, _ in smoke.FUZZ_COMBOS]
    assert sorted(smoke.JAX_FUZZ_CROSSINGS) == sorted(names)
    assert smoke.JAX_FUZZ_COPIES == smoke.NATIVE_COPIES
    for name in names:
        by_step = smoke.JAX_FUZZ_CROSSINGS[name]
        assert len(by_step) == smoke.NATIVE_FUZZ_STEPS
        assert smoke.crossings_reference(
            name, smoke.NATIVE_COPIES, smoke.NATIVE_FUZZ_STEPS) == sum(by_step)
    assert smoke.crossings_reference("default", smoke.NATIVE_COPIES, 6) == 1
    assert smoke.crossings_reference("dynveg2", smoke.NATIVE_COPIES, 6) == 3
    assert smoke.crossings_reference("default", 2, 6) is None
    assert smoke.crossings_reference(
        "default", smoke.NATIVE_COPIES, smoke.NATIVE_FUZZ_STEPS + 1) is None
    assert smoke.crossings_reference("CONUS", smoke.NATIVE_COPIES, 1) is None
