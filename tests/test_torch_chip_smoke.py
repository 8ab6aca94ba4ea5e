"""The parts of ``chip_smoke.py`` that need no card: the kinds of
operation its probe prices, how it judges the points outside the bars,
the dist phases' helpers and the JAX step's crossing counts.  The
helpers it shares with the cells of ``BENCHMARK.json`` are tested in
``test_torch_bench_helpers.py``."""

import importlib.util
import os
import subprocess

import numpy as np
import pytest

from benchmarks_torch import work
from noahmp_tpu_torch import Options, load_params, make_fused_step
from noahmp_tpu_torch.cases import to_device, uniform_case
from noahmp_tpu_torch.kernels._build import CSRC_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 900.0


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_counted_kind_has_a_probe(smoke):
    """issue_ms multiplies a kind's count by the probe's weight for it:
    every kind the count can name is one the probe measures, in the
    order of the enum in csrc/issue_probe.cu."""
    kinds = set(work._CALL_KIND.values()) | set(
        work._OPERATOR_KIND.values())
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


def test_canopy_split_phase_on_host_builds(smoke, tmp_path):
    """Phase ``canopy_split`` with the host build of the kernels' sources
    in place of the card's, the package's two passes and the one-pass
    build: every leaf bit-equal at every hour, the pass counters read,
    the plain step's trips beside them; nothing timed on the CPU."""
    import torch
    from noahmp_tpu_torch import load_params
    builds = []
    for name, defines in (("split", ()),
                          ("one_pass", (smoke.ONE_PASS_DEFINE,))):
        where = tmp_path / name
        where.mkdir()
        smoke.host_column_library(str(where), *defines)
        builds.append(smoke.ColumnBuild(
            name, str(where / "libcolumn_host.so"), on_card=False))
    out = smoke.phase_canopy_split(load_params(device="cpu"),
                                   torch.device("cpu"), builds, n=128,
                                   span=4, hours=(0, 1))
    assert out["pass_ends"] == [1, 20]
    assert [row["step"] for row in out["steps"]] == [4, 8]
    for row in out["steps"]:
        assert row["leaves_bit_equal"] == 97
        # every point goes on after the first trip, those without a
        # canopy at the list's back
        assert row["second_pass_share"] == 1.0
        assert 0.0 < row["without_canopy_share"] < 1.0
    trips = out["plain_trips"]
    assert trips["points"] == 256
    assert sum(trips["histogram"].values()) == 256
    assert trips["share_without_canopy"] > 0.0
    assert not any(key.endswith("_ms") for key in out)
