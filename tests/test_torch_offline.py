"""The port's offline driver (``run_offline``, the CLI) on the CPU
against the JAX package's ``run_offline`` on the same generated case:
``examples/make_case.py:conus(32, seed=1)``, 6 model hours of 900 s
steps, hourly output windows of 4 steps, restarts every 3 hours.

One JAX reference, compiled once for the module: a chunk of T = 4 at
n = 32 under the case's namelist (the executable that
``tests/test_driver.py::test_cli_end_to_end_generated_case`` also
compiles).  Against it, the port's uninterrupted run (also shared by the
module): the same files, the final State within the step's bars
(``cases.py``), every ldasout field within WINDOW_BARS times them.
Then the port against itself: chunk dispatch bit-equal to step
dispatch, a resume bit-equal to the
uninterrupted run, compact forcing within the bars of exact, the strict
budget abort, the CLI, and a sink that fetches late.
"""

import datetime
import filecmp
import os
import re
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from noahmp_tpu.driver import config as jconfig
from noahmp_tpu.driver import io as jio
from noahmp_tpu.driver import run as jrun

import noahmp_tpu_torch.utils as tutils
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, STATE_BAR,
                                    STATE_CEILING, bar_ratio)
from noahmp_tpu_torch.driver import cli as tcli
from noahmp_tpu_torch.driver import config as tconfig
from noahmp_tpu_torch.driver import io as tio
from noahmp_tpu_torch.driver import run as trun
from noahmp_tpu_torch.state import State

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32
HOURS = 6
HOUR = datetime.timedelta(hours=1)
SNAPSHOT = set(tio.OutputWriter.SNAPSHOT)
# An ldasout window of the port against the JAX run, in multiples of the
# step's bars: two implementations that differ in the last bit part
# where a point sits near one of the model's thresholds, and on this
# case the worst window reads 2.6 times the flux bar (ssoil, after 8
# steps) and 3.6 times the state bar (canliq, after 16), then falls
# back; the final State is held to the step's bars themselves
WINDOW_BARS = 5.0


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import make_case
    d = str(tmp_path_factory.mktemp("conus32"))
    make_case.conus(N, seed=1, days=1, outdir=d, fmt="nc")
    return d


def make_cfg(mod, case_dir, tag, hours=HOURS, indir=None):
    """The case's namelist, cut to ``hours``, hourly output, 3-hourly
    restarts, outputs under ``tag``; ``mod`` is the config module of the
    package that runs it."""
    cfg = mod.Config.from_namelist(os.path.join(case_dir, "case.nml"))
    cfg.enddatetime = cfg.begdatetime + hours * HOUR
    cfg.outfreq = mod.Cadence(seconds=3600.0)
    cfg.resfreq = mod.Cadence(seconds=3 * 3600.0)
    cfg.outdir = os.path.join(case_dir, tag, "ldasout")
    cfg.resdir = os.path.join(case_dir, tag, "restart")
    if indir is not None:
        cfg.indir = indir
    return cfg


def host_state(state):
    return {name: np.asarray(leaf.numpy() if isinstance(leaf, torch.Tensor)
                             else leaf) for name, leaf in
            zip(State._fields, state)}


@pytest.fixture(scope="module")
def jax_run(case_dir):
    cfg = make_cfg(jconfig, case_dir, "jax")
    state, files = jrun.run_offline(cfg, verbose=False)
    return cfg, host_state(state), files


@pytest.fixture(scope="module")
def port_run(case_dir):
    cfg = make_cfg(tconfig, case_dir, "port")
    state, files = trun.run_offline(cfg, verbose=False, device="cpu")
    return cfg, state, files


def assert_state_close(ref, got, where):
    for name, r in ref.items():
        g = got[name]
        assert r.dtype == g.dtype and r.shape == g.shape, (where, name)
        if r.dtype == np.int32:
            np.testing.assert_array_equal(g, r, err_msg=f"{where} {name}")
            continue
        ratio = bar_ratio(r, g, STATE_BAR, STATE_CEILING)
        assert ratio <= 1.0, f"{where} {name}: {ratio:.3g} x allowed"


def assert_bit_equal(a, b):
    for name, x, y in zip(State._fields, a, b):
        assert torch.equal(x, y) or bool(
            ((x == y) | (torch.isnan(x) & torch.isnan(y))).all()), name


def test_offline_run_matches_jax(jax_run, port_run):
    """The same ldasout and restart files; the final State within the
    state bars; every window's flux means within WINDOW_BARS times the
    flux bars and its State snapshot within WINDOW_BARS times the state
    bars (a field near one of the model's thresholds drifts for some
    steps and comes back)."""
    jcfg, j_state, j_files = jax_run
    tcfg, t_state, t_files = port_run
    assert [os.path.basename(f) for f in t_files] == [
        os.path.basename(f) for f in j_files]
    assert len(t_files) == HOURS
    assert sorted(os.listdir(tcfg.resdir)) == sorted(
        os.listdir(jcfg.resdir)) == ["restart_200007010300.nc",
                                     "restart_200007010600.nc"]
    for jf, tf in zip(j_files, t_files):
        ref, got = jio.load_arrays(jf), tio.load_arrays(tf)
        assert sorted(ref) == sorted(got)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            bar = (STATE_BAR, STATE_CEILING) if k in SNAPSHOT else (
                FLUX_BAR, FLUX_CEILING)
            ratio = bar_ratio(ref[k], got[k], *bar)
            assert ratio <= WINDOW_BARS, f"{tf} {k}: {ratio:.3g} x bars"
            assert np.isfinite(got[k][np.isfinite(ref[k])]).all(), k
    assert_state_close(j_state, host_state(t_state), "final State")


def test_restarts_load_in_the_other_package(jax_run, port_run):
    """The 06:00 restart of each run is its final State, bit for bit,
    when the other package loads it."""
    jcfg, j_state, _ = jax_run
    tcfg, t_state, _ = port_run
    name = "restart_200007010600.nc"
    from_jax, when = tio.load_restart(os.path.join(jcfg.resdir, name),
                                      device="cpu")
    from_port, when2 = jio.load_restart(os.path.join(tcfg.resdir, name))
    assert when == when2 == jcfg.enddatetime
    for k, leaf in host_state(from_jax).items():
        assert leaf.dtype == j_state[k].dtype, k
        np.testing.assert_array_equal(leaf, j_state[k], err_msg=k)
    for k, leaf in host_state(t_state).items():
        got = np.asarray(getattr(from_port, k))
        assert got.dtype == leaf.dtype, k
        np.testing.assert_array_equal(got, leaf, err_msg=k)


def test_chunk_dispatch_is_step_dispatch(case_dir, port_run):
    """Step dispatch (the chunk loop with chunks of one step) writes the
    very bytes of the chunked run and ends in the same State."""
    _cfg, t_state, t_files = port_run
    cfg = make_cfg(tconfig, case_dir, "port_step")
    state, files = trun.run_offline(cfg, verbose=False, device="cpu",
                                    dispatch="step")
    assert_bit_equal(t_state, state)
    assert [os.path.basename(f) for f in files] == [
        os.path.basename(f) for f in t_files]
    for a, b in zip(t_files, files):
        assert filecmp.cmp(a, b, shallow=False), b


def test_resume_is_the_uninterrupted_run(case_dir, port_run):
    """Restart from the 03:00 file and run to 06:00: the last three
    windows' files and the final State, bit for bit."""
    tcfg, t_state, t_files = port_run
    cfg = make_cfg(tconfig, case_dir, "port_resume")
    os.makedirs(cfg.resdir)
    shutil.copy(os.path.join(tcfg.resdir, "restart_200007010300.nc"),
                cfg.resdir)
    cfg.restart = True
    cfg.resfile = "restart_200007010300.nc"
    state, files = trun.run_offline(cfg, verbose=False, device="cpu")
    assert [os.path.basename(f) for f in files] == [
        os.path.basename(f) for f in t_files[3:]]
    for a, b in zip(t_files[3:], files):
        assert filecmp.cmp(a, b, shallow=False), b
    assert_bit_equal(t_state, state)


def test_compact_forcing_within_the_bars_of_exact(case_dir, port_run):
    _cfg, t_state, t_files = port_run
    cfg = make_cfg(tconfig, case_dir, "port_compact")
    state, files = trun.run_offline(cfg, verbose=False, device="cpu",
                                    forcing_mode="compact")
    assert_state_close(host_state(t_state), host_state(state), "compact")
    for a, b in zip(t_files, files):
        ref, got = tio.load_arrays(a), tio.load_arrays(b)
        for k in set(ref) - SNAPSHOT:
            assert bar_ratio(ref[k], got[k], FLUX_BAR, FLUX_CEILING) <= 1.0
        assert_state_close({k: ref[k] for k in SNAPSHOT}, got, b)


def test_strict_budgets_name_a_step_the_corrupt_record_feeds(case_dir,
                                                             tmp_path):
    """The 01:00 forcing file carries a corrupt shortwave record (1e7
    W/m2): under ``"strict"`` the run stops with ConservationError at a
    step whose forcing interpolates that file (steps 1-7: model times
    00:15 to 01:45), the same step under either dispatch."""
    indir = str(tmp_path / "ldasin")
    shutil.copytree(os.path.join(case_dir, "ldasin"), indir)
    path = os.path.join(indir, "2000070101.nc")
    d = tio.load_arrays(path)
    d["soldn"] = np.full_like(d["soldn"], 1.0e7)
    tio.save_arrays(path, d)
    cfg = make_cfg(tconfig, case_dir, "port_strict", hours=3, indir=indir)
    with pytest.raises(tutils.ConservationError) as err:
        trun.run_offline(cfg, verbose=False, device="cpu",
                         check_budgets_every="strict")
    m = re.search(r"at model time (\S+ \S+) \(step (\d+)\)", str(err.value))
    assert m, str(err.value)
    step = int(m.group(2))
    assert 1 <= step <= 7
    assert datetime.datetime.fromisoformat(m.group(1)) == \
        cfg.begdatetime + step * cfg.timestep
    cfg = make_cfg(tconfig, case_dir, "port_strict_step", hours=3,
                   indir=indir)
    with pytest.raises(tutils.ConservationError) as err_step:
        trun.run_offline(cfg, verbose=False, device="cpu", dispatch="step",
                         check_budgets_every="strict")
    assert m.group(0) in str(err_step.value)
    # the clean files: the same run goes through
    clean = make_cfg(tconfig, case_dir, "port_strict_clean", hours=2)
    _state, files = trun.run_offline(clean, verbose=False, device="cpu",
                                     check_budgets_every="strict")
    assert len(files) == 2


def test_cli_end_to_end_on_the_cpu(case_dir, tmp_path):
    """``cli.main`` on the case's namelist, cut to 2 hours with hourly
    output: two ldasout files with finite fields, and the budgets
    checked every 4 steps."""
    with open(os.path.join(case_dir, "case.nml")) as fh:
        text = fh.read()
    out = str(tmp_path / "ldasout")
    text = re.sub(r"end_day = \d+", "end_day = 1", text)
    text = re.sub(r"end_hour = \d+", "end_hour = 2", text)
    text = re.sub(r"output_directory = '[^']*'",
                  f"output_directory = '{out}'", text)
    text = re.sub(r"output_frequency = '[^']*'",
                  "output_frequency = '1 hour'", text)
    text = re.sub(r"restart_directory = '[^']*'",
                  f"restart_directory = '{tmp_path / 'restart'}'", text)
    nml = str(tmp_path / "case.nml")
    with open(nml, "w") as fh:
        fh.write(text)
    state, files = tcli.main([nml, "--device", "cpu", "--check-budgets",
                              "4", "--chunk-steps", "2"])
    assert sorted(os.listdir(out)) == ["200007010100.nc", "200007010200.nc"]
    assert files == [os.path.join(out, f) for f in sorted(os.listdir(out))]
    got = tio.load_arrays(files[-1])
    assert got["fsh"].shape == (N,) and got["smc"].shape == (N, 4)
    for k in ("fsh", "fsa", "trad", "tg", "smc"):
        assert np.isfinite(got[k]).all(), k
    assert state.tg.device.type == "cpu"


def test_a_late_sink_sees_its_own_window(case_dir, monkeypatch, capsys):
    """The chunk updates its accumulators in place and the next chunk
    goes on updating them; a sink that fetches late must still see the
    values of the chunk that submitted the job.  Chunks of 2 steps in
    windows of 4: every advisory check and the last window's errwat are
    recorded with a sink that runs each job at once, then with one that
    sleeps before each job, and must agree."""
    seen = []

    def record(flux, ist=None, **_kw):
        seen.append(tuple(np.array(getattr(flux, k).numpy(), copy=True)
                          for k in ("errsw", "erreng", "errwat")))

    class InlineSink:
        def submit(self, fn, *args, **kwargs):
            fn(*args, **kwargs)

        def close(self):
            pass

    class LateSink(tio.AsyncSink):
        def submit(self, fn, *args, **kwargs):
            def late(*a, **k):
                time.sleep(0.2)
                fn(*a, **k)
            super().submit(late, *args, **kwargs)

    monkeypatch.setattr(tutils, "check_budgets", record)
    runs = {}
    for name, sink in (("inline", InlineSink), ("late", LateSink)):
        monkeypatch.setattr(tio, "AsyncSink", sink)
        seen.clear()
        cfg = make_cfg(tconfig, case_dir, f"port_sink_{name}", hours=2)
        trun.run_offline(cfg, verbose=True, device="cpu",
                         check_budgets_every=1, chunk_steps=2)
        printed = capsys.readouterr().out
        runs[name] = (list(seen), re.search(r"errwat\| last window: (\S+)",
                                            printed).group(1))
    checks, errwat = runs["inline"]
    assert len(checks) == 4
    # the test can see a late read: a window's second chunk moves its
    # absmax somewhere
    assert any(not np.array_equal(a, b)
               for a, b in zip(checks[0], checks[1]))
    late_checks, late_errwat = runs["late"]
    assert late_errwat == errwat
    for k, (a, b) in enumerate(zip(checks, late_checks)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x, err_msg=f"check {k}")


def test_default_device_is_the_card(case_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    cfg = make_cfg(tconfig, case_dir, "port_none", hours=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.run_offline(cfg, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([os.path.join(case_dir, "case.nml")])
    assert not os.path.exists(cfg.outdir)
