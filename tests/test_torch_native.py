"""The port's binding to the serial C++ reference column
(``noahmp_tpu_torch.native``), held on the CPU with no JAX compile.

Parity with the JAX binding is shown byte for byte: the port's C structs
have the JAX binding's fields, types and offsets (and the header's), and
for the same inputs the port's conversions write the very bytes that the
JAX binding's ``gather_col_params``, ``forcing_to_c`` and ``state_to_c``
write.  Equal bytes into the same sources built with the same flags are
the same oracle, so the JAX binding's library is never built or loaded
here: ``tests/test_golden_native.py`` builds it under ``native/`` on
another worker at the same time.

Then the port's plain eager step (``make_step(device="cpu")``) against
the oracle, with the cases and tolerances of
``tests/test_golden_native.py``: the trajectories, the option matrix,
the stochastic fuzz and the resync fuzz.  Cases that share an
``Options`` run as columns of one batch, so that a step is one eager
call for all of them; the oracle advances the free-running columns from
its own State and the resync columns from the State the port's step
started from.
"""

import ctypes as ct
import datetime
import os
import shutil
import subprocess
from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch

from noahmp_tpu import native as jax_native
from noahmp_tpu import state as jax_state
from noahmp_tpu.options import Options as JaxOptions
from noahmp_tpu.params import load_params as jax_load_params

from noahmp_tpu_torch import Options, load_params, make_step, native
from noahmp_tpu_torch.cases import (FUZZ_CAP, FUZZ_COMBOS, FUZZ_OUTLIER_FRAC,
                                    FUZZ_TIGHT, conus_case, fuzz_case,
                                    fuzz_forcing, fuzz_shares, to_device)
from noahmp_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from noahmp_tpu_torch.driver import io as driver_io
from noahmp_tpu_torch.driver.config import Config
from noahmp_tpu_torch.state import (Forcing, State, Static, init_state,
                                    init_static)

DT = 900.0
STRUCTS = {"CColParams": "ColParams", "COpts": "Opts",
           "CForcing": "ColForcing", "CState": "ColState",
           "CFlux": "ColFlux"}
N_CONUS = 64
# the resync fuzz: steps a combo by default, and under --runslow
# (tests/test_golden_native.py's calibrated 500).  That file runs 75 by
# default; here an eager step on the CPU costs some 0.1 s whatever the
# batch, and eight combos of 75 would put this file past a minute, so the
# default holds 120 column-steps a combo against that file's 750 (the
# default combo rides its batch's 60 steps, jarvis_run3_inf2 24).
# chip_smoke.py's native_oracle phase runs every combo 24 steps over
# 40,960 columns on the card.
RESYNC_STEPS = 12
RESYNC_STEPS_SLOW = 500
# what the resync and trajectory cases compare
FIELDS = ("tg", "tv", "stc", "swc", "sneqv", "canliq", "nsnow")


@pytest.fixture(scope="module", autouse=True)
def oracle(tmp_path_factory):
    """The port's oracle built under a directory of this module's own,
    on one thread; the JAX binding's library refused throughout."""
    def refuse(*_a, **_k):
        raise AssertionError("the JAX binding's library is not built or "
                             "loaded here")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR",
                   str(tmp_path_factory.mktemp("native_build")))
        mp.setattr(native, "_lib", None)
        mp.setattr(jax_native, "build", refuse)
        mp.setattr(jax_native, "load", refuse)
        native.set_threads(1)
        yield native


@pytest.fixture(scope="module")
def params():
    return load_params(device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    return jax_load_params(to_device=False)


def fuzz_inputs(copies=1, seed=42):
    static, state = fuzz_case(copies)
    forcing = fuzz_forcing(np.random.default_rng(seed),
                           static["lat"].shape[0])
    return static, forcing, state


@pytest.fixture(scope="module")
def conus_inputs(tmp_path_factory):
    """(static, forcing, state) numpy dicts: N_CONUS points of the
    generated CONUS case, its init State and its forcing at 01:15."""
    case = conus_case(N_CONUS, days=1,
                      outdir=str(tmp_path_factory.mktemp("conus")))
    cfg = Config.from_namelist(os.path.join(case, "case.nml"))
    static = driver_io.static_to_host(driver_io.load_domain(cfg.constfile,
                                                            "cpu"))
    provider = driver_io.FileForcing(cfg.indir, cfg.infreq, static,
                                     prefetch=False)
    when = cfg.begdatetime + datetime.timedelta(minutes=75)
    forcing = {k: np.array(v) for k, v in provider(when)._asdict().items()}
    state = tree_to_numpy(driver_io.load_init(cfg.initfile, N_CONUS, "cpu"))
    return static._asdict(), forcing, state


def join(*dicts):
    return {k: np.concatenate([d[k] for d in dicts]) for k in dicts[0]}


# ---------------------------------------------------------------------
# Layout


@pytest.mark.parametrize("name", list(STRUCTS))
def test_struct_layout_matches_the_jax_binding(name):
    mine, theirs = getattr(native, name), getattr(jax_native, name)
    assert len(mine._fields_) == len(theirs._fields_)
    for (fm, tm), (fj, tj) in zip(mine._fields_, theirs._fields_):
        assert fm == fj
        assert tm.__name__ == tj.__name__, fm
        assert getattr(mine, fm).offset == getattr(theirs, fj).offset, fm
        assert getattr(mine, fm).size == getattr(theirs, fj).size, fm
    assert ct.sizeof(mine) == ct.sizeof(theirs)
    assert np.dtype(mine).itemsize == ct.sizeof(mine)
    assert native.FLUX_FIELDS == jax_native.FLUX_FIELDS


def test_struct_layout_matches_the_header(tmp_path):
    """sizeof and offsetof of every field, from a probe that includes
    native/noahmp_ref.hpp."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this machine")
    lines = ['#include <cstddef>', '#include <cstdio>',
             '#include "noahmp_ref.hpp"', 'int main() {']
    for mine, theirs in STRUCTS.items():
        lines.append(f'  std::printf("{mine} %zu\\n", '
                     f'sizeof(noahmp::{theirs}));')
        for field, _ in getattr(native, mine)._fields_:
            lines.append(f'  std::printf("{mine}.{field} %zu\\n", '
                         f'offsetof(noahmp::{theirs}, {field}));')
    lines += ['  return 0;', '}']
    src = tmp_path / "probe.cpp"
    src.write_text("\n".join(lines) + "\n")
    exe = tmp_path / "probe"
    subprocess.run([cxx, "-std=c++17", "-I", native.NATIVE_DIR, "-o",
                    str(exe), str(src)], check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    header = dict(line.rsplit(" ", 1) for line in out.splitlines())
    for mine in STRUCTS:
        struct = getattr(native, mine)
        assert int(header[mine]) == ct.sizeof(struct), mine
        for field, _ in struct._fields_:
            assert int(header[f"{mine}.{field}"]) == getattr(
                struct, field).offset, (mine, field)


def test_library_lands_under_the_build_directory():
    """The library is named by the hash of the five sources and the
    flags, under the build directory, never under native/."""
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libnoahmp_ref-")
    assert native.library_path() != native.library_path(("-O2", "-shared",
                                                         "-fPIC"))
    assert not path.startswith(native.NATIVE_DIR)
    assert not any(f.endswith(".tmp") for f in os.listdir(native.BUILD_DIR))
    assert isinstance(native.openmp(), bool)


# ---------------------------------------------------------------------
# Bytes


@pytest.mark.parametrize("case", ["fuzz", "conus"])
def test_bytes_match_the_jax_binding(params, jax_params, conus_inputs, case):
    """make_batch's rows, the per-column conversions and the JAX
    binding's structs: the same bytes for every column."""
    static_np, forcing_np, state_np = (fuzz_inputs() if case == "fuzz"
                                       else conus_inputs)
    static, forcing, state = to_device((static_np, forcing_np, state_np),
                                       "cpu")
    jstatic = jax_state.Static(**static_np)
    jforcing = jax_state.Forcing(**forcing_np)
    jstate = jax_state.State(**state_np)
    co, cp, cf, cs, cx = native.make_batch(params, Options(), static,
                                           forcing, state)
    assert len(cp) == len(cf) == len(cs) == len(cx) == static.lat.shape[0]
    for i in range(len(cp)):
        want = bytes(jax_native.gather_col_params(jax_params, jstatic, i))
        assert cp[i].tobytes() == want, i
        assert bytes(native.gather_col_params(params, static, i)) == want, i
        want = bytes(jax_native.forcing_to_c(jforcing, i))
        assert cf[i].tobytes() == want, i
        assert bytes(native.forcing_to_c(forcing, i)) == want, i
        want = bytes(jax_native.state_to_c(jstate, i))
        assert cs[i].tobytes() == want, i
        assert bytes(native.state_to_c(state, i)) == want, i
    assert bytes(co) == bytes(jax_native.opts_to_c(JaxOptions()))
    for _name, opts in FUZZ_COMBOS:
        assert bytes(native.opts_to_c(opts)) == bytes(
            jax_native.opts_to_c(JaxOptions(**opts._asdict())))


# ---------------------------------------------------------------------
# Batch equals column


@pytest.mark.parametrize("threads", [1, 2])
def test_batch_equals_column(params, conus_inputs, threads):
    """noahmp_step_batch over make_batch gives per-column step_column's
    bits in every State and Flux field."""
    case = tuple(join(a, b) for a, b in zip(fuzz_inputs(), conus_inputs))
    static, forcing, state = to_device(case, "cpu")
    opts = Options(veg=2, crs=1)
    co, cp, cf, cs, cx = native.make_batch(params, opts, static, forcing,
                                           state)
    native.set_threads(threads)
    try:
        native.step_batch(co, cp, cf, cs, cx, DT)
    finally:
        native.set_threads(1)
    for i in range(len(cp)):
        sd, fl = native.step_column(params, opts, static, forcing, state, i,
                                    DT)
        for name, typ in native.CState._fields_:
            dtype = np.int32 if typ is ct.c_int32 else np.float32
            assert np.asarray(sd[name], dtype).tobytes() == \
                cs[name][i].tobytes(), (i, name)
        for name in native.FLUX_FIELDS:
            assert np.float32(fl[name]).tobytes() == \
                cx[name][i].tobytes(), (i, name)


# ---------------------------------------------------------------------
# Trajectories against the oracle


class Member(NamedTuple):
    """Columns of one batch: numpy leaves, a Forcing a step (called in
    order), and whether the oracle restarts from the port's State."""
    static: dict
    state: dict
    forcing: Callable
    steps: int
    resync: bool


def mkforcing(n, **kw):
    d = dict(sfctmp=295.0, sfcprs=90000.0, psfc=90000.0, uu=3.0, vv=1.0,
             q2=0.008, soldn=600.0, lwdn=350.0, prcp=0.001, cosz=0.7,
             co2air=39.0, o2air=18900.0, foln=1.0, julian=180.0,
             yearlen=366.0)
    d.update(kw)
    return {k: np.full(n, v, np.float32) for k, v in d.items()}


def trajectory(static_kw, forcing_kw, state_kw=None, steps=24):
    static = tree_to_numpy(init_static(1, device="cpu", **static_kw))
    state = tree_to_numpy(init_state(1, device="cpu", **(state_kw or {})))
    forcing = mkforcing(1, **forcing_kw)
    return Member(static, state, lambda _t: forcing, steps, False)


# tests/test_golden_native.py:110-152
TRAJECTORIES = {
    "warm_vegetated": (Options(), dict(lutyp=7, sltyp=6), {}, None, 24),
    "forest": (Options(), dict(lutyp=14, sltyp=4),
               dict(sfctmp=288.0, soldn=400.0, prcp=0.0), None, 24),
    "bare_ground": (Options(), dict(lutyp=19, sltyp=1, shdfac=0.0,
                                    shdmax=0.0), dict(prcp=0.002), None, 24),
    # measured masked-vs-serial divergence over 60 steps is <3e-4 K
    # (f32 ordering only) in the JAX package; 0.02 K keeps ~60x margin
    "snow": (Options(), dict(lutyp=7, sltyp=6),
             dict(sfctmp=263.0, prcp=0.002, soldn=80.0, cosz=0.3,
                  lwdn=240.0, q2=0.002),
             dict(tg=266.0, tv=266.0, stc_soil=270.0), 60),
    "jarvis_and_runoff3": (Options(crs=2, run=3, inf=2),
                           dict(lutyp=11, sltyp=8), dict(prcp=0.002), None,
                           24),
}

# tests/test_golden_native.py:155-172
OPTION_COMBOS = [
    (Options(frz=2), 7, 6),
    (Options(rad=2), 11, 8),
    (Options(rad=3), 11, 8),
    (Options(snf=2, tbot=1), 7, 6),
    (Options(snf=3, stc=2), 7, 6),
    (Options(alb=1, sfc=2), 14, 4),
    (Options(veg=1), 7, 6),
    (Options(veg=2, crs=1), 11, 8),
    (Options(veg=3, btr=2, run=2), 7, 6),
    (Options(btr=3, run=4), 5, 9),
]
COMBO_STEPS = 12


def combo_id(opts):
    return "_".join(f"{k}{v}" for k, v in opts._asdict().items()
                    if v != getattr(Options(), k))


def stochastic():
    """tests/test_golden_native.py:175-224: one column, new weather every
    step from the same draws."""
    rng = np.random.default_rng(42)
    static = tree_to_numpy(init_static(1, device="cpu", lutyp=7, sltyp=6))
    state = tree_to_numpy(init_state(1, device="cpu", tg=278.0, tv=278.0,
                                     stc_soil=278.0))

    def forcing(_t):
        sfctmp = rng.uniform(255.0, 300.0)
        day = rng.random() < 0.5
        return mkforcing(
            1, sfctmp=sfctmp,
            prcp=float(rng.choice([0.0, 0.0005, 0.003])),
            soldn=float(rng.uniform(200.0, 800.0)) if day else 0.0,
            cosz=float(rng.uniform(0.2, 0.9)) if day else -0.2,
            lwdn=float(rng.uniform(220.0, 380.0)),
            q2=float(rng.uniform(0.001, 0.01)),
            uu=float(rng.uniform(0.5, 10.0)))
    return Member(static, state, forcing, 60, False)


def resync(steps):
    """tests/test_golden_native.py:294-368: the ten fuzz columns."""
    rng = np.random.default_rng(42)
    static, state = fuzz_case()
    n = static["lat"].shape[0]
    return Member(static, state, lambda _t: fuzz_forcing(rng, n), steps,
                  True)


def batches(runslow):
    """{Options: {member name: Member}}: every case of this file, by
    the options it runs under."""
    out = {}
    for name, (opts, skw, fkw, stkw, steps) in TRAJECTORIES.items():
        out.setdefault(opts, {})[name] = trajectory(skw, fkw, stkw, steps)
    for opts, lutyp, sltyp in OPTION_COMBOS:
        out.setdefault(opts, {})[f"combo_{combo_id(opts)}"] = trajectory(
            dict(lutyp=lutyp, sltyp=sltyp), dict(prcp=0.0015),
            steps=COMBO_STEPS)
    out[Options()]["stochastic"] = stochastic()
    for name, opts in FUZZ_COMBOS:
        out.setdefault(opts, {})[f"resync_{name}"] = resync(
            RESYNC_STEPS_SLOW if runslow else RESYNC_STEPS)
    return out


def run_batch(params, opts, members):
    """One eager step a step over all members' columns, and the oracle
    beside it.  Returns {member: (port, oracle)}, each a list over the
    steps of {field: that member's rows}."""
    names = list(members)
    sizes = [members[m].static["lat"].shape[0] for m in names]
    bounds = np.cumsum([0] + sizes)
    rows = {m: slice(bounds[k], bounds[k + 1]) for k, m in enumerate(names)}
    static = tree_from_numpy(Static, join(*[members[m].static
                                            for m in names]), "cpu")
    state = tree_from_numpy(State, join(*[members[m].state for m in names]),
                            "cpu")
    free = np.concatenate([np.full(k, not members[m].resync)
                           for m, k in zip(names, sizes)])
    steps = max(members[m].steps for m in names)
    step = make_step(params, opts, DT, device="cpu")
    co = native.opts_to_c(opts)
    cp = native.params_to_array(params, static)
    own = native.state_to_array(state)
    out = {m: ([], []) for m in names}
    with torch.inference_mode():
        for _t in range(steps):
            forcing = tree_from_numpy(Forcing, join(*[
                members[m].forcing(_t) for m in names]), "cpu")
            cs = native.state_to_array(state)
            cs[free] = own[free]
            cx = np.zeros(len(cs), native.FLUX_DTYPE)
            native.step_batch(co, cp, native.forcing_to_array(forcing), cs,
                              cx, DT)
            own = cs
            state, _flux = step(static, forcing, state)
            port = {k: getattr(state, k).numpy() for k in FIELDS}
            for m in names:
                r = rows[m]
                out[m][0].append({k: port[k][r].copy() for k in FIELDS})
                out[m][1].append({k: cs[k][r].copy() for k in FIELDS})
    return out


@pytest.fixture(scope="module")
def runs(params, runslow):
    """The runs of each options' batch, made when a test first asks."""
    plan = batches(runslow)
    done = {}

    def get(opts, member):
        if opts not in done:
            done[opts] = run_batch(params, opts, plan[opts])
        return done[opts][member]
    return get


def compare(run, steps, atol_t=0.02, atol_w=1e-3, atol_sneqv=0.05):
    """tests/test_golden_native.py:compare over the member's column."""
    port, orc = run
    assert len(port) >= steps
    for t in range(steps):
        p, o = port[t], orc[t]
        np.testing.assert_allclose(p["tg"], o["tg"], atol=atol_t,
                                   err_msg=f"tg step {t}")
        np.testing.assert_allclose(p["tv"], o["tv"], atol=atol_t,
                                   err_msg=f"tv step {t}")
        np.testing.assert_allclose(p["stc"][:, 3:], o["stc"][:, 3:],
                                   atol=atol_t, err_msg=f"soil stc step {t}")
        np.testing.assert_allclose(p["swc"], o["swc"], atol=atol_w,
                                   err_msg=f"swc step {t}")
        np.testing.assert_allclose(p["sneqv"], o["sneqv"], atol=atol_sneqv,
                                   err_msg=f"sneqv step {t}")


def test_warm_vegetated_trajectory(runs):
    compare(runs(Options(), "warm_vegetated"), 24)


def test_forest_trajectory(runs):
    compare(runs(Options(), "forest"), 24)


def test_bare_ground_trajectory(runs):
    compare(runs(Options(), "bare_ground"), 24)


def test_snow_trajectory(runs):
    """Snow accumulation with layer formation: layer combine/divide and
    phase change."""
    compare(runs(Options(), "snow"), 60, atol_t=0.02, atol_w=1e-3)


def test_jarvis_and_runoff3_trajectory(runs):
    compare(runs(Options(crs=2, run=3, inf=2), "jarvis_and_runoff3"), 24)


@pytest.mark.parametrize("opts,lutyp,sltyp", OPTION_COMBOS,
                         ids=[combo_id(c[0]) for c in OPTION_COMBOS])
def test_option_combo_trajectory(runs, opts, lutyp, sltyp):
    """The option matrix against the serial C++ reference."""
    compare(runs(opts, f"combo_{combo_id(opts)}"), COMBO_STEPS)


def test_stochastic_regime_fuzz(runs):
    """New weather every step (warm/cold/rainy/snowy/night), the oracle
    free-running beside the port; the JAX file's tolerances (measured
    x10 over 200-step runs across seeds {42, 7, 123})."""
    port, orc = runs(Options(), "stochastic")
    for t in range(60):
        p, o = port[t], orc[t]
        np.testing.assert_allclose(p["tg"], o["tg"], atol=0.034,
                                   err_msg=f"tg diverged at step {t}")
        np.testing.assert_allclose(p["tv"], o["tv"], atol=0.11,
                                   err_msg=f"tv diverged at step {t}")
        np.testing.assert_allclose(p["swc"], o["swc"], atol=2.3e-5,
                                   err_msg=f"swc diverged at step {t}")
        np.testing.assert_allclose(p["sneqv"], o["sneqv"], atol=0.03,
                                   err_msg=f"sneqv diverged at step {t}")
        assert np.array_equal(p["nsnow"], o["nsnow"]), \
            f"layer count diverged at step {t}"


@pytest.mark.parametrize("name,opts", FUZZ_COMBOS,
                         ids=[c[0] for c in FUZZ_COMBOS])
def test_resync_fuzz(runs, runslow, name, opts):
    """Every column-step within FUZZ_CAP, at most FUZZ_OUTLIER_FRAC of
    them beyond FUZZ_TIGHT, layer counts exact."""
    port, orc = runs(opts, f"resync_{name}")
    assert len(port) >= (RESYNC_STEPS_SLOW if runslow else RESYNC_STEPS)
    outliers = total = 0
    for t, (p, o) in enumerate(zip(port, orc)):
        share, over_cap, nsnow, _ = fuzz_shares(p, o)
        assert not nsnow.any(), (f"{name}: layer count diverged step {t} "
                                 f"cols {np.flatnonzero(nsnow)}")
        assert not over_cap.any(), (
            f"{name}: beyond the hard cap at step {t} cols "
            f"{np.flatnonzero(over_cap)} ({FUZZ_CAP})")
        outliers += int((share > 1.0).sum())
        total += share.size
    assert outliers <= FUZZ_OUTLIER_FRAC * total, (
        f"{name}: {outliers}/{total} column-steps beyond {FUZZ_TIGHT} "
        f"(allowed {FUZZ_OUTLIER_FRAC:.1%})")


# ---------------------------------------------------------------------
# Device contract


def test_conversions_read_each_tensor_once(params, monkeypatch):
    """A batch of 256 columns and one column cost the same reads: each
    table and each container leaf comes to the host once a call."""
    static, state = fuzz_case(26)
    case = ({k: v[:256] for k, v in static.items()},
            fuzz_forcing(np.random.default_rng(0), 256),
            {k: v[:256] for k, v in state.items()})
    static, forcing, state = to_device(case, "cpu")
    reads = [0]
    cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        reads[0] += 1
        return cpu(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    tables = sum(len(t.FIELDS) for t in (params.veg, params.soil,
                                         params.gen))
    leaves = len(Static._fields) + len(Forcing._fields) + len(State._fields)
    native.make_batch(params, Options(), static, forcing, state)
    assert reads[0] == tables + leaves
    reads[0] = 0
    native.step_column(params, Options(), static, forcing, state, 255, DT)
    assert reads[0] == tables + leaves


def test_bench_native_gives_a_positive_rate(params):
    static, forcing, state = to_device(fuzz_inputs(2), "cpu")
    before = state.tg.clone()
    rate = native.bench_native(params, Options(), static, forcing, state,
                               steps=2, threads=1)
    assert np.isfinite(rate) and rate > 0.0
    assert torch.equal(state.tg, before)
