#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``noahmp_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 chip_smoke.py

It builds the CUDA kernels from ``noahmp_tpu_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card, and
drives the port's two main paths at n = 65,536 land points for a few
steps on five cases: the eager step (``make_step``, whose two implicit
solves go through the Thomas kernel) and the fused step
(``make_fused_step``, one launch of the column kernel a step).  It
checks the outputs (finite, conservation residuals under the reference
model's abort bounds, agreement with the port's own CPU run, every
option value the fused step accepts), shows from the launch counters
that each path went through its kernels, and times both steps in turns.

Each phase prints one JSON line.  The line before the last two is
``{"kernels": [...]}``; then the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises: the run
ends with a non-zero code and no ``ok`` line.  Without a CUDA device the
script exits with code 2 before any phase.

``--cpu-rehearsal`` runs the phases that need no card at a tiny size on
the CPU, to find wrong paths and shapes; it never prints the ``ok`` line
and always exits non-zero.  ``--profile DIR`` adds one step under
``torch.profiler`` and writes the kernel table to ``DIR/step_profile.txt``;
``--sweep`` times both steps at 16k to 1M land points.

The column kernel's operation bound needs ``g++`` and ``gcov`` on the
machine: the operations are counted by running the kernel's headers,
built for the host with coverage, over this run's inputs.
"""

import argparse
import ctypes
import gzip
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from noahmp_tpu_torch import (Options, load_params, make_fused_step,
                              make_step)
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, REGIMES,
                                    STATE_BAR, STATE_CEILING, bar_ratio,
                                    hetero_case, scaled_err, to_device,
                                    uniform_case)
from noahmp_tpu_torch.convert import tree_to_numpy
from noahmp_tpu_torch.kernels import _build, column
from noahmp_tpu_torch.kernels.column import column_cuda, column_plain
from noahmp_tpu_torch.kernels.tridiag import (reset_launches, thomas_cuda,
                                              thomas_plain)
from noahmp_tpu_torch.numerics.tridiag import masked_identity_rows
from noahmp_tpu_torch.options import fused_option_sets

SEED = 0
N_POINTS = 65536
N_STEPS = 8
DT = 900.0
LAUNCHES_PER_STEP = {7: 1, 4: 6}    # heat solve; six Richards sub-steps
N_OPTIONS = 4096                    # points a fused_options comparison
N_OPS = 8                           # points the operation count walks

# Gathered parameters the physics uses under the default options: what
# the byte bound counts, since the bound is what the function needs.
# The kernel itself loads every gathered parameter of its point,
# whatever the options; the kernels line gives both byte counts.
DEFAULT_PARAM_READS = (
    "xl", "rhol", "rhos", "taul", "taus", "lai12m", "sai12m", "nroot",
    "canwmxp", "dleaf", "z0mvt", "hvt", "hvb", "rcrown", "cwpvt", "c3c4",
    "kc25", "akc", "ko25", "ako", "vcmx25", "avcmx", "bp", "mp", "qe25",
    "folnmx", "tmin", "bexp", "smcmax", "smcref", "smcwlt", "psisat",
    "dksat", "dwsat", "quartz", "albsat", "albdry")

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and float32 FLOP/s outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67.0e12

KERNEL_TOL = 1.0e-6       # max |x_k - x_p| / max(1, |x_p|)
# The step's bars (STATE_BAR, FLUX_BAR and their ceilings) are those the
# CPU tests hold the port to against the JAX package; see cases.py.
RESIDUAL_BOUND = 0.01     # W/m2 and mm: the reference model aborts above

# Vegetated-tile diagnostics are undefined (NaN) on points without
# vegetation, in the reference implementation as well.
VEG_TILE_ONLY = ("irc", "irg", "shc", "shg", "evc", "evg", "ghv", "tr",
                 "chleaf", "chuc", "chv2", "t2mv", "q2v")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def phase_env():
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    card = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=shutil.which("nvcc") or _build.find_nvcc(),
         triton=has_triton, python=sys.version.split()[0], card=card)
    return card


def phase_build():
    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    attrs = column.kernel_attributes()
    emit("build", seconds=round(seconds, 3), sources=sorted(paths),
         flags=" ".join(_build.NVCC_FLAGS),
         extra_flags={k: " ".join(v) for k, v in _build.EXTRA_FLAGS.items()},
         column_kernel=attrs)
    return seconds, attrs


def make_system(rng, n, rows, device):
    """Diagonally dominant (n, rows) systems from a numpy generator."""
    b = rng.uniform(1.5, 3.0, (n, rows)).astype(np.float32)
    a = rng.uniform(-0.5, 0.5, (n, rows)).astype(np.float32)
    c = rng.uniform(-0.5, 0.5, (n, rows)).astype(np.float32)
    d = rng.uniform(-1.0, 1.0, (n, rows)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (a, b, c, d))


def kernel_err(xk, xp):
    return float(((xk - xp).abs() / xp.abs().clamp(min=1.0)).max())


_BLOCKER = {}


def _hold_the_card(device):
    """Queue some tens of milliseconds of device work (large float32
    matrix products), so that launches enqueued right after it wait in
    the stream and then run back to back, not at the host's pace."""
    if "m" not in _BLOCKER:
        _BLOCKER["m"] = torch.ones(8192, 8192, device=device)
    for _ in range(3):
        _BLOCKER["m"] @ _BLOCKER["m"]


def time_cuda(fn, arg_sets, reps=20, batches=5, warmup=5, device=None):
    """Device milliseconds of one fn(*args): ``reps`` launches between
    two CUDA events, queued behind a blocker so that they run back to
    back; median over ``batches`` such runs.  Walks over ``arg_sets`` so
    that a set is cold in the L2 cache when its turn comes (the sets
    together exceed the cache)."""
    device = device or arg_sets[0][0].device
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    means = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        _hold_the_card(device)
        start.record()
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        stop.record()
        stop.synchronize()
        means.append(start.elapsed_time(stop) / reps)
    return statistics.median(means)


def time_cuda_isolated(fn, arg_sets, reps=30, warmup=5):
    """Median milliseconds between two events around ONE call on an idle
    card: the kernel plus the host's time to launch it, which is what a
    caller that launches one small kernel at a time sees."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*arg_sets[i % len(arg_sets)])
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def dense_solve(a, b, c, d):
    """The nearest single library call: a dense batched solve of the
    (n, L, L) matrices.  Timed as a yardstick only; the port never calls
    it."""
    mat = (torch.diag_embed(b) + torch.diag_embed(a[:, 1:], offset=-1)
           + torch.diag_embed(c[:, :-1], offset=1))
    return mat, d.unsqueeze(-1)


def phase_kernels(device):
    rng = np.random.default_rng(SEED)
    checks = []
    for n, rows in ((N_POINTS, 4), (N_POINTS, 7), (N_POINTS + 1, 7), (1, 4)):
        sysm = make_system(rng, n, rows, device)
        err = kernel_err(thomas_cuda(*sysm), thomas_plain(*sysm))
        checks.append({"n": n, "L": rows, "max_err": err})
    # variable-top systems: identity rows on top, as the heat solve
    # passes them for inactive snow slots
    a, b, c, d = make_system(rng, N_POINTS, 7, device)
    nsnow = torch.from_numpy(
        rng.integers(0, 4, N_POINTS).astype(np.int32)).to(device)
    active = (torch.arange(7, device=device, dtype=torch.int32)
              >= (3 - nsnow).unsqueeze(-1))
    a = torch.where(active & ~(torch.arange(7, device=device)
                               == (3 - nsnow).unsqueeze(-1)), a, 0.0)
    sysm = tuple(t.contiguous()
                 for t in masked_identity_rows(active, a, b, c, d))
    xk = thomas_cuda(*sysm)
    err = kernel_err(xk, thomas_plain(*sysm))
    inactive_zero = bool((xk[~active] == 0).all())
    checks.append({"n": N_POINTS, "L": 7, "identity_rows": True,
                   "max_err": err, "inactive_rows_zero": inactive_zero})
    torch.cuda.synchronize()
    for chk in checks:
        if not chk["max_err"] <= KERNEL_TOL:
            raise AssertionError(f"thomas_cuda disagrees with "
                                 f"thomas_plain: {chk}")
    if not inactive_zero:
        raise AssertionError("identity rows did not solve to zero")

    entries = []
    for rows in (7, 4):
        n = N_POINTS
        nbytes = 5 * n * rows * 4
        nsets = math.ceil(60e6 / nbytes) + 1    # past the 50 MB L2
        sets = [make_system(rng, n, rows, device) for _ in range(nsets)]
        ms = time_cuda(thomas_cuda, sets)
        ms_isolated = time_cuda_isolated(thomas_cuda, sets)
        plain_ms = time_cuda(thomas_plain, sets)
        mat, rhs = dense_solve(*sets[0])
        library_ms = time_cuda(torch.linalg.solve, [(mat, rhs)])
        lib_err = kernel_err(
            thomas_cuda(*sets[0]),
            torch.linalg.solve(mat, rhs).squeeze(-1))
        # forward sweep 3 div + 2 mul + 2 add a row, back sweep 1 mul +
        # 1 add: 9 float32 operations a row
        flops = 9 * n * rows
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        err = max(c["max_err"] for c in checks if c["L"] == rows)
        entries.append({
            "name": f"thomas_cuda[L={rows}]", "route": "cuda",
            "source": "noahmp_tpu_torch/csrc/tridiag.cu",
            "replaces": "noahmp_tpu/pallas/tridiag.py:47",
            "shape": [n, rows], "launches": None,
            "max_abs_err": err, "ms": ms, "ms_isolated": ms_isolated,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "library": "torch.linalg.solve on dense (n, L, L); no single "
                       "PyTorch call solves batched tridiagonal systems",
            "library_vs_kernel_err": lib_err,
            "timing": f"CUDA events around 20 launches queued back to "
                      f"back, median of 5; inputs cold in L2 ({nsets} sets "
                      f"walked in turn); ms_isolated is one launch on an "
                      f"idle card, the host's launch time included",
        })
    emit("kernels_check", tolerance=KERNEL_TOL, cases=checks)
    return entries


def check_outputs(case_name, static_np, state, flux):
    """Finite leaves and conservation residuals under the bounds."""
    s = tree_to_numpy(state)
    f = tree_to_numpy(flux)
    for name, leaf in s.items():
        if not np.isfinite(leaf).all():
            raise AssertionError(f"{case_name}: State.{name} not finite")
    lutyp = static_np["lutyp"]
    for name, leaf in f.items():
        bad = ~np.isfinite(leaf)
        if name in VEG_TILE_ONLY:
            # undefined where the point carries no vegetation
            bad = bad & (f["fveg"] > 0.0)
        if bad.any():
            raise AssertionError(
                f"{case_name}: Flux.{name} not finite at land-use "
                f"classes {sorted(set(lutyp[bad].tolist()))}")
    land = static_np["ist"] == 1
    res = {k: float(np.abs(f[k][land]).max())
           for k in ("errsw", "erreng", "errwat")}
    for k, v in res.items():
        if not v < RESIDUAL_BOUND:
            raise AssertionError(f"{case_name}: max|{k}| = {v} on land, "
                                 f"bound {RESIDUAL_BOUND}")
    return res


def run_steps(step, case, device, steps):
    static, forcing, state = to_device(case, device)
    flux = None
    for _ in range(steps):
        state, flux = step(static, forcing, state)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return state, flux


def phase_step(step, device, n, steps):
    """The main path: ``steps`` model steps of each case.  Launch
    counts are zeroed just before and read just after."""
    cases = [("uniform", uniform_case(n))]
    cases += [(f"hetero/{r}", hetero_case(r, n)) for r in REGIMES]
    reset_launches()
    report = []
    for name, case in cases:
        before = thomas_cuda.launches
        t0 = time.perf_counter()
        state, flux = run_steps(step, case, device, steps)
        seconds = time.perf_counter() - t0
        res = check_outputs(name, case[0], state, flux)
        report.append({"case": name, "steps": steps,
                       "seconds": round(seconds, 3),
                       "thomas_launches": thomas_cuda.launches - before,
                       **{f"max_abs_{k}": v for k, v in res.items()}})
    launches = dict(thomas_cuda.launches_by_rows)
    total_steps = steps * len(cases)
    if device.type == "cuda":
        want = {r: k * total_steps for r, k in LAUNCHES_PER_STEP.items()}
        if launches != want or thomas_cuda.launches != sum(want.values()):
            raise AssertionError(f"Thomas kernel launches {launches}, "
                                 f"expected {want} for {total_steps} steps")
    emit("step", n=n, dt=DT, cases=report, total_steps=total_steps,
         thomas_launches=launches)
    return launches


def compare_step(label, ref, got):
    """(state, flux) of the plain version against the kernel's: every
    float leaf within the step's bars, every int32 leaf equal.  Returns
    (worst scaled error, its leaf, worst share of the allowed error,
    leaves equal bit for bit, leaves)."""
    worst_err, worst_leaf, worst_ratio, equal, leaves = 0.0, "", 0.0, 0, 0
    for r_tree, g_tree, bar, ceiling in (
            (ref[0], got[0], STATE_BAR, STATE_CEILING),
            (ref[1], got[1], FLUX_BAR, FLUX_CEILING)):
        r_np, g_np = tree_to_numpy(r_tree), tree_to_numpy(g_tree)
        for name, r in r_np.items():
            g = g_np[name]
            leaves += 1
            if r.dtype == np.int32:
                if not np.array_equal(g, r):
                    raise AssertionError(
                        f"{label}: int leaf {name} differs on "
                        f"{int((g != r).sum())} elements")
                equal += 1
                continue
            if g.dtype != r.dtype:
                raise AssertionError(f"{label}: {name} is {g.dtype}")
            ratio = bar_ratio(r, g, bar, ceiling)
            err = scaled_err(r, g)
            if not ratio <= 1.0:
                raise AssertionError(
                    f"{label}: {name} kernel vs plain: scaled error {err} "
                    f"on {int((r != g).sum())} elements, {ratio:.3g} times "
                    f"what bar {bar} and ceiling {ceiling} allow")
            equal += int(np.array_equal(r, g, equal_nan=True))
            if err > worst_err:
                worst_err, worst_leaf = err, name
            worst_ratio = max(worst_ratio, ratio)
    return worst_err, worst_leaf, worst_ratio, equal, leaves


def fused_against_plain(params, opts, case, device):
    """One step from the same state through the fused step's entry point
    and through the kernel's plain version.  On the card the entry
    point launches the kernel, once."""
    static, forcing, state = to_device(case, device)
    step = make_fused_step(params, opts, DT, static, device=device)
    dt = torch.tensor(DT, dtype=torch.float32, device=device)
    before = column_cuda.launches
    got = step(None, forcing, state)
    if device.type == "cuda":
        torch.cuda.synchronize()
        if column_cuda.launches - before != column.LAUNCHES_PER_STEP:
            raise AssertionError("the fused step did not launch the kernel")
    with torch.no_grad():
        ref = column_plain(step.gathered, opts, static, forcing, state, dt)
    return ref, got


def all_cases(n):
    cases = [("uniform", uniform_case(n))]
    return cases + [(f"hetero/{r}", hetero_case(r, n)) for r in REGIMES]


def phase_fused_kernel(params, device, n):
    """column_cuda against column_plain: all five cases at n, and the
    ragged sizes n + 1 and 1."""
    cases = all_cases(n) + [("uniform", uniform_case(n + 1)),
                            ("uniform", uniform_case(1))]
    report, worst = [], (0.0, "", "", 0.0)
    for name, case in cases:
        ref, got = fused_against_plain(params, Options(), case, device)
        points = case[2]["tg"].shape[0]
        err, leaf, ratio, equal, leaves = compare_step(
            f"{name} n={points}", ref, got)
        report.append({"case": name, "n": points, "max_err": err,
                       "leaf": leaf, "share_of_bar": ratio,
                       "leaves_bit_equal": equal, "leaves": leaves})
        if err >= worst[0]:
            worst = (err, name, leaf, max(ratio, worst[3]))
    emit("fused_kernel_check", state_bar=STATE_BAR, flux_bar=FLUX_BAR,
         state_ceiling=STATE_CEILING, flux_ceiling=FLUX_CEILING, cases=report)
    return worst


def phase_fused_step(params, device, n, steps):
    """This slice's main path: ``steps`` steps of each case through
    make_fused_step, the trajectory the kernel's own.  Launch counts are
    zeroed just before and read just after."""
    cases = all_cases(n)
    column.reset_launches()
    reset_launches()
    report = []
    for name, case in cases:
        static, forcing, state = to_device(case, device)
        step = make_fused_step(params, Options(), DT, static, device=device)
        t0 = time.perf_counter()
        flux = None
        for _ in range(steps):
            state, flux = step(None, forcing, state)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        res = check_outputs(f"fused {name}", case[0], state, flux)
        report.append({"case": name, "steps": steps,
                       "seconds": round(seconds, 4),
                       **{f"max_abs_{k}": v for k, v in res.items()}})
    total_steps = steps * len(cases)
    launches = column_cuda.launches
    if device.type == "cuda":
        want = total_steps * column.LAUNCHES_PER_STEP
        if launches != want:
            raise AssertionError(f"column kernel launches {launches}, "
                                 f"expected {want} for {total_steps} steps")
        if thomas_cuda.launches != 0:
            raise AssertionError("the fused path launched the stand-alone "
                                 f"Thomas kernel {thomas_cuda.launches} times")
    emit("fused_step", n=n, dt=DT, cases=report, total_steps=total_steps,
         column_launches=launches,
         launches_per_step=column.LAUNCHES_PER_STEP,
         thomas_launches=thomas_cuda.launches)
    return launches


def phase_cpu_agreement(params_cpu, step, device, n=4096):
    """One step from the same state on the card and on the CPU (plain
    versions), leaf by leaf."""
    cpu = torch.device("cpu")
    cpu_step = make_step(params_cpu, Options(), DT, device="cpu")
    worst = ("", "", 0.0)
    for regime in REGIMES:
        case = hetero_case(regime, n)
        s_gpu, f_gpu = run_steps(step, case, device, 1)
        s_cpu, f_cpu = run_steps(cpu_step, case, cpu, 1)
        for got, ref, bar, ceiling in (
                (s_gpu, s_cpu, STATE_BAR, STATE_CEILING),
                (f_gpu, f_cpu, FLUX_BAR, FLUX_CEILING)):
            g, r = tree_to_numpy(got), tree_to_numpy(ref)
            for name in r:
                if r[name].dtype == np.int32:
                    if not np.array_equal(g[name], r[name]):
                        raise AssertionError(
                            f"{regime}: {name} differs between card and CPU")
                    continue
                err = scaled_err(r[name], g[name])
                if err > worst[2]:
                    worst = (regime, name, err)
                ratio = bar_ratio(r[name], g[name], bar, ceiling)
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"{regime}: {name} card vs CPU: scaled error "
                        f"{err}, {ratio:.3g} times what bar {bar} and "
                        f"ceiling {ceiling} allow")
    emit("cpu_agreement", n=n, regimes=list(REGIMES),
         state_bar=STATE_BAR, flux_bar=FLUX_BAR,
         state_ceiling=STATE_CEILING, flux_ceiling=FLUX_CEILING,
         worst={"regime": worst[0], "leaf": worst[1], "err": worst[2]})


def phase_fused_cpu_agreement(params, params_cpu, device, n=4096):
    """One fused step from the same state on the card (the kernel) and
    on the CPU (its plain version), leaf by leaf."""
    cpu = torch.device("cpu")
    worst = ("", "", 0.0)
    for regime in REGIMES:
        case = hetero_case(regime, n)
        _ref, got = fused_against_plain(params, Options(), case, device)
        static, forcing, state = to_device(case, cpu)
        ref = make_fused_step(params_cpu, Options(), DT, static,
                              device="cpu")(None, forcing, state)
        err, leaf, _ratio, _eq, _n = compare_step(
            f"{regime} card vs CPU", ref, got)
        if err > worst[2]:
            worst = (regime, leaf, err)
    emit("fused_cpu_agreement", n=n, regimes=list(REGIMES),
         worst={"regime": worst[0], "leaf": worst[1], "err": worst[2]})


def phase_fused_options(params, device, n):
    """Every option value the fused step accepts, one at a time beside
    the defaults, on a snow case and a stress case."""
    report = []
    for opts in fused_option_sets():
        changed = {k: v for k, v in opts._asdict().items()
                   if v != getattr(Options(), k)}
        for regime in ("cold_snow", "hot_dry"):
            ref, got = fused_against_plain(params, opts,
                                           hetero_case(regime, n), device)
            err, leaf, ratio, _eq, _n = compare_step(
                f"{changed} hetero/{regime}", ref, got)
            report.append({"options": changed, "regime": regime,
                           "max_err": err, "leaf": leaf,
                           "share_of_bar": ratio})
    emit("fused_options", n=n, checked=len(report),
         worst=max(report, key=lambda r: r["share_of_bar"]), cases=report)


def phase_no_sync(step, params, device, n):
    """One step of each path with PyTorch's synchronisation check set to
    raise: a step must not make the host wait for the card anywhere."""
    static, forcing, state = to_device(uniform_case(n), device)
    fused = make_fused_step(params, Options(), DT, static, device=device)
    state, _ = step(static, forcing, state)      # kernels are built by now
    state, _ = fused(None, forcing, state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(static, forcing, state)
        state, _ = fused(None, forcing, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit("no_sync", n=n, paths=["make_step", "make_fused_step"],
         host_synchronisations=0)


def wall_ms_in_turns(steps, states, reps, warmup):
    """Host-clock milliseconds of one step of each of ``steps`` (a list
    of callables state -> state), taken in turns so that both see the
    same host and the same card; each step ends in a synchronise."""
    times = [[] for _ in steps]
    for i in range(warmup + reps):
        for k, fn in enumerate(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[k] = fn(states[k])
            torch.cuda.synchronize()
            if i >= warmup:
                times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def phase_sweep(params, step, device, sizes=(16384, 65536, 262144, 1048576)):
    """Step time of both paths against the number of land points
    (opt-in)."""
    rows = []
    for n in sizes:
        static, forcing, state = to_device(uniform_case(n), device)
        fused = make_fused_step(params, Options(), DT, static, device=device)
        eager_ms, fused_ms = wall_ms_in_turns(
            [lambda s: step(static, forcing, s)[0],
             lambda s: fused(None, forcing, s)[0]], [state, state], 3, 2)
        rows.append({"n": n,
                     "eager_ms_per_step": statistics.median(eager_ms),
                     "fused_ms_per_step": statistics.median(fused_ms),
                     "fused_point_steps_per_s":
                         n / (statistics.median(fused_ms) * 1e-3),
                     "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
        del static, forcing, state, fused
    emit("sweep", case="uniform", rows=rows)


def eager_device_ms(step, static, forcing, state):
    """Summed device time of the kernels of one eager step, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(static, forcing, state)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        raise RuntimeError("torch.profiler reported no device time")
    return (sum(e.device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


# --- the operations one step executes -------------------------------
# No profiler counts executed operations on the card, and the work
# depends on the data (Newton trips, bisection trips, Richards
# sub-steps).  So the count is taken on the host from the very headers
# the CUDA kernel is built from: csrc/column_host.cpp is compiled with
# g++ -O0 --coverage, run over the points, and gcov reports how often
# each source line ran.  Each statement is weighted by the arithmetic it
# spells out: one for every + - * / between float operands and one for
# every call of a math function, of a rounding intrinsic of the Thomas
# solve or of mx/mn (two for clipf); the small helpers (rdiv, divc, sq,
# cube, sum_last) are counted where they are defined.  A transcendental
# call counts as one operation, so the bound errs low.  The loads and
# stores of column_io.cuh are addressing and are left out, as is integer
# arithmetic inside [...] and against bare integer literals.  An
# estimate good to a few per cent, which is all a bound asks for.
_MATH = ("expf", "logf", "log10f", "powf", "pow", "sqrtf", "rsqrtf", "tanhf",
         "atanf", "fabsf", "floorf", "fmodf", "mx", "mn", "__fadd_rn",
         "__fsub_rn", "__fmul_rn", "__fdiv_rn")
_CALL = re.compile(r"\b(" + "|".join(_MATH) + r")\(")
_CLIP = re.compile(r"\bclipf\(")
_BINARY = re.compile(r"(?<=[\w\)\]]) ([+\-*/]) (?=[\w\(\-])")
_INT_NEIGHBOUR = re.compile(r"(?:\b\d+ [+\-*/] )|(?: [+\-*/] \d+\b(?![.\w]))")
# sources that hold no physics: the argument list, the per-point loads
# and stores, the host loop
_NOT_PHYSICS = ("column_args.cuh", "column_io.cuh", "column_host.cpp",
                "host_compat.h")
# the host build plus a way to write the counters out before the
# process ends
_COVERAGE_UNIT = """#include "column_host.cpp"
extern "C" void __gcov_dump(void);
extern "C" void column_coverage_dump() { __gcov_dump(); }
"""


def statement_ops(code):
    """Float operations spelled out in one line of source."""
    code = code.split("//")[0]
    if code.lstrip().startswith("#"):
        return 0
    code = re.sub(r"\[[^\]]*\]", "[]", code)
    n = len(_BINARY.findall(code)) - len(_INT_NEIGHBOUR.findall(code))
    return max(n, 0) + len(_CALL.findall(code)) + 2 * len(_CLIP.findall(code))


def line_counts(build_dir):
    """{header: {line number: executions}} from gcov's JSON report."""
    subprocess.run(["gcov", "--json-format", "-o", build_dir,
                    os.path.join(build_dir, "coverage.o")],
                   cwd=build_dir, check=True, capture_output=True)
    with gzip.open(os.path.join(build_dir, "coverage.gcov.json.gz")) as fh:
        report = json.load(fh)
    counts = {}
    for entry in report["files"]:
        path = os.path.abspath(os.path.join(build_dir, entry["file"]))
        name = os.path.basename(path)
        if os.path.dirname(path) != _build.CSRC_DIR or name in _NOT_PHYSICS:
            continue
        per_line = counts.setdefault(name, {})
        for line in entry["lines"]:
            no = line["line_number"]
            per_line[no] = per_line.get(no, 0) + line["count"]
    return counts


def weigh(counts):
    """Sum over statements of (operations spelled out) x (executions).
    A statement spans lines up to its ``;``, ``{`` or ``}``; it ran as
    often as its most-run line."""
    total, by_file = 0, {}
    for fname, per_line in counts.items():
        with open(os.path.join(_build.CSRC_DIR, fname)) as fh:
            lines = fh.read().splitlines()
        ops = runs = sub = 0
        for no, text in enumerate(lines, 1):
            ops += statement_ops(text)
            runs = max(runs, per_line.get(no, 0))
            if text.split("//")[0].rstrip().endswith((";", "{", "}")):
                sub += ops * runs
                ops = runs = 0
        by_file[fname] = sub
        total += sub
    return total, by_file


def count_operations(gathered, opts, dt, static, forcing, state):
    """Float32 operations that one step of these CPU tensors executes,
    summed over the points.  Returns (total, {header: operations})."""
    build_dir = tempfile.mkdtemp(prefix="column_ops_")
    try:
        unit = os.path.join(build_dir, "coverage.cpp")
        obj = os.path.join(build_dir, "coverage.o")
        lib_path = os.path.join(build_dir, "libcolumn_coverage.so")
        with open(unit, "w") as fh:
            fh.write(_COVERAGE_UNIT)
        subprocess.run(["g++", "-O0", "--coverage", "-std=c++17",
                        "-ffp-contract=off", "-fPIC", "-I", _build.CSRC_DIR,
                        "-c", unit, "-o", obj], check=True)
        subprocess.run(["g++", "--coverage", "-shared", "-o", lib_path, obj],
                       check=True)
        lib = ctypes.CDLL(lib_path)
        args_type = column._args_type()
        column.check_abi(lib, args_type)
        lib.noahmp_column_host.argtypes = [ctypes.POINTER(args_type)]
        lib.noahmp_column_host.restype = ctypes.c_int
        plan = column.ColumnPlan(gathered, opts, dt, static, need_cuda=False)
        _s, _f, outputs = plan.outputs()
        args = plan.point_to(forcing, state, outputs)
        if lib.noahmp_column_host(ctypes.byref(args)) != 0:
            raise RuntimeError("the host build of the column step failed")
        lib.column_coverage_dump()
        return weigh(line_counts(build_dir))
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)


def column_bound(params_cpu, gathered, static, forcing, state, n):
    """The least time the card could take for one launch: bytes (every
    input the default options need, once; every output, once) over the
    memory rate, against the float32 operations these inputs execute
    (counted on the host over N_OPS of the points, which are all alike
    in the uniform case) over the float32 rate.  Also the bytes the
    kernel as written moves: it loads every gathered parameter."""
    def nbytes(t):
        return t.numel() * t.element_size()
    in_bytes = sum(nbytes(t) for tree in (static, forcing, state)
                   for t in tree)
    param_bytes = sum(nbytes(gathered.fields[f]) for f in DEFAULT_PARAM_READS)
    all_param_bytes = sum(nbytes(t) for t in gathered.fields.values())
    head = column.header_layout()
    out_bytes = 4 * n * sum(w for _n, _d, w in head["STATE"] + head["FLUX"])
    s_cpu, f_cpu, st_cpu = to_device(uniform_case(N_OPS), "cpu")
    g_cpu = make_fused_step(params_cpu, Options(), DT, s_cpu,
                            device="cpu").gathered
    ops, _by_file = count_operations(g_cpu, Options(), DT, s_cpu, f_cpu,
                                     st_cpu)
    ops_per_point = ops / N_OPS
    needed = in_bytes + param_bytes + out_bytes
    t_bytes = needed / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_per_point * n / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": needed, "bytes_per_point": needed / n,
            "bytes_ms": t_bytes,
            "kernel_bytes_per_point":
                (in_bytes + all_param_bytes + out_bytes) / n,
            "operations_per_point": ops_per_point, "operations_ms": t_ops}


def phase_timing(params, params_cpu, step, device, n, reps=7, warmup=2):
    """Eager and fused step in turns on the host clock, and the fused
    kernel's device time from CUDA events."""
    static, forcing, state = to_device(uniform_case(n), device)
    fused = make_fused_step(params, Options(), DT, static, device=device)
    eager_ms, fused_ms = wall_ms_in_turns(
        [lambda s: step(static, forcing, s)[0],
         lambda s: fused(None, forcing, s)[0]], [state, state], reps, warmup)

    # device time of the kernel alone: launches queued back to back
    # behind a blocker, walking three independent copies of the inputs
    # (120 MB together, past the 50 MB L2)
    sets = []
    for _ in range(3):
        s_k, f_k, st_k = to_device(uniform_case(n), device)
        fk = make_fused_step(params, Options(), DT, s_k, device=device)
        sets.append((column.ColumnPlan(fk.gathered, Options(), DT, s_k),
                     f_k, st_k))
    kernel_ms = time_cuda(column_cuda, sets, device=device)
    kernel_ms_isolated = time_cuda_isolated(column_cuda, sets)
    plain_device_ms, plain_kernels = eager_device_ms(step, static, forcing,
                                                     state)
    bound = column_bound(params_cpu, fused.gathered, static, forcing, state, n)

    e_ms, f_ms = statistics.median(eager_ms), statistics.median(fused_ms)
    emit("timing", case="uniform", n=n, reps=reps, in_turns=True,
         eager={"ms_per_step": e_ms, "ms_min": min(eager_ms),
                "ms_max": max(eager_ms),
                "point_steps_per_s": n / (e_ms * 1e-3),
                "device_ms": plain_device_ms,
                "device_kernels": plain_kernels},
         fused={"ms_per_step": f_ms, "ms_min": min(fused_ms),
                "ms_max": max(fused_ms),
                "point_steps_per_s": n / (f_ms * 1e-3),
                "kernel_device_ms": kernel_ms,
                "kernel_ms_isolated": kernel_ms_isolated,
                "host_share_ms": f_ms - kernel_ms},
         bound=bound,
         note="eager: one CUDA kernel per tensor operation; fused: one "
              "launch of the column kernel a step")
    return {"ms": kernel_ms, "ms_isolated": kernel_ms_isolated,
            "plain_ms": plain_device_ms, "plain_wall_ms": e_ms,
            "wall_ms": f_ms, **bound}


def phase_profile(step, device, n, out_dir):
    from torch.profiler import ProfilerActivity, profile
    static, forcing, state = to_device(uniform_case(n), device)
    state, _ = step(static, forcing, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(static, forcing, state)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "step_profile.txt"), "w") as fh:
        fh.write(prof.key_averages().table(
            sort_by="device_time_total", row_limit=40))
    top = sorted(rows, key=lambda e: -e.device_time_total)[:8]
    emit("profile", n=n, wall_ms_under_profiler=wall_ms,
         device_kernel_ms=device_ms, device_kernels=launches,
         top=[{"name": e.key[:60], "count": e.count,
               "ms": e.device_time_total / 1e3} for e in top])


def cpu_rehearsal():
    """Phases that need no card, tiny, on the CPU.  Never ok."""
    device = torch.device("cpu")
    params = load_params("USGS", "STAS", device="cpu")
    step = make_step(params, Options(), DT, device="cpu")
    phase_step(step, device, 64, 2)
    rng = np.random.default_rng(SEED)
    sysm = make_system(rng, 5, 7, device)
    mat, rhs = dense_solve(*sysm)
    emit("rehearsal_dense", err=kernel_err(
        thomas_plain(*sysm), torch.linalg.solve(mat, rhs).squeeze(-1)))
    # the fused phases, with the kernel's plain version in its place
    phase_fused_kernel(params, device, 16)
    phase_fused_step(params, device, 64, 2)
    phase_fused_options(params, device, 8)
    static, forcing, state = to_device(uniform_case(N_OPS), device)
    fused = make_fused_step(params, Options(), DT, static, device="cpu")
    emit("rehearsal_bound", **column_bound(params, fused.gathered, static,
                                           forcing, state, N_OPS))
    print("cpu rehearsal finished; this is not a result", file=sys.stderr)
    return 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if args.cpu_rehearsal:
        return cpu_rehearsal()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    t_start = time.perf_counter()

    card = phase_env()
    build_seconds, attrs = phase_build()
    entries = phase_kernels(device)

    params = load_params("USGS", "STAS")            # on the card
    params_cpu = load_params("USGS", "STAS", device="cpu")
    worst = phase_fused_kernel(params, device, N_POINTS)

    # the eager path and the Thomas kernel it launches
    step = make_step(params, Options(), DT)          # device=None: the card
    launches = phase_step(step, device, N_POINTS, N_STEPS)
    phase_cpu_agreement(params_cpu, step, device)

    # the fused path and the column kernel it launches
    column_launches = phase_fused_step(params, device, N_POINTS, N_STEPS)
    phase_fused_cpu_agreement(params, params_cpu, device)
    phase_fused_options(params, device, N_OPTIONS)
    phase_no_sync(step, params, device, N_POINTS)
    timing = phase_timing(params, params_cpu, step, device, N_POINTS)
    if args.profile:
        phase_profile(step, device, N_POINTS, args.profile)
    if args.sweep:
        phase_sweep(params, step, device)

    for entry in entries:
        entry["launches"] = launches[entry["shape"][1]]
    entries.append({
        "name": "column_cuda", "route": "cuda",
        "source": "noahmp_tpu_torch/csrc/column.cu",
        "replaces": "noahmp_tpu/pallas/column.py:127",
        "shape": [N_POINTS], "launches": column_launches,
        "launches_per_step": column.LAUNCHES_PER_STEP,
        "max_abs_err": worst[0],
        "max_abs_err_at": f"{worst[1]}: {worst[2]}",
        "max_share_of_bar": worst[3],
        "ms": timing["ms"], "ms_isolated": timing["ms_isolated"],
        "step_wall_ms": timing["wall_ms"],
        "plain_ms": timing["plain_ms"],
        "plain_wall_ms": timing["plain_wall_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "bytes_per_point": timing["bytes_per_point"],
        "bytes_ms": timing["bytes_ms"],
        "kernel_bytes_per_point": timing["kernel_bytes_per_point"],
        "operations_per_point": timing["operations_per_point"],
        "operations_ms": timing["operations_ms"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes a land-surface "
                   "model step",
        "registers_per_thread": attrs["registers_per_thread"],
        "local_bytes_per_thread": attrs["local_bytes_per_thread"],
        "build_seconds": round(build_seconds, 3),
        "timing": "ms: CUDA events around 20 launches queued back to back, "
                  "median of 5, three input sets walked in turn (cold in "
                  "L2); plain_ms: summed device time of the eager step's "
                  "kernels (torch.profiler); plain_wall_ms and "
                  "step_wall_ms: host clock, median of 7, in turns; "
                  "max_abs_err is |a-b|/max(1,|a|) against column_plain",
    })
    for entry in entries:
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} was not launched by "
                                 "the main path")
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
