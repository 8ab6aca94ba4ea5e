#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``noahmp_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 chip_smoke.py

It builds the CUDA kernels from ``noahmp_tpu_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card, drives
the port's main path (one batched Noah-MP model step, ``make_step``) at
n = 65,536 land points for a few steps on two cases, checks the outputs
(finite, conservation residuals under the reference model's abort
bounds, agreement with the port's own CPU run), shows from the launch
counters that the steps went through the kernels, and times the step.

Each phase prints one JSON line.  The line before the last two is
``{"kernels": [...]}``; then the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises: the run
ends with a non-zero code and no ``ok`` line.  Without a CUDA device the
script exits with code 2 before any phase.

``--cpu-rehearsal`` runs the phases that need no card at a tiny size on
the CPU, to find wrong paths and shapes; it never prints the ``ok`` line
and always exits non-zero.  ``--profile DIR`` adds one step under
``torch.profiler`` and writes the kernel table to ``DIR/step_profile.txt``;
``--sweep`` times the step at 16k to 1M land points.
"""

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from noahmp_tpu_torch import Options, load_params, make_step
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING, REGIMES,
                                    STATE_BAR, STATE_CEILING, bar_ratio,
                                    hetero_case, scaled_err, to_device,
                                    uniform_case)
from noahmp_tpu_torch.convert import tree_to_numpy
from noahmp_tpu_torch.kernels import _build
from noahmp_tpu_torch.kernels.tridiag import (reset_launches, thomas_cuda,
                                              thomas_plain)
from noahmp_tpu_torch.numerics.tridiag import masked_identity_rows

SEED = 0
N_POINTS = 65536
N_STEPS = 8
DT = 900.0
LAUNCHES_PER_STEP = {7: 1, 4: 6}    # heat solve; six Richards sub-steps

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
    emit("build", seconds=round(seconds, 3), sources=sorted(paths),
         flags=" ".join(_build.NVCC_FLAGS))
    return seconds


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


def time_cuda(fn, arg_sets, reps=20, batches=5, warmup=5):
    """Device milliseconds of one fn(*args): ``reps`` launches between
    two CUDA events, queued behind a blocker so that they run back to
    back; median over ``batches`` such runs.  Walks over ``arg_sets`` so
    that a set is cold in the L2 cache when its turn comes (the sets
    together exceed the cache)."""
    device = arg_sets[0][0].device
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


def phase_no_sync(step, device, n):
    """One step with PyTorch's synchronisation check set to raise: the
    step must not make the host wait for the card anywhere."""
    static, forcing, state = to_device(uniform_case(n), device)
    state, _ = step(static, forcing, state)      # kernels are built by now
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(static, forcing, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit("no_sync", n=n, host_synchronisations=0)


def phase_sweep(step, device, sizes=(16384, 65536, 262144, 1048576)):
    """Step time against the number of land points (opt-in)."""
    rows = []
    for n in sizes:
        static, forcing, state = to_device(uniform_case(n), device)
        times = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(static, forcing, state)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        rows.append({"n": n, "ms_per_step": ms,
                     "point_steps_per_s": n / (ms * 1e-3),
                     "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
        del static, forcing, state
    emit("sweep", case="uniform", rows=rows)


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


def phase_timing(step, device, n, reps=7, warmup=2):
    static, forcing, state = to_device(uniform_case(n), device)
    times = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(static, forcing, state)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    emit("timing", case="uniform", n=n, ms_per_step=ms,
         ms_min=min(times), ms_max=max(times), reps=reps,
         point_steps_per_s=n / (ms * 1e-3),
         note="eager PyTorch, one CUDA kernel per elementwise operation")
    return ms


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
    phase_build()
    entries = phase_kernels(device)

    params = load_params("USGS", "STAS")            # on the card
    params_cpu = load_params("USGS", "STAS", device="cpu")
    step = make_step(params, Options(), DT)          # device=None: the card
    launches = phase_step(step, device, N_POINTS, N_STEPS)
    phase_no_sync(step, device, N_POINTS)
    phase_cpu_agreement(params_cpu, step, device)
    phase_timing(step, device, N_POINTS)
    if args.profile:
        phase_profile(step, device, N_POINTS, args.profile)
    if args.sweep:
        phase_sweep(step, device)

    for entry in entries:
        entry["launches"] = launches[entry["shape"][1]]
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
