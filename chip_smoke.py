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
(``make_fused_step``, the five launches of the column kernels a step,
enqueued by one C call).  It checks the outputs (finite, conservation
residuals under the reference model's abort bounds, agreement with the port's own CPU run, every
option value the fused step accepts), shows from the launch counters
that each path went through its kernels, and times both steps in turns.
Then the further paths, each with its own launch counts: the
carbon pools (``opt_veg`` 2 and 5) through both steps, and the
multi-step entry points (``make_chunk_step`` over both steps, plain and
with strict budgets, and ``simulate``), held bit for bit against the same
number of single steps and checked for host synchronisations.  Last the
offline driver on the generated CONUS case: through the CLI and as a
resume, exact and compact forcing, at 1,048,576 points, the kernels
against their plain version on that domain, and the card against the
CPU, where the points outside the bars are counted and each explained
or not by what the plain step does under a last-bit change.  On the same
case the land-point axis over ``torch.distributed`` ranks: a one-rank
NCCL mesh through ``run_offline(mesh=...)``, and two gloo ranks through
``driver.multihost`` sharing the one card, plain and strict, each held
bit for bit against the run in one process.  Last both steps against
the serial C++ reference column (``noahmp_tpu_torch.native``, built with
``g++`` on the host), each step from the card's State, under the limits
of ``tests/test_golden_native.py``, and that reference's own rate on
this host beside the card's.  Last each cell of ``BENCHMARK.json``
through the function its command (``python3 -m benchmarks_torch.run``)
runs, cut to a size (``bench_cells``): correct, and printing the
metrics the file names.

Each phase prints one JSON line.  The line before the last two is
``{"kernels": [...]}``; then the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises: the run
ends with a non-zero code and no ``ok`` line.  Without a CUDA device the
script exits with code 2 before any phase.

``--cpu-rehearsal`` runs the phases that need no card at a tiny size on
the CPU, to find wrong paths and shapes; it never prints the ``ok`` line
and always exits non-zero.  ``--profile DIR`` adds one step under
``torch.profiler`` and writes the kernel table to ``DIR/step_profile.txt``;
``--sweep`` times both steps, and the column kernels on the card's
clock, at 16k to 1M land points.

The column kernels' operation bound needs ``g++`` and ``gcov`` on the
machine: the operations are counted by running the kernels' headers,
built for the host with coverage, over this run's inputs.  Beside that
bound stands ``issue_ms``: the same operations, each weighted by the
issue slots it costs under the build's flags, which a probe kernel
(``csrc/issue_probe.cu``) measures in the same run.
"""

import argparse
import contextlib
import copy
import ctypes
import datetime
import filecmp
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from noahmp_tpu_torch import (STRICT_SENTINEL, Options, load_params,
                              make_chunk_step, make_fused_step, make_simulate,
                              make_step, native, simulate, utils)
from noahmp_tpu_torch.cases import (CARBON_BAR, CARBON_POOLS, FLUX_BAR,
                                    FLUX_CEILING, FUZZ_CAP, FUZZ_COMBOS,
                                    FUZZ_OUTLIER_FRAC, FUZZ_TIGHT, REGIMES,
                                    STATE_BAR, STATE_CEILING, bar_ratio,
                                    carbon_ratios, forcing_sequence,
                                    fuzz_case, fuzz_forcing,
                                    hetero_case, point_ratios, run_ratio,
                                    scaled_err, to_device, uniform_case)
from noahmp_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from noahmp_tpu_torch.driver import cli as driver_cli
from noahmp_tpu_torch.driver import io as driver_io
from noahmp_tpu_torch.driver import run as driver_run
from noahmp_tpu_torch.driver.config import _ANCHOR as ANCHOR, Config
from noahmp_tpu_torch.driver.step import STRICT_TOL
from noahmp_tpu_torch.kernels import _build, column
from noahmp_tpu_torch.kernels.column import column_cuda, column_plain
from noahmp_tpu_torch.kernels.tridiag import (reset_launches, thomas_cuda,
                                              thomas_plain)
from noahmp_tpu_torch.kernels._build import load_library
from noahmp_tpu_torch.numerics.tridiag import masked_identity_rows
from noahmp_tpu_torch.options import fused_option_sets
from noahmp_tpu_torch.params.gathered import gather_params
from noahmp_tpu_torch.physics import flux as flux_physics
from noahmp_tpu_torch.state import Flux, Forcing, State, Static, init_state

from benchmarks_torch import run as bench_run
from benchmarks_torch.measure import (HostSplit, loop_ms_per_step,
                                      nvidia_smi_line, offline_cfg,
                                      run_summarised, write_case)
from benchmarks_torch.oracle import (CROSSINGS_ALPHA, against_oracle,
                                     check_oracle)
from benchmarks_torch.work import (PEAK_BYTES_PER_S, PEAK_F32_FLOPS,
                                   count_operations, step_bytes)
from benchmarks_torch.work import bound as step_bound
from benchmarks_torch.spinup import device_forcing
from benchmarks_torch.spinup import domain as spinup_domain
from scripts.canopy_trips import step_trips
from scripts.canopy_trips import summary as trips_summary

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_POINTS = 65536
N_STEPS = 8
DT = 900.0
LAUNCHES_PER_STEP = {7: 1, 4: 6}    # heat solve; six Richards sub-steps
N_OPTIONS = 4096                    # points a fused_options comparison
N_OPS = 8                           # points the operation count walks
N_LARGE = 1048576                   # where a launch's fixed cost vanishes
T_CHUNK = 48                        # steps of a chunk over the fused step
T_CHUNK_EAGER = 4                   # ... and over the eager step
T_SIMULATE = 8
T_STRICT, BAD_AT = 16, 5            # strict phase: steps, the corrupt record
# canopy_split: the spin-up cell's span (its traced run starts there),
# then the hours of the next day at which both builds of the column
# kernels are held bit for bit against each other and timed
SPLIT_SPAN = 5760
SPLIT_HOURS = (0, 6, 12, 18)
ONE_PASS_DEFINE = "-DNM_CANOPY_ONE_PASS"    # csrc/flux.cuh
CORRUPT_SOLDN = 1.0e7               # W/m2: breaks the budgets by rounding
CARBON_OPTIONS = (Options(veg=2, crs=1), Options(veg=5))
CARBON_CASES = ("uniform", "hetero/warm_day", "hetero/cold_snow")
NONVEG_CLASSES = (1, 16, 19, 24)    # urban, water, barren, ice (USGS)
# What the JAX package's offline driver accumulates in a chunk
# (noahmp_tpu/driver/run.py:218): the output writer's default fields
# (noahmp_tpu/driver/io.py:600) as window sums, and the three budget
# residuals as absmax.  18 + 3 accumulators, 24 small launches a step.
WRITER_FIELDS = ("fsa", "fsr", "fira", "fsh", "fcev", "fgev", "fctr", "ssoil",
                 "trad", "ecan", "etran", "edir", "runsrf", "runsub", "fsno",
                 "albedo", "gpp", "nee")
RESIDUALS = ("errsw", "erreng", "errwat")
CHUNK_ACC = (tuple((f, "sum") for f in WRITER_FIELDS)
             + tuple((f, "absmax") for f in RESIDUALS))
ACC_AT = {field: k for k, (field, _op) in enumerate(CHUNK_ACC)}

# The offline driver (noahmp_tpu_torch/driver): the generated CONUS case
# (cases.conus_case: hourly NetCDF forcing, 15-minute steps, 3-hourly
# output, daily restarts) at the size of a regional run on one card
N_OFFLINE = 131072
OFFLINE_DAYS = 2
OFFLINE_BUDGETS_EVERY = 12          # advisory budget check, steps
OFFLINE_FORCING_HOURS = 12          # offline_forcing: exact and compact
OFFLINE_LARGE_HOURS = 6             # offline_large at N_LARGE points
N_OFFLINE_CPU = 4096                # offline_cpu_agreement
OFFLINE_CPU_HOURS = 6
DIST_HOURS = 12                     # dist_*: model hours, exact forcing
DIST_WORLD = 2                      # dist_two_ranks: processes on the card
DIST_PROCESS_TIMEOUT = 300          # seconds, a rank of dist_two_ranks
DIST_GROUP_TIMEOUT = 120            # seconds a collective waits for a peer
DIST_CORRUPT_HOUR = 1               # forcing file corrupt on rank 1's rows
# native_oracle: the steps against the serial C++ reference column
# (noahmp_tpu_torch.native, on the host), each step from the same State
NATIVE_COPIES = 4096                # each of the ten fuzz columns, repeated
NATIVE_FUZZ_STEPS = 24              # a FUZZ_COMBOS set through the fused step
NATIVE_EAGER_STEPS = 6              # ... through the eager step, for
NATIVE_EAGER_COMBOS = ("default", "dynveg2")    # these sets
NATIVE_CONUS_STEPS = 12             # CONUS: from the init State, a day later
NATIVE_BENCH_STEPS = 5              # bench_native's timed steps
FUZZ_SEED = 42                      # the weather's draws
# The point-steps beyond FUZZ_CAP or with nsnow changed (crossings) that
# the JAX package's own step makes against the oracle on the same fuzz
# (the ten columns JAX_FUZZ_COPIES times, FUZZ_SEED's weather), by set and
# step, each step from the JAX step's own State: JAX_FUZZ_SOURCE, on the
# CPU.  test_golden_native.py's cap allows none over its 750 column-steps
# a set; over 40,960 columns the reference crosses it too, at knife-edge
# points.  Two runs of one model part after a step or two, so their counts
# differ by counting noise: given the two counts' sum, equal rates put
# each crossing on either side with probability 1/2, and a set of the
# card's fails when its count is above what that allows at
# CROSSINGS_ALPHA, one-sided.  Where there is no such count (the CONUS
# case, another size) no crossing passes.
JAX_FUZZ_SOURCE = "scripts/oracle_fuzz_at_scale.py"
JAX_FUZZ_COPIES = 4096
JAX_FUZZ_CROSSINGS = {
    "default": (0, 0, 0, 1, 0, 0, 2, 0, 0, 2, 0, 1,
                0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0),
    "frz2_tbot1": (0, 0, 0, 1, 0, 0, 2, 0, 0, 2, 0, 1,
                   0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0),
    "jarvis_run3_inf2": (0, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 2,
                         0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    "dynveg2": (0, 2, 0, 1, 0, 0, 0, 1, 0, 1, 0, 0,
                0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 2),
    "snf2_stc2": (0, 0, 0, 0, 0, 0, 2, 0, 1, 0, 0, 0,
                  0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 1),
    "btr3_run4_alb1_sfc2": (56, 17, 8, 10, 6, 6, 2, 3, 2, 4, 5, 2,
                            5, 5, 4, 2, 3, 4, 2, 6, 3, 6, 5, 2),
    "rad2_run2": (0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 1,
                  0, 1, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0),
    "rad3_frz2_snf3": (0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 1,
                       0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 0, 0),
}
# bench_cells: each cell of BENCHMARK.json through the function its
# command runs (benchmarks_torch.run.run_workload), cut to a size
BENCH_CUTS = {
    "conus131k-offline-2day": {"points": 8192, "hours": 3, "repeats": 2},
    "conus1m-spinup-60day": {"points": 65536, "days": 1, "restart_days": 1,
                             "trace_steps": 24},
}
RESYNC_STEPS = 3    # offline_kernel_agreement: from the init State and
                    # from the last restart of offline_case, each
# Two implementations of the step that differ in the last bit part
# beyond the step's bars, from the same State, at a few points of the
# generated CONUS case: the canopy loop of physics/flux.py:vege_flux
# reads the under-canopy stability from tg - tah (two numbers near 280 K
# whose difference is near 0), which amplifies a last-bit difference some
# 10^3 times, and its exit test (|dTV| <= DTV_EXIT from the fifth trip)
# then leaves the loop at another trip; a snow surface at the freezing
# point takes the cap at TFRZ or not.  column_plain itself, given State.tv
# moved by one ulp, puts 61 of 4,096 points beyond the bars, up to 344
# times them (--cpu-conditioning prints these figures and those below
# that come from the CPU).  A point outside the bars is explained when
# column_plain comes within the bars of the kernel there with the exit
# threshold moved by one of EXIT_VARIANTS, or with State.tv, State.tg
# and every Forcing leaf moved by one ulp (ONE_ULP_DRAWS draws): what
# the model gives at that point under a change it cannot tell from
# rounding.  A fault is not reproduced so
EXIT_VARIANTS = (-0.2, -0.1, -0.05, -0.02, 0.02, 0.05, 0.1, 0.2)
ONE_ULP_DRAWS = 8
# What may stay unexplained in a step taken from the same State: on the
# CPU the host build of the kernels against column_plain, 12 steps at
# 4,096 points, left 21 of 154 outside points unexplained by the exit
# alone (at most 5 in a step, the worst 13.3 times the bars, Flux.shg
# 1.25 against 1.33 W/m2), 2 with the one-ulp draws too (the worst 2.2
# times the bars, Flux.shg); a fault in a branch puts the points that
# take it outside, unexplained, and a land-use class with them
UNEXPLAINED_SHARE = 0.0025          # of the points, in any step
UNEXPLAINED_RATIO = 16.0            # times the step's bars, at any point
UNEXPLAINED_CLASS_SHARE = 0.02      # of a land-use class of >= 100 points
# Card against CPU crosses math libraries, whose last-bit differences
# enter at every operation of the canopy loop, and a one-ulp change of
# the inputs does not reproduce all they do: column_plain on the card
# parts from column_plain on the CPU as far as the CPU's float32 step
# parts from the same step in float64 (55-105 and 78-119 of 4,096 points
# a step outside the bars), and column_cuda gives column_plain's values
# on the card.  So there a point is also explained when the float64 step
# or column_plain on the card comes within the bars of the kernel
# A free run of 24 steps, card against CPU, every ldasout field and the
# final State against cases.run_ratio: the CPU run against itself with
# the initial tg moved by one ulp has up to 3 of 4,096 points outside,
# the worst 6.1 times (sneqv), in three draws; the phase measures that
# spread again (SELF_SPREAD_DRAWS)
FREE_RUN_OUTLIERS = 0.005           # of the points
FREE_RUN_RATIO = 10.0               # times cases.run_ratio, at any point
SELF_SPREAD_DRAWS = 2

# NVIDIA H100 SXM: 132 SMs of 4 schedulers that issue one instruction for
# 32 lanes a clock
LANES_PER_CLOCK = 132 * 4 * 32

THOMAS_THREADS = 128      # threads a block of csrc/tridiag.cu
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


def one_pass_library_path():
    """Where the column kernels built with their canopy loop in one pass
    go: beside the package's build, in its ignored directory."""
    path = _build.library_path("column")
    return os.path.join(os.path.dirname(path), os.path.basename(path)
                        .replace("libcolumn-", "libcolumn_one_pass-"))


def build_one_pass():
    """Start nvcc on csrc/column.cu with ONE_PASS_DEFINE; returns a
    function that waits for it and returns the library's path."""
    out = one_pass_library_path()
    if os.path.exists(out):
        return lambda: out
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = _build.build_command("column", tmp)
    proc = subprocess.Popen(cmd[:1] + [ONE_PASS_DEFINE] + cmd[1:],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def wait():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on column.cu with "
                               f"{ONE_PASS_DEFINE}:\n{err}")
        os.replace(tmp, out)
        return out

    return wait


def phase_build():
    """Every kernel's source, and the column kernels a second time with
    their canopy loop in one pass, one nvcc each, all started together."""
    t0 = time.perf_counter()
    one_pass = build_one_pass()
    paths = _build.build_all()
    paths["column_one_pass"] = one_pass()
    seconds = time.perf_counter() - t0
    attrs = column.kernel_attributes()
    emit("build", seconds=round(seconds, 3), sources=sorted(paths),
         flags=" ".join(_build.NVCC_FLAGS),
         extra_flags={k: " ".join(v) for k, v in _build.EXTRA_FLAGS.items()},
         column_kernels=attrs)
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


PROBE_OPS = ("identity", "add", "mul", "div", "sqrtf", "rsqrtf", "expf",
             "logf", "log10f", "powf", "tanhf", "atanf", "fmodf", "floorf",
             "fabsf", "mx")     # the order of csrc/issue_probe.cu:Op


def _probe_library():
    lib = load_library("issue_probe")
    if lib.noahmp_probe_op.argtypes is None:
        lib.noahmp_probe_op.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.noahmp_probe_op.restype = ctypes.c_int
        lib.noahmp_probe_empty.argtypes = [ctypes.c_uint, ctypes.c_uint,
                                           ctypes.c_void_p]
        lib.noahmp_probe_empty.restype = ctypes.c_int
    return lib


def empty_kernel_ms(blocks, threads, device):
    """Device time of a kernel that does nothing on this grid: the floor
    under any launch of that shape, queued back to back."""
    fn = _probe_library().noahmp_probe_empty

    def launch():
        err = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel: CUDA error {err}")

    return time_cuda(launch, [()], device=device)


def sm_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    now, most = (float(x) for x in out.split(","))
    return now, most


def phase_issue_weights(device):
    """What one operation of each kind costs the schedulers, in float32
    adds, under the column kernels' build flags: the probe's time with
    the operation in its loop, less the loop alone, over the same for an
    add.  Also the SM clock while the card is busy."""
    fn = _probe_library().noahmp_probe_op
    threads = 132 * 2048 * 2        # two waves of every thread an SM holds
    trips, step = 8192, 1.0e-4
    rng = np.random.default_rng(SEED)
    inp = torch.from_numpy(
        rng.uniform(0.5, 1.5, 2 * threads).astype(np.float32)).to(device)
    out = torch.empty(threads, dtype=torch.float32, device=device)

    def launch(op):
        err = fn(op, inp.data_ptr(), out.data_ptr(), threads, trips, step,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"issue probe: CUDA error {err}")

    ms = {name: time_cuda(launch, [(op,)], reps=3, batches=3, warmup=1,
                          device=device)
          for op, name in enumerate(PROBE_OPS)}
    if not torch.isfinite(out).all():
        raise AssertionError("the issue probe left its value range")
    # the clock under load: queue about a second of probe work, ask
    # nvidia-smi while it runs
    for _ in range(max(1, int(1000.0 / ms["powf"]))):
        launch(PROBE_OPS.index("powf"))
    clock_mhz, clock_max_mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    unit = ms["add"] - ms["identity"]
    weights = {name: (ms[name] - ms["identity"]) / unit
               for name in PROBE_OPS[1:]}
    adds_per_s = threads * trips / (unit * 1e-3)
    emit("issue_weights", probe_ms=ms, weights=weights, threads=threads,
         trips=trips, sm_clock_mhz=clock_mhz, sm_clock_max_mhz=clock_max_mhz,
         add_rate_share_of_issue_peak=adds_per_s
         / (LANES_PER_CLOCK * clock_mhz * 1e6),
         note="weight = (probe ms with the operation - probe ms of the "
              "loop alone) / the same for one float32 add; built with the "
              "column kernels' flags")
    return weights, clock_mhz


def issue_ms(by_kind_per_point, weights, clock_mhz, n):
    """The least time the schedulers could issue these operations in:
    each kind's count times its weight in adds, over every lane of the
    card at the clock it ran at."""
    slots = sum(count * weights[kind]
                for kind, count in by_kind_per_point.items())
    return slots * n / (LANES_PER_CLOCK * clock_mhz * 1e6) * 1e3


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
        del mat, rhs
        # the floor of a launch of this grid, and both at a size where
        # that floor no longer counts (two sets, 294 or 168 MB)
        empty_ms = empty_kernel_ms(math.ceil(n / THOMAS_THREADS),
                                   THOMAS_THREADS, device)
        large = [make_system(rng, N_LARGE, rows, device) for _ in range(2)]
        large_err = kernel_err(thomas_cuda(*large[0]),
                               thomas_plain(*large[0]))
        if not large_err <= KERNEL_TOL:
            raise AssertionError(f"thomas_cuda disagrees with thomas_plain "
                                 f"at n = {N_LARGE}, L = {rows}: {large_err}")
        ms_large = time_cuda(thomas_cuda, large)
        del large
        # forward sweep 3 div + 2 mul + 2 add a row, back sweep 1 mul +
        # 1 add: 9 float32 operations a row
        flops = 9 * n * rows
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        err = max([c["max_err"] for c in checks if c["L"] == rows]
                  + [large_err])
        entries.append({
            "name": f"thomas_cuda[L={rows}]", "route": "cuda",
            "source": "noahmp_tpu_torch/csrc/tridiag.cu",
            "replaces": "noahmp_tpu/pallas/tridiag.py:47",
            "shape": [n, rows], "launches": None,
            "max_abs_err": err, "ms": ms, "ms_isolated": ms_isolated,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "empty_kernel_ms": empty_ms,
            "ms_1m": ms_large,
            "bound_ms_1m": max(t_bytes, t_ops) * N_LARGE / n,
            "library_ms": library_ms,
            "library": "torch.linalg.solve on dense (n, L, L); no single "
                       "PyTorch call solves batched tridiagonal systems",
            "library_vs_kernel_err": lib_err,
            "timing": f"CUDA events around 20 launches queued back to "
                      f"back, median of 5; inputs cold in L2 ({nsets} sets "
                      f"walked in turn, 2 at n = {N_LARGE}); ms_isolated is "
                      f"one launch on an idle card, the host's launch time "
                      f"included; empty_kernel_ms is a kernel that does "
                      f"nothing on the same grid, timed the same way",
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
    and through the kernels' plain version.  On the card the entry
    point runs the kernels, one step of them."""
    static, forcing, state = to_device(case, device)
    step = make_fused_step(params, opts, DT, static, device=device)
    dt = torch.tensor(DT, dtype=torch.float32, device=device)
    before = column_cuda.launches
    got = step(None, forcing, state)
    if device.type == "cuda":
        torch.cuda.synchronize()
        if column_cuda.launches - before != 1:
            raise AssertionError("the fused step did not launch the kernels")
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
        if launches != total_steps:
            raise AssertionError(f"column_cuda counted {launches} steps, "
                                 f"expected {total_steps}")
        if thomas_cuda.launches != 0:
            raise AssertionError("the fused path launched the stand-alone "
                                 f"Thomas kernel {thomas_cuda.launches} times")
    emit("fused_step", n=n, dt=DT, cases=report, total_steps=total_steps,
         column_launches=launches,
         kernel_launches_per_step=column.device_launches(n),
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


@contextlib.contextmanager
def chen97_fixed_carry():
    """``physics/flux.py:CHEN97_FIXED_CARRY`` on inside, restored after:
    a plan built inside carries it into the kernels, and the plain
    version reads it when it runs."""
    before = flux_physics.CHEN97_FIXED_CARRY
    flux_physics.CHEN97_FIXED_CARRY = True
    try:
        yield
    finally:
        flux_physics.CHEN97_FIXED_CARRY = before


def phase_fused_options(params, device, n):
    """Every option value the fused step accepts, one at a time beside
    the defaults, on a snow case and a stress case; and ``opt_sfc = 2``
    with the Chen97 carry switch on."""
    report = []
    sets = [(opts, False) for opts in fused_option_sets()]
    sets.append((Options(sfc=2), True))
    for opts, fixed_carry in sets:
        changed = {k: v for k, v in opts._asdict().items()
                   if v != getattr(Options(), k)}
        if fixed_carry:
            changed["CHEN97_FIXED_CARRY"] = True
        for regime in ("cold_snow", "hot_dry"):
            with (chen97_fixed_carry() if fixed_carry
                  else contextlib.nullcontext()):
                ref, got = fused_against_plain(params, opts,
                                               hetero_case(regime, n), device)
            err, leaf, ratio, _eq, _n = compare_step(
                f"{changed} hetero/{regime}", ref, got)
            if fixed_carry:
                default, _ = fused_against_plain(params, opts,
                                                 hetero_case(regime, n),
                                                 device)
                if torch.equal(default[0].ch, got[0].ch):
                    raise AssertionError("Chen97 carry on: the kernels' ch "
                                         "is the default's")
            report.append({"options": changed, "regime": regime,
                           "max_err": err, "leaf": leaf,
                           "share_of_bar": ratio})
    chen97 = max(r["share_of_bar"] for r in report
                 if "CHEN97_FIXED_CARRY" in r["options"])
    emit("fused_options", n=n, checked=len(report),
         worst=max(report, key=lambda r: r["share_of_bar"]),
         chen97_fixed_carry_share_of_bar=chen97, cases=report)
    return chen97


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


def named_case(name, n):
    if name == "uniform":
        return uniform_case(n)
    return hetero_case(name.split("/", 1)[1], n)


def check_carbon_outputs(label, static_np, state):
    """Pools non-negative; LAI and SAI at or above their floors where
    something grows and, like the pools, zero where nothing does."""
    s = tree_to_numpy(state)
    gated = np.isin(static_np["lutyp"], NONVEG_CLASSES)
    for name in CARBON_POOLS:
        if not (s[name] >= 0.0).all():
            raise AssertionError(f"{label}: State.{name} went negative")
    for name in CARBON_POOLS + ("lai", "sai"):
        if not (s[name][gated] == 0.0).all():
            raise AssertionError(f"{label}: State.{name} not zero on a "
                                 "class without vegetation")
    if not ((s["lai"][~gated] >= 0.05).all()
            and (s["sai"][~gated] >= 0.01).all()):
        raise AssertionError(f"{label}: LAI or SAI under its floor")


def compare_carbon(label, old_state, ref, got):
    """gpp, npp, nee and the six pools' change over the step on their
    own scale (cases.carbon_ratios): the step's bars are blind to
    them."""
    ratios = carbon_ratios(tree_to_numpy(old_state),
                           tuple(tree_to_numpy(t) for t in ref),
                           tuple(tree_to_numpy(t) for t in got))
    leaf = max(ratios, key=ratios.get)
    if not ratios[leaf] <= 1.0:
        raise AssertionError(
            f"{label}: {leaf} is {ratios[leaf]:.3g} times what the carbon "
            f"bar ({CARBON_BAR} of the leaf's largest magnitude) allows")
    return ratios[leaf], leaf


def phase_carbon(params, params_cpu, device, n, steps, n_cpu=4096):
    """opt_veg 2 and 5.  The kernels against column_plain from the same
    state, and the card against the CPU, with the carbon leaves on
    their own scale; then ``steps`` steps of each case through make_step
    and make_fused_step, launch counts zeroed just before and read just
    after."""
    cpu = torch.device("cpu")
    checks = []
    for opts in CARBON_OPTIONS:
        for name in CARBON_CASES:
            label = f"veg={opts.veg} {name}"
            case = named_case(name, n)
            ref, got = fused_against_plain(params, opts, case, device)
            err, leaf, ratio, _eq, _n = compare_step(label, ref, got)
            old = to_device(case, device)[2]
            c_ratio, c_leaf = compare_carbon(label, old, ref, got)
            # the card's kernels against the CPU's plain version
            small = named_case(name, n_cpu)
            _ref, got_small = fused_against_plain(params, opts, small, device)
            static, forcing, state = to_device(small, cpu)
            ref_cpu = make_fused_step(params_cpu, opts, DT, static,
                                      device="cpu")(None, forcing, state)
            compare_step(f"{label} card vs CPU", ref_cpu, got_small)
            cpu_ratio, cpu_leaf = compare_carbon(f"{label} card vs CPU",
                                                 state, ref_cpu, got_small)
            checks.append({"veg": opts.veg, "case": name, "max_err": err,
                           "leaf": leaf, "share_of_bar": ratio,
                           "carbon_share_of_bar": c_ratio,
                           "carbon_leaf": c_leaf,
                           "card_vs_cpu_carbon_share_of_bar": cpu_ratio,
                           "card_vs_cpu_carbon_leaf": cpu_leaf})
    # the path itself
    column.reset_launches()
    reset_launches()
    runs = []
    for opts in CARBON_OPTIONS:
        eager = make_step(params, opts, DT, device=device)
        for name in CARBON_CASES:
            case = named_case(name, n)
            static, forcing, state = to_device(case, device)
            fused = make_fused_step(params, opts, DT, static, device=device)
            for path, step in (("make_step", eager),
                               ("make_fused_step", fused)):
                s, flux = state, None
                for _ in range(steps):
                    s, flux = step(static, forcing, s)
                label = f"veg={opts.veg} {name} {path}"
                res = check_outputs(label, case[0], s, flux)
                check_carbon_outputs(label, case[0], s)
                f = tree_to_numpy(flux)
                runs.append({"veg": opts.veg, "case": name, "path": path,
                             "steps": steps, "max_abs_gpp": float(
                                 np.abs(f["gpp"]).max()),
                             "max_abs_nee": float(np.abs(f["nee"]).max()),
                             **{f"max_abs_{k}": v for k, v in res.items()}})
    total = steps * len(CARBON_OPTIONS) * len(CARBON_CASES)
    launches = {"column": column_cuda.launches,
                "thomas": dict(thomas_cuda.launches_by_rows)}
    if device.type == "cuda":
        want = {r: k * total for r, k in LAUNCHES_PER_STEP.items()}
        if launches != {"column": total, "thomas": want}:
            raise AssertionError(f"carbon path: launches {launches}, expected "
                                 f"{total} fused steps and {want}")
    emit("carbon", n=n, n_card_vs_cpu=n_cpu, carbon_bar=CARBON_BAR,
         note="carbon_share_of_bar: worst of gpp, npp, nee and the six "
              "pools' change over the step, |kernel - plain| over "
              "(carbon_bar x the leaf's largest magnitude in the case, plus "
              "one float32 spacing of the pool for a pool's change)",
         checks=checks, runs=runs, launches=launches)
    return launches


def stacked_forcings(case, steps, device, corrupt_at=None):
    """The case's forcing as ``steps`` steps stacked (T, n) on the
    device; with ``corrupt_at`` that step's shortwave is a corrupt
    record."""
    seq = forcing_sequence(case[1], steps)
    if corrupt_at is not None:
        seq["soldn"][corrupt_at] = CORRUPT_SOLDN
    return tree_from_numpy(Forcing, seq, device)


def zero_acc(spec, n, device):
    return tuple(torch.zeros(n, dtype=torch.float32, device=device)
                 for _ in spec)


def steps_by_hand(single, static, forcings, state, spec, n, device,
                  stop_at_violation=False):
    """What a chunk does, written out: single steps over the rows of the
    stacked Forcing with the accumulators kept by hand.  Returns (state,
    acc, fluxes, first violating step or None); with
    ``stop_at_violation`` the loop ends after the first step that breaks
    a budget (this reads the card back every step: it is the check, not
    the path)."""
    acc = zero_acc(spec, n, device)
    fluxes, bad = [], None
    for t in range(forcings[0].shape[0]):
        forcing = Forcing(*[leaf[t] for leaf in forcings])
        state, flux = single(static, forcing, state)
        fluxes.append(flux)
        for a, (field, op) in zip(acc, spec):
            leaf = getattr(flux, field)
            a.copy_(a + leaf if op == "sum" else torch.maximum(a, leaf.abs()))
        violated = bool(((flux.errsw.abs() > STRICT_TOL)
                         | (flux.erreng.abs() > STRICT_TOL)).any())
        if violated and bad is None:
            bad = t
            if stop_at_violation:
                break
    return state, acc, fluxes, bad


def assert_bit_equal(label, want, got):
    for k, (a, b) in enumerate(zip(want, got)):
        same = torch.equal(a, b) or bool(
            ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        if not same:
            raise AssertionError(f"{label}: tensor {k} differs from the "
                                 "single steps done by hand")


def phase_chunk(params, device, n, t_fused, t_eager, t_simulate):
    """make_chunk_step over the fused step and over the eager step,
    make_simulate over the fused step and simulate (the eager step, as
    many steps as the eager chunk) with collected fluxes: each the very
    bits of the same number of single steps.  The entry points run first, launch counts
    zeroed just before and read just after; the single steps they are
    held against come afterwards."""
    case = hetero_case("warm_day", n)
    static, _forcing_one, state0 = to_device(case, device)
    fused = make_fused_step(params, Options(), DT, static, device=device)
    eager = make_step(params, Options(), DT, device=device)
    f_fused = stacked_forcings(case, t_fused, device)
    f_eager = Forcing(*[leaf[:t_eager].contiguous() for leaf in f_fused])
    f_sim = Forcing(*[leaf[:t_simulate].contiguous() for leaf in f_fused])
    chunk_fused = make_chunk_step(params, Options(), DT, CHUNK_ACC,
                                  static=static, device=device)
    chunk_eager = make_chunk_step(params, Options(), DT, CHUNK_ACC,
                                  device=device)

    column.reset_launches()
    reset_launches()
    got_fused = chunk_fused(None, f_fused, state0,
                            zero_acc(CHUNK_ACC, n, device))
    got_eager = chunk_eager(static, f_eager, state0,
                            zero_acc(CHUNK_ACC, n, device))
    got_sim = make_simulate(params, Options(), DT, collect_fluxes=True,
                            static=static, device=device)(None, f_sim, state0)
    got_sim_eager = simulate(params, Options(), DT, static, f_eager, state0,
                             collect_fluxes=True, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {"column": column_cuda.launches,
                "thomas": dict(thomas_cuda.launches_by_rows)}
    if device.type == "cuda":
        want = {"column": t_fused + t_simulate,
                "thomas": {r: k * 2 * t_eager
                           for r, k in LAUNCHES_PER_STEP.items()}}
        if launches != want:
            raise AssertionError(f"chunk path: launches {launches}, "
                                 f"expected {want}")

    s, acc, _fl, _bad = steps_by_hand(fused, static, f_fused, state0,
                                      CHUNK_ACC, n, device)
    assert_bit_equal("chunk over the fused step", tuple(s) + acc,
                     tuple(got_fused[0]) + got_fused[1])
    res = check_outputs("chunk over the fused step", case[0], s, _fl[-1])
    s, acc, fluxes, _bad = steps_by_hand(eager, static, f_eager, state0,
                                         CHUNK_ACC, n, device)
    assert_bit_equal("chunk over the eager step", tuple(s) + acc,
                     tuple(got_eager[0]) + got_eager[1])
    stacked = Flux(*[torch.stack(leaves) for leaves in zip(*fluxes)])
    assert_bit_equal("simulate", tuple(s) + tuple(stacked),
                     tuple(got_sim_eager[0]) + tuple(got_sim_eager[1]))
    s, _acc, fluxes, _bad = steps_by_hand(fused, static, f_sim, state0, (),
                                          n, device)
    stacked = Flux(*[torch.stack(leaves) for leaves in zip(*fluxes)])
    assert_bit_equal("make_simulate over the fused step",
                     tuple(s) + tuple(stacked),
                     tuple(got_sim[0]) + tuple(got_sim[1]))
    if tuple(got_sim[1].fsh.shape) != (t_simulate, n) or tuple(
            got_sim[1].fsa.shape) != (t_simulate, n):
        raise AssertionError("simulate: fluxes are not stacked (T, n)")
    # the accumulated residuals stay under the reference's abort bound
    land = torch.from_numpy(case[0]["ist"] == 1).to(device)
    worst = {field: float(got_fused[1][ACC_AT[field]][land].max())
             for field in RESIDUALS}
    for field, v in worst.items():
        if not v < RESIDUAL_BOUND:
            raise AssertionError(f"chunk: max|{field}| over {t_fused} steps "
                                 f"= {v}, bound {RESIDUAL_BOUND}")
    emit("chunk", n=n, case="hetero/warm_day", acc_spec=CHUNK_ACC,
         fused_steps=t_fused, eager_steps=t_eager,
         make_simulate_fused_steps=t_simulate, simulate_eager_steps=t_eager,
         bit_equal_to_single_steps=True, launches=launches,
         max_abs_residual_over_chunk=worst,
         mean_fsh=float(got_fused[1][ACC_AT["fsh"]].mean()) / t_fused,
         **{f"last_step_max_abs_{k}": v for k, v in res.items()})
    return launches


def phase_strict(params, device, n, steps, bad_at, t_eager):
    """Strict budgets.  A clean sequence gives STRICT_SENTINEL and the
    plain chunk's bits; a sequence whose step ``bad_at`` carries a
    corrupt shortwave record (1e7 W/m2 breaks the energy budget by
    rounding alone, far above the bound) gives bad_step = bad_at, the
    state after that step and accumulators that stop there: the bits of
    bad_at + 1 single steps.  Over the fused step at ``steps`` steps and
    over the eager step at ``t_eager``."""
    case = hetero_case("warm_day", n)
    static, _f, state0 = to_device(case, device)
    report = []
    for path, t_len, k in (("fused", steps, bad_at), ("eager", t_eager, 1)):
        build = dict(static=static) if path == "fused" else {}
        single = (make_fused_step(params, Options(), DT, static,
                                  device=device) if path == "fused"
                  else make_step(params, Options(), DT, device=device))
        strict = make_chunk_step(params, Options(), DT, CHUNK_ACC,
                                 strict_budgets=True, device=device, **build)
        plain = make_chunk_step(params, Options(), DT, CHUNK_ACC,
                                device=device, **build)
        clean = stacked_forcings(case, t_len, device)
        corrupt = stacked_forcings(case, t_len, device, corrupt_at=k)

        s, acc, bad = strict(static, clean, state0,
                             zero_acc(CHUNK_ACC, n, device))
        p_s, p_acc = plain(static, clean, state0,
                           zero_acc(CHUNK_ACC, n, device))
        if (bad.dtype != torch.int32 or bad.dim() != 0
                or bad.device != s.tg.device):
            raise AssertionError("bad_step is no 0-d int32 tensor on the "
                                 "step's device")
        if int(bad) != STRICT_SENTINEL:
            raise AssertionError(f"strict, {path}: a clean sequence stopped "
                                 f"at step {int(bad)}")
        assert_bit_equal(f"strict, {path}, clean", tuple(p_s) + p_acc,
                         tuple(s) + acc)

        s, acc, bad = strict(static, corrupt, state0,
                             zero_acc(CHUNK_ACC, n, device))
        h_s, h_acc, _fl, h_bad = steps_by_hand(
            single, static, corrupt, state0, CHUNK_ACC, n, device,
            stop_at_violation=True)
        if int(bad) != k or h_bad != k:
            raise AssertionError(
                f"strict, {path}: bad_step {int(bad)}, single steps by hand "
                f"first break a budget at {h_bad}, the corrupt record is "
                f"step {k}")
        assert_bit_equal(f"strict, {path}, stopped at {k}",
                         tuple(h_s) + h_acc, tuple(s) + acc)
        for name, leaf in tree_to_numpy(s).items():
            if not np.isfinite(leaf).all():
                raise AssertionError(f"strict, {path}: State.{name} not "
                                     "finite after the corrupt step")
        report.append({"path": path, "steps": t_len, "corrupt_step": k,
                       "bad_step": int(bad), "clean_bad_step": STRICT_SENTINEL,
                       "max_abs_errsw_at_stop": float(
                           acc[ACC_AT["errsw"]].max()),
                       "max_abs_erreng_at_stop": float(
                           acc[ACC_AT["erreng"]].max())})
    emit("strict", n=n, case="hetero/warm_day", tolerance=STRICT_TOL,
         corrupt_soldn=CORRUPT_SOLDN, sentinel=STRICT_SENTINEL, cases=report)


def phase_chunk_no_sync(params, device, n, steps=4):
    """A chunk in either mode over either step, and simulate, with
    PyTorch's synchronisation check set to raise: nothing between the
    first step and the last may make the host wait for the card."""
    case = hetero_case("warm_day", n)
    static, _f, state = to_device(case, device)
    forcings = stacked_forcings(case, steps, device)
    chunks = {}
    for path, build in (("fused", dict(static=static)), ("eager", {})):
        for strict in (False, True):
            chunks[(path, strict)] = make_chunk_step(
                params, Options(), DT, CHUNK_ACC, strict_budgets=strict,
                device=device, **build)
    accs = {key: zero_acc(CHUNK_ACC, n, device) for key in chunks}
    # building a step reads the tables back (the by-value constants), so
    # everything is built, and run once, before the check is armed
    sim = make_simulate(params, Options(), DT, collect_fluxes=True,
                        static=static, device=device)
    for key, chunk in chunks.items():
        chunk(static, forcings, state, accs[key])
    sim(None, forcings, state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for key, chunk in chunks.items():
            chunk(static, forcings, state, accs[key])
        sim(None, forcings, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit("chunk_no_sync", n=n, steps=steps,
         paths=[f"make_chunk_step {p}{' strict' if s else ''}"
                for p, s in chunks] + ["make_simulate fused"],
         host_synchronisations=0)


def phase_chunk_timing(params, device, n, steps, reps=5):
    """ms a step of the fused step driven four ways, in turns in one
    call: a synchronise after every step; free-running (``steps`` single
    steps, one synchronise at the end; the same with each step's Forcing
    sliced from the stacked one); one chunk of ``steps`` (with the
    accumulators of CHUNK_ACC, and with none); one strict chunk.  For
    each also the host's share: the time until the last step is
    enqueued."""
    case = uniform_case(n)
    static, forcing, state = to_device(case, device)
    forcings = stacked_forcings(case, steps, device)
    fused = make_fused_step(params, Options(), DT, static, device=device)
    chunk = make_chunk_step(params, Options(), DT, CHUNK_ACC, static=static,
                            device=device)
    bare = make_chunk_step(params, Options(), DT, (), static=static,
                           device=device)
    strict = make_chunk_step(params, Options(), DT, CHUNK_ACC, static=static,
                             strict_budgets=True, device=device)
    acc = zero_acc(CHUNK_ACC, n, device)

    def synchronised():
        s = state
        for _ in range(steps):
            s, _ = fused(None, forcing, s)
            torch.cuda.synchronize()

    def free_running():
        s = state
        for _ in range(steps):
            s, _ = fused(None, forcing, s)

    def free_running_sliced():
        # what a chunk would do without the plan's stacked Forcing: a
        # new Forcing of row views every step, checked leaf by leaf
        s = state
        for t in range(steps):
            s, _ = fused(None, Forcing(*[leaf[t] for leaf in forcings]), s)

    ways = {"synchronised_every_step": synchronised,
            "free_running": free_running,
            "free_running_sliced_forcing": free_running_sliced,
            "chunk": lambda: chunk(None, forcings, state, acc),
            "chunk_no_accumulators": lambda: bare(None, forcings, state, ()),
            "strict_chunk": lambda: strict(None, forcings, state, acc)}
    enqueue = {k: [] for k in ways}
    total = {k: [] for k in ways}
    for i in range(reps + 1):
        for key, fn in ways.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i:                       # the first round warms up
                enqueue[key].append((t1 - t0) / steps * 1e3)
                total[key].append((t2 - t0) / steps * 1e3)
    out = {key: {"ms_per_step": statistics.median(total[key]),
                 "ms_min": min(total[key]), "ms_max": max(total[key]),
                 "host_enqueue_ms_per_step": statistics.median(enqueue[key])}
           for key in ways}
    emit("chunk_timing", case="uniform", n=n, steps=steps, reps=reps,
         in_turns=True, acc_spec=CHUNK_ACC, **out,
         strict_ms_per_step=out["strict_chunk"]["ms_per_step"],
         note="host clock; every way advances the same fused step; "
              "host_enqueue_ms_per_step is the time until the call that "
              "enqueues the last step returns (for synchronised_every_step "
              "it holds the waits)")
    return out


def check_ldasout(label, files):
    """Every field of every ldasout file finite."""
    for path in files:
        for name, leaf in driver_io.load_arrays(path).items():
            if not np.isfinite(leaf).all():
                raise AssertionError(f"{label}: {os.path.basename(path)} "
                                     f"{name} not finite")


def states_bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def file_forcing(cfg, static_host, when, device):
    """The case's Forcing at ``when`` (``FileForcing``) on ``device``."""
    provider = driver_io.FileForcing(cfg.indir, cfg.infreq, static_host,
                                     prefetch=False)
    return tree_from_numpy(Forcing, {k: np.array(v) for k, v in
                                     provider(when)._asdict().items()},
                           device)


def offline_kernel_ms(params, cfg, state, device):
    """The fused step's kernels alone on the case's own domain and final
    State (one input set), device milliseconds."""
    static = driver_io.load_domain(cfg.constfile, device)
    forcing = file_forcing(cfg, driver_io.static_to_host(static),
                           cfg.begdatetime, device)
    fused = make_fused_step(params, cfg.options, cfg.dt, static,
                            device=device)
    return time_cuda(lambda f, s: fused(None, f, s), [(forcing, state)],
                     device=device)


def phase_offline_case(params, device, n, days, work, out_hours=3,
                       hours=None):
    """The offline driver end to end, as a user runs it: ``cases.
    conus_case`` writes the case, ``driver.cli.main`` runs it (chunk
    dispatch, advisory budget check every OFFLINE_BUDGETS_EVERY steps).
    Launch counts zeroed just before, read just after.  Then the same
    case through ``run_offline`` as its first half and a resume from the
    restart written there to the end: the same State, bit for bit, and
    the same ldasout files."""
    t0 = time.perf_counter()
    case = write_case(n, days, work, out_hours, hours)
    gen_seconds = time.perf_counter() - t0
    nml = os.path.join(case, "case.nml")
    argv = [nml, "--check-budgets", str(OFFLINE_BUDGETS_EVERY),
            "--dispatch", "chunk"]
    if device.type == "cpu":
        argv += ["--device", "cpu"]
    cfg = Config.from_namelist(nml)
    steps = cfg.nsteps

    column.reset_launches()
    reset_launches()
    t0 = time.perf_counter()
    with HostSplit() as split:
        state, files = driver_cli.main(argv)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"column": column_cuda.launches,
                "thomas": thomas_cuda.launches}
    if device.type == "cuda" and launches != {"column": steps, "thomas": 0}:
        raise AssertionError(f"offline path: launches {launches}, expected "
                             f"one column_cuda call for each of {steps} "
                             "steps and no Thomas launch")
    want = int((cfg.enddatetime - cfg.begdatetime).total_seconds()
               // (3600 * out_hours))
    if len(files) != want:
        raise AssertionError(f"offline case: {len(files)} ldasout files, "
                             f"expected {want}")
    check_ldasout("offline case", files)
    tols = {"errsw": utils.SW_TOL, "erreng": utils.ENG_TOL,
            "errwat": utils.WAT_TOL}

    # the first half, then a resume from the restart written there; the
    # two give the same steps as the run above (the State bit for bit),
    # and their residual reports hold the run's largest residuals
    first = offline_cfg(case, "resume")
    first.enddatetime = first.begdatetime + (
        cfg.enddatetime - cfg.begdatetime) / 2
    halves = [driver_run.run_offline(first, verbose=False, device=device,
                                     residual_limit=utils.WAT_TOL)[2]]
    stamp = first.enddatetime.strftime("%Y%m%d%H%M")
    second = offline_cfg(case, "resume")
    second.restart = True
    second.resfile = f"restart_{stamp}.nc"
    resumed, resumed_files, residuals = driver_run.run_offline(
        second, verbose=False, device=device, residual_limit=utils.WAT_TOL)
    halves.append(residuals)
    if not states_bit_equal(state, resumed):
        raise AssertionError("offline case: the resumed State differs from "
                             "the uninterrupted one")
    land = driver_io.static_to_host(driver_io.load_domain(
        cfg.constfile, "cpu")).ist == 1
    worst = {}
    for name in tols:
        v = torch.maximum(*(h[name] for h in halves)).cpu().numpy()
        worst[name] = float(np.where(land, v, 0.0).max() if name == "errwat"
                            else v.max())
        if not worst[name] < tols[name]:
            raise AssertionError(f"offline case: run absmax |{name}| "
                                 f"{worst[name]}, bound {tols[name]}")
    day2 = files[len(files) - len(resumed_files):]
    for a, b in zip(day2, resumed_files):
        if os.path.basename(a) != os.path.basename(b) or not filecmp.cmp(
                a, b, shallow=False):
            raise AssertionError(f"offline case: resumed {b} differs")
    kernel_ms = (offline_kernel_ms(params, cfg, state, device)
                 if device.type == "cuda" else None)
    out = split.report(n, steps)
    emit("offline_case", n=n, days=days, steps=steps, dt=cfg.dt,
         output_hours=out_hours,
         entry="driver.cli.main " + " ".join(argv[1:]),
         forcing_mode="exact", case_seconds=gen_seconds, wall_seconds=wall,
         ldasout_files=len(files), all_fields_finite=True,
         run_absmax=worst,
         bounds=tols, resumed_state_bit_equal=True,
         resumed_files_equal=len(resumed_files), launches=launches,
         kernel_ms_per_step=kernel_ms,
         kernel_share=(kernel_ms / out["ms_per_step"] if kernel_ms else None),
         **out,
         note="loop: from the forcing prefetcher's start to the sink's "
              "close (host clock); host_ms_per_step: summed time of each "
              "part, on three threads (prefetch: forcing_assembly, upload; "
              "main: chunk_enqueue, prefetch_wait; sink); kernel_ms_per_step:"
              " the fused step's kernels alone on this domain (CUDA events)")
    return case, launches, {"wall_seconds": wall, **out,
                            "kernel_ms_per_step": kernel_ms}


def dist_namelist(case, tag, hours, indir=None):
    """A copy of the case's namelist for the dist phases (the launcher
    reads a file): outputs under ``tag``, ``hours`` model hours,
    restarts at half and at the end, forcing from ``indir`` if given."""
    with open(os.path.join(case, "case.nml")) as fh:
        text = fh.read()
    sub = {"output_directory": os.path.join(case, tag, "ldasout"),
           "restart_directory": os.path.join(case, tag, "restart"),
           "restart_frequency": f"{max(1, hours // 2)} hour"}
    if indir is not None:
        sub["input_directory"] = indir
    for key, value in sub.items():
        text = re.sub(rf"{key} = '[^']*'", f"{key} = '{value}'", text)
    end = Config.from_namelist(os.path.join(case, "case.nml")).begdatetime \
        + datetime.timedelta(hours=hours)
    for key in ("year", "month", "day", "hour"):
        text = re.sub(rf"end_{key}\s*= \d+",
                      f"end_{key} = {getattr(end, key)}", text)
    for key in ("output_directory", "restart_directory"):
        os.makedirs(sub[key], exist_ok=True)
    path = os.path.join(case, f"{tag}.nml")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def same_files(label, want, got_dir):
    """Every file of ``want`` has a namesake in ``got_dir`` with the same
    bytes."""
    for path in want:
        other = os.path.join(got_dir, os.path.basename(path))
        if not filecmp.cmp(path, other, shallow=False):
            raise AssertionError(f"{label}: {os.path.basename(path)} "
                                 "differs from the one-process run's")


def assert_states_equal(label, want, got):
    for name, a, b in zip(State._fields, want, got):
        a, b = a.cpu(), b.cpu()
        if not bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()):
            raise AssertionError(f"{label}: State.{name} differs")


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_ranks(args, world=DIST_WORLD, timeout=DIST_PROCESS_TIMEOUT):
    """``driver.multihost`` in ``world`` processes on this machine, each
    with a time limit; every process is ended before this returns.
    Returns [(exit code, output)] in rank order."""
    port = free_port()
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "noahmp_tpu_torch.driver.multihost",
                 *args, "--timeout", str(DIST_GROUP_TIMEOUT)],
                cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        results = []
        for rank, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {rank} of {world} did not end "
                                     f"within {timeout} s") from None
            results.append((proc.returncode, out))
        return results
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


class DcpTimer:
    """Host milliseconds of every ``CheckpointManager`` build (its gloo
    group connected), ``save`` (the State staged to the host; the write
    goes on on DCP's thread) and ``close`` (waits for the last write),
    while inside."""

    def __enter__(self):
        from noahmp_tpu_torch.dist.checkpoint import CheckpointManager
        self._cls = CheckpointManager
        self._real = (CheckpointManager.save, CheckpointManager.close,
                      CheckpointManager.__init__)
        self.save_ms, self.close_ms, self.build_ms = [], [], []

        def timed(fn, into):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    into.append(1e3 * (time.perf_counter() - t0))
            return wrapper

        CheckpointManager.save = timed(self._real[0], self.save_ms)
        CheckpointManager.close = timed(self._real[1], self.close_ms)
        CheckpointManager.__init__ = timed(self._real[2], self.build_ms)
        return self

    def __exit__(self, *exc):
        self._cls.save, self._cls.close, self._cls.__init__ = self._real


def phase_dist_one_rank(params, device, case, n, hours):
    """``run_offline(cfg, mesh=make_mesh())`` in this process: a mesh of
    one rank (NCCL on the card) over the case's first ``hours`` hours,
    exact forcing, against the same run without a mesh: the same
    ldasout bytes and final State, the launch count of the mesh path,
    the run's DCP checkpoint and a save and restore giving the same
    bits, and ``make_sharded_step``'s diagnostics against torch
    reductions of the one-process flux."""
    import torch.distributed as dist
    from noahmp_tpu_torch.dist.checkpoint import CheckpointManager
    from noahmp_tpu_torch.dist.mesh import make_mesh, make_sharded_step
    plain_cfg = Config.from_namelist(dist_namelist(case, "dist_plain", hours))
    plain_state, plain_files, plain_ms = run_summarised(plain_cfg,
                                                        device=device)
    mesh = make_mesh(device.type)
    try:
        cfg = Config.from_namelist(dist_namelist(case, "dist_one", hours))
        column.reset_launches()
        with DcpTimer() as dcp_ms:
            state, files, mesh_ms = run_summarised(cfg, mesh=mesh)
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = column_cuda.launches
        # in turns: the mesh without DCP checkpoints, no mesh again
        no_dcp = Config.from_namelist(dist_namelist(case, "dist_one_no_dcp",
                                                    hours))
        no_dcp_state, _f, no_dcp_ms = run_summarised(no_dcp, mesh=mesh,
                                                     use_dcp=False)
        assert_states_equal("dist_one_rank, no DCP", plain_state,
                            no_dcp_state)
        _s, _f, plain_ms_again = run_summarised(plain_cfg, device=device)
        if device.type == "cuda" and launches != cfg.nsteps:
            raise AssertionError(f"dist path: {launches} column_cuda calls "
                                 f"for {cfg.nsteps} steps")
        if [os.path.basename(f) for f in files] != [
                os.path.basename(f) for f in plain_files]:
            raise AssertionError("dist_one_rank: other ldasout files")
        same_files("dist_one_rank", plain_files, cfg.outdir)
        assert_states_equal("dist_one_rank, final", plain_state, state)

        ckpt = CheckpointManager(os.path.join(cfg.resdir, "dcp"), mesh=mesh)
        latest = ckpt.latest_step()
        if latest != int((cfg.enddatetime - ANCHOR).total_seconds()):
            raise AssertionError(f"dist_one_rank: latest checkpoint {latest}")
        assert_states_equal("dist_one_rank, DCP of the run", state,
                            ckpt.restore(latest, template=state))
        ckpt.save(latest + 1, state, wait=True)
        assert_states_equal("dist_one_rank, DCP save and restore", state,
                            ckpt.restore(latest + 1, template=state))
        ckpt.close()

        static = driver_io.load_domain(cfg.constfile, device)
        forcing = file_forcing(cfg, driver_io.static_to_host(static),
                               cfg.enddatetime, device)
        one = make_fused_step(params, cfg.options, cfg.dt, static,
                              device=device)
        sharded = make_sharded_step(params, cfg.options, cfg.dt, mesh,
                                    static=static)
        ref_s, ref_f = one(None, forcing, state)
        got_s, got_f, diag = sharded(None, forcing, state)
        assert_states_equal("dist_one_rank, sharded step", ref_s, got_s)
        if not all(torch.equal(a, b) or bool(
                ((a == b) | (a.isnan() & b.isnan())).all())
                for a, b in zip(ref_f, got_f)):
            raise AssertionError("dist_one_rank: the sharded step's Flux "
                                 "differs from the fused step's")
        peaks = {f"max_abs_{f}": float(getattr(ref_f, f).abs().max())
                 for f in ("errsw", "erreng", "errwat")}
        means = {f"mean_{f}": float(getattr(ref_f, f).double().mean())
                 for f in ("fsh", "fsa")}
        got = {k: float(v) for k, v in diag._asdict().items()}
        for key, want in peaks.items():
            if got[key] != want:
                raise AssertionError(f"dist_one_rank: {key} {got[key]} "
                                     f"against {want}")
        rel = {key: abs(got[key] - want) / max(abs(want), 1e-30)
               for key, want in means.items()}
        if not max(rel.values()) <= 1e-6:
            raise AssertionError(f"dist_one_rank: means {rel} relative")
    finally:
        dist.destroy_process_group()
    card = nvidia_smi_line() if device.type == "cuda" else "cpu"
    emit("dist_one_rank", n=n, hours=hours, steps=cfg.nsteps,
         backend="nccl" if device.type == "cuda" else "gloo",
         ldasout_files=len(files), ldasout_bytes_equal=True,
         final_state_bit_equal=True, dcp_bit_equal=True,
         launches=launches, diagnostics=got, reference=dict(**peaks, **means),
         mean_rel_err=rel, ms_per_step=mesh_ms,
         ms_per_step_mesh_no_dcp=no_dcp_ms,
         ms_per_step_without_mesh=[plain_ms, plain_ms_again],
         dcp_build_ms=dcp_ms.build_ms, dcp_save_ms=dcp_ms.save_ms,
         dcp_close_ms=dcp_ms.close_ms, card=card,
         note="ms_per_step: host clock over run_offline's loop (its "
              "summary line), which ends after the last DCP write; in "
              "turns: no mesh, mesh, mesh without DCP, no mesh; "
              "dcp_build_ms: the manager's build, before the loop; "
              "dcp_save_ms: host time of each CheckpointManager.save in "
              "the loop (staging), dcp_close_ms: the wait for the last "
              "write")
    return {"launches": launches, "ms_per_step": mesh_ms,
            "plain_ms_per_step": plain_ms, "plain_cfg": plain_cfg,
            "plain_state": plain_state, "plain_files": plain_files}


def corrupt_forcing(case, cfg, hours, rows):
    """A copy of the forcing files the first ``hours`` hours read, whose
    DIST_CORRUPT_HOUR file carries a corrupt shortwave record on
    ``rows`` only."""
    indir = os.path.join(case, "ldasin_corrupt")
    os.makedirs(indir, exist_ok=True)
    for k in range(hours + 2):
        name = (cfg.begdatetime + datetime.timedelta(hours=k)).strftime(
            "%Y%m%d%H") + ".nc"
        shutil.copy(os.path.join(cfg.indir, name), indir)
    name = (cfg.begdatetime + datetime.timedelta(
        hours=DIST_CORRUPT_HOUR)).strftime("%Y%m%d%H") + ".nc"
    arrays = driver_io.load_arrays(os.path.join(indir, name))
    arrays["soldn"] = np.array(arrays["soldn"], np.float32)
    arrays["soldn"][rows] = CORRUPT_SOLDN
    driver_io.save_arrays(os.path.join(indir, name), arrays)
    return indir


def rank_abort_steps(results):
    """The abort step each rank of a strict run names."""
    steps = []
    for rank, (code, out) in enumerate(results):
        lines = [json.loads(line) for line in out.splitlines()
                 if line.startswith('{"rank"')]
        if code != 1 or len(lines) != 1:
            raise AssertionError(f"strict rank {rank}: exit {code}, "
                                 f"{len(lines)} abort lines: {out[-3000:]}")
        steps.append(lines[0]["abort_step"])
    return steps


def phase_dist_two_ranks(device, case, n, hours, one_rank):
    """``driver.multihost`` in two processes with gloo, both on this
    card (NCCL refuses two ranks on one card), n / 2 points each, the
    kernels already built: the merged ldasout and final restart against
    the one-process run of ``phase_dist_one_rank``; then strict mode
    with the forcing corrupt on rank 1's rows only: both ranks name the
    step that the one-process strict run names, and the merged State
    they stopped at is that run's."""
    plain_cfg = one_rank["plain_cfg"]
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    results = launch_ranks([dist_namelist(case, "dist_two", hours),
                            "--backend", "gloo", *cpu])
    for rank, (code, out) in enumerate(results):
        if code != 0:
            raise AssertionError(f"dist_two_ranks: rank {rank} exited "
                                 f"{code}: {out[-3000:]}")
    steps, two_ms = loop_ms_per_step(results[0][1])
    cfg = Config.from_namelist(os.path.join(case, "dist_two.nml"))
    same_files("dist_two_ranks", one_rank["plain_files"], cfg.outdir)
    last = "restart_" + cfg.enddatetime.strftime("%Y%m%d%H%M") + ".nc"
    merged = driver_io.load_restart(os.path.join(cfg.resdir, last), "cpu")[0]
    assert_states_equal("dist_two_ranks, merged final restart",
                        one_rank["plain_state"], merged)
    assert_states_equal("dist_two_ranks, one-process restart file",
                        driver_io.load_restart(os.path.join(
                            plain_cfg.resdir, last), "cpu")[0], merged)

    indir = corrupt_forcing(case, plain_cfg, hours, slice(n // DIST_WORLD,
                                                          None))
    strict_cfg = Config.from_namelist(dist_namelist(case, "dist_strict_one",
                                                    hours, indir))
    try:
        driver_run.run_offline(strict_cfg, verbose=False, device=device,
                               check_budgets_every="strict")
    except utils.ConservationError as err:
        ref = err
    else:
        raise AssertionError("dist_two_ranks: the one-process strict run "
                             "did not abort")
    strict = launch_ranks([dist_namelist(case, "dist_strict_two", hours,
                                         indir),
                           "--backend", "gloo", "--check-budgets", "strict",
                           *cpu])
    abort_steps = rank_abort_steps(strict)
    if abort_steps != [ref.step] * DIST_WORLD:
        raise AssertionError(f"dist_two_ranks: the ranks abort at "
                             f"{abort_steps}, one process at {ref.step}")
    two_cfg = Config.from_namelist(os.path.join(case, "dist_strict_two.nml"))
    # read as it is: load_restart refuses the non-finite values that the
    # corrupt record leaves at some points
    stopped = tree_from_numpy(State, driver_io.load_arrays(os.path.join(
        two_cfg.resdir, f"abort_{ref.when.strftime('%Y%m%d%H%M')}.nc")),
        "cpu")
    assert_states_equal("dist_two_ranks, strict", ref.state, stopped)
    card = nvidia_smi_line() if device.type == "cuda" else "cpu"
    emit("dist_two_ranks", n=n, ranks=DIST_WORLD, points_per_rank=n //
         DIST_WORLD, hours=hours, steps=steps, backend="gloo",
         merged_ldasout_bytes_equal=len(one_rank["plain_files"]),
         merged_final_restart_bit_equal=True,
         strict={"corrupt_rows": f"[{n // DIST_WORLD}, {n})",
                 "corrupt_hour": DIST_CORRUPT_HOUR, "abort_step": ref.step,
                 "ranks_abort_steps": abort_steps,
                 "merged_state_bit_equal": True},
         ms_per_step=two_ms,
         ms_per_step_one_process=one_rank["plain_ms_per_step"], card=card,
         note="ms_per_step: host clock over rank 0's loop, from its summary "
              "line; the two ranks share one card and one host, so this "
              "is no scaling figure")
    return {"ms_per_step": two_ms}


def forcing_split_check(case, n):
    """The case's exact forcing at every step of its span, assembled on
    this host with the pool (``io.POOL_SIZE`` parts of the point axis)
    and with one part, in turns a step: every bit of every leaf the
    same.  ms a step of each on the host clock (file reads on each
    provider's own prefetch thread, as in a run)."""
    cfg = offline_cfg(case, "split")
    static_host = driver_io.static_to_host(
        driver_io.load_domain(cfg.constfile, device="cpu"))
    modes = {"pooled": driver_io.POOL_SIZE, "one_part": 1}
    providers = {m: driver_io.FileForcing(cfg.indir, cfg.infreq,
                                          static_host) for m in modes}
    seconds = dict.fromkeys(modes, 0.0)
    differing = {}
    for k in range(cfg.nsteps):
        when = cfg.begdatetime + k * cfg.timestep
        got = {}
        for mode in (modes if k % 2 == 0 else list(modes)[::-1]):
            t0 = time.perf_counter()
            got[mode] = providers[mode].assemble(when, modes[mode])
            seconds[mode] += time.perf_counter() - t0
        for name in Forcing._fields:
            a = np.asarray(getattr(got["pooled"], name)).view(np.uint32)
            b = np.asarray(getattr(got["one_part"], name)).view(np.uint32)
            bad = int(np.count_nonzero(a != b))
            if bad:
                differing[name] = differing.get(name, 0) + bad
    emit("offline_forcing_split", n=n, steps=cfg.nsteps,
         pool_size=driver_io.POOL_SIZE, cpu_count=os.cpu_count(),
         pool_min_points=driver_io.POOL_MIN_POINTS,
         split_below_threshold=n < driver_io.POOL_MIN_POINTS,
         **{f"{m}_ms_per_step": seconds[m] / cfg.nsteps * 1e3
            for m in modes},
         differing_values=differing,
         note="FileForcing.assemble with io.POOL_SIZE parts and with one, "
              "in turns a step; host clock; differing_values: values of a "
              "leaf whose bits differ, by leaf, over the span")
    if differing:
        raise AssertionError(f"offline forcing: the pooled assembly differs "
                             f"from one part's in bits: {differing}")


def phase_offline_forcing(device, case, n, hours, reps=2):
    """The first ``hours`` model hours of the case with the exact forcing
    stack and with compact forcing, in turns: bytes uploaded, ms a step,
    the host's split, and the final State of compact against exact.
    First the case's whole span assembled with the pool and with one
    part: bit for bit (``forcing_split_check``)."""
    forcing_split_check(case, n)
    modes = ("exact", "compact")
    runs = {m: [] for m in modes}
    states = {}
    for i in range(reps):
        for mode in (modes if i % 2 == 0 else modes[::-1]):
            cfg = offline_cfg(case, f"forcing_{mode}_{i}", hours)
            with HostSplit() as split:
                state, _files = driver_run.run_offline(
                    cfg, verbose=False, device=device, forcing_mode=mode)
            runs[mode].append(split.report(n, cfg.nsteps))
            states[mode] = state
    steps = offline_cfg(case, "x", hours).nsteps
    ratios = {}
    for name, ref, got in zip(State._fields, states["exact"],
                              states["compact"]):
        ratios[name] = run_ratio(ref.cpu().numpy(), got.cpu().numpy(),
                                 STATE_BAR, STATE_CEILING, steps)
    worst = max(ratios, key=ratios.get)
    if not ratios[worst] <= 1.0:
        raise AssertionError(f"offline forcing: compact against exact, "
                             f"State.{worst} at {ratios[worst]} of the bar")
    summary = {}
    for mode in modes:
        r = runs[mode]
        summary[mode] = {
            "ms_per_step": statistics.median(x["ms_per_step"] for x in r),
            "ms_per_step_runs": [x["ms_per_step"] for x in r],
            "point_steps_per_s": statistics.median(
                x["point_steps_per_s"] for x in r),
            "h2d_bytes_per_step": r[0]["h2d_bytes_per_step"],
            "host_ms_per_step": {
                k: statistics.median(x["host_ms_per_step"][k] for x in r)
                for k in HostSplit.PARTS}}
    emit("offline_forcing", n=n, hours=hours, steps=steps, reps=reps,
         in_turns=True, **summary,
         compact_vs_exact_worst_share_of_bar=ratios[worst],
         compact_vs_exact_worst_leaf=worst,
         compact_vs_exact_bit_equal_leaves=sum(
             torch.equal(a, b) for a, b in zip(states["exact"],
                                              states["compact"])),
         note="run_offline, chunk dispatch; ms_per_step: host clock over "
              "the loop, median of the runs; h2d_bytes_per_step: bytes "
              "handed to the prefetcher's uploads; compact vs exact: "
              "cases.run_ratio over the run's steps")
    return summary


def phase_offline_large(device, n, hours, work, kernel_ms_large, out_hours=3):
    """Compact forcing at ``n`` points for ``hours`` model hours (two
    3-hourly windows), through run_offline."""
    t0 = time.perf_counter()
    case = write_case(n, 1, work, out_hours)
    gen_seconds = time.perf_counter() - t0
    cfg = offline_cfg(case, "large", hours)
    column.reset_launches()
    t0 = time.perf_counter()
    with HostSplit() as split:
        state, files = driver_run.run_offline(cfg, verbose=False,
                                              device=device,
                                              forcing_mode="compact")
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_ldasout("offline large", files)
    if len(files) != hours // out_hours:
        raise AssertionError(f"offline large: {len(files)} ldasout files")
    if device.type == "cuda" and column_cuda.launches != cfg.nsteps:
        raise AssertionError(f"offline large: {column_cuda.launches} "
                             f"column_cuda calls for {cfg.nsteps} steps")
    out = split.report(n, cfg.nsteps)
    emit("offline_large", n=n, hours=hours, steps=cfg.nsteps,
         forcing_mode="compact", case_seconds=gen_seconds,
         wall_seconds=wall, ldasout_files=len(files),
         chunk_cap_steps=max(1, 2 ** 21 // n), **out,
         kernel_ms_per_step=kernel_ms_large,
         kernel_share=(kernel_ms_large / out["ms_per_step"]
                       if kernel_ms_large else None),
         note="kernel_ms_per_step: the column kernels alone at this n on "
              "the uniform case (phase timing, ms_1m)")
    return out


def outside_the_bars(label, ref, got, steps, snapshot=()):
    """{field: per-point ratio to ``steps`` times the step's bars} over
    two dicts of numpy leaves; ``snapshot`` names the fields held to the
    state bars, the rest to the flux bars."""
    out = {}
    for name, r in ref.items():
        b = (STATE_BAR, STATE_CEILING) if name in snapshot else (
            FLUX_BAR, FLUX_CEILING)
        out[f"{label}{name}"] = point_ratios(r, got[name], *b, steps)
    return out


def free_run_summary(table):
    """Points outside (ratio > 1) in a {field: per-point ratio} table:
    the field with most, and the worst ratio and where."""
    counts = {k: int((r > 1.0).sum()) for k, r in table.items()}
    most = max(counts, key=counts.get)
    worst = max(table, key=lambda k: float(table[k].max()))
    return {"most_points_outside": counts[most],
            "most_points_outside_at": most,
            "fields_with_points_outside": sorted(k for k, c in counts.items()
                                                 if c),
            "worst_ratio": float(table[worst].max()), "worst_at": worst}


def free_run_table(ref, other, steps_per_window, steps):
    """{field: per-point ratio} of run ``other`` against run ``ref``, each
    (final State, ldasout files): every ldasout field against
    cases.run_ratio with the steps run so far, and the final State."""
    snapshot = set(driver_io.OutputWriter.SNAPSHOT)
    table = {}
    for k, (rf, gf) in enumerate(zip(ref[1], other[1])):
        if os.path.basename(rf) != os.path.basename(gf):
            raise AssertionError(f"free run: {gf} against {rf}")
        table.update(outside_the_bars(
            os.path.basename(rf) + " ", driver_io.load_arrays(rf),
            driver_io.load_arrays(gf), (k + 1) * steps_per_window, snapshot))
    table.update(outside_the_bars(
        "final State.", tree_to_numpy(ref[0]), tree_to_numpy(other[0]),
        steps, set(State._fields)))
    return table


def point_step_ratios(ref, got):
    """Per point (the leading axis), the worst |ref - got| over the
    step's bars (those of fused_kernel_check) across every leaf of two
    (State, Flux) pairs, on ``ref``'s device in float64; NaN in both
    counts as equal, an int leaf that differs as inf.  Returns (the
    worst ratio a point, {leaf: its ratio a point})."""
    by_leaf = {}
    for label, r_tree, g_tree, bar, (rtol, atol) in (
            ("State.", ref[0], got[0], STATE_BAR, STATE_CEILING),
            ("Flux.", ref[1], got[1], FLUX_BAR, FLUX_CEILING)):
        for name, r, g in zip(r_tree._fields, r_tree, g_tree):
            n = r.shape[0]
            r, g = r.reshape(n, -1), g.to(r.device).reshape(n, -1)
            if r.dtype == torch.int32:
                ratio = (r != g).any(1).double() * math.inf
                ratio = torch.nan_to_num(ratio, nan=0.0)
            else:
                r, g = r.double(), g.double()
                mag = r.abs()
                allowed = torch.minimum(bar * mag.clamp(min=1.0),
                                        atol + rtol * mag)
                ratio = (r - g).abs() / allowed
                same = (r == g) | (r.isnan() & g.isnan())
                ratio = torch.nan_to_num(torch.where(same, 0.0, ratio),
                                         nan=math.inf).amax(1)
            by_leaf[label + name] = ratio
    return torch.stack(list(by_leaf.values())).amax(0), by_leaf


@contextlib.contextmanager
def canopy_exit(threshold):
    """column_plain with the canopy loop's exit threshold at
    ``threshold`` (physics/flux.py:DTV_EXIT) while the block runs; the
    kernels keep theirs."""
    saved = flux_physics.DTV_EXIT
    flux_physics.DTV_EXIT = threshold
    try:
        yield
    finally:
        flux_physics.DTV_EXIT = saved


def nudged(t, seed):
    """``t`` with each element other than 0 moved by one ulp up, down or
    not at all (a generator of ``seed``), on ``t``'s device."""
    x = t.cpu().numpy()
    s = np.random.default_rng(seed).integers(-1, 2, x.shape) * (x != 0)
    y = np.where(s > 0, np.nextafter(x, np.float32(np.inf)),
                 np.where(s < 0, np.nextafter(x, np.float32(-np.inf)), x))
    return torch.from_numpy(y.astype(np.float32)).to(t.device)


def judge_resynced(plain, forcing, state, ref, got, lutyp,
                   draws=ONE_ULP_DRAWS, also=()):
    """One step from the same State: ``ref`` = plain(forcing, state),
    ``got`` the kernel's.  The points outside the step's bars, each
    explained or not by column_plain with the canopy exit moved
    (EXIT_VARIANTS) or with tv, tg and the Forcing moved by one ulp
    (``draws``), or by one of the (State, Flux) pairs ``also``; the
    unexplained ones counted, their worst ratio,
    and the largest share of one land-use class (classes of 100 points
    or more) they take."""
    ratio, by_leaf = point_step_ratios(ref, got)
    outside = torch.nonzero(ratio > 1.0).squeeze(1)
    best = ratio[outside]
    for other in also:
        best = torch.minimum(best, point_step_ratios(other, got)[0][outside])
    variants = [(e, None) for e in EXIT_VARIANTS] + [
        (0.0, SEED + d) for d in range(draws)]
    for e, seed in variants:
        if not bool((best > 1.0).any()):
            break
        start, drive = state, forcing
        if seed is not None:
            start = state._replace(tv=nudged(state.tv, seed),
                                   tg=nudged(state.tg, seed + 1))
            drive = Forcing(*[nudged(x, seed + 2 + k)
                              for k, x in enumerate(forcing)])
        with canopy_exit(flux_physics.DTV_EXIT * (1.0 + e)):
            alt = plain(drive, start)
        best = torch.minimum(best, point_step_ratios(alt, got)[0][outside])
    unexplained = outside[best > 1.0].cpu().numpy()
    worst_leaf = {}
    for name, r in by_leaf.items():
        for p in np.flatnonzero(r.cpu().numpy() > 1.0):
            worst_leaf[p] = max(worst_leaf.get(p, (0.0, "")), (float(r[p]),
                                                                name))
    class_share, class_at = 0.0, None
    for cls in np.unique(lutyp):
        members = int((lutyp == cls).sum())
        if members >= 100:
            frac = float((lutyp[unexplained] == cls).sum()) / members
            if frac > class_share:
                class_share, class_at = frac, int(cls)
    leaves = [worst_leaf[p][1] for p in outside.cpu().numpy()]
    worst_u = max(unexplained, key=lambda p: worst_leaf[p][0], default=None)
    return {"points_outside": int(outside.numel()),
            "explained": int(outside.numel() - len(unexplained)),
            "unexplained": len(unexplained),
            "unexplained_points": unexplained.tolist(),
            "worst_ratio": float(ratio.max()),
            "most_outside_in": max(set(leaves), key=leaves.count,
                                   default=None),
            "worst_unexplained_ratio": (worst_leaf[worst_u][0]
                                        if worst_u is not None else 0.0),
            "worst_unexplained_at": (
                f"{worst_leaf[worst_u][1]}, point {int(worst_u)}, land use "
                f"{int(lutyp[worst_u])}" if worst_u is not None else None),
            "unexplained_land_use": sorted(set(lutyp[unexplained].tolist())),
            "unexplained_class_share": class_share,
            "unexplained_class_share_at": class_at}


def check_resynced(label, report, n):
    """The limits on what stays unexplained, in every step."""
    for r in report:
        if r["unexplained"] > UNEXPLAINED_SHARE * n:
            raise AssertionError(
                f"{label}, step {r['step']}: {r['unexplained']} of {n} points"
                " outside the step's bars and not explained (at most "
                f"{UNEXPLAINED_SHARE * n:.0f}); worst at "
                f"{r['worst_unexplained_at']}")
        if r["worst_unexplained_ratio"] > UNEXPLAINED_RATIO:
            raise AssertionError(
                f"{label}, step {r['step']}: a point outside the bars not "
                f"explained, at "
                f"{r['worst_unexplained_ratio']:.3g} times them (at most "
                f"{UNEXPLAINED_RATIO}): {r['worst_unexplained_at']}")
        if r["unexplained_class_share"] > UNEXPLAINED_CLASS_SHARE:
            raise AssertionError(
                f"{label}, step {r['step']}: "
                f"{r['unexplained_class_share']:.3f} of land use "
                f"{r['unexplained_class_share_at']} outside the bars and not"
                " explained")


def resynced_summary(report):
    worst = max(report, key=lambda r: r["worst_unexplained_ratio"])
    return {"steps": len(report),
            "points_outside_by_step": [r["points_outside"] for r in report],
            "unexplained_by_step": [r["unexplained"] for r in report],
            "worst_ratio": max(r["worst_ratio"] for r in report),
            "worst_unexplained_ratio": worst["worst_unexplained_ratio"],
            "worst_unexplained_at": worst["worst_unexplained_at"],
            "worst_unexplained_step": worst["step"],
            "unexplained_class_share": max(r["unexplained_class_share"]
                                           for r in report),
            "most_outside_in": sorted({r["most_outside_in"] for r in report
                                       if r["most_outside_in"]})}


def phase_offline_kernel_agreement(params, device, case, n):
    """column_cuda against column_plain, both on the card, on the
    offline case's domain: RESYNC_STEPS steps from the init State and
    as many from the last restart the run wrote (2 days on), each step
    taken by both from column_plain's State of the step before, held
    to fused_kernel_check's bars point by point.  The points outside
    must be explained (EXIT_VARIANTS, ONE_ULP_DRAWS), all but a few of
    small excess (UNEXPLAINED_*)."""
    nml_cfg = Config.from_namelist(os.path.join(case, "case.nml"))
    static = driver_io.load_domain(nml_cfg.constfile, device)
    static_host = driver_io.static_to_host(static)
    lutyp = static_host.lutyp
    fused = make_fused_step(params, nml_cfg.options, nml_cfg.dt, static,
                            device=device)
    dt = torch.tensor(nml_cfg.dt, dtype=torch.float32, device=device)

    def plain(forcing, state):
        with torch.no_grad():
            return column_plain(fused.gathered, nml_cfg.options, static,
                                forcing, state, dt)

    last = sorted(f for f in os.listdir(nml_cfg.resdir)
                  if f.startswith("restart_"))[-1]
    restart, when = driver_io.load_restart(os.path.join(nml_cfg.resdir,
                                                        last), device)
    starts = ((nml_cfg.begdatetime,
               driver_io.load_init(nml_cfg.initfile, n, device)),
              (when, restart))
    report = []
    t0 = time.perf_counter()
    for begin, state in starts:
        state = State(*[x.contiguous() for x in state])
        for k in range(RESYNC_STEPS):
            at = begin + k * nml_cfg.timestep
            forcing = file_forcing(nml_cfg, static_host, at, device)
            ref = plain(forcing, state)
            got = fused(None, forcing, state)
            report.append({"step": str(at), **judge_resynced(
                plain, forcing, state, ref, got, lutyp)})
            state = ref[0]
    check_resynced("column_cuda against column_plain on the card", report, n)
    emit("offline_kernel_agreement", n=n, **resynced_summary(report),
         exit_variants=EXIT_VARIANTS, one_ulp_draws=ONE_ULP_DRAWS,
         unexplained_allowed={"share": UNEXPLAINED_SHARE,
                              "ratio": UNEXPLAINED_RATIO,
                              "class_share": UNEXPLAINED_CLASS_SHARE},
         state_bar=STATE_BAR, flux_bar=FLUX_BAR, seconds=time.perf_counter()
         - t0, by_step=report,
         note="column_cuda and column_plain on the card from column_plain's "
              "State; a point is outside when any leaf is beyond "
              "fused_kernel_check's bars, explained when column_plain "
              "comes within them with the canopy exit threshold moved by "
              "one of exit_variants or with tv, tg and the Forcing moved "
              "by one ulp")


def moved(tree, device):
    """A container (or a pair of them) with every leaf on ``device``."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(moved(t, device) for t in tree)
    return type(tree)(*[x.to(device) for x in tree])


def retyped(tree, dtype=torch.float64):
    """A container with every float leaf as ``dtype``."""
    return type(tree)(*[x.to(dtype) if x.is_floating_point() else x
                        for x in tree])


def phase_offline_cpu_agreement(device, n, hours, work, out_hours=3):
    """The same case through run_offline on the card and on the CPU
    (column_plain): every ldasout field and every leaf of the final
    State within cases.run_ratio at all but FREE_RUN_OUTLIERS of the
    points and within FREE_RUN_RATIO of it at every point.  Beside it
    the CPU run against itself started from a State whose tg moved by
    one ulp (the worst of SELF_SPREAD_DRAWS): how far the model parts
    from itself.  Then each step of the
    CPU run's trajectory taken again on the card from the CPU's State
    (resynced), held as in offline_kernel_agreement (the variants run on
    the CPU), a point also explained by the same step in float64 on the
    CPU or by column_plain on the card; beside it, how far the CPU's
    float32 step parts from its float64 one, and the kernel from
    column_plain on the card."""
    case = write_case(n, 1, work, out_hours)
    got = driver_run.run_offline(offline_cfg(case, "card", hours),
                                 verbose=False, device=device)
    ref = driver_run.run_offline(offline_cfg(case, "cpu", hours),
                                 verbose=False, device="cpu")
    cfg = offline_cfg(case, "x", hours)
    init = driver_io.load_init(cfg.initfile, n, "cpu")
    itself = [driver_run.run_offline(
        offline_cfg(case, f"cpu_nudged_{d}", hours), verbose=False,
        device="cpu", state=init._replace(tg=nudged(init.tg, SEED + d)))
        for d in range(SELF_SPREAD_DRAWS)]
    if len(got[1]) != hours // out_hours:
        raise AssertionError(f"offline card vs CPU: {len(got[1])} files")
    tables = [free_run_summary(free_run_table(ref, other, 4 * out_hours,
                                              cfg.nsteps))
              for other in [got] + itself]
    free_report = tables[0]
    self_report = max(tables[1:], key=lambda t: t["worst_ratio"])

    # resynced: one step at a time from the CPU run's State
    static = driver_io.load_domain(cfg.constfile, "cpu")
    static_host = driver_io.static_to_host(static)
    card_static = moved(static, device)
    card = make_fused_step(load_params(cfg.veg_scheme, cfg.soil_scheme,
                                       device=device), cfg.options, cfg.dt,
                           card_static, device=device)
    cpu_params = load_params(cfg.veg_scheme, cfg.soil_scheme, device="cpu")
    cpu = make_fused_step(cpu_params, cfg.options, cfg.dt, static,
                          device="cpu")

    def plain(forcing, state):
        return cpu(None, forcing, state)

    gathered64 = gather_params(copy.deepcopy(cpu_params).double(),
                               static.lutyp, static.sltyp, static.isc,
                               static.slptyp)
    dt64 = torch.tensor(cfg.dt, dtype=torch.float64)

    def plain64(forcing, state):
        with torch.no_grad():
            out = column_plain(gathered64, cfg.options, retyped(static),
                               retyped(forcing), retyped(state), dt64)
        return tuple(retyped(t, torch.float32) for t in out)

    dt_card = torch.tensor(cfg.dt, dtype=torch.float32, device=device)

    def plain_on_the_card(forcing, state):
        with torch.no_grad():
            out = column_plain(card.gathered, cfg.options, card_static,
                               moved(forcing, device), moved(state, device),
                               dt_card)
        return tuple(moved(t, "cpu") for t in out)

    state = init
    report, yardstick, same_card = [], [], []
    for k in range(cfg.nsteps):
        at = cfg.begdatetime + k * cfg.timestep
        forcing = file_forcing(cfg, static_host, at, "cpu")
        ref_step = plain(forcing, state)
        got_step = moved(card(None, moved(forcing, device),
                              moved(state, device)), "cpu")
        wide = plain64(forcing, state)
        on_card = plain_on_the_card(forcing, state)
        for table, a, b in ((yardstick, ref_step, wide),
                            (same_card, on_card, got_step)):
            r = point_step_ratios(a, b)[0]
            table.append((int((r > 1.0).sum()), float(r.max())))
        report.append({"step": k, **judge_resynced(
            plain, forcing, state, ref_step, got_step, static_host.lutyp,
            also=(wide, on_card))})
        state = ref_step[0]
    yardstick = {"points_outside_by_step": [c for c, _ in yardstick],
                 "worst_ratio": max(w for _, w in yardstick)}
    same_card = {"points_outside_by_step": [c for c, _ in same_card],
                 "worst_ratio": max(w for _, w in same_card)}

    limit = int(FREE_RUN_OUTLIERS * n)
    if free_report["most_points_outside"] > limit:
        raise AssertionError(
            "offline card vs CPU, free run: "
            f"{free_report['most_points_outside']} points of {n} outside the "
            "bars in "
            f"{free_report['most_points_outside_at']} (at most {limit})")
    if free_report["worst_ratio"] > FREE_RUN_RATIO:
        raise AssertionError(
            f"offline card vs CPU, free run: {free_report['worst_at']} at "
            f"{free_report['worst_ratio']:.3g} times cases.run_ratio (at most "
            f"{FREE_RUN_RATIO})")
    check_resynced("offline card vs CPU, resynced", report, n)
    emit("offline_cpu_agreement", n=n, hours=hours, steps=cfg.nsteps,
         ldasout_files=len(got[1]),
         free_run_allowed={"points": limit, "ratio": FREE_RUN_RATIO},
         free_run=free_report, cpu_against_itself_tg_one_ulp=self_report,
         resynced=resynced_summary(report),
         float32_vs_float64_on_the_cpu=yardstick,
         kernel_vs_plain_on_the_card=same_card,
         unexplained_allowed={"share": UNEXPLAINED_SHARE,
                              "ratio": UNEXPLAINED_RATIO,
                              "class_share": UNEXPLAINED_CLASS_SHARE},
         note="free_run: ldasout fields and the final State, "
              "cases.point_ratios with the steps run so far; "
              "cpu_against_itself_tg_one_ulp: the same for the CPU run from "
              "the initial State with tg moved by one ulp; resynced: each step"
              " from the CPU run's State on the card and on the CPU, "
              "the step's bars per point, explained as in "
              "offline_kernel_agreement (variants on the CPU) or by the "
              "float64 step on the CPU or column_plain on the card; "
              "float32_vs_float64_on_the_cpu and kernel_vs_plain_on_the_card:"
              " the points outside the bars between those two pairs")


def crossings_reference(name, copies, steps):
    """The JAX step's crossings on FUZZ_COMBOS set ``name`` over its
    first ``steps`` steps at ``copies`` (JAX_FUZZ_CROSSINGS); None at
    any other size or depth."""
    by_step = JAX_FUZZ_CROSSINGS.get(name)
    if copies != JAX_FUZZ_COPIES or by_step is None or steps > len(by_step):
        return None
    return sum(by_step[:steps])


def native_fields(totals):
    """A path's totals of phase native_oracle, as keys of the kernels
    line."""
    return {"native_outliers": totals["outliers"],
            "native_point_steps": totals["point_steps"],
            "native_crossings": totals["crossings"],
            "native_crossings_of_jax": totals["crossings_of_jax"],
            "native_max_share_of_tight": totals["max_share_of_tight"]}


def host_cpu():
    """The host CPU's model name (/proc/cpuinfo: with its vendor, family
    and model numbers, which a virtual machine may report where it hides
    the name) and logical cores."""
    info = {}
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if not line.strip():
                    break
                info.setdefault(key.strip(), value.strip())
    model = (f"{info.get('model name')} ({info.get('vendor_id')}, family "
             f"{info.get('cpu family')}, model {info.get('model')})")
    return model, os.cpu_count()


def phase_native_oracle(params, device, work, free_running_ms,
                        copies=NATIVE_COPIES, fuzz_steps=NATIVE_FUZZ_STEPS,
                        eager_steps=NATIVE_EAGER_STEPS,
                        n_conus=N_OFFLINE_CPU, conus_steps=NATIVE_CONUS_STEPS,
                        day_hours=24, n_bench=N_POINTS):
    """The steps against the serial C++ reference column
    (noahmp_tpu_torch.native, built with g++ on the host): (a) the resync
    fuzz of test_golden_native.py, its ten columns ``copies`` times over
    with per-point weather, every FUZZ_COMBOS set through the fused step
    and NATIVE_EAGER_COMBOS through the eager step, each step of the
    card's trajectory also taken by the oracle from the card's State;
    (b) the generated CONUS case at ``n_conus`` points, exact forcing,
    from the init State and from the card's State ``day_hours`` later;
    both held to FUZZ_TIGHT and FUZZ_OUTLIER_FRAC, and to no more
    point-steps beyond FUZZ_CAP or with nsnow changed than
    crossings_allowed (none on the CONUS case); (c) the
    oracle's own rate (bench_native) on the uniform case at ``n_bench``
    points, one thread and all, beside the fused step's free-running
    rate (phase timing).  Launch counts zeroed before (a)
    and read after (b)."""
    t0 = time.perf_counter()
    model, cores = host_cpu()
    native.load()
    threaded = native.openmp()
    native.set_threads(cores)
    column.reset_launches()
    reset_launches()

    # (a) the resync fuzz
    fuzz = {}
    static_np, state_np = fuzz_case(copies)
    static = tree_from_numpy(Static, static_np, device)
    lutyp = static_np["lutyp"]
    n = lutyp.shape[0]
    for path, steps in (("column_cuda", fuzz_steps),
                        ("make_step", eager_steps)):
        for name, opts in FUZZ_COMBOS:
            if path == "column_cuda":
                step = make_fused_step(params, opts, DT, static,
                                       device=device)
                take = lambda f, s, step=step: step(None, f, s)  # noqa: E731
            elif name in NATIVE_EAGER_COMBOS:
                step = make_step(params, opts, DT, device=device)
                take = lambda f, s, step=step: step(static, f, s)  # noqa: E731
            else:
                continue
            rng = np.random.default_rng(FUZZ_SEED)
            reports = against_oracle(
                take, static, (fuzz_forcing(rng, n) for _ in range(steps)),
                tree_from_numpy(State, state_np, device), opts, DT, lutyp,
                params)
            fuzz[f"{path} {name}"] = check_oracle(
                f"{path} {name}", reports,
                crossings_reference(name, copies, steps))

    # (b) the CONUS case, from the init State and a day later
    case = write_case(n_conus, 2, os.path.join(work, "native"))
    cfg = offline_cfg(case, "native", day_hours)
    later = driver_run.run_offline(cfg, verbose=False, device=device)[0]
    c_static = driver_io.load_domain(cfg.constfile, device)
    c_host = driver_io.static_to_host(c_static)
    fused = make_fused_step(params, cfg.options, cfg.dt, c_static,
                            device=device)
    conus = {}
    for label, begin, state in (
            ("from the init State", cfg.begdatetime,
             driver_io.load_init(cfg.initfile, n_conus, device)),
            (f"{day_hours} hours later", cfg.enddatetime, later)):
        forcings = (file_forcing(cfg, c_host, begin + k * cfg.timestep,
                                 "cpu")._asdict()
                    for k in range(conus_steps))
        reports = against_oracle(
            lambda f, s: fused(None, f, s), c_static,
            ({k: v.numpy() for k, v in f.items()} for f in forcings),
            State(*[x.contiguous() for x in state]), cfg.options, cfg.dt,
            c_host.lutyp, params)
        conus[label] = check_oracle(f"column_cuda CONUS {label}", reports)
    launches = {"column": column_cuda.launches,
                "thomas": dict(thomas_cuda.launches_by_rows)}
    shutil.rmtree(case)

    # (c) the oracle's rate on the card's host
    bench = to_device(uniform_case(n_bench), device)
    rate_1 = native.bench_native(params, Options(), *bench,
                                 steps=NATIVE_BENCH_STEPS, threads=1)
    rate_all = (native.bench_native(params, Options(), *bench,
                                    steps=NATIVE_BENCH_STEPS, threads=cores)
                if threaded else None)
    card_rate = (n_bench / (free_running_ms * 1e-3) if free_running_ms
                 else None)
    by_path = {
        "column_cuda": [r for k, r in fuzz.items()
                        if k.startswith("column_cuda ")]
        + list(conus.values()),
        "make_step": [r for k, r in fuzz.items()
                      if k.startswith("make_step ")]}
    totals = {path: {"point_steps": sum(r["point_steps"] for r in rs),
                     "outliers": sum(r["outliers"] for r in rs),
                     "crossings": sum(r["crossings"] for r in rs),
                     "crossings_of_jax": sum(r["crossings_of_jax"] or 0
                                             for r in rs),
                     "max_share_of_tight": max(r["max_share_of_tight"]
                                               for r in rs)}
              for path, rs in by_path.items()}
    out = {"launches": launches, "totals": totals,
           "rate_1_thread": rate_1, "rate_all_threads": rate_all,
           "threads": cores if threaded else 1}
    emit("native_oracle", n_fuzz=n, fuzz_steps=fuzz_steps,
         eager_steps=eager_steps, n_conus=n_conus, conus_steps=conus_steps,
         limits={"tight": FUZZ_TIGHT, "cap": FUZZ_CAP,
                 "outlier_frac": FUZZ_OUTLIER_FRAC,
                 "crossings_from": JAX_FUZZ_SOURCE},
         fuzz=fuzz, conus=conus, launches=launches, totals=totals,
         oracle={"library": os.path.basename(native.library_path()),
                 "flags": " ".join(native.CXX_FLAGS), "openmp": threaded,
                 "n": n_bench, "timed_steps": NATIVE_BENCH_STEPS,
                 "point_steps_per_s_1_thread": rate_1,
                 "point_steps_per_s_all_threads": rate_all,
                 "threads": out["threads"]},
         column_cuda={"free_running_ms_per_step": free_running_ms,
                      "point_steps_per_s": card_rate,
                      "over_1_thread": (card_rate / rate_1
                                        if card_rate else None),
                      "over_all_threads": (card_rate / rate_all
                                           if card_rate and rate_all
                                           else None)},
         host_cpu=model, logical_cores=cores,
         card=nvidia_smi_line() if device.type == "cuda" else None,
         seconds=time.perf_counter() - t0,
         note="each step of the card's trajectory also taken by the oracle "
              "from the card's State; outliers: point-steps beyond "
              "FUZZ_TIGHT in any of its fields (share: |card - oracle| "
              "over that field's FUZZ_TIGHT); crossings: beyond FUZZ_CAP "
              "or with nsnow changed, crossings_of_jax the JAX step's own "
              "on its own trajectory over the same set and steps "
              "(crossings_from), crossings_allowed the most that passes "
              "beside it (a one-sided binomial test at CROSSINGS_ALPHA "
              f"= {CROSSINGS_ALPHA}; none without a JAX count); oracle "
              "rates: bench_native, host clock, one warm call then the "
              "timed steps in place")
    return out


def phase_bench_cells(device, cuts=BENCH_CUTS):
    """Each cell of BENCHMARK.json through the entry point its command
    runs (``benchmarks_torch.run.run_workload``), cut to ``cuts``, and
    the lines the command prints (``report``): the run must be correct,
    and the metrics it prints must be those BENCHMARK.json names for the
    cell.  Launch counts zeroed before the first cell, read after the
    last."""
    named = bench_run.workloads()
    if sorted(cuts) != sorted(named):
        raise AssertionError(f"bench_cells runs {sorted(cuts)}, "
                             f"BENCHMARK.json has {sorted(named)}")
    column.reset_launches()
    reset_launches()
    cells = {}
    for name, cut in cuts.items():
        t0 = time.perf_counter()
        result = bench_run.run_workload(name, SEED, device=device, **cut)
        lines = bench_run.report(result)
        printed = json.loads(lines[0])["metrics"]
        if sorted(printed) != sorted(named[name]["metrics"]):
            raise AssertionError(f"{name}: prints {sorted(printed)}, "
                                 "BENCHMARK.json names "
                                 f"{sorted(named[name]['metrics'])}")
        last = json.loads(lines[-1])
        if not last["correct"]:
            failed = {k: v for k, v in result["checks"].items()
                      if not v["ok"]}
            raise AssertionError(f"{name} at {cut}: not correct: {failed}")
        cells[name] = {"cut": cut, "points": result["points"],
                       "steps": result["steps"],
                       "point_steps_per_s": last["point_steps_per_s"],
                       "vs_baseline": last["vs_baseline"],
                       "failed_share": last["failed_share"],
                       "oracle_outliers":
                           result["checks"]["oracle"]["outliers"],
                       "oracle_point_steps":
                           result["checks"]["oracle"]["point_steps"],
                       "seconds": time.perf_counter() - t0}
    launches = {"column": column_cuda.launches,
                "thomas": dict(thomas_cuda.launches_by_rows)}
    emit("bench_cells", cells=cells, launches=launches,
         note="python3 -m benchmarks_torch.run <cell> runs the same "
              "function at the configuration's size; here cut to cut; "
              "point_steps_per_s of the timed loop (host clock)")
    return launches


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


def column_sets(params, case, device, copies, opts=Options()):
    """``copies`` independent copies of one case's inputs, each with its
    own plan, as arguments of column_cuda: walked in turn they are cold
    in the L2 cache (two copies at 65,536 points exceed it)."""
    sets = []
    for _ in range(copies):
        static, forcing, state = to_device(case, device)
        fused = make_fused_step(params, opts, DT, static, device=device)
        sets.append((fused.plan, forcing, state))
    return sets


def phase_sweep(params, step, device, sizes=(16384, 65536, 262144, 1048576)):
    """Step time of both paths, and the column kernels' device time,
    against the number of land points (opt-in)."""
    rows = []
    for n in sizes:
        static, forcing, state = to_device(uniform_case(n), device)
        fused = make_fused_step(params, Options(), DT, static, device=device)
        eager_ms, fused_ms = wall_ms_in_turns(
            [lambda s: step(static, forcing, s)[0],
             lambda s: fused(None, forcing, s)[0]], [state, state], 3, 2)
        host_enqueue_ms, free_running_ms = chained_ms(fused, forcing, state,
                                                      steps=20)
        kernel_ms = time_cuda(column_cuda,
                              column_sets(params, uniform_case(n), device, 2),
                              device=device)
        rows.append({"n": n,
                     "eager_ms_per_step": statistics.median(eager_ms),
                     "fused_ms_per_step": statistics.median(fused_ms),
                     "fused_enqueue_ms": host_enqueue_ms,
                     "fused_free_running_ms_per_step": free_running_ms,
                     "fused_kernel_device_ms": kernel_ms,
                     "kernel_launches_per_step": column.device_launches(n),
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


def carbon_operations(params_cpu):
    """Operations a point with the carbon branch on (opt_veg = 2), whole
    step and the water stage that holds it, counted as column_bound
    counts the default's."""
    opts = CARBON_OPTIONS[0]
    s_cpu, f_cpu, st_cpu = to_device(uniform_case(N_OPS), "cpu")
    g_cpu = make_fused_step(params_cpu, opts, DT, s_cpu,
                            device="cpu").gathered
    ops = count_operations(g_cpu, opts, DT, s_cpu, f_cpu, st_cpu)
    return {"operations_per_point": ops["total"] / N_OPS,
            "water_stage_operations_per_point":
                ops["by_stage"]["water"]["total"] / N_OPS,
            "carbon_header_operations_per_point":
                ops["by_file"].get("carbon.cuh", 0) / N_OPS}


def column_bound(params_cpu, gathered, static, forcing, state, n, weights,
                 clock_mhz):
    """The least time the card could take for one step: bytes (every
    input the default options need, once; every output, once) over the
    memory rate, against the float32 operations these inputs execute
    (counted on the host over N_OPS of the points, which are all alike
    in the uniform case) over the float32 rate.  Beside it issue_ms, the
    same operations weighted by the issue slots each kind costs, and the
    scratch a point writes and reads between the stages, which the bound
    does not count."""
    s_cpu, f_cpu, st_cpu = to_device(uniform_case(N_OPS), "cpu")
    g_cpu = make_fused_step(params_cpu, Options(), DT, s_cpu,
                            device="cpu").gathered
    ops = count_operations(g_cpu, Options(), DT, s_cpu, f_cpu, st_cpu)
    ops_per_point = ops["total"] / N_OPS
    needed = step_bytes(gathered, static, forcing, state)
    least = step_bound(needed, ops_per_point * n)
    by_kind = {k: v / N_OPS for k, v in ops["by_kind"].items()}
    by_stage = {}
    for stage, part in ops["by_stage"].items():
        kinds = {k: v / N_OPS for k, v in part["by_kind"].items()}
        by_stage[stage] = {
            "operations_per_point": part["total"] / N_OPS,
            "issue_ms": (issue_ms(kinds, weights, clock_mhz, n)
                         if weights else None)}
    return {"bound_ms": least["bound_ms"], "bound_by": least["bound_by"],
            "bytes": needed, "bytes_per_point": needed / n,
            "bytes_ms": least["bytes_ms"],
            "kernel_bytes_per_point": needed / n,
            "scratch_bytes_per_point": 4 * column.SEAM_WORDS,
            "operations_per_point": ops_per_point,
            "operations_ms": least["operations_ms"],
            "operations_by_kind": by_kind,
            "operations_by_file": {k: v / N_OPS
                                   for k, v in ops["by_file"].items()},
            "operations_by_stage": by_stage,
            "issue_ms": (issue_ms(by_kind, weights, clock_mhz, n)
                         if weights else None),
            "issue_clock_mhz": clock_mhz}


def chained_ms(fused, forcing, state, steps=50):
    """Host milliseconds a fused step takes to enqueue, and milliseconds
    a step when the caller never waits: ``steps`` chained steps with one
    synchronise at the end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = fused(None, forcing, state)
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    done = time.perf_counter() - t0
    return enqueued / steps * 1e3, done / steps * 1e3


def phase_timing(params, params_cpu, step, device, n, weights, clock_mhz,
                 reps=7, warmup=2):
    """Eager and fused step in turns on the host clock, and the fused
    step's kernels on the card's clock: the whole step at n and at
    N_LARGE on the uniform case, at n on hetero/cold_snow (divergent
    warps, snow layers), and each stage alone."""
    static, forcing, state = to_device(uniform_case(n), device)
    fused = make_fused_step(params, Options(), DT, static, device=device)
    eager_ms, fused_ms = wall_ms_in_turns(
        [lambda s: step(static, forcing, s)[0],
         lambda s: fused(None, forcing, s)[0]], [state, state], reps, warmup)
    host_enqueue_ms, free_running_ms = chained_ms(fused, forcing, state)

    # device time of the kernels alone: steps queued back to back behind
    # a blocker, walking three independent copies of the inputs (120 MB
    # together, past the 50 MB L2)
    sets = column_sets(params, uniform_case(n), device, 3)
    kernel_ms = time_cuda(column_cuda, sets, device=device)
    kernel_ms_isolated = time_cuda_isolated(column_cuda, sets)
    # each stage alone, on the pointers and the scratch of a whole step
    plan = sets[0][0]
    last = column_cuda(*sets[0])
    stage_ms = {stage: time_cuda(column.launch_stage, [(plan, stage)],
                                 device=device)
                for stage in column.STAGES}
    del last, sets
    ms_cold_snow = time_cuda(
        column_cuda, column_sets(params, hetero_case("cold_snow", n), device,
                                 3), device=device)
    ms_large = time_cuda(
        column_cuda, column_sets(params, uniform_case(N_LARGE), device, 2),
        device=device)
    # the same kernels with the carbon branch on, in the same call: the
    # whole step, and the water stage (which holds the branch) alone
    veg2 = CARBON_OPTIONS[0]
    sets = column_sets(params, uniform_case(n), device, 3, veg2)
    ms_veg2 = time_cuda(column_cuda, sets, device=device)
    last = column_cuda(*sets[0])
    water_ms_veg2 = time_cuda(column.launch_stage, [(sets[0][0], "water")],
                              device=device)
    del last, sets
    carbon_ops = carbon_operations(params_cpu)
    plain_device_ms, plain_kernels = eager_device_ms(step, static, forcing,
                                                     state)
    bound = column_bound(params_cpu, fused.gathered, static, forcing, state,
                         n, weights, clock_mhz)

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
                "stage_ms": stage_ms,
                "kernel_ms_hetero_cold_snow": ms_cold_snow,
                f"kernel_ms_n{N_LARGE}": ms_large,
                "kernel_ms_opt_veg_2": ms_veg2,
                "water_stage_ms_opt_veg_2": water_ms_veg2,
                "opt_veg_2": carbon_ops,
                "kernel_launches_per_step": column.device_launches(n),
                "host_share_ms": f_ms - kernel_ms,
                "host_enqueue_ms": host_enqueue_ms,
                "free_running_ms_per_step": free_running_ms},
         bound=bound,
         note="eager: one CUDA kernel per tensor operation; fused: "
              f"{column.device_launches(n)} launches of the column kernels "
              "a step, enqueued by one C call; stage_ms: each launch alone, "
              "back to back with itself, on the scratch of a whole step")
    return {"ms": kernel_ms, "ms_isolated": kernel_ms_isolated,
            "stage_ms": stage_ms, "ms_hetero_cold_snow": ms_cold_snow,
            "ms_large": ms_large, "ms_veg2": ms_veg2,
            "water_ms_veg2": water_ms_veg2, "carbon_ops": carbon_ops,
            "host_enqueue_ms": host_enqueue_ms,
            "free_running_ms": free_running_ms,
            "plain_ms": plain_device_ms, "plain_wall_ms": e_ms,
            "wall_ms": f_ms, **bound}


class ColumnBuild:
    """A build of the column kernels' sources, run on a plan's pointers:
    a step and, on the card, its flux stage alone.  Without a path, the
    package's own build through ``column_cuda`` and ``launch_stage``;
    else the library at ``path`` (the host build's on the CPU)."""

    def __init__(self, name, path=None, on_card=True):
        self.name, self.on_card, self.lib = name, on_card, None
        if path is None:
            self.launches = column.LAUNCHES_PER_STEP
            return
        self.lib = lib = ctypes.CDLL(path)
        args_p = ctypes.POINTER(column._args_type())
        self.launches = column.check_abi(lib, column._args_type())[7]
        if on_card:
            lib.noahmp_column_step.argtypes = [args_p, ctypes.c_void_p]
            lib.noahmp_column_step.restype = ctypes.c_int
            lib.noahmp_column_stage.argtypes = [args_p, ctypes.c_int,
                                                ctypes.c_void_p]
            lib.noahmp_column_stage.restype = ctypes.c_int
        else:
            lib.noahmp_column_host.argtypes = [args_p]
            lib.noahmp_column_host.restype = ctypes.c_int

    def step(self, plan, forcing, state):
        if self.lib is None:
            return column_cuda(plan, forcing, state)
        args = plan.point_to(forcing, state)
        new_state, flux = plan.outputs()
        if self.on_card:
            err = self.lib.noahmp_column_step(
                ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
        else:
            err = self.lib.noahmp_column_host(ctypes.byref(args))
        if err != 0:
            raise RuntimeError(f"{self.name}: step failed, error {err}")
        return new_state, flux

    def flux_stage(self, plan):
        if self.lib is None:
            return column.launch_stage(plan, "flux")
        err = self.lib.noahmp_column_stage(
            ctypes.byref(plan.args), column.STAGES.index("flux"),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: flux stage failed, CUDA "
                               f"error {err}")


def pass_counts(plan):
    """The points of the last slab at the front (with a canopy) and at
    the back (without one) of the list of the canopy loop's second pass
    in the plan's last step (column_args.cuh:kPassCounters); reads the
    card."""
    tail = plan.scratch[column.SEAM_WORDS * plan.args.slab:]
    with_canopy, without = tail[:column.PASS_COUNTERS].view(
        torch.int32).tolist()
    return with_canopy, without


def differing_leaves(want, got):
    """Names of the State and Flux leaves whose bits differ (NaN
    included)."""
    return [f"{type(a).__name__}.{name}"
            for a, b in zip(want, got)
            for name, x, y in zip(a._fields, a, b)
            if not torch.equal(x.view(torch.int32), y.view(torch.int32))]


def phase_canopy_split(params, device, builds, n=N_LARGE, span=SPLIT_SPAN,
                       hours=SPLIT_HOURS):
    """The column kernels with their canopy loop in two passes
    (``column.CANOPY_PASS_ENDS``) against the same sources built with one
    pass of every trip, on the spin-up cell's domain (``n`` points of
    ``benchmarks_torch.spinup.domain``) at its traced time of year: the
    cell's ``span`` steps from a cold start on Jan 1 through the fused
    step, then at each of ``hours`` of the next day one step of both
    builds from the same State, every leaf bit for bit.  On the card
    both builds' flux stage and whole step are timed there (CUDA events,
    in turns), and the pass counters are read after the timing: the
    share of the points that run the second pass, and of those without
    a canopy.  Beside it the canopy trips of the plain step from the
    same States (``scripts/canopy_trips.py``).  ``builds``: the
    package's build and the one-pass build (``ColumnBuild``)."""
    on_card = device.type == "cuda"
    split, one_pass = builds
    static = spinup_domain(n, SEED, device)
    state = init_state(n, device=device)
    fused = make_fused_step(params, Options(), DT, static, device=device)
    plain = make_step(params, Options(), DT, device=device)
    plan = column.ColumnPlan(fused.gathered, Options(), DT, static,
                             need_cuda=on_card)
    t0 = time.perf_counter()
    k = 0
    rows, trips = [], []
    for hour in hours:
        for k in range(k, span + hour * 4):
            state, _ = fused(None, device_forcing(k * DT, static), state)
        k = span + hour * 4
        forcing = device_forcing(k * DT, static)
        _s, point_trips, bare = step_trips(plain, static, forcing, state)
        trips.append((point_trips, bare))
        row = {"step": k, "hour": hour,
               "plain_trips_mean": float(point_trips.mean()),
               "plain_share_at_every_trip": float(
                   (point_trips == flux_physics.NITERC).mean())}
        got = split.step(plan, forcing, state)
        with_canopy, without = pass_counts(plan)
        want = one_pass.step(plan, forcing, state)
        differ = differing_leaves(want, got)
        if differ:
            raise AssertionError(f"canopy_split step {k}: the split build "
                                 f"differs from the one-pass build in "
                                 f"{differ}")
        row["leaves_bit_equal"] = sum(len(t) for t in got)
        if on_card:
            order = (split, one_pass) if len(rows) % 2 == 0 else (
                one_pass, split)
            for build in order:
                row[f"{build.name}_flux_stage_ms"] = time_cuda(
                    build.flux_stage, [(plan,)], device=device)
                row[f"{build.name}_step_ms"] = time_cuda(
                    build.step, [(plan, forcing, state)], device=device)
                if build is split:
                    # the counters as its last timed step left them
                    with_canopy, without = pass_counts(plan)
        row["second_pass_share"] = (with_canopy + without) / n
        row["without_canopy_share"] = without / n
        rows.append(row)
        del got, want
        state, _ = fused(None, forcing, state)
        k += 1
    seconds = time.perf_counter() - t0
    ist, lutyp = static.ist.cpu().numpy(), static.lutyp.cpu().numpy()
    out = {"n": n, "span_steps": span, "hours": list(hours),
           "pass_ends": list(column.CANOPY_PASS_ENDS),
           "launches_a_slab": {split.name: split.launches,
                               one_pass.name: one_pass.launches},
           "steps": rows,
           "plain_trips": trips_summary(
               np.concatenate([t for t, _b in trips]),
               np.tile(ist, len(hours)), np.tile(lutyp, len(hours)),
               np.concatenate([b for _t, b in trips])),
           "seconds": round(seconds, 1)}
    keys = ["second_pass_share", "without_canopy_share"]
    if on_card:
        keys += [f"{b.name}_{what}_ms" for b in builds
                 for what in ("flux_stage", "step")]
    for key in keys:
        out[key] = statistics.mean(r[key] for r in rows)
    emit("canopy_split", **out,
         note="every State and Flux leaf of the split build bit-equal to "
              f"the build with {ONE_PASS_DEFINE} at every step; *_ms: CUDA "
              "events around 20 launches back to back, median of 5, the "
              "two builds in turns, the mean over the hours; "
              "second_pass_share, without_canopy_share: the pass counters "
              "over n, after the timing; plain_trips: the plain step's "
              "canopy trips at the same States (scripts/canopy_trips.py), "
              "pooled over the hours")
    return out


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


def host_column_library(build_dir, *defines):
    """``csrc/column_host.cpp`` (the kernels' headers for the host) built
    with g++ as tests/test_torch_column_host.py builds it, and bound."""
    lib_path = os.path.join(build_dir, "libcolumn_host.so")
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", *defines, "-o", lib_path,
                    os.path.join(_build.CSRC_DIR, "column_host.cpp")],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    args_type = column._args_type()
    column.check_abi(lib, args_type)
    lib.noahmp_column_host.argtypes = [ctypes.POINTER(args_type)]
    lib.noahmp_column_host.restype = ctypes.c_int
    return lib


def oracle_witness(params, cfg, static, forcing, state, plain, host, point):
    """The serial C++ reference column at ``point`` from ``state`` and
    ``forcing``, held against two other steps' (State, Flux) there: each
    State field's |oracle - other| over FUZZ_TIGHT, fsh, and which of the
    two it comes closer to."""
    sd, fl = native.step_column(params, cfg.options, static, forcing, state,
                                point, cfg.dt)
    out = {"point": int(point), "land_use": int(static.lutyp[point])}
    worst = {}
    for label, (s_new, flux) in (("column_plain", plain), ("host_build",
                                                           host)):
        shares = {name: float(np.max(np.abs(
            np.asarray(sd[name], np.float64)
            - getattr(s_new, name)[point].double().numpy())) / tight)
            for name, tight in FUZZ_TIGHT.items()}
        out[f"share_of_tight_{label}"] = shares
        out[f"fsh_{label}"] = float(flux.fsh[point])
        worst[label] = max(shares.values())
    out["fsh_oracle"] = fl["fsh"]
    out["sides_with"] = min(worst, key=worst.get)
    return out


def cpu_conditioning(n=N_OFFLINE_CPU, steps=12, free_draws=3):
    """Where the figures behind EXIT_VARIANTS, ONE_ULP_DRAWS,
    UNEXPLAINED_* and FREE_RUN_* come from, on the CPU, no card: the
    generated CONUS case at ``n`` points.  column_plain against itself
    from a State whose tv moved by one ulp (the first step); the host
    build of the kernels against column_plain over ``steps`` steps along
    column_plain's trajectory, the points outside explained or not by
    the exit variants alone and with the one-ulp draws; the offline run
    against itself from an initial tg moved by one ulp (``free_draws``
    draws, OFFLINE_CPU_HOURS).  One JSON line a part; never ok."""
    work = tempfile.mkdtemp(prefix="noahmp_conditioning_")
    try:
        case = write_case(n, 1, work)
        cfg = offline_cfg(case, "x", OFFLINE_CPU_HOURS)
        static = driver_io.load_domain(cfg.constfile, "cpu")
        static_host = driver_io.static_to_host(static)
        params = load_params(cfg.veg_scheme, cfg.soil_scheme, device="cpu")
        fused = make_fused_step(params, cfg.options, cfg.dt, static,
                                device="cpu")

        def plain(forcing, state):
            return fused(None, forcing, state)

        lib = host_column_library(work)
        plan = column.ColumnPlan(fused.gathered, cfg.options, cfg.dt, static,
                                 need_cuda=False)
        state = driver_io.load_init(cfg.initfile, n, "cpu")
        forcing = file_forcing(cfg, static_host, cfg.begdatetime, "cpu")
        ratio, by_leaf = point_step_ratios(
            plain(forcing, state),
            plain(forcing, state._replace(tv=nudged(state.tv, SEED))))
        counts = {k: int((r > 1.0).sum()) for k, r in by_leaf.items()}
        emit("conditioning_one_ulp_tv", n=n,
             points_outside=int((ratio > 1.0).sum()),
             worst_ratio=float(ratio.max()),
             most_outside_in=sorted(counts, key=counts.get)[-4:],
             note="column_plain against itself, State.tv moved by one ulp, "
                  "the step's bars per point")
        by_exit, full, witnessed = [], [], []
        for k in range(steps):
            forcing = file_forcing(cfg, static_host,
                                   cfg.begdatetime + k * cfg.timestep, "cpu")
            ref = plain(forcing, state)
            args = plan.point_to(forcing, state)
            got = plan.outputs()
            if lib.noahmp_column_host(ctypes.byref(args)) != 0:
                raise RuntimeError("the host build failed")
            lutyp = static_host.lutyp
            by_exit.append({"step": k, **judge_resynced(
                plain, forcing, state, ref, got, lutyp, draws=0)})
            full.append({"step": k, **judge_resynced(
                plain, forcing, state, ref, got, lutyp)})
            witnessed += [{"step": k, **oracle_witness(
                params, cfg, static, forcing, state, ref, got, point)}
                for point in full[-1]["unexplained_points"]]
            state = ref[0]
        emit("conditioning_host_build", n=n, steps=steps,
             exit_variants_alone=resynced_summary(by_exit),
             with_one_ulp_draws=resynced_summary(full),
             note="the host build of the kernels (csrc/column_host.cpp) "
                  "against column_plain, each step from column_plain's State")
        emit("conditioning_oracle", points=witnessed,
             note="at each point the host build leaves unexplained, the "
                  "serial C++ reference column from the same State and "
                  "Forcing: |oracle - column_plain| and |oracle - host "
                  "build| over FUZZ_TIGHT by State field, and fsh (the "
                  "oracle has no shg)")
        ref = driver_run.run_offline(cfg, verbose=False, device="cpu")
        init = driver_io.load_init(cfg.initfile, n, "cpu")
        draws = []
        for d in range(free_draws):
            other = driver_run.run_offline(
                offline_cfg(case, f"nudged_{d}", OFFLINE_CPU_HOURS),
                verbose=False, device="cpu",
                state=init._replace(tg=nudged(init.tg, SEED + d)))
            draws.append(free_run_summary(free_run_table(ref, other, 12,
                                                         cfg.nsteps)))
        emit("conditioning_free_run", n=n, hours=OFFLINE_CPU_HOURS,
             draws=draws,
             note="the offline run against itself from an initial tg moved "
                  "by one ulp, cases.point_ratios with the steps run so far")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("cpu conditioning finished; this is not a result", file=sys.stderr)
    return 3


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
    phase_carbon(params, params, device, 16, 2, n_cpu=8)
    phase_chunk(params, device, 16, 6, 2, 3)
    phase_strict(params, device, 16, 6, 3, 3)
    work = tempfile.mkdtemp(prefix="noahmp_offline_")
    try:
        case, _launches, _out = phase_offline_case(params, device, 64, 1, work,
                                                   out_hours=1, hours=2)
        phase_offline_forcing(device, case, 64, 2)
        phase_offline_kernel_agreement(params, device, case, 64)
        dist_one = phase_dist_one_rank(params, device, case, 64, 2)
        phase_dist_two_ranks(device, case, 64, 2, dist_one)
        shutil.rmtree(case)
        phase_offline_large(device, 64, 2, work, None, out_hours=1)
        phase_offline_cpu_agreement(device, 64, 2, work, out_hours=1)
        phase_native_oracle(params, device, work, None, copies=2,
                            fuzz_steps=2, eager_steps=1, n_conus=4096,
                            conus_steps=2, day_hours=2, n_bench=64)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    with tempfile.TemporaryDirectory(prefix="column_host_") as tmp:
        builds = []
        for name, defines in (("split", ()), ("one_pass", (ONE_PASS_DEFINE,))):
            os.makedirs(os.path.join(tmp, name))
            host_column_library(os.path.join(tmp, name), *defines)
            builds.append(ColumnBuild(name, os.path.join(
                tmp, name, "libcolumn_host.so"), False))
        phase_canopy_split(params, device, builds, n=256, span=8,
                           hours=(0, 1))
    emit("rehearsal_carbon_operations", **carbon_operations(params))
    static, forcing, state = to_device(uniform_case(N_OPS), device)
    fused = make_fused_step(params, Options(), DT, static, device="cpu")
    emit("rehearsal_bound", **column_bound(params, fused.gathered, static,
                                           forcing, state, N_OPS, None, None))
    print("cpu rehearsal finished; this is not a result", file=sys.stderr)
    return 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true")
    ap.add_argument("--cpu-conditioning", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if args.cpu_rehearsal:
        return cpu_rehearsal()
    if args.cpu_conditioning:
        return cpu_conditioning()
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

    # the fused path and the column kernels it launches
    column_launches = phase_fused_step(params, device, N_POINTS, N_STEPS)
    phase_fused_cpu_agreement(params, params_cpu, device)
    chen97 = phase_fused_options(params, device, N_OPTIONS)
    phase_no_sync(step, params, device, N_POINTS)

    # the further paths: carbon through both steps, the multi-step
    # entry points over both steps
    carbon_launches = phase_carbon(params, params_cpu, device, N_POINTS,
                                   N_STEPS)
    chunk_launches = phase_chunk(params, device, N_POINTS, T_CHUNK,
                                 T_CHUNK_EAGER, T_SIMULATE)
    phase_strict(params, device, N_POINTS, T_STRICT, BAD_AT, T_CHUNK_EAGER)
    phase_chunk_no_sync(params, device, N_POINTS)

    weights, clock_mhz = phase_issue_weights(device)
    timing = phase_timing(params, params_cpu, step, device, N_POINTS,
                          weights, clock_mhz)
    chunk_timing = phase_chunk_timing(params, device, N_POINTS, T_CHUNK)
    # the canopy loop in passes against one pass, on the spin-up cell's
    # domain at its traced time of year
    canopy = phase_canopy_split(params, device, (
        ColumnBuild("split"),
        ColumnBuild("one_pass", one_pass_library_path())))

    # the offline driver: the generated CONUS case through the CLI, a
    # resume, exact and compact forcing, the kernels against their plain
    # version on that domain, 1M points, card against CPU
    work = tempfile.mkdtemp(prefix="noahmp_offline_")
    try:
        case, offline_launches, offline = phase_offline_case(
            params, device, N_OFFLINE, OFFLINE_DAYS, work)
        offline_forcing = phase_offline_forcing(device, case, N_OFFLINE,
                                                OFFLINE_FORCING_HOURS)
        phase_offline_kernel_agreement(params, device, case, N_OFFLINE)
        # the land-point axis over torch.distributed ranks on that case
        dist_one = phase_dist_one_rank(params, device, case, N_OFFLINE,
                                       DIST_HOURS)
        dist_two = phase_dist_two_ranks(device, case, N_OFFLINE, DIST_HOURS,
                                        dist_one)
        shutil.rmtree(case)
        offline_large = phase_offline_large(device, N_LARGE,
                                            OFFLINE_LARGE_HOURS, work,
                                            timing["ms_large"])
        phase_offline_cpu_agreement(device, N_OFFLINE_CPU, OFFLINE_CPU_HOURS,
                                    work)
        # both steps against the serial C++ reference column, and the
        # reference's own rate on this host
        oracle = phase_native_oracle(params, device, work,
                                     timing["free_running_ms"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the port's measured entry points (BENCHMARK.json), cut to a size
    bench_launches = phase_bench_cells(device)
    if args.profile:
        phase_profile(step, device, N_POINTS, args.profile)
    if args.sweep:
        phase_sweep(params, step, device)

    for entry in entries:
        rows = entry["shape"][1]
        entry["launches"] = launches[rows]
        entry["launches_carbon_path"] = carbon_launches["thomas"][rows]
        entry["launches_chunk_path"] = chunk_launches["thomas"][rows]
        entry["launches_native_path"] = oracle["launches"]["thomas"][rows]
        entry["launches_bench_path"] = bench_launches["thomas"].get(rows, 0)
        entry.update(native_fields(oracle["totals"]["make_step"]))
        entry["timing"] += (
            "; native_*: phase native_oracle, the eager step (make_step, "
            f"which launches this kernel) on {len(NATIVE_EAGER_COMBOS)} "
            f"option sets x {NATIVE_EAGER_STEPS} steps x "
            f"{10 * NATIVE_COPIES} fuzz points against the serial C++ "
            "reference column, each step from the same State: "
            "native_outliers of native_point_steps beyond FUZZ_TIGHT, "
            "native_crossings beyond FUZZ_CAP or with nsnow changed "
            "(native_crossings_of_jax: the JAX step's own on the same sets "
            "and steps; a set passes within counting noise of its count), "
            "native_max_share_of_tight the worst |step - oracle| over "
            "FUZZ_TIGHT")
    entries.append({
        "name": "column_cuda", "route": "cuda",
        "source": "noahmp_tpu_torch/csrc/column.cu",
        "replaces": "noahmp_tpu/pallas/column.py:127",
        "shape": [N_POINTS], "launches": column_launches,
        "launches_carbon_path": carbon_launches["column"],
        "launches_chunk_path": chunk_launches["column"],
        "launches_offline_path": offline_launches["column"],
        "launches_dist_path": dist_one["launches"],
        "launches_native_path": oracle["launches"]["column"],
        "launches_bench_path": bench_launches["column"],
        "launches_per_step": column.device_launches(N_POINTS),
        "max_abs_err": worst[0],
        "max_abs_err_at": f"{worst[1]}: {worst[2]}",
        "max_share_of_bar": worst[3],
        "chen97_fixed_carry_share_of_bar": chen97,
        "ms": timing["ms"], "ms_isolated": timing["ms_isolated"],
        "ms_1m": timing["ms_large"],
        "ms_hetero_cold_snow": timing["ms_hetero_cold_snow"],
        "ms_opt_veg_2": timing["ms_veg2"],
        "water_stage_ms_opt_veg_2": timing["water_ms_veg2"],
        "opt_veg_2": timing["carbon_ops"],
        "stages": [{**attr, "ms": timing["stage_ms"][attr["stage"]]}
                   for attr in attrs],
        "canopy_pass_ends": canopy["pass_ends"],
        "canopy_second_pass_share": canopy["second_pass_share"],
        "canopy_without_canopy_share": canopy["without_canopy_share"],
        "canopy_flux_stage_ms": canopy["split_flux_stage_ms"],
        "one_pass_flux_stage_ms": canopy["one_pass_flux_stage_ms"],
        "canopy_1m_ms": canopy["split_step_ms"],
        "one_pass_1m_ms": canopy["one_pass_step_ms"],
        "chunk_ms_per_step": chunk_timing["chunk"]["ms_per_step"],
        "chunk_host_enqueue_ms_per_step":
            chunk_timing["chunk"]["host_enqueue_ms_per_step"],
        "chunk_no_accumulators_ms_per_step":
            chunk_timing["chunk_no_accumulators"]["ms_per_step"],
        "strict_ms_per_step": chunk_timing["strict_chunk"]["ms_per_step"],
        "offline_ms_per_step": offline["ms_per_step"],
        "offline_point_steps_per_s": offline["point_steps_per_s"],
        "offline_kernel_ms_per_step": offline["kernel_ms_per_step"],
        "offline_exact_ms_per_step": offline_forcing["exact"]["ms_per_step"],
        "offline_compact_ms_per_step":
            offline_forcing["compact"]["ms_per_step"],
        "offline_1m_ms_per_step": offline_large["ms_per_step"],
        "dist_one_rank_ms_per_step": dist_one["ms_per_step"],
        "dist_without_mesh_ms_per_step": dist_one["plain_ms_per_step"],
        "dist_two_ranks_one_card_ms_per_step": dist_two["ms_per_step"],
        "native_point_steps_per_s_1_thread": oracle["rate_1_thread"],
        "native_point_steps_per_s_all_threads": oracle["rate_all_threads"],
        "native_threads": oracle["threads"],
        **native_fields(oracle["totals"]["column_cuda"]),
        "step_wall_ms": timing["wall_ms"],
        "host_share_ms": timing["wall_ms"] - timing["ms"],
        "host_enqueue_ms": timing["host_enqueue_ms"],
        "free_running_ms_per_step": timing["free_running_ms"],
        "plain_ms": timing["plain_ms"],
        "plain_wall_ms": timing["plain_wall_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "issue_ms": timing["issue_ms"],
        "issue_clock_mhz": timing["issue_clock_mhz"],
        "bytes_per_point": timing["bytes_per_point"],
        "bytes_ms": timing["bytes_ms"],
        "kernel_bytes_per_point": timing["kernel_bytes_per_point"],
        "scratch_bytes_per_point": timing["scratch_bytes_per_point"],
        "operations_per_point": timing["operations_per_point"],
        "operations_ms": timing["operations_ms"],
        "operations_by_stage": timing["operations_by_stage"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes a land-surface "
                   "model step",
        "build_seconds": round(build_seconds, 3),
        "timing": "ms: CUDA events around 20 steps queued back to back, "
                  "median of 5, three input sets walked in turn (cold in "
                  "L2), uniform case; ms_1m: the same at n = 1,048,576, two "
                  "sets; ms_hetero_cold_snow: the same on hetero/cold_snow; "
                  "ms_opt_veg_2 and water_stage_ms_opt_veg_2: the step and "
                  "its water stage with the carbon branch on, same call; "
                  "chunk_ms_per_step and strict_ms_per_step: host clock over "
                  f"one chunk of {T_CHUNK} steps with the {len(CHUNK_ACC)} "
                  "accumulators of an offline run, median of 5, in turns with "
                  "the free-running steps (phase chunk_timing); "
                  "offline_*: the offline driver's loop on the host clock "
                  f"(phases offline_case at n = {N_OFFLINE}, exact forcing; "
                  "offline_forcing, exact and compact in turns; "
                  f"offline_large at n = {N_LARGE}, compact), "
                  "offline_kernel_ms_per_step the kernels alone on that "
                  "domain (CUDA events); dist_*: the same loop over "
                  f"{DIST_HOURS} hours of that case, a one-rank NCCL mesh, "
                  "no mesh, and two gloo ranks sharing the one card and "
                  "host (rank 0's loop; no scaling figure); "
                  "native_*: phase native_oracle, the serial C++ reference "
                  "column (g++ -O2 -fopenmp, on the host): "
                  "native_point_steps_per_s_*: bench_native on the uniform "
                  f"case at n = {N_POINTS}, {NATIVE_BENCH_STEPS} timed steps "
                  "after a warm one, host clock, at 1 and native_threads "
                  "OpenMP threads (null: built without OpenMP); "
                  "native_outliers of native_point_steps: the fused "
                  f"step's (column_cuda on {len(FUZZ_COMBOS)} option sets "
                  f"x {NATIVE_FUZZ_STEPS} steps x {10 * NATIVE_COPIES} fuzz "
                  f"points and 2 x {NATIVE_CONUS_STEPS} steps x "
                  f"{N_OFFLINE_CPU} CONUS points), each from the same State "
                  "as the oracle's, beyond FUZZ_TIGHT; native_crossings: "
                  "beyond FUZZ_CAP or with nsnow changed "
                  "(native_crossings_of_jax: the JAX step's own on the same "
                  "fuzz sets and steps; a set passes within counting noise "
                  "of its count, CONUS with none); "
                  "native_max_share_of_tight: the worst |card - oracle| "
                  "over FUZZ_TIGHT (the eager step's: on the thomas_cuda "
                  "entries); "
                  "stages[].ms: the kernel's stage alone, back to back "
                  "with itself; canopy_*, one_pass_*: phase canopy_split, "
                  f"n = {N_LARGE} of the spin-up cell's domain after its "
                  f"{SPLIT_SPAN} steps, at hours {list(SPLIT_HOURS)} of the "
                  "next day, the build with the canopy loop in passes and "
                  f"the one built with {ONE_PASS_DEFINE} in turns (CUDA "
                  "events, 20 launches back to back, median of 5, mean over "
                  "the hours): the flux stage alone and the whole step "
                  "(canopy_1m_ms, one_pass_1m_ms), and the share of points "
                  "entering each later pass; "
                  "plain_ms: summed device time of the eager step's kernels "
                  "(torch.profiler); plain_wall_ms and step_wall_ms: host "
                  "clock, median of 7, in turns; host_share_ms: "
                  "step_wall_ms - ms; host_enqueue_ms and "
                  "free_running_ms_per_step: host time to enqueue a step, "
                  "and time a step, over 50 chained steps with one "
                  "synchronise at the end; issue_ms: operations weighted "
                  "by their measured issue slots over 132 x 4 x 32 lanes at "
                  "issue_clock_mhz; max_abs_err is |a-b|/max(1,|a|) against "
                  "column_plain",
    })
    for entry in entries:
        keys = ["launches", "launches_carbon_path", "launches_chunk_path",
                "launches_native_path"]
        if entry["name"] == "column_cuda":
            # the offline and dist paths run the fused step only: no
            # Thomas launch
            keys += ["launches_offline_path", "launches_dist_path",
                     "launches_bench_path"]
        for key in keys:
            if entry[key] <= 0:
                raise AssertionError(f"{entry['name']}: {key} = "
                                     f"{entry[key]}, a path did not launch "
                                     "the kernel")
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
