"""The port's ``dist/`` over two gloo ranks on the CPU: the sharded step,
the offline driver under a mesh (``driver/multihost.py``), DCP
checkpoints, strict mode over ranks, against one-process runs of the
port.  No JAX compile: the JAX package serves only its numpy
``merge_shard_files``.

Every multi-process run is a group of fresh processes started by the
module's fixture, all groups at once: this file run as a script (the
worker scenarios at the bottom) or ``python -m
noahmp_tpu_torch.driver.multihost``.  Each group meets on a free port of
its own (six xdist workers run side by side), each process carries a
``subprocess`` timeout and each process group a timeout of its own, so a
lost or hung rank fails the test instead of hanging it.

Every process, the one-process references included, runs with
``ATEN_CPU_CAPABILITY=default``.  PyTorch's CPU kernels compute a
transcendental function (``exp``, ``log``, ``pow``) with a vector routine
in the body of a loop and with the scalar C library in its tail (32
float32 lanes a trip under AVX-512), so under the machine's own dispatch
the plain step's last bit at a point depends on where the point sits in
its block: 16 points a rank against 32 in one process part at a few
points, within the step's bars (``test_cpu_block_parts_within_bars``).
The default dispatch computes every lane with the scalar routine, so
that the bits say whether the decomposition itself (slicing, the
forcing's row ranges, shard files, the merge, the strict flag) is exact.
On the card there is nothing to pin: ``column_cuda`` is one thread a
point (``chip_smoke.py``, phases ``dist_*``).
"""

import datetime
import filecmp
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:            # run as a worker script
    sys.path.insert(0, ROOT)

from noahmp_tpu_torch import Options, load_params  # noqa: E402
from noahmp_tpu_torch.cases import (FLUX_BAR, FLUX_CEILING,  # noqa: E402
                                    STATE_BAR, STATE_CEILING, bar_ratio,
                                    conus_case, forcing_sequence,
                                    hetero_case, to_device)
from noahmp_tpu_torch.convert import tree_from_numpy  # noqa: E402
from noahmp_tpu_torch.driver import io as tio  # noqa: E402
from noahmp_tpu_torch.driver.step import (make_chunk_step,  # noqa: E402
                                          make_fused_step, make_step)
from noahmp_tpu_torch.state import Forcing, State, Static  # noqa: E402

N = 32
WORLD = 2
HOURS = 6
DT = 900.0
CORRUPT_SOLDN = 1.0e7        # W/m2: breaks the budgets by rounding alone
CORRUPT_HOUR = 1             # the forcing file of rank 1's corrupt rows
PROCESS_TIMEOUT = 240        # seconds, a process
GROUP_TIMEOUT = 60           # seconds a collective waits for a peer
LOST_PEER_TIMEOUT = 5
REGIMES_CHECKED = ("warm_day", "cold_snow")
STRICT_STEPS, STRICT_AT = 6, 3


# --------------------------------------------------------------------
# the worker scenarios (this file run as a script, one process a rank)
# --------------------------------------------------------------------

def _worker_mesh():
    from noahmp_tpu_torch.dist.mesh import init_distributed, make_mesh
    init_distributed(backend="gloo", timeout=GROUP_TIMEOUT)
    return make_mesh("cpu", timeout=GROUP_TIMEOUT)


def _bits_equal(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def worker_step(out):
    """The sharded step and the strict chunk over the mesh against the
    one-process steps, computed in this process over every point."""
    import torch.distributed as dist
    from noahmp_tpu_torch.dist.mesh import (make_sharded_step, process_slice,
                                            replicate, shard_batch)
    mesh = _worker_mesh()
    lo, hi = process_slice(mesh, N)
    report = {"rank": dist.get_rank(), "slice": [lo, hi],
              "slice_of_8": list(process_slice(mesh, 8))}
    try:
        process_slice(mesh, N + 1)
        report["refuses_ragged"] = False
    except ValueError:
        report["refuses_ragged"] = True
    params = load_params(device="cpu")
    report["replicated_params"] = replicate(params, mesh) is params
    checks = {}
    for regime in REGIMES_CHECKED:
        case = hetero_case(regime, N)
        static, forcing, state = to_device(case, "cpu")
        local = [shard_batch(tree_from_numpy(cls, leaves, "cpu"), mesh)
                 for cls, leaves in zip((Static, Forcing, State), case)]
        numpy_local = shard_batch(Static(**case[0]), mesh)
        checks[f"{regime}/shard_batch"] = all(
            torch.equal(a, b[lo:hi]) and a.is_contiguous()
            for a, b in zip(local[0], static)) and all(
            torch.equal(a, b) for a, b in zip(numpy_local, local[0]))
        for path in ("eager", "fused"):
            if path == "eager":
                whole = make_step(params, Options(), DT, device="cpu")
                built = {}
            else:
                whole = make_fused_step(params, Options(), DT, static,
                                        device="cpu")
                built = {"static": local[0]}
            sharded = make_sharded_step(params, Options(), DT, mesh, **built)
            ref_s, ref_f = whole(static, forcing, state)
            got_s, got_f, diag = sharded(*local)
            checks[f"{regime}/{path}/bits"] = all(
                _bits_equal(a[lo:hi], b) for a, b in
                zip(tuple(ref_s) + tuple(ref_f), tuple(got_s) + tuple(got_f)))
            peaks = [float(getattr(ref_f, f).abs().max())
                     for f in ("errsw", "erreng", "errwat")]
            means = [float(getattr(ref_f, f).double().mean())
                     for f in ("fsh", "fsa")]
            checks[f"{regime}/{path}/max_equal"] = peaks == [
                float(v) for v in diag[:3]]
            checks[f"{regime}/{path}/mean_rel"] = max(
                abs(float(g) - r) / max(abs(r), 1e-30)
                for g, r in zip(diag[3:], means))
    # strict: a corrupt shortwave record on rank 1's rows only
    case = hetero_case("warm_day", N)
    seq = forcing_sequence(case[1], STRICT_STEPS)
    seq["soldn"][STRICT_AT, N // WORLD:] = CORRUPT_SOLDN
    static, _f, state = to_device(case, "cpu")
    forcings = tree_from_numpy(Forcing, seq, "cpu")
    spec = (("fsh", "sum"), ("errsw", "absmax"))
    whole = make_chunk_step(params, Options(), DT, spec, strict_budgets=True,
                            static=static, device="cpu")
    ref_s, ref_acc, ref_bad = whole(static, forcings, state,
                                    [torch.zeros(N) for _ in spec])
    local_static = shard_batch(static, mesh)
    chunk = make_chunk_step(params, Options(), DT, spec, strict_budgets=True,
                            static=local_static, mesh=mesh)
    local_forcings = Forcing(*[leaf[:, lo:hi].contiguous()
                               for leaf in forcings])
    got_s, got_acc, got_bad = chunk(local_static, local_forcings,
                                    shard_batch(state, mesh),
                                    [torch.zeros(hi - lo) for _ in spec])
    report["strict"] = {"bad_step": int(got_bad), "one_process": int(ref_bad),
                        "bits": all(_bits_equal(a[lo:hi], b) for a, b in zip(
                            tuple(ref_s) + tuple(ref_acc),
                            tuple(got_s) + tuple(got_acc)))}
    report["checks"] = checks
    with open(out, "w") as fh:
        json.dump(report, fh)
    dist.destroy_process_group()


def worker_dcp(directory, out):
    """Checkpoints of a State whose rows differ from rank to rank."""
    import torch.distributed as dist
    from noahmp_tpu_torch.dist.checkpoint import CheckpointManager
    from noahmp_tpu_torch.dist.mesh import shard_batch
    from noahmp_tpu_torch.state import init_state
    mesh = _worker_mesh()
    whole = [init_state(N, device="cpu") for _ in range(3)]
    for k, st in enumerate(whole):
        st.tg.copy_(torch.arange(N, dtype=torch.float32) + 100.0 * k)
        st.nsnow.copy_(torch.arange(N, dtype=torch.int32) % 4)
        st.stc.copy_(torch.arange(N * 7, dtype=torch.float32).reshape(N, 7))
    local = [shard_batch(st, mesh) for st in whole]
    mgr = CheckpointManager(directory, max_to_keep=2, mesh=mesh)
    mgr.save(10, local[0], wait=True)
    mgr.save(20, local[1])                  # async
    mgr.save(30, local[2])
    mgr.close()
    mgr = CheckpointManager(directory, max_to_keep=2, mesh=mesh)
    got = mgr.restore(template=local[0])
    older = mgr.restore(20, template=local[0])
    full = mgr.restore(30)
    report = {
        "rank": dist.get_rank(), "steps": mgr.all_steps(),
        "latest": mgr.latest_step(),
        "own_rows": all(torch.equal(a, b) for a, b in zip(got, local[2])),
        "older_rows": all(torch.equal(a, b) for a, b in zip(older, local[1])),
        "full_state": all(torch.equal(a, b) for a, b in zip(full, whole[2])),
        "first_tg": float(got.tg[0])}
    mgr.close()
    try:
        CheckpointManager(directory + "_plain")
        report["refuses_no_mesh"] = False
    except ValueError:
        report["refuses_no_mesh"] = True
    with open(out, "w") as fh:
        json.dump(report, fh)
    dist.destroy_process_group()


def worker_reference(nml, strict_nml, out):
    """The one-process runs of the port: the case, and its strict run
    with rank 1's rows corrupt (the State it stopped at as a restart)."""
    from noahmp_tpu_torch.driver.config import Config
    from noahmp_tpu_torch.driver.run import run_offline
    from noahmp_tpu_torch.utils import ConservationError
    cfg = Config.from_namelist(nml)
    run_offline(cfg, verbose=False, device="cpu")
    cfg = Config.from_namelist(strict_nml)
    report = {}
    try:
        run_offline(cfg, verbose=False, device="cpu",
                    check_budgets_every="strict")
    except ConservationError as err:
        tio.save_restart(os.path.join(cfg.resdir, "abort.nc"), err.state,
                         err.when)
        report = {"abort_step": err.step, "abort_time": err.when.isoformat()}
    with open(out, "w") as fh:
        json.dump(report, fh)


# --------------------------------------------------------------------
# the test side
# --------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(rank=None, world=WORLD, port=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=ROOT, ATEN_CPU_CAPABILITY="default",
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
    return env


class Group:
    """Processes started together; ``wait`` gives each one's (code,
    output), killing any that outlives its timeout."""

    def __init__(self, argv, ranks=WORLD, world=WORLD, cwd=ROOT):
        port = _free_port()
        self.procs = [subprocess.Popen(
            argv, cwd=cwd, env=_env(r, world, port) if ranks else _env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(max(ranks, 1))]
        self.started = time.monotonic()
        self._done = None

    def wait(self):
        if self._done is None:
            self._done = []
            for p in self.procs:
                left = PROCESS_TIMEOUT - (time.monotonic() - self.started)
                try:
                    out, _ = p.communicate(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    out += "\n<killed at the process timeout>"
                self._done.append((p.returncode, out))
        return self._done

    def ok(self):
        for code, out in self.wait():
            assert code == 0, out[-4000:]
        return self


def _multihost(nml, *extra):
    return [sys.executable, "-m", "noahmp_tpu_torch.driver.multihost", nml,
            "--backend", "gloo", "--device", "cpu",
            "--timeout", str(GROUP_TIMEOUT), *extra]


def _script(*args):
    return [sys.executable, os.path.abspath(__file__), *args]


def write_nml(case, tag, hours=HOURS, restart=False, indir=None,
              domain=True, out_hours=3):
    """A copy of the case's namelist: outputs under ``tag`` every
    ``out_hours``, restarts every 3 hours, ``hours`` model hours;
    ``domain=False`` points the domain, init and forcing at nothing (a
    synthetic domain)."""
    with open(os.path.join(case, "case.nml")) as fh:
        text = fh.read()
    out = os.path.join(case, tag)
    for sub in ("ldasout", "restart"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    sub = {"output_directory": os.path.join(out, "ldasout"),
           "restart_directory": os.path.join(out, "restart"),
           "restart_frequency": "3 hour",
           "output_frequency": f"{out_hours} hour"}
    if indir is not None:
        sub["input_directory"] = indir
    if not domain:
        for key in ("static_parameter_file", "initialization_file",
                    "input_directory"):
            sub[key] = os.path.join(out, "absent")
    for key, value in sub.items():
        text = re.sub(rf"{key} = '[^']*'", f"{key} = '{value}'", text)
    end = datetime.datetime(2000, 7, 1) + datetime.timedelta(hours=hours)
    for key in ("day", "hour"):
        text = re.sub(rf"end_{key}\s*= \d+",
                      f"end_{key} = {getattr(end, key)}", text)
    if restart:
        text = text.replace("&NOAHMP_OFFLINE", "&NOAHMP_OFFLINE\n  restart = "
                            ".true.", 1)
    path = os.path.join(case, f"{tag}_{hours}h{'_restart' if restart else ''}"
                              ".nml")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def corrupt_forcing(case):
    """A copy of the forcing whose hour-CORRUPT_HOUR file carries a
    corrupt shortwave record on rank 1's rows only."""
    indir = os.path.join(case, "ldasin_corrupt")
    shutil.copytree(os.path.join(case, "ldasin"), indir)
    path = os.path.join(indir, f"20000701{CORRUPT_HOUR:02d}.nc")
    arrays = tio.load_arrays(path)
    arrays["soldn"] = np.array(arrays["soldn"], np.float32)
    arrays["soldn"][N // WORLD:] = CORRUPT_SOLDN
    tio.save_arrays(path, arrays)
    return indir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of processes, started at once; later groups that
    depend on an earlier one start when it has ended."""
    case = conus_case(N, seed=1, days=1,
                      outdir=str(tmp_path_factory.mktemp("dist") / "conus32"))
    nml = {tag: write_nml(case, tag) for tag in ("one", "two")}
    nml["first"] = write_nml(case, "resume", hours=HOURS // 2)
    nml["resume"] = write_nml(case, "resume", restart=True)
    indir = corrupt_forcing(case)
    nml["strict_one"] = write_nml(case, "strict_one", indir=indir)
    nml["strict_two"] = write_nml(case, "strict_two", indir=indir)
    nml["padded"] = write_nml(case, "padded", hours=1, domain=False,
                              out_hours=1)
    out = os.path.join(case, "json")
    os.makedirs(out)
    groups = {
        "step": Group(_script("step", os.path.join(out, "step{}.json"))),
        "dcp": Group(_script("dcp", os.path.join(case, "dcp"),
                             os.path.join(out, "dcp{}.json"))),
        "two": Group(_multihost(nml["two"])),
        "first": Group(_multihost(nml["first"])),
        "strict": Group(_multihost(nml["strict_two"], "--check-budgets",
                                   "strict")),
        "padded": Group(_multihost(nml["padded"], "--points", "33")),
        "reference": Group(_script("reference", nml["one"],
                                   nml["strict_one"],
                                   os.path.join(out, "reference.json")),
                           ranks=0),
        # rank 0 of two, its peer never comes: it must fail, not hang
        "lost_peer": Group(_multihost(nml["padded"]) + [
            "--timeout", str(LOST_PEER_TIMEOUT)], ranks=1),
    }
    groups["first"].ok()
    groups["resume"] = Group(_multihost(nml["resume"]))
    return case, out, groups


def _json(out, name):
    with open(os.path.join(out, name)) as fh:
        return json.load(fh)


def _rank_reports(runs, group, name):
    case, out, groups = runs
    groups[group].ok()
    return [_json(out, name.format(r)) for r in range(WORLD)]


class _Mesh:
    """What process_slice reads of a mesh."""

    def __init__(self, rank, world):
        self._rank, self._world = rank, world

    def size(self):
        return self._world

    def get_local_rank(self, _dim=None):
        return self._rank


@pytest.mark.parametrize("world", [1, 2, 4])
def test_process_slice_blocks(world):
    from noahmp_tpu_torch.dist.mesh import process_slice
    blocks = [process_slice(_Mesh(r, world), 32) for r in range(world)]
    assert blocks[0][0] == 0 and blocks[-1][1] == 32
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert {hi - lo for lo, hi in blocks} == {32 // world}
    with pytest.raises(ValueError, match="not divisible"):
        process_slice(_Mesh(0, 3 * world), 32)


def test_process_slice_refuses_ragged_n():
    from noahmp_tpu_torch.dist.mesh import process_slice
    with pytest.raises(ValueError, match="n=33 not divisible by 2"):
        process_slice(_Mesh(1, 2), 33)


def test_one_process_mesh_without_a_group():
    """In one process with no group, ``make_mesh`` spans that process
    alone (a one-rank gloo group over an in-process store); without a
    card ``make_mesh()`` raises before it makes any group."""
    import torch.distributed as dist
    from noahmp_tpu_torch.dist.mesh import (make_mesh, mesh_device,
                                            process_slice, shard_batch)
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        assert not dist.is_initialized()
    try:
        mesh = make_mesh("cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("points",)
        assert mesh_device(mesh) == torch.device("cpu")
        assert process_slice(mesh, 5) == (0, 5)
        static = Static(**hetero_case("warm_day", 8)[0])
        assert all(torch.equal(a, torch.from_numpy(np.asarray(b)))
                   for a, b in zip(shard_batch(static, mesh), static))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_shard_batch_and_replicate_over_two_ranks(runs):
    reports = _rank_reports(runs, "step", "step{}.json")
    assert [r["slice"] for r in reports] == [[0, 16], [16, 32]]
    assert [r["slice_of_8"] for r in reports] == [[0, 4], [4, 8]]
    for r in reports:
        assert r["refuses_ragged"] and r["replicated_params"]
        for regime in REGIMES_CHECKED:
            assert r["checks"][f"{regime}/shard_batch"], (r["rank"], regime)


@pytest.mark.parametrize("path", ["eager", "fused"])
def test_sharded_step_bit_equal_to_one_process(runs, path):
    for r in _rank_reports(runs, "step", "step{}.json"):
        for regime in REGIMES_CHECKED:
            assert r["checks"][f"{regime}/{path}/bits"], (r["rank"], regime)


@pytest.mark.parametrize("path", ["eager", "fused"])
def test_sharded_step_diagnostics(runs, path):
    """The three maxima equal the one-process flux's; the two means
    within 1e-6 relative of its float64 means."""
    for r in _rank_reports(runs, "step", "step{}.json"):
        for regime in REGIMES_CHECKED:
            assert r["checks"][f"{regime}/{path}/max_equal"], r["rank"]
            assert r["checks"][f"{regime}/{path}/mean_rel"] <= 1e-6


def test_strict_chunk_violation_on_one_rank(runs):
    """A corrupt record on rank 1's rows: both ranks stop after the same
    step, the one-process chunk's, with its bits."""
    for r in _rank_reports(runs, "step", "step{}.json"):
        assert r["strict"]["one_process"] == STRICT_AT
        assert r["strict"]["bad_step"] == STRICT_AT, r["rank"]
        assert r["strict"]["bits"], r["rank"]


def _ldasout(case, tag):
    d = os.path.join(case, tag, "ldasout")
    return sorted(f for f in os.listdir(d) if f.endswith(".nc"))


def test_offline_two_ranks_merged_ldasout_bit_equal(runs):
    case, _out, groups = runs
    groups["two"].ok()
    groups["reference"].ok()
    files = _ldasout(case, "one")
    assert files == ["200007010300.nc", "200007010600.nc"]
    assert _ldasout(case, "two") == files
    for f in files:
        assert filecmp.cmp(os.path.join(case, "one", "ldasout", f),
                           os.path.join(case, "two", "ldasout", f),
                           shallow=False), f
    shards = [f for f in os.listdir(os.path.join(case, "two", "ldasout"))
              if ".nc.p" in f]
    assert len(shards) == WORLD * len(files)


def _restart_state(case, tag, name):
    return tio.load_restart(os.path.join(case, tag, "restart", name),
                            "cpu")[0]


@pytest.mark.parametrize("stamp", ["200007010300", "200007010600"])
def test_offline_two_ranks_merged_restarts_bit_equal(runs, stamp):
    """The merged restart shards hold the one-process run's State, bit
    for bit (the 6-hour one is the final State)."""
    case, _out, groups = runs
    groups["two"].ok()
    groups["reference"].ok()
    name = f"restart_{stamp}.nc"
    one, two = (_restart_state(case, t, name) for t in ("one", "two"))
    for field, a, b in zip(State._fields, one, two):
        assert _bits_equal(a, b), field


def test_offline_two_ranks_writes_dcp_checkpoints(runs):
    case, _out, groups = runs
    groups["two"].ok()
    d = os.path.join(case, "two", "restart", "dcp")
    anchor = datetime.datetime(1900, 1, 1)
    want = [int((datetime.datetime(2000, 7, 1, h) - anchor).total_seconds())
            for h in (3, 6)]
    assert sorted(int(s) for s in os.listdir(d)) == want
    assert all(os.path.exists(os.path.join(d, str(s), ".metadata"))
               for s in want)


def test_dcp_resume_gives_the_uninterrupted_bits(runs):
    """Two ranks run 3 hours, then resume from the DCP checkpoint of hour
    3 (no restart file is named) to hour 6: the 6-hour window and State
    of the uninterrupted run."""
    case, _out, groups = runs
    groups["resume"].ok()
    groups["reference"].ok()
    for code, out in groups["resume"].wait()[:1]:
        assert "24 steps" not in out and "12 steps" in out, out[-2000:]
    name = "restart_200007010600.nc"
    for field, a, b in zip(State._fields, _restart_state(case, "one", name),
                           _restart_state(case, "resume", name)):
        assert _bits_equal(a, b), field
    f = "200007010600.nc"
    assert filecmp.cmp(os.path.join(case, "one", "ldasout", f),
                       os.path.join(case, "resume", "ldasout", f),
                       shallow=False)


def test_dcp_round_trip_keeps_each_ranks_rows(runs):
    """Rows that differ from rank to rank come back to their own rank
    (DCP keeps one copy of a plain tensor: rank 1 would read rank 0's);
    the whole State without a template; the oldest step pruned."""
    reports = _rank_reports(runs, "dcp", "dcp{}.json")
    assert [r["first_tg"] for r in reports] == [200.0, 216.0]
    for r in reports:
        assert r["own_rows"] and r["older_rows"] and r["full_state"], r
        assert r["steps"] == [20, 30] and r["latest"] == 30
        assert r["refuses_no_mesh"]


def test_strict_offline_run_stops_every_rank_at_one_step(runs):
    """Budgets broken on rank 1's rows only: both ranks name the one
    step the one-process strict run names, and the merged State they
    stopped at is that run's, bit for bit."""
    case, out, groups = runs
    groups["reference"].ok()
    ref = _json(out, "reference.json")
    assert ref, "the one-process strict run did not abort"
    results = groups["strict"].wait()
    steps = []
    for code, text in results:
        assert code == 1, text[-4000:]
        lines = [json.loads(line) for line in text.splitlines()
                 if line.startswith('{"rank"')]
        assert len(lines) == 1, text[-4000:]
        steps.append(lines[0]["abort_step"])
    assert steps == [ref["abort_step"]] * WORLD
    stamp = datetime.datetime.fromisoformat(
        ref["abort_time"]).strftime("%Y%m%d%H%M")
    # read as written: the corrupt record may leave non-finite values,
    # which load_restart refuses
    one, two = (tree_from_numpy(State, tio.load_arrays(os.path.join(
        case, tag, "restart", name)), "cpu") for tag, name in (
        ("strict_one", "abort.nc"), ("strict_two", f"abort_{stamp}.nc")))
    for field, a, b in zip(State._fields, one, two):
        assert _bits_equal(a, b), field


def test_launcher_pads_the_synthetic_domain(runs):
    """``--points 33`` over two ranks: 34 points, 17 a rank."""
    case, _out, groups = runs
    results = groups["padded"].ok().wait()
    assert "mesh: 2 ranks on cpu, backend gloo" in results[0][1]
    assert "mesh:" not in results[1][1]             # rank 0 prints
    merged = tio.load_arrays(os.path.join(case, "padded", "ldasout",
                                          "200007010100.nc"))
    assert merged["fsh"].shape == (34,)
    assert sorted(f for f in os.listdir(os.path.join(case, "padded",
                                                     "ldasout"))
                  if ".p0" in f) == ["200007010100.nc.p000000000-000000017",
                                     "200007010100.nc.p000000017-000000034"]


def test_lost_peer_fails_instead_of_hanging(runs):
    _case, _out, groups = runs
    (code, out), = groups["lost_peer"].wait()
    assert code != 0 and "<killed" not in out, out[-2000:]


def test_jax_merge_writes_the_same_bytes(runs, tmp_path):
    """The JAX package's ``merge_shard_files`` (numpy, no compile) on the
    port's shard files writes the bytes the port's merge wrote."""
    from noahmp_tpu.driver import io as jio
    case, _out, groups = runs
    groups["two"].ok()
    for sub in ("ldasout", "restart"):
        src = os.path.join(case, "two", sub)
        work = tmp_path / sub
        work.mkdir()
        for f in os.listdir(src):
            if ".nc.p" in f:
                shutil.copy(os.path.join(src, f), work / f)
        merged = jio.merge_shard_files(str(work))
        assert len(merged) == 2
        for path in merged:
            assert filecmp.cmp(path, os.path.join(src, os.path.basename(
                path)), shallow=False), path


def test_cpu_block_parts_within_bars():
    """Under the machine's own dispatch, a step over each half of the
    points against one over all of them: within the step's bars, and bit
    for bit only where the SIMD loop treats every point alike (see the
    module's docstring)."""
    params = load_params(device="cpu")
    static, forcing, state = to_device(hetero_case("warm_day", N), "cpu")
    whole = make_fused_step(params, Options(), DT, static, device="cpu")
    ref_s, ref_f = whole(None, forcing, state)
    for lo, hi in ((0, N // 2), (N // 2, N)):
        def cut(tree):
            return type(tree)(*[leaf[lo:hi].contiguous() for leaf in tree])
        part = make_fused_step(params, Options(), DT, cut(static),
                               device="cpu")
        got_s, got_f = part(None, cut(forcing), cut(state))
        for ref, got, bar, ceiling in ((ref_s, got_s, STATE_BAR,
                                        STATE_CEILING),
                                       (ref_f, got_f, FLUX_BAR, FLUX_CEILING)):
            for field, a, b in zip(ref._fields, ref, got):
                assert bar_ratio(a[lo:hi].numpy(), b.numpy(), bar,
                                 ceiling) <= 1.0, field


if __name__ == "__main__":
    scenario, *args = sys.argv[1:]
    rank = os.environ.get("RANK", "")
    args = [a.format(rank) for a in args]
    {"step": worker_step, "dcp": worker_dcp,
     "reference": worker_reference}[scenario](*args)
