"""Offline time loop: the runnable driver the reference only stubbed
(core/module_noahmp_engine.f90:5-10, run/main.py); counterpart of
``noahmp_tpu/driver/run.py`` on one device.

Reads the namelist config, loads (or synthesizes) domain/init/forcing,
advances the fused step (``make_chunk_step`` over ``make_fused_step``:
the column kernels on the card, their plain version on the CPU) from
start to end datetime, writes outputs at output_frequency and restarts
at restart_frequency.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch

from ..convert import tree_on_device
from ..device import resolve_device
from ..params import load_params
from ..state import State, Static, init_state, init_static
from .. import utils
from .config import _ANCHOR, Config, as_cadence
from .step import STRICT_SENTINEL, make_chunk_step
from . import io as io_mod


def _host_abs_max(arr) -> float:
    """max |arr| on the host (reads the tensor back)."""
    return float(np.max(np.abs(utils._host(arr))))


def _chunk_schedule(begin, end, ts, outfreq, res_cad, cap):
    """Deterministic (when, steps) chunk plan for a run: chunks stop at
    every output/restart cadence boundary, are capped at ``cap`` steps,
    and use power-of-two lengths (the JAX package caches one executable
    a length; here nothing is cached by length, and the same plan keeps
    the files, restart times and chunk ends of the two packages one for
    one).  Precomputing the plan lets the forcing prefetcher run ahead
    of the compute loop."""
    sched = []
    when = begin
    while when < end:
        boundary = min(outfreq.next_due(when), res_cad.next_due(when),
                       end)
        steps = int(round((boundary - when).total_seconds()
                          / ts.total_seconds()))
        steps = max(1, min(steps, cap))
        steps = 1 << (steps.bit_length() - 1)
        sched.append((when, steps))
        when = when + steps * ts
    return sched


def run_offline(cfg: Config, verbose=True, forcing_provider=None,
                static=None, state=None, n_points=None,
                check_budgets_every=0, dispatch: str = "auto",
                chunk_pointsteps: int = 2 ** 21,
                chunk_steps: int = 0, forcing_mode: str = "exact",
                device=None, mesh=None, use_dcp=None, shard_output=None):
    """Run the offline case described by ``cfg``.  Returns
    (final_state, output_files).  ``check_budgets_every`` > 0 asserts
    the conservation residuals every N steps (advisory, on the sink's
    thread; the window's absmax at each chunk end); the string
    ``"strict"`` reproduces the reference's fatal per-step abort
    exactly (func:688-721: |ERRSW| or |ERRENG| > 0.01 W/m2 on ANY step
    kills the run at that step) — the check runs on the device inside
    the chunk, the state stops advancing at the violating step, and a
    ConservationError is raised naming it; the error carries the
    model time (``when``), the step (``step``) and the State it stopped
    at (``state``).

    ``device=None`` means the card and raises when CUDA is not
    available; ``device="cpu"`` runs the fused step's plain version on
    the host.

    ``dispatch``: "chunk" (default via "auto") advances whole
    output/restart windows per call of ``make_chunk_step`` over the
    fused step, accumulating output-window flux sums on the device —
    one stacked forcing upload per chunk, nothing in the loop waits for
    the card.  "step" is the same loop with chunks of one step (the
    JAX package's per-step loop; the same bits, strict mode included,
    and the advisory check then runs every step).
    ``chunk_pointsteps`` caps chunk length x points (stacked-forcing
    memory bound: 15 f32 leaves x cap ~= 120 MB at the default);
    ``chunk_steps`` > 0 caps the chunk length in steps too.

    ``forcing_mode``: "exact" uploads the host-assembled (T, n) stack
    (bit-identical to the per-step path); "compact" uploads hourly
    frames + per-step scalars and interpolates on the device (~4x less
    host->device traffic; may differ from host interp by an ulp).
    Compact engages only for the FileForcing chunk path without a mesh;
    under a mesh it falls back to exact, as in the JAX package.

    ``mesh`` (``dist.mesh.make_mesh``): spread the land points over the
    mesh's ranks.  Every rank calls ``run_offline`` with the same
    arguments; ``static`` and ``state``, when given, hold every point.
    Each rank advances its own block (``dist.mesh.process_slice``) on its
    own device (``device`` may name it or stay ``None``) through the
    fused chunk, reads only its rows of the forcing files, and returns
    its rows of the final State; a ``forcing_provider`` given under a
    mesh returns this rank's rows.  Nothing but strict mode's flag is
    communicated, and nothing on the prefetch or sink threads.

    ``use_dcp`` (default: with a mesh) stands where the JAX package's
    ``use_orbax`` stood: restarts are also saved, asynchronously, as
    ``torch.distributed.checkpoint`` checkpoints under
    ``<restart_directory>/dcp`` (steps named by model seconds since
    ``config._ANCHOR``), and a run with ``restart`` set resumes from the
    latest one.  The restart files are written all the same: DCP
    checkpoints are not readable by the JAX package, they are.
    ``shard_output`` (default: a mesh of more than one rank): each rank
    writes its own ``.pLO-HI`` ldasout and restart files, which
    ``merge_shard_files`` reassembles.
    """
    if mesh is not None:
        from ..dist.mesh import process_slice, rank_device
        device = rank_device(mesh, device)
    else:
        device = resolve_device(device)
    params = load_params(cfg.veg_scheme, cfg.soil_scheme, device=device)

    if static is None:
        if os.path.exists(io_mod._npz_path(cfg.constfile)):
            static = io_mod._load_domain_host(cfg.constfile)
        else:
            static = init_static(n_points or 1, device="cpu")
    # host-side copy for forcing providers / advisory checks; the fused
    # step gathers its per-point parameters from the device copy once
    static_host = io_mod.static_to_host(static)
    n = static_host.lat.shape[0]
    lo, hi = (0, n) if mesh is None else process_slice(mesh, n)
    if mesh is not None:
        static = static_host = Static(*[leaf[lo:hi] for leaf in static_host])
    static = tree_on_device(Static, static, device)

    when = cfg.begdatetime
    if state is None:
        # under a mesh the files are read whole and cut to this rank's rows
        load_on = device if mesh is None else "cpu"
        respath = os.path.join(cfg.resdir, cfg.resfile)
        if cfg.restart and os.path.exists(io_mod._npz_path(respath)):
            state, when = io_mod.load_restart(respath, load_on)
        elif os.path.exists(io_mod._npz_path(cfg.initfile)):
            state = io_mod.load_init(cfg.initfile, n, load_on)
        else:
            state = init_state(n, device=load_on)
    if mesh is not None:
        state = State(*[leaf[lo:hi] for leaf in state])
    state = tree_on_device(State, state, device)

    if use_dcp is None:
        use_dcp = mesh is not None
    ckpt = None
    if use_dcp:
        from ..dist.checkpoint import CheckpointManager
        ckpt = CheckpointManager(os.path.join(cfg.resdir, "dcp"), mesh=mesh)
        latest = ckpt.latest_step() if cfg.restart else None
        if latest is not None:
            state = ckpt.restore(latest, template=state)
            when = _ANCHOR + datetime.timedelta(seconds=latest)

    if forcing_provider is None:
        if os.path.isdir(cfg.indir) and os.listdir(cfg.indir):
            forcing_provider = io_mod.FileForcing(
                cfg.indir, cfg.infreq, static_host,
                points_slice=None if mesh is None else (lo, hi))
        else:
            forcing_provider = io_mod.SyntheticForcing(static_host)

    if shard_output is None:
        shard_output = mesh is not None and mesh.size() > 1
    if shard_output and mesh is None:
        raise ValueError("shard_output needs a mesh")
    shard = (lo, hi, n) if shard_output else None
    writer = io_mod.OutputWriter(cfg.outdir, cfg.outfreq, shard=shard)
    res_cad = as_cadence(cfg.resfreq)

    def save_restart_at(when, state):
        path = os.path.join(
            cfg.resdir,
            "restart_" + when.strftime("%Y%m%d%H%M") + ".nc")
        if shard is None:
            io_mod.save_restart(path, state, when)
        else:
            io_mod.save_restart_shard(path, state, when, shard)

    if dispatch == "auto":
        dispatch = "chunk"
    if dispatch not in ("chunk", "step"):
        raise ValueError(f"dispatch {dispatch!r}: one of auto, chunk, step")
    if forcing_mode not in ("exact", "compact"):
        raise ValueError(f"forcing_mode {forcing_mode!r}: one of exact, "
                         "compact")

    strict = check_budgets_every == "strict"

    t0 = time.perf_counter()
    nsteps = 0
    errwat_box = [np.float32(0.0)]
    acc_spec = tuple((f, "sum") for f in writer.fields) + (
        ("errsw", "absmax"), ("erreng", "absmax"),
        ("errwat", "absmax"))
    chunk = make_chunk_step(params, cfg.options, cfg.dt,
                            acc_spec=acc_spec, strict_budgets=strict,
                            static=static, device=device, mesh=mesh)
    ts = cfg.timestep
    cap = max(1, int(chunk_pointsteps) // max(n, 1))
    if chunk_steps:
        cap = min(cap, int(chunk_steps))
    if dispatch == "step":
        cap = 1
    schedule = _chunk_schedule(when, cfg.enddatetime, ts,
                               writer.outfreq, res_cad, cap)

    # pipeline: forcing assembly + host->device upload for chunk
    # k+1 runs on a background thread while chunk k computes, and
    # every device->host fetch (window means, snapshots, restarts,
    # advisory budget checks) runs on an ordered writer thread —
    # the main loop only enqueues device work.
    prefetch = io_mod.ChunkPrefetcher(
        forcing_provider, schedule, ts, device,
        compact=(forcing_mode == "compact" and mesh is None))
    sink = io_mod.AsyncSink()

    def record_errwat(arr):
        errwat_box[0] = max(errwat_box[0],
                            np.float32(_host_abs_max(arr)))

    def advisory_check(errsw, erreng, errwat):
        class _Res:  # duck-typed Flux for check_budgets
            pass
        _Res.errsw, _Res.erreng, _Res.errwat = errsw, erreng, errwat
        utils.check_budgets(_Res, ist=static_host.ist)

    acc = None
    win_steps = 0
    try:
        for when, steps in schedule:
            forcings = prefetch.get()
            if acc is None:
                acc = tuple(torch.zeros(hi - lo, dtype=torch.float32,
                                        device=device)
                            for _ in acc_spec)
            if strict:
                state, acc, bad_step = chunk(static, forcings,
                                             state, acc)
                bad = int(bad_step)
                if bad != STRICT_SENTINEL:
                    # match the reference's wrf_error_fatal: the
                    # run dies at the violating step (func:709,721);
                    # state as of that step is in `state`
                    errsw_m = _host_abs_max(acc[-3])
                    erreng_m = _host_abs_max(acc[-2])
                    err = utils.ConservationError(
                        f"budget abort (strict): |ERRSW| or "
                        f"|ERRENG| > 0.01 W/m2 at model time "
                        f"{when + bad * ts} (step {nsteps + bad}); "
                        f"window absmax errsw={errsw_m:.4g} "
                        f"erreng={erreng_m:.4g}")
                    err.when, err.step, err.state = (when + bad * ts,
                                                     nsteps + bad, state)
                    raise err
            else:
                state, acc = chunk(static, forcings, state, acc)
            when = when + steps * ts
            nsteps += steps
            win_steps += steps
            # the chunk updates the accumulators in place and the
            # next chunk goes on updating them: the sink, which may
            # fetch after that, gets snapshots taken here
            if check_budgets_every and not strict:
                sink.submit(advisory_check,
                            *[a.clone() for a in acc[-3:]])
            at_end = when >= cfg.enddatetime
            if writer.outfreq.due(when) or at_end:
                sink.submit(record_errwat, acc[-1].clone())
                if writer.outfreq.due(when):
                    # trailing partial windows are not written (the
                    # reference's cadence contract)
                    cnt = max(1, win_steps)
                    means = {f: a / cnt
                             for (f, _op), a in zip(acc_spec, acc)
                             if _op == "sum"}
                    sink.submit(writer.push_window, when, means,
                                state)
                    acc = None
                    win_steps = 0
            if res_cad.due(when):
                sink.submit(save_restart_at, when, state)
                if ckpt is not None:
                    # staged to the host here, written on DCP's thread
                    ckpt.save(int((when - _ANCHOR).total_seconds()), state)
    finally:
        prefetch.close()
        sink.close()
        if ckpt is not None:
            ckpt.close()
    elapsed = time.perf_counter() - t0

    if verbose:
        rate = n * nsteps / max(elapsed, 1e-9)
        where = device.type if mesh is None else \
            f"{mesh.size()} ranks ({device.type})"
        print(f"noahmp_tpu_torch: {nsteps} steps x {n} points on "
              f"{where} in {elapsed:.2f}s  "
              f"({rate:,.0f} point-steps/s)")
        print(f"  max |errwat| last window: {errwat_box[0]:.3e} mm")
    return state, writer._files
