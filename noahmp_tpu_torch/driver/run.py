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

import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..params import load_params
from ..state import State, Static, init_state, init_static
from .. import utils
from .config import Config, as_cadence
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


def _on_device(cls, tree, device):
    """A container of tensors or numpy arrays as ``cls`` on ``device``,
    every leaf contiguous (what the fused step's plan requires); leaves
    already there and contiguous stay as they are."""
    leaves = []
    for name, leaf in zip(cls._fields, tree):
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
            if leaf.dtype not in (np.float32, np.int32):
                raise TypeError(f"{cls.__name__}.{name} is {leaf.dtype}, "
                                "needs float32 or int32")
            # a C-ordered copy: a broadcast view (zsoil, a held forcing
            # field) copied in numpy's default order can come out
            # column-major
            leaf = torch.from_numpy(np.array(leaf, order="C"))
        leaves.append(leaf.to(device).contiguous())
    return cls(*leaves)


def run_offline(cfg: Config, verbose=True, forcing_provider=None,
                static=None, state=None, n_points=None,
                check_budgets_every=0, dispatch: str = "auto",
                chunk_pointsteps: int = 2 ** 21,
                chunk_steps: int = 0, forcing_mode: str = "exact",
                device=None):
    """Run the offline case described by ``cfg``.  Returns
    (final_state, output_files).  ``check_budgets_every`` > 0 asserts
    the conservation residuals every N steps (advisory, on the sink's
    thread; the window's absmax at each chunk end); the string
    ``"strict"`` reproduces the reference's fatal per-step abort
    exactly (func:688-721: |ERRSW| or |ERRENG| > 0.01 W/m2 on ANY step
    kills the run at that step) — the check runs on the device inside
    the chunk, the state stops advancing at the violating step, and a
    ConservationError is raised naming it.

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
    Compact engages only for the FileForcing chunk path.

    Not taken here: a device mesh, orbax checkpoints and sharded output
    (the JAX package's ``mesh``, ``use_orbax``, ``shard_output``).
    """
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
    static = _on_device(Static, static, device)
    n = static.lat.shape[0]

    when = cfg.begdatetime
    if state is None:
        respath = os.path.join(cfg.resdir, cfg.resfile)
        if cfg.restart and os.path.exists(io_mod._npz_path(respath)):
            state, when = io_mod.load_restart(respath, device)
        elif os.path.exists(io_mod._npz_path(cfg.initfile)):
            state = io_mod.load_init(cfg.initfile, n, device)
        else:
            state = init_state(n, device=device)
    state = _on_device(State, state, device)

    if forcing_provider is None:
        if os.path.isdir(cfg.indir) and os.listdir(cfg.indir):
            forcing_provider = io_mod.FileForcing(cfg.indir, cfg.infreq,
                                                  static_host)
        else:
            forcing_provider = io_mod.SyntheticForcing(static_host)

    writer = io_mod.OutputWriter(cfg.outdir, cfg.outfreq)
    res_cad = as_cadence(cfg.resfreq)

    def save_restart_at(when, state):
        path = os.path.join(
            cfg.resdir,
            "restart_" + when.strftime("%Y%m%d%H%M") + ".nc")
        io_mod.save_restart(path, state, when)

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
                            static=static, device=device)
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
        compact=(forcing_mode == "compact"))
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
                acc = tuple(torch.zeros(n, dtype=torch.float32,
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
                    raise utils.ConservationError(
                        f"budget abort (strict): |ERRSW| or "
                        f"|ERRENG| > 0.01 W/m2 at model time "
                        f"{when + bad * ts} (step {nsteps + bad}); "
                        f"window absmax errsw={errsw_m:.4g} "
                        f"erreng={erreng_m:.4g}")
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
    finally:
        prefetch.close()
        sink.close()
    elapsed = time.perf_counter() - t0

    if verbose:
        rate = n * nsteps / max(elapsed, 1e-9)
        print(f"noahmp_tpu_torch: {nsteps} steps x {n} points on "
              f"{device.type} in {elapsed:.2f}s  "
              f"({rate:,.0f} point-steps/s)")
        print(f"  max |errwat| last window: {errwat_box[0]:.3e} mm")
    return state, writer._files
