"""Batched model step and time loop: the entry points of the JAX
package's ``driver/step.py``.

``make_step`` is the counterpart of
``noahmp_tpu/driver/step.py:make_step`` (layout "major": the land-point
axis leads): the eager step, one CUDA kernel per tensor operation.
``make_fused_step`` is the counterpart of ``make_fused_step`` there: the
whole step of every point through the hand-written column kernels, five
launches enqueued by one C call (``kernels/column.py``).  PyTorch runs
eagerly, so there is nothing to trace or compile here; building a step
checks the options, moves the tables and fixes the device.

``simulate``, ``make_simulate`` and ``make_chunk_step`` run a sequence of
steps over a Forcing whose leaves are stacked ``(T, n)``, the state
carried from step to step; either step can stand under them.  Where the
JAX package scans, these loop on the host and only enqueue: no step of a
sequence waits for the card, so the card runs the steps back to back
while the host is already enqueuing the next ones.
"""

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..kernels.column import ColumnPlan, column_cuda, column_plain
from ..options import check_fused_ported, check_ported
from ..params.gathered import gather_params
from ..physics.sflx import step_columns
from ..state import Flux, Forcing


def _check_devices(trees, device):
    for tree in trees:
        for name, leaf in zip(tree._fields, tree):
            if leaf.device.type != device.type:
                raise ValueError(
                    f"{type(tree).__name__}.{name} is on "
                    f"{leaf.device}, the step was built for {device}")


def make_step(params, opts, dt, device=None):
    """Build step(static, forcing, state) -> (state, flux), batched over
    the leading land-point axis of every leaf.

    ``device=None`` means the card and raises when CUDA is not available;
    pass ``device="cpu"`` to run the plain versions on the host.  The
    returned step takes tensors that already live on that device and
    raises on any other: it moves nothing silently.  On the card the two
    implicit solves of the step go through the CUDA Thomas kernel, and
    the step contains no host synchronisation.

    Raises ValueError for an option value that is none of its option's
    (``options.OPTION_VALUES``).
    """
    check_ported(opts)
    device = resolve_device(device)
    params = params.to(device)
    dt_t = torch.tensor(float(dt), dtype=torch.float32, device=device)

    def step(static, forcing, state):
        _check_devices((static, forcing, state), device)
        with torch.no_grad():
            return step_columns(params, opts, static, forcing, state, dt_t)

    step.params = params
    step.device = device
    return step


def make_fused_step(params, opts, dt, static, device=None):
    """Build step(static_ignored, forcing, state) -> (state, flux) that
    advances every land point through the fused column kernels: five
    launches a step, enqueued by one C call.

    The table lookups are gathered once, here, from ``static``'s class
    indices; the domain is therefore fixed when the step is built, and
    the step ignores its first argument (kept so that the fused step
    can stand wherever ``make_step``'s does).  ``device=None`` means the
    card and raises when CUDA is not available.  With ``device="cpu"``
    the step runs the kernel's plain version, ``step_columns`` on the
    gathered parameters; on the card it launches the kernels and never
    the plain version.  The returned step raises on tensors that live
    on another device (on the card, on any leaf of wrong device, dtype,
    shape or layout) and contains no host synchronisation.

    On the card the leaves of the returned State are views of one
    allocation and those of the Flux of another: a leaf keeps its whole
    container's storage alive, and every step allocates both anew, so
    nothing a caller holds is overwritten by a later step.

    Raises ValueError for an option value that is none of its option's,
    NotImplementedError for one that the fused kernel refuses
    (``options.FUSED_UNPORTED``, empty today).
    """
    check_ported(opts)
    check_fused_ported(opts)
    device = resolve_device(device)
    params = params.to(device)
    _check_devices((static,), device)
    gathered = gather_params(params, static.lutyp, static.sltyp, static.isc,
                             static.slptyp)
    on_card = device.type == "cuda"
    plan = ColumnPlan(gathered, opts, dt, static) if on_card else None
    dt_t = torch.tensor(float(dt), dtype=torch.float32, device=device)

    def step(_static_ignored, forcing, state):
        if on_card:
            # the plan checks device, dtype, shape and layout of every
            # leaf it does not know already
            return column_cuda(plan, forcing, state)
        _check_devices((forcing, state), device)
        with torch.no_grad():
            return column_plain(gathered, opts, static, forcing, state, dt_t)

    step.params = params
    step.gathered = gathered
    step.plan = plan
    step.device = device
    return step


STRICT_SENTINEL = 2 ** 30  # "no step violated yet"
# strict mode holds BOTH budgets to the reference's abort bound
# (func:691,715), not to the widened ENG_TOL of utils.check_budgets
STRICT_TOL = 0.01          # W/m2
ACC_OPS = ("sum", "absmax")


def _num_steps(forcings):
    steps = {tuple(leaf.shape[:1]) for leaf in forcings}
    if len(steps) != 1 or forcings[0].dim() != 2:
        raise ValueError("forcings: every leaf must be stacked (T, n) "
                         f"with one T; got {sorted(steps)}")
    return forcings[0].shape[0]


def _sequence_step(params, opts, dt, static, device):
    """What the multi-step entry points loop over.  Returns (advance,
    device): ``advance(static, forcings, t, state) -> (state, flux)`` is
    step ``t`` of the stacked Forcing.  With ``static`` given at build
    the step is the fused one for that domain, else the eager one."""
    if static is None:
        single = make_step(params, opts, dt, device=device)
    else:
        single = make_fused_step(params, opts, dt, static, device=device)
    plan = getattr(single, "plan", None)

    if plan is not None:
        # the plan checks the stacked Forcing once and points step t at
        # its row t
        def advance(_static, forcings, t, state):
            return column_cuda(plan, forcings, state, t)
    else:
        def advance(static_now, forcings, t, state):
            return single(static_now, Forcing(*[leaf[t] for leaf in forcings]),
                          state)

    return advance, single.device


def simulate(params, opts, dt, static, forcings, state0,
             collect_fluxes=True, device=None):
    """Run a forcing sequence through the eager step.  ``forcings`` is a
    Forcing whose leaves have a leading time axis (then the land-point
    axis).  Returns (final_state, fluxes): every Flux leaf stacked
    ``(T, ...)``, or ``None`` when ``collect_fluxes`` is false.

    ``device=None`` means the card and raises when CUDA is not
    available.  Callers who run many sequences, or who want the fused
    column kernels, build the step once with ``make_simulate``."""
    sim = make_simulate(params, opts, dt, collect_fluxes, device=device)
    return sim(static, forcings, state0)


def make_simulate(params, opts, dt, collect_fluxes=True, static=None,
                  device=None):
    """Build sim(static, forcings, state0) -> (final_state, fluxes), the
    built form of ``simulate``: options checked, tables moved and, with
    ``static`` given, the fused step prepared for that domain, once.
    With ``static`` given the returned function ignores its first
    argument, as the fused step does.  The loop over T enqueues and
    returns: nothing in it waits for the card."""
    advance, device = _sequence_step(params, opts, dt, static, device)

    def sim(static_now, forcings, state):
        with torch.no_grad():
            steps = _num_steps(forcings)
            if collect_fluxes and not steps:
                raise ValueError("forcings hold no step: nothing to collect")
            fluxes = []
            for t in range(steps):
                state, flux = advance(static_now, forcings, t, state)
                if collect_fluxes:
                    fluxes.append(flux)
            if not collect_fluxes:
                return state, None
            return state, Flux(*[torch.stack(leaves)
                                 for leaves in zip(*fluxes)])

    sim.device = device
    return sim


def make_chunk_step(params, opts, dt, acc_spec=(), strict_budgets=False,
                    static=None, device=None, mesh=None, observe=None):
    """Multi-step dispatch for an offline driver: one call advances a
    whole chunk of timesteps and accumulates flux statistics on the
    device, so that the caller fetches results at its output cadence
    only.

    ``acc_spec``: tuple of (flux_field, op) with op "sum" (for output
    window means) or "absmax" (for conservation budget checks); any
    other op raises here.

    Returns chunk(static, forcings, state, acc) -> (state, acc) where
    ``forcings`` leaves are stacked (T, n) and ``acc`` is a tuple of
    per-field running statistics in acc_spec order.  The accumulators
    are updated in place and handed back; the state is new storage every
    step, so the State the caller passed in is left as it was.  Any T
    runs; nothing is cached by chunk length.

    ``static``: given, the chunk runs the fused column kernels for that
    domain and ignores its first argument; absent, the eager step.
    ``device=None`` means the card and raises when CUDA is not
    available.

    ``mesh`` (``dist.mesh.make_mesh``): the chunk advances this rank's
    block of points (``static``, the forcings and the state hold its
    rows) on this rank's device, which ``device`` may name or leave
    ``None``.  Without strict mode it needs no collective.  Strict mode
    is global, as in the JAX package: every step's violation flag is
    reduced over the ranks with one ``all_reduce(MAX)`` on the device,
    so that every point of every rank freezes after the first step
    that breaks a budget anywhere, and every rank returns the same
    ``bad_step``.

    ``strict_budgets``: reproduce the reference's per-step fatal abort
    semantics (func:688-721: |ERRSW| > 0.01 or |ERRENG| > 0.01 W/m2
    kills the run at that step) without leaving the device.  The chunk
    then returns (state, acc, bad_step): ``bad_step`` is a 0-d int32
    tensor on the step's device, the 0-based chunk-local index of the
    FIRST violating step (STRICT_SENTINEL if none).  The violating step
    is applied; every later step leaves state and accumulators as they
    were, exactly the state the aborting reference would leave.  The
    caller reads ``bad_step`` and raises.

    ``observe``: given, called with every step's Flux after the
    accumulators, in both modes (a step that strict mode freezes too);
    it should only enqueue work on the step's device.

    No step of a chunk waits for the card, in either mode: the loop
    enqueues and returns, and strict mode selects on the device."""
    acc_spec = tuple((field, op) for field, op in acc_spec)
    for field, op in acc_spec:
        if op not in ACC_OPS:
            raise ValueError(f"acc_spec: unknown op {op!r} for {field!r}; "
                             f"one of {ACC_OPS}")
        if field not in Flux._fields:
            raise ValueError(f"acc_spec: Flux has no field {field!r}")
    group = None
    if mesh is not None:
        from ..dist.mesh import mesh_group, rank_device
        device = rank_device(mesh, device)
        group = mesh_group(mesh) if strict_budgets else None
    advance, device = _sequence_step(params, opts, dt, static, device)

    def accumulate(acc, flux, frozen):
        for a, (field, op) in zip(acc, acc_spec):
            leaf = getattr(flux, field)
            if frozen is not None:
                new = a + leaf if op == "sum" else torch.maximum(a, leaf.abs())
                torch.where(frozen, a, new, out=a)
            elif op == "sum":
                a.add_(leaf)
            else:
                torch.maximum(a, leaf.abs(), out=a)

    def chunk(static_now, forcings, state, acc):
        acc = tuple(acc)
        if len(acc) != len(acc_spec):
            raise ValueError(f"acc holds {len(acc)} accumulators, acc_spec "
                             f"names {len(acc_spec)}")
        with torch.no_grad():
            steps = _num_steps(forcings)
            if not strict_budgets:
                for t in range(steps):
                    state, flux = advance(static_now, forcings, t, state)
                    accumulate(acc, flux, None)
                    if observe is not None:
                        observe(flux)
                return state, acc
            bad = torch.full((), STRICT_SENTINEL, dtype=torch.int32,
                             device=device)
            sentinel = bad.clone()
            index = torch.arange(steps, dtype=torch.int32, device=device)
            for t in range(steps):
                frozen = bad < t        # an earlier step already aborted
                new_state, flux = advance(static_now, forcings, t, state)
                violated = ((flux.errsw.abs() > STRICT_TOL)
                            | (flux.erreng.abs() > STRICT_TOL)).any()
                if group is not None:
                    flag = violated.to(torch.int32)
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
                    violated = flag.bool()
                bad = torch.minimum(bad, torch.where(violated & ~frozen,
                                                     index[t], sentinel))
                state = type(state)(*[torch.where(frozen, old, new)
                                      for old, new in zip(state, new_state)])
                accumulate(acc, flux, frozen)
                if observe is not None:
                    observe(flux)
            return state, acc, bad

    chunk.acc_spec = acc_spec
    chunk.device = device
    return chunk
