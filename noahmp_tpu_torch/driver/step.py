"""Batched model step: two entry points, as in the JAX package.

``make_step`` is the counterpart of
``noahmp_tpu/driver/step.py:make_step`` (layout "major": the land-point
axis leads): the eager step, one CUDA kernel per tensor operation.
``make_fused_step`` is the counterpart of ``make_fused_step`` there: the
whole step of every point through the hand-written column kernels, four
launches enqueued by one C call (``kernels/column.py``).  PyTorch runs eagerly, so there is
nothing to trace or compile here; building a step checks the options,
moves the tables and fixes the device.
"""

import torch

from ..device import resolve_device
from ..kernels.column import ColumnPlan, column_cuda, column_plain
from ..options import check_fused_ported, check_ported
from ..params.gathered import gather_params
from ..physics.sflx import step_columns


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

    Raises NotImplementedError when ``opts`` selects physics that is
    not ported yet (``options.UNPORTED``).
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
    advances every land point through the fused column kernels: four
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

    Raises NotImplementedError when ``opts`` selects physics that is
    not ported yet (``options.UNPORTED``) or that the fused kernel
    refuses (``options.FUSED_UNPORTED``).
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
    step.device = device
    return step
