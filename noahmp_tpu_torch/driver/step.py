"""Batched model step.

Counterpart of ``noahmp_tpu/driver/step.py:make_step`` (layout
"major": the land-point axis leads).  PyTorch runs eagerly, so there is
nothing to trace or compile here; building a step checks the options,
moves the tables and fixes the device.
"""

import torch

from ..device import resolve_device
from ..options import check_ported
from ..physics.sflx import step_columns


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
        for tree in (static, forcing, state):
            for name, leaf in zip(tree._fields, tree):
                if leaf.device.type != device.type:
                    raise ValueError(
                        f"{type(tree).__name__}.{name} is on "
                        f"{leaf.device}, the step was built for {device}")
        with torch.no_grad():
            return step_columns(params, opts, static, forcing, state, dt_t)

    step.params = params
    step.device = device
    return step
