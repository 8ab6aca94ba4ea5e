"""noahmp_tpu_torch: the PyTorch/CUDA port of the Noah-MP land surface
model in ``noahmp_tpu`` (the JAX package, which stays the reference).

Quick start::

    from noahmp_tpu_torch import (load_params, Options, init_state,
                                  init_static, make_step)

    params = load_params("USGS", "STAS")          # on the card
    step = make_step(params, Options(), dt=900.0)
    state, flux = step(static, forcing, state)

    # the same step through the fused column kernels (5 launches)
    fused = make_fused_step(params, Options(), 900.0, static)
    state, flux = fused(None, forcing, state)

    # 48 steps in one call over the fused step, forcings stacked (48, n),
    # the sensible heat flux summed on the card
    chunk = make_chunk_step(params, Options(), 900.0, (("fsh", "sum"),),
                            static=static)
    acc = (torch.zeros(n, device="cuda"),)
    state, (fsh_sum,) = chunk(None, forcings, state, acc)

Every entry point takes ``device=None`` (the card; raises without CUDA)
or an explicit device such as ``"cpu"``.  The package imports ``torch``
and ``numpy`` only, never ``jax`` or ``noahmp_tpu``.
"""

from .constants import NBAND, NSOIL, MSNOW, NLEVELS
from .options import Options, DEFAULT_OPTIONS
from .params import load_params, Params
from .state import State, Static, Forcing, Flux, init_state, init_static
from .driver.step import (make_step, make_fused_step, make_chunk_step,
                          make_simulate, simulate, STRICT_SENTINEL)
from . import utils

__version__ = "0.1.0"

__all__ = [
    "NBAND", "NSOIL", "MSNOW", "NLEVELS",
    "Options", "DEFAULT_OPTIONS", "load_params", "Params",
    "State", "Static", "Forcing", "Flux", "init_state", "init_static",
    "make_step", "make_fused_step", "make_chunk_step", "make_simulate",
    "simulate", "STRICT_SENTINEL", "utils", "__version__",
]
