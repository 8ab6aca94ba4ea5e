"""noahmp_tpu_torch: the PyTorch/CUDA port of the Noah-MP land surface
model in ``noahmp_tpu`` (the JAX package, which stays the reference).

Quick start::

    from noahmp_tpu_torch import (load_params, Options, init_state,
                                  init_static, make_step)

    params = load_params("USGS", "STAS")          # on the card
    step = make_step(params, Options(), dt=900.0)
    state, flux = step(static, forcing, state)

    # the same step in one launch of the fused column kernel
    fused = make_fused_step(params, Options(), 900.0, static)
    state, flux = fused(None, forcing, state)

Every entry point takes ``device=None`` (the card; raises without CUDA)
or an explicit device such as ``"cpu"``.  The package imports ``torch``
and ``numpy`` only, never ``jax`` or ``noahmp_tpu``.
"""

from .constants import NBAND, NSOIL, MSNOW, NLEVELS
from .options import Options, DEFAULT_OPTIONS
from .params import load_params, Params
from .state import State, Static, Forcing, Flux, init_state, init_static
from .driver.step import make_step, make_fused_step

__version__ = "0.1.0"

__all__ = [
    "NBAND", "NSOIL", "MSNOW", "NLEVELS",
    "Options", "DEFAULT_OPTIONS", "load_params", "Params",
    "State", "Static", "Forcing", "Flux", "init_state", "init_static",
    "make_step", "make_fused_step", "__version__",
]
