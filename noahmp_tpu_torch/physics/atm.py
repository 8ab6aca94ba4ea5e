"""Atmospheric forcing pre-processing.

Derives potential temperature, vapor pressure, air density, the fixed
10/90 convective/large-scale precipitation split, and the 70/30
direct/diffuse x 50/50 vis/nir shortwave partition
(reference: core/module_noahmp_func.f90:479-531).  Counterpart of
``noahmp_tpu/physics/atm.py``; per-point inputs are ``(n,)``.
"""

from typing import NamedTuple

import torch

from ..constants import RAIR, CPAIR
from ..numerics.ops import where


class AtmOut(NamedTuple):
    thair: torch.Tensor    # potential temperature [K]
    qair: torch.Tensor     # specific humidity [kg kg-1]
    eair: torch.Tensor     # vapor pressure [Pa]
    rhoair: torch.Tensor   # air density [kg m-3]
    qprecc: torch.Tensor   # convective precipitation [mm s-1]
    qprecl: torch.Tensor   # large-scale precipitation [mm s-1]
    solad: torch.Tensor    # (n, 2) direct beam vis/nir [W m-2]
    solai: torch.Tensor    # (n, 2) diffuse vis/nir [W m-2]
    swdown: torch.Tensor   # total downward solar after cosz gate [W m-2]


def atm(sfcprs, sfctmp, q2, prcp, soldn, cosz) -> AtmOut:
    # The reference uses the surface pressure itself as the reference
    # pressure, making thair == sfctmp (func:508-509); kept for parity.
    thair = sfctmp * (sfcprs / sfcprs) ** (RAIR / CPAIR)
    qair = q2  # driver supplies specific humidity already
    eair = qair * sfcprs / (0.622 + 0.378 * qair)
    rhoair = (sfcprs - 0.378 * eair) / (RAIR * sfctmp)

    qprecc = 0.10 * prcp
    qprecl = 0.90 * prcp

    swdown = where(cosz <= 0.0, 0.0, soldn)
    solad = torch.stack([swdown * 0.7 * 0.5, swdown * 0.7 * 0.5], dim=-1)
    solai = torch.stack([swdown * 0.3 * 0.5, swdown * 0.3 * 0.5], dim=-1)
    return AtmOut(thair, qair, eair, rhoair, qprecc, qprecl,
                  solad, solai, swdown)
