"""Thermal properties of the snow/soil column.

Per-layer conductivity DF and heat capacity HCPCT for snow (Yen-1965
conductivity), soil (Peters-Lidard/Johansen), and lake columns, plus the
phase-change factor FACT = dt/(C*dz) and the snow/soil interface blending
(reference: core/module_noahmp_func.f90:1341-1595).  Counterpart of
``noahmp_tpu/physics/thermo.py``.

Snow layers are fixed-shape (n, MSNOW) tensors; inactive slots are masked
(their dz is 0) and guarded against division by zero.
"""

from typing import NamedTuple

import torch

from ..constants import (MSNOW, CICE, CWAT, CPAIR, TFRZ, TKICE,
                         TKWAT, DENICE, DENWAT, MPE)
from ..numerics.ops import where, maximum, minimum, col


class SnowThermo(NamedTuple):
    tksno: torch.Tensor    # (n, MSNOW) snow conductivity [W m-1 K-1]
    cvsno: torch.Tensor    # (n, MSNOW) snow volumetric heat capacity
    snicev: torch.Tensor   # (n, MSNOW) partial volume of ice
    snliqv: torch.Tensor   # (n, MSNOW) partial volume of liquid
    epore: torch.Tensor    # (n, MSNOW) effective porosity


class ThermoOut(NamedTuple):
    df: torch.Tensor       # (n, NLEVELS) thermal conductivity
    hcpct: torch.Tensor    # (n, NLEVELS) volumetric heat capacity
    fact: torch.Tensor     # (n, NLEVELS) dt/(C*dz) phase-change factor
    snicev: torch.Tensor
    snliqv: torch.Tensor
    epore: torch.Tensor


def csnow(snice, snliq, dzsnow) -> SnowThermo:
    """Snow heat capacity/conductivity from partial volumes
    (reference func:1448-1497).  dzsnow: (n, MSNOW) thicknesses (0 when
    the slot is inactive)."""
    dz = maximum(dzsnow, MPE)
    snicev = minimum(1.0, snice / (dz * DENICE))
    epore = 1.0 - snicev
    snliqv = minimum(epore, snliq / (dz * DENWAT))
    bdsnoi = (snice + snliq) / dz
    cvsno = CICE * snicev + CWAT * snliqv
    tksno = 3.2217e-6 * bdsnoi ** 2.0   # Stieglitz (Yen 1965)
    return SnowThermo(tksno, cvsno, snicev, snliqv, epore)


def tdfcnd(soil, sltyp, smc, swc):
    """Peters-Lidard soil thermal conductivity (reference func:1500-1595).
    Elementwise over soil layers: smc, swc are (n, NSOIL)."""
    smcmax = col(soil.smcmax[sltyp])
    quartz = col(soil.quartz[sltyp])
    satratio = smc / smcmax
    thkw = 0.57
    thko = 2.0
    thkqtz = 7.7
    thks = thkqtz ** quartz * thko ** (1.0 - quartz)
    xunfroz = swc / maximum(smc, MPE)
    xu = xunfroz * smcmax
    thksat = (thks ** (1.0 - smcmax) * TKICE ** (smcmax - xu)
              * thkw ** xu)
    gammd = (1.0 - smcmax) * 2700.0
    thkdry = (0.135 * gammd + 64.7) / (2700.0 - 0.947 * gammd)
    frozen = (swc + 0.0005) < smc
    ake_unfrozen = where(satratio > 0.1,
                         torch.log10(maximum(satratio, MPE)) + 1.0,
                         0.0)
    ake = where(frozen, satratio, ake_unfrozen)
    return ake * (thksat - thkdry) + thkdry


def thermoprop(soil, veg, gen, sltyp, lutyp, ist, nsnow, dt, dzsnso,
               snowh, snice, snliq, csoil, smc, swc, stc) -> ThermoOut:
    """Column thermal properties (reference func:1341-1445).

    dzsnso: (n, NLEVELS) layer thicknesses; snow slots 0..MSNOW-1 hold 0
    when inactive.
    """
    snow = csnow(snice, snliq, dzsnso[..., :MSNOW])

    soilice = smc - swc
    smcmax = col(soil.smcmax[sltyp])
    hc_soil = (swc * CWAT + (1.0 - smcmax) * csoil
               + (smcmax - smc) * CPAIR + soilice * CICE)
    df_soil = tdfcnd(soil, sltyp, smc, swc)
    # urban override (func:1405-1409)
    df_soil = where(col(lutyp == veg.isurban), 3.24, df_soil)
    # lake branch (func:1420-1430)
    stc_soil = stc[..., MSNOW:]
    lake = col(ist == 2)
    hc_soil = where(lake, where(stc_soil > TFRZ, CWAT, CICE), hc_soil)
    df_soil = where(lake, where(stc_soil > TFRZ, TKWAT, TKICE), df_soil)

    df = torch.cat([snow.tksno, df_soil], dim=-1)
    hcpct = torch.cat([snow.cvsno, hc_soil], dim=-1)
    fact = dt / (hcpct * maximum(dzsnso, MPE))

    # snow/soil interface blending of the top soil layer (func:1440-1444)
    dz1 = dzsnso[..., MSNOW]
    df1 = df[..., MSNOW]
    # no layered snow: blend with bulk snow conductivity 0.35
    df1_bulk = (df1 * dz1 + 0.35 * snowh) / (snowh + dz1)
    # layered snow: blend with the lowest snow layer (slot MSNOW-1)
    dz0 = dzsnso[..., MSNOW - 1]
    df1_lay = (df1 * dz1 + df[..., MSNOW - 1] * dz0) / maximum(dz0 + dz1, MPE)
    df = torch.cat([df[..., :MSNOW],
                    col(where(nsnow == 0, df1_bulk, df1_lay)),
                    df[..., MSNOW + 1:]], dim=-1)

    return ThermoOut(df, hcpct, fact, snow.snicev, snow.snliqv, snow.epore)
