"""Vegetation phenology: monthly LAI/SAI climatology, canopy burial by
snow, growing-season index (reference: core/module_noahmp_func.f90:534-630).
Counterpart of ``noahmp_tpu/physics/phenology.py``.
"""

from typing import NamedTuple

import torch

from ..numerics.ops import where, maximum, minimum, clip
from ..numerics.select import vsel


class PhenologyOut(NamedTuple):
    lai: torch.Tensor    # leaf area index before snow burial
    sai: torch.Tensor    # stem area index before snow burial
    elai: torch.Tensor   # effective (exposed) LAI
    esai: torch.Tensor   # effective (exposed) SAI
    igs: torch.Tensor    # growing-season index (0/1)
    htop: torch.Tensor   # canopy top height [m]


def phenology(veg, lutyp, snowh, tv, lat, yearlen, julian, lai, sai,
              opt_veg: int) -> PhenologyOut:
    """``veg`` is the VegParams table module, ``lutyp`` an int64 index;
    lai/sai carry the incoming (possibly carbon-prognosed) values used
    when opt_veg in (2, 5)."""
    if opt_veg in (1, 3, 4):
        # hemisphere-shifted fractional month (func:580-597)
        day = where(lat >= 0.0, julian,
                    torch.remainder(julian + 0.5 * yearlen, yearlen))
        t = 12.0 * day / yearlen
        it1 = torch.floor(t + 0.5).to(torch.int32)
        it2 = it1 + 1
        wt1 = (it1.to(t.dtype) + 0.5) - t
        wt2 = 1.0 - wt1
        it1 = where(it1 < 1, 12, it1)
        it2 = where(it2 > 12, 1, it2)
        # gather the class row once, then select the two bracketing
        # months
        lai_row = veg.lai12m[lutyp]
        sai_row = veg.sai12m[lutyp]
        lai = wt1 * vsel(lai_row, it1 - 1) + wt2 * vsel(lai_row, it2 - 1)
        sai = wt1 * vsel(sai_row, it1 - 1) + wt2 * vsel(sai_row, it2 - 1)

    sai = where(sai < 0.05, 0.0, sai)
    lai = where((lai < 0.05) | (sai == 0.0), 0.0, lai)

    nonveg = ((lutyp == veg.iswater) | (lutyp == veg.isbarren)
              | (lutyp == veg.isice) | (lutyp == veg.isurban))
    lai = where(nonveg, 0.0, lai)
    sai = where(nonveg, 0.0, sai)

    # canopy burial by snow (func:607-620)
    hvt = veg.hvt[lutyp]
    hvb = veg.hvb[lutyp]
    db = clip(snowh - hvb, 0.0, hvt - hvb)
    fb = db / maximum(1.0e-6, hvt - hvb)
    # short vegetation: exponential critical depth
    snowhc = hvt * torch.exp(-snowh / 0.2)
    fb_short = minimum(snowh, snowhc) / maximum(snowhc, 1.0e-12)
    fb = where((hvt > 0.0) & (hvt <= 1.0), fb_short, fb)

    elai = lai * (1.0 - fb)
    esai = sai * (1.0 - fb)
    esai = where(esai < 0.05, 0.0, esai)
    elai = where((elai < 0.05) | (esai == 0.0), 0.0, elai)

    igs = where(tv > veg.tmin[lutyp], 1.0, 0.0)
    return PhenologyOut(lai, sai, elai, esai, igs, hvt)


def green_fraction(veg, lutyp, shdfac, shdmax, lai, sai, elai, esai,
                   opt_veg: int):
    """Effective vegetated fraction fveg (reference func:366-380)."""
    if opt_veg == 1:
        fveg = shdfac
    elif opt_veg in (2, 3):
        fveg = 1.0 - torch.exp(-0.52 * (lai + sai))
    elif opt_veg in (4, 5):
        fveg = shdmax
    else:
        raise ValueError(f"unknown opt_veg {opt_veg}")
    fveg = maximum(fveg, 0.01)
    fveg = where((lutyp == veg.isurban) | (lutyp == veg.isbarren),
                 0.0, fveg)
    fveg = where(elai + esai == 0.0, 0.0, fveg)
    return fveg
