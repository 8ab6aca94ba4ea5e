"""Dynamic vegetation carbon (Dickinson et al. 1998)
(reference: core/module_noahmp_func.f90:6642-7025).  Active only for
opt_veg in (2, 5); prognoses leaf/stem/root/wood/soil carbon pools and
derives LAI/SAI from leaf/stem mass.  Counterpart of
``noahmp_tpu/physics/carbon.py`` with the land-point axis written out:
per-point values are (n,), layer vectors (n, L).
"""

from typing import NamedTuple

import torch

from ..constants import MSNOW, MPE, RGAS
from ..numerics.ops import (where, maximum, minimum, col, sum_last,
                            layer_index)
from ..numerics.select import vsel


class CarbonOut(NamedTuple):
    lfmass: torch.Tensor
    rtmass: torch.Tensor
    stmass: torch.Tensor
    wood: torch.Tensor
    stblcp: torch.Tensor
    fastcp: torch.Tensor
    lai: torch.Tensor
    sai: torch.Tensor
    gpp: torch.Tensor
    npp: torch.Tensor
    nee: torch.Tensor
    autors: torch.Tensor
    heters: torch.Tensor
    totsc: torch.Tensor
    totlb: torch.Tensor


def carbon(veg, lutyp, sltyp_smcmax, dt, zsoil, dzsoil, stc, smc, tv,
           tg, psn, foln, btran, apar, fveg, igs, troot, ist, lai, sai,
           lfmass, rtmass, stmass, wood, stblcp, fastcp) -> CarbonOut:
    """Carbon driver (reference func:6642-6751).  ``sltyp_smcmax`` is
    the per-point porosity (n,); ``stc`` is the (n, NLEVELS)
    temperature.  ``tg``, ``apar``, ``fveg``, ``troot`` and ``ist`` are
    read by nothing here, as in the reference's call tree; they keep the
    counterpart's signature."""
    nroot = veg.nroot[lutyp]
    lapm = veg.sla[lutyp] / 1000.0
    wstres = 1.0 - btran
    in_root = layer_index(smc) < col(nroot)
    zroot = -vsel(zsoil, maximum(nroot - 1, 0))
    wroot = sum_last(where(
        in_root, smc / col(sltyp_smcmax) * dzsoil / col(zroot), 0.0))

    out = co2flux(veg, lutyp, igs, dt, stc[..., MSNOW], psn, troot, tv,
                  wroot, wstres, foln, lapm, lai, sai, lfmass, rtmass,
                  stmass, fastcp, stblcp, wood)

    # gate: non-vegetated classes zero all pools (func:6709-6727)
    gate = ((lutyp == veg.iswater) | (lutyp == veg.isbarren)
            | (lutyp == veg.isice) | (lutyp == veg.isurban))
    return CarbonOut(*[where(gate, 0.0, f) for f in out])


def co2flux(veg, lutyp, igs, dt, stc1, psn, troot, tv, wroot, wstres,
            foln, lapm, xlai, xsai, lfmass, rtmass, stmass, fastcp,
            stblcp, wood) -> CarbonOut:
    """Carbon pool update (reference func:6754-7025)."""
    rtovrc = 2.0e-8
    rswoodc = 3.0e-10
    bf = 0.90
    wstrc = 100.0
    laimin, xsamin = 0.05, 0.01
    sapm = 3.0 * 0.001
    # sla = 0 (the classes without leaves, not all of which the gate
    # zeroes) gives inf here and NaN further down, as upstream
    lfmsmn = laimin / lapm
    stmsmn = xsamin / sapm
    wdpool = veg.wdpool[lutyp]

    rf = where(igs == 0.0, 0.5, 1.0)
    fnf = minimum(foln / maximum(1.0e-6, veg.folnmx[lutyp]), 1.0)
    tf = veg.arm[lutyp] ** ((tv - 298.16) / 10.0)
    resp = veg.rmf25[lutyp] * tf * fnf * xlai * rf * (1.0 - wstres)
    rsleaf = minimum(lfmass / dt, resp * 12.0e-6)
    rsroot = veg.rmr25[lutyp] * (rtmass * 1.0e-3) * tf * rf * 12.0e-6
    rsstem = veg.rms25[lutyp] * (stmass * 1.0e-3) * tf * rf * 12.0e-6
    rswood = rswoodc * torch.exp(0.08 * (tv - 298.16)) * wood * wdpool

    carbfx = psn * 12.0e-6

    leafpt = where(lutyp == veg.isegblf,
                   torch.exp(0.01 * (1.0 - torch.exp(0.50 * xlai)) * xlai),
                   torch.exp(0.01 * (1.0 - torch.exp(0.75 * xlai)) * xlai))
    nonlef = 1.0 - leafpt
    stempt = xlai / 10.0
    leafpt = leafpt - stempt

    woodf = where(wood > 0.0,
                  (1.0 - torch.exp(-bf * (veg.wrrat[lutyp] * rtmass
                                          / maximum(wood, MPE)))
                   / bf) * wdpool,
                  0.0)
    rootpt = nonlef * (1.0 - woodf)
    woodpt = nonlef * woodf

    lftovr = veg.ltovrc[lutyp] * 1.0e-6 * lfmass
    sttovr = veg.ltovrc[lutyp] * 1.0e-6 * stmass
    rttovr = rtovrc * rtmass
    wdtovr = 9.5e-10 * wood

    sc = torch.exp(-0.3 * maximum(0.0, tv - veg.tdlef[lutyp])) \
        * (lfmass / 120.0)
    sd = torch.exp((wstres - 1.0) * wstrc)
    die_rate = veg.dilefw[lutyp] * sd + veg.dilefc[lutyp] * sc
    dielf = lfmass * 1.0e-6 * die_rate
    diest = stmass * 1.0e-6 * die_rate

    fragr = veg.fragr[lutyp]
    grleaf = maximum(0.0, fragr * (leafpt * carbfx - rsleaf))
    grstem = maximum(0.0, fragr * (stempt * carbfx - rsstem))
    grroot = maximum(0.0, fragr * (rootpt * carbfx - rsroot))
    grwood = maximum(0.0, fragr * (woodpt * carbfx - rswood))

    addnpplf = maximum(0.0, leafpt * carbfx - grleaf - rsleaf)
    addnppst = maximum(0.0, stempt * carbfx - grstem - rsstem)
    cold = tv < veg.tmin[lutyp]
    addnpplf = where(cold, 0.0, addnpplf)
    addnppst = where(cold, 0.0, addnppst)

    lfdel = (lfmass - lfmsmn) / dt
    stdel = (stmass - stmsmn) / dt
    dielf = minimum(dielf, lfdel + addnpplf - lftovr)
    diest = minimum(diest, stdel + addnppst - sttovr)

    nppl = maximum(addnpplf, -lfdel)
    npps = maximum(addnppst, -stdel)
    nppr = rootpt * carbfx - rsroot - grroot
    nppw = woodpt * carbfx - rswood - grwood

    lfmass = lfmass + (nppl - lftovr - dielf) * dt
    stmass = stmass + (npps - sttovr - diest) * dt
    rtmass = rtmass + (nppr - rttovr) * dt
    # a root pool driven negative gives all of this step's root
    # production to the turnover, before the soil pool takes it up
    neg_rt = rtmass < 0.0
    rttovr = where(neg_rt, nppr, rttovr)
    rtmass = where(neg_rt, 0.0, rtmass)
    wood = (wood + (nppw - wdtovr) * dt) * wdpool

    fastcp = fastcp + (rttovr + lftovr + sttovr + wdtovr + dielf) * dt
    fst = 2.0 ** ((stc1 - 283.16) / 10.0)
    fsw = wroot / (0.20 + wroot) * 0.23 / (0.23 + wroot)
    rssoil = fsw * fst * veg.mrp[lutyp] \
        * maximum(0.0, fastcp * 1.0e-3) * 12.0e-6
    stablc = 0.1 * rssoil
    fastcp = fastcp - (rssoil + stablc) * dt
    stblcp = stblcp + stablc * dt

    gpp = carbfx
    npp = nppl + nppw + nppr
    autors = rsroot + rswood + rsleaf + grleaf + grroot + grwood
    heters = rssoil
    nee = (autors + heters - gpp) * 44.0 / 12.0
    totsc = fastcp + stblcp
    totlb = lfmass + rtmass + wood

    xlai = maximum(lfmass * lapm, laimin)
    xsai = maximum(stmass * sapm, xsamin)

    return CarbonOut(lfmass, rtmass, stmass, wood, stblcp, fastcp,
                     xlai, xsai, gpp, npp, nee, autors, heters, totsc,
                     totlb)


def bvocflux(veg, lutyp, vegfrac, apar, tv):
    """Guenther biogenic VOC emissions, 5 species [ug C m-2 h-1]
    (reference func:7028-7112: present upstream but disconnected from
    the call tree, func:59,6749; an optional diagnostic here too, called
    by nothing in the step).  Returns (n, 5) fluxes."""
    alpha, cl1 = 0.0027, 1.066
    ct1, ct2, ct3 = 95000.0, 230000.0, 0.961
    tm, tstd, bet = 314.0, 303.0, 0.09

    eps = veg.eps[lutyp]              # (n, 5)
    reciprod = 1.0 / (RGAS * tv * tstd)
    ct = torch.exp(ct1 * (tv - tstd) * reciprod) \
        / (ct3 + torch.exp(ct2 * (tv - tm) * reciprod))
    par = apar * 4.6
    cl = alpha * cl1 * par * (1.0 + alpha * alpha * par * par) ** (-0.5)
    gamma_rest = torch.exp(bet * (tv - tstd))
    gamma = torch.cat([col(cl * ct), col(gamma_rest).expand(-1, 4)], dim=-1)
    elai = maximum(0.0, -6.5 / 2.5 * torch.log(maximum(1.0 - vegfrac, MPE)))
    density = elai / (maximum(veg.slarea[lutyp], MPE) * 0.5)
    return eps * gamma * col(density)
