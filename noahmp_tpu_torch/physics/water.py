"""Hydrology driver: canopy water, snowpack driver, soil/lake water
balance (reference: core/module_noahmp_func.f90:4601-5174).  Counterpart
of ``noahmp_tpu/physics/water.py``.
"""

from typing import NamedTuple

import torch

from ..numerics.select import cumsum_small
from ..numerics.ops import (where, maximum, minimum, col, sum_last,
                            shift_down, layer_index)
from ..constants import (MSNOW, MPE, TFRZ, HVAP, HSUB,
                         CICE, CWAT, HFUS, DENICE, DENWAT)
from . import snow as snow_mod
from . import soilwater as sw_mod

WSLMAX = 5000.0   # maximum lake storage [mm] (func:4705)


class CanWaterOut(NamedTuple):
    canliq: torch.Tensor
    canice: torch.Tensor
    tv: torch.Tensor
    cmc: torch.Tensor
    ecan: torch.Tensor
    etran: torch.Tensor
    qrain: torch.Tensor
    qsnow: torch.Tensor
    snowhin: torch.Tensor
    fwet: torch.Tensor
    fpice: torch.Tensor


def canwater(veg, lutyp, dt, sfctmp, uu, vv, fcev, fctr, qprecc,
             qprecl, elai, esai, ist, tg, fveg, frozen_canopy, canliq,
             canice, tv, opt_snf: int) -> CanWaterOut:
    """Canopy interception/unloading/phase change
    (reference func:4807-5046)."""
    # rain/snow partition (func:4893-4921)
    if opt_snf == 1:
        fpice = where(
            sfctmp > TFRZ + 2.5, 0.0,
            where(sfctmp <= TFRZ + 0.5, 1.0,
                      where(sfctmp <= TFRZ + 2.0,
                                1.0 - (-54.632 + 0.2 * sfctmp), 0.6)))
    elif opt_snf == 2:
        fpice = where(sfctmp >= TFRZ + 2.2, 0.0, 1.0)
    else:
        fpice = where(sfctmp >= TFRZ, 0.0, 1.0)

    bdfall = minimum(120.0, 67.92 + 51.25
                         * torch.exp((sfctmp - TFRZ) / 2.59))
    prcp = qprecc + qprecl
    rain = prcp * (1.0 - fpice)
    snowf = prcp * fpice
    fp = where(prcp > 0.0,
                   prcp / maximum(10.0 * qprecc + qprecl, MPE), 0.0)

    vai = elai + esai
    has_canopy = vai > 0.0

    # liquid interception (func:4938-4953)
    maxliq = veg.canwmxp[lutyp] * vai
    qintr = fveg * rain * fp
    qintr = minimum(qintr, (maxliq - canliq) / dt
                        * (1.0 - torch.exp(-rain * dt
                                         / maximum(maxliq, MPE))))
    qintr = maximum(qintr, 0.0)
    qintr = where(has_canopy, qintr, 0.0)
    qdripr = where(has_canopy, fveg * rain - qintr, 0.0)
    qthror = where(has_canopy, (1.0 - fveg) * rain, rain)

    # canopy ET partition by phase (func:4956-4968)
    etran = where(frozen_canopy, maximum(fctr / HSUB, 0.0),
                      maximum(fctr / HVAP, 0.0))
    qevac = where(frozen_canopy, 0.0, maximum(fcev / HVAP, 0.0))
    qdewc = where(frozen_canopy, 0.0,
                      torch.abs(minimum(fcev / HVAP, 0.0)))
    qsubc = where(frozen_canopy, maximum(fcev / HSUB, 0.0), 0.0)
    qfroc = where(frozen_canopy,
                      torch.abs(minimum(fcev / HSUB, 0.0)), 0.0)

    qevac = minimum(canliq / dt, qevac)
    canliq = maximum(0.0, canliq + (qintr + qdewc - qevac) * dt)
    canliq = where(canliq <= 1.0e-6, 0.0, canliq)

    # snow interception (func:4977-4992)
    maxsno = 6.6 * (0.27 + 46.0 / bdfall) * vai
    qints = fveg * snowf * fp
    qints = minimum(qints, (maxsno - canice) / dt
                        * (1.0 - torch.exp(-snowf * dt
                                         / maximum(maxsno, MPE))))
    qints = maximum(qints, 0.0)
    qints = where(has_canopy, qints, 0.0)
    ft = maximum(0.0, (tv - 270.15) / 1.87e5)
    fv = torch.sqrt(uu * uu + vv * vv) / 1.56e5
    qdrips = where(has_canopy,
                       maximum(0.0, canice) * (fv + ft), 0.0)
    qthros = where(has_canopy,
                       (1.0 - fveg) * snowf + (fveg * snowf - qints),
                       snowf)

    qsubc = minimum(canice / dt, qsubc)
    canice = maximum(0.0, canice + (qints - qdrips) * dt
                         + (qfroc - qsubc) * dt)
    canice = where(canice <= 1.0e-6, 0.0, canice)

    # wetted fraction (func:4998-5005)
    fwet = where(canice > 0.0,
                     maximum(0.0, canice) / maximum(maxsno,
                                                            1.0e-6),
                     maximum(0.0, canliq) / maximum(maxliq,
                                                            1.0e-6))
    fwet = minimum(fwet, 1.0) ** 0.667

    # canopy melt / refreeze (func:5009-5024)
    melt = (canice > 1.0e-6) & (tv > TFRZ)
    qmeltc = minimum(canice / dt, (tv - TFRZ) * CICE * canice
                         / DENICE / (dt * HFUS))
    canice_m = maximum(0.0, canice - qmeltc * dt)
    canliq_m = maximum(0.0, canliq + qmeltc * dt)
    tv_m = fwet * TFRZ + (1.0 - fwet) * tv
    canice = where(melt, canice_m, canice)
    canliq = where(melt, canliq_m, canliq)
    tv = where(melt, tv_m, tv)

    frz = (canliq > 1.0e-6) & (tv < TFRZ)
    qfrzc = minimum(canliq / dt, (TFRZ - tv) * CWAT * canliq
                        / DENWAT / (dt * HFUS))
    canliq_f = maximum(0.0, canliq - qfrzc * dt)
    canice_f = maximum(0.0, canice + qfrzc * dt)
    tv_f = fwet * TFRZ + (1.0 - fwet) * tv
    canliq = where(frz, canliq_f, canliq)
    canice = where(frz, canice_f, canice)
    tv = where(frz, tv_f, tv)

    cmc = canliq + canice
    ecan = qevac + qsubc - qdewc - qfroc
    qrain = qdripr + qthror
    qsnow = qdrips + qthros
    snowhin = qsnow / bdfall
    warm_lake = (ist == 2) & (tg > TFRZ)
    qsnow = where(warm_lake, 0.0, qsnow)
    snowhin = where(warm_lake, 0.0, snowhin)

    return CanWaterOut(canliq, canice, tv, cmc, ecan, etran, qrain,
                       qsnow, snowhin, fwet, fpice)


class SnowWaterOut(NamedTuple):
    nsnow: torch.Tensor
    snowh: torch.Tensor
    sneqv: torch.Tensor
    snice: torch.Tensor
    snliq: torch.Tensor
    stc: torch.Tensor      # full (n, NLEVELS)
    zsnso: torch.Tensor    # full (n, NLEVELS)
    dzsnso: torch.Tensor   # full (n, NLEVELS)
    swc: torch.Tensor
    sice: torch.Tensor
    qsnbot: torch.Tensor
    snoflow: torch.Tensor
    ponding1: torch.Tensor
    ponding2: torch.Tensor


def _active_slots(nsnow, like):
    """Live-slot mask (n, L) for a bottom-aligned layer array shaped as
    ``like``: the MSNOW snow slots alone, or extended by the always-live
    soil slots (index >= MSNOW).  The extended form relies on the
    invariant 0 <= nsnow <= MSNOW (snow.py guards every nsnow decrement
    with nsnow > 0 and every increment against MSNOW); if nsnow could go
    negative, soil depths would be silently zeroed here."""
    return layer_index(like) >= col(MSNOW - nsnow)


def snowwater_full(gen, dt, zsoil, dzsnow, imelt_snow, sfctmp, snowhin,
                   qsnow, qsnfro, qsnsub, qrain, ficeold, nsnow, snowh,
                   sneqv, snice, snliq, swc, sice,
                   stc) -> SnowWaterOut:
    """Snowpack driver (reference func:5049-5174).  ``dzsnow`` is the
    (n, MSNOW) positive snow layer thickness from the previous dzsnso."""
    dz_soil = -(zsoil - shift_down(zsoil))
    zero = torch.zeros_like(sneqv)
    p = snow_mod.Pack(
        nsnow=nsnow, dz=dzsnow, ice=snice, liq=snliq, stc=stc[..., :MSNOW],
        sneqv=sneqv, snowh=snowh, swc0=swc[..., 0], sice0=sice[..., 0],
        dzsoil1=dz_soil[..., 0], ponding1=zero, ponding2=zero)

    p = snow_mod.snowfall(p, dt, qsnow, snowhin, sfctmp)

    def gated(fn, p):
        return snow_mod.select_pack(p.nsnow > 0, fn(p), p)

    p = gated(lambda q: snow_mod.compact(q, dt, imelt_snow, ficeold), p)
    p = gated(snow_mod.combine, p)
    p = gated(snow_mod.divide, p)

    p, qsnbot = snow_mod.snowh2o(p, dt, qsnfro, qsnsub, qrain, gen.ssi)

    # zero empty layers (func:5127-5133)
    active = _active_slots(p.nsnow, p.dz)
    ice = where(active, p.ice, 0.0)
    liq = where(active, p.liq, 0.0)
    stc3 = where(active, p.stc, 0.0)
    dz3 = where(active, p.dz, 0.0)

    # glacier overflow (func:5137-5143)
    over = p.sneqv > 2000.0
    bot = MSNOW - 1
    bdsnow = ice[..., bot] / maximum(dz3[..., bot], MPE)
    snoflow_mm = where(over, p.sneqv - 2000.0, 0.0)
    is_bot = layer_index(ice) == bot
    ice = ice - where(is_bot, col(snoflow_mm), 0.0)
    dz3 = dz3 - where(is_bot & col(over),
                      col(snoflow_mm / maximum(bdsnow, MPE)), 0.0)
    snoflow = snoflow_mm / dt

    # layered pack mass (func:5147-5152)
    sneqv = where(p.nsnow > 0, sum_last(where(active, ice + liq, 0.0)),
                  p.sneqv)

    # rebuild zsnso/dzsnso (func:5154-5172)
    dz_full = torch.cat([dz3, dz_soil], dim=-1)
    zsnso = -cumsum_small(dz_full)
    # inactive snow slots must carry zero depth; soil slots are always
    # live (see _active_slots for the nsnow invariant this rests on)
    full_active = _active_slots(p.nsnow, dz_full)
    zsnso = where(full_active, zsnso, 0.0)
    dzsnso = where(full_active, dz_full, 0.0)

    stc_out = torch.cat([stc3, stc[..., MSNOW:]], dim=-1)
    swc_out = torch.cat([col(p.swc0), swc[..., 1:]], dim=-1)
    sice_out = torch.cat([col(p.sice0), sice[..., 1:]], dim=-1)

    return SnowWaterOut(p.nsnow, p.snowh, sneqv, ice, liq, stc_out,
                        zsnso, dzsnso, swc_out, sice_out, qsnbot,
                        snoflow, p.ponding1, p.ponding2)


class WaterOut(NamedTuple):
    canliq: torch.Tensor
    canice: torch.Tensor
    tv: torch.Tensor
    fwet: torch.Tensor
    nsnow: torch.Tensor
    snowh: torch.Tensor
    sneqv: torch.Tensor
    snice: torch.Tensor
    snliq: torch.Tensor
    stc: torch.Tensor
    zsnso: torch.Tensor
    dzsnso: torch.Tensor
    swc: torch.Tensor
    smc: torch.Tensor
    zwt: torch.Tensor
    wa: torch.Tensor
    wt: torch.Tensor
    wslake: torch.Tensor
    cmc: torch.Tensor
    ecan: torch.Tensor
    etran: torch.Tensor
    runsrf: torch.Tensor
    runsub: torch.Tensor
    qin: torch.Tensor
    qdis: torch.Tensor
    qsnow: torch.Tensor
    ponding1: torch.Tensor
    ponding2: torch.Tensor
    qsnbot: torch.Tensor
    fpice: torch.Tensor


def water(params, opts, lutyp, sltyp, slptyp, ist, dt, zsoil, dzsnow,
          imelt_snow, uu, vv, fcev, fctr, qprecc, qprecl, elai, esai,
          sfctmp, qvap, qdew, btrani, ficeold, ponding, tg, fveg,
          latheav, latheag, frozen_canopy, frozen_ground,
          nsnow, canliq, canice, tv, snowh, sneqv, snice, snliq, stc,
          swc, smc, zwt, wa, wt, wslake) -> WaterOut:
    """Hydrology driver (reference func:4601-4804)."""
    veg_p, soil_p, gen_p = params.veg, params.soil, params.gen
    sice = maximum(0.0, smc - swc)

    cw = canwater(veg_p, lutyp, dt, sfctmp, uu, vv, fcev, fctr, qprecc,
                  qprecl, elai, esai, ist, tg, fveg, frozen_canopy,
                  canliq, canice, tv, opts.snf)

    # sublimation/frost vs soil evap/dew partition (func:4725-4735)
    has_snow = sneqv > 0.0
    qsnsub = where(has_snow, minimum(qvap, sneqv / dt), 0.0)
    qseva = qvap - qsnsub
    qsnfro = where(has_snow, qdew, 0.0)
    qsdew = qdew - qsnfro

    sw = snowwater_full(gen_p, dt, zsoil, dzsnow, imelt_snow, sfctmp,
                        cw.snowhin, cw.qsnow, qsnfro, qsnsub, cw.qrain,
                        ficeold, nsnow, snowh, sneqv, snice, snliq,
                        swc, sice, stc)
    swc, sice = sw.swc, sw.sice

    # frozen-ground dew/evap acts on soil ice (func:4744-4752)
    dz1 = sw.dzsnso[..., MSNOW]
    sice0 = where(frozen_ground,
                      sice[..., 0] + (qsdew - qseva) * dt / (dz1 * 1000.0),
                      sice[..., 0])
    qsdew_g = where(frozen_ground, 0.0, qsdew)
    qseva_g = where(frozen_ground, 0.0, qseva)
    neg = frozen_ground & (sice0 < 0.0)
    swc = torch.cat([col(where(neg, swc[..., 0] + sice0, swc[..., 0])),
                     swc[..., 1:]], dim=-1)
    sice = torch.cat([col(where(neg, 0.0, sice0)), sice[..., 1:]], dim=-1)

    # surface water input (func:4754-4764)
    qinsrf = (ponding + sw.ponding1 + sw.ponding2) / dt * 0.001
    qinsrf = qinsrf + where(sw.nsnow == 0,
                                (sw.qsnbot + qsdew_g + cw.qrain),
                                (sw.qsnbot + qsdew_g)) * 0.001
    qseva_m = qseva_g * 0.001

    etrani = col(cw.etran) * btrani * 0.001  # (n, NSOIL) [m/s]

    dz_soil = sw.dzsnso[..., MSNOW:]

    # lake branch (func:4774-4777)
    runsrf_lake = where(wslake >= WSLMAX, qinsrf * 1000.0, 0.0)
    wslake_new = wslake + (qinsrf - qseva_m) * 1000.0 * dt \
        - runsrf_lake * dt

    sh = sw_mod.soilh2o(soil_p, gen_p, veg_p, sltyp, slptyp, lutyp, dt,
                        zsoil, dz_soil, qinsrf, qseva_m, etrani, sice,
                        swc, smc, zwt, opts.run, opts.inf)

    if opts.run == 1:
        gw = sw_mod.groundwater(soil_p, gen_p, sltyp, dt, zsoil, sice,
                                sh.wcnd, sh.fcrmax, sh.swc, sh.zwt, wa,
                                wt)
        swc_soil = gw.swc
        zwt_soil = gw.zwt
        wa_new, wt_new = gw.wa, gw.wt
        qin, qdis = gw.qin, gw.qdis
        runsub = qdis
    else:
        swc_soil = sh.swc
        zwt_soil = sh.zwt
        wa_new, wt_new = wa, wt
        qin = torch.zeros_like(tg)
        qdis = torch.zeros_like(tg)
        runsub = sh.runsub
        if opts.run in (3, 4):
            runsub = runsub + sh.qdrain

    smc_soil = swc_soil + sice

    is_lake = ist == 2
    swc = where(col(is_lake), swc, swc_soil)
    smc = where(col(is_lake), smc, smc_soil)
    zwt = where(is_lake, zwt, zwt_soil)
    runsrf = where(is_lake, runsrf_lake, sh.runsrf)
    runsub = where(is_lake, 0.0, runsub) + sw.snoflow
    wslake = where(is_lake, wslake_new, wslake)
    wa = where(is_lake, wa, wa_new)
    wt = where(is_lake, wt, wt_new)

    return WaterOut(
        canliq=cw.canliq, canice=cw.canice, tv=cw.tv, fwet=cw.fwet,
        nsnow=sw.nsnow, snowh=sw.snowh, sneqv=sw.sneqv, snice=sw.snice,
        snliq=sw.snliq, stc=sw.stc, zsnso=sw.zsnso, dzsnso=sw.dzsnso,
        swc=swc, smc=smc, zwt=zwt, wa=wa, wt=wt, wslake=wslake,
        cmc=cw.cmc, ecan=cw.ecan, etran=cw.etran, runsrf=runsrf,
        runsub=runsub, qin=qin, qdis=qdis, qsnow=cw.qsnow,
        ponding1=sw.ponding1, ponding2=sw.ponding2, qsnbot=sw.qsnbot,
        fpice=cw.fpice)
