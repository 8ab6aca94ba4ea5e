"""Snow/soil temperature diffusion and phase change
(reference: core/module_noahmp_func.f90:3987-4598).  Counterpart of
``noahmp_tpu/physics/soiltemp.py``.

The heat equation is assembled over all NLEVELS=7 slots with inactive
snow slots as identity rows, then solved with the batched Thomas solve
(the CUDA kernel when the tensors are on the card).  Phase change
(melt/freeze of snow layers, bulk thin snow, and soil water with
supercooled liquid) is fully masked elementwise.
"""

from typing import NamedTuple

import torch

from ..constants import (MSNOW, NLEVELS, MPE, TFRZ, HFUS, GRAV)
from ..numerics.ops import (where, maximum, minimum, clip, col, sum_last,
                            shift_down, shift_up, layer_index)
from ..numerics.tridiag import thomas, masked_identity_rows

FRH2O_TRIPS = 10


def tsnosoi(dt, nsnow, tbot, zbot, zsnso, ssoil, df, hcpct, snowh, stc,
            opt_tbot: int, opt_stc: int):
    """Advance snow/soil temperatures one implicit step
    (reference func:3987-4237).  Returns new stc (n, NLEVELS)."""
    idx = layer_index(stc)
    top = col(MSNOW - nsnow)
    active = idx >= top
    is_top = idx == top
    is_bot = idx == NLEVELS - 1

    zbotsno = zbot - snowh  # lower BC depth measured from snow surface

    zs = zsnso
    zs_prev = shift_down(zs)
    zs_next = shift_up(zs)
    stc_next = shift_up(stc)

    denom = (zs_prev - zs) * hcpct
    denom_safe = where(active, denom, -1.0)
    temp1 = where(is_bot, zs_prev - zs, zs_prev - zs_next)
    temp1 = where(active, temp1, -1.0)
    ddz = 2.0 / temp1
    dtsdz = 2.0 * (stc - stc_next) / temp1
    nl = NLEVELS
    if opt_tbot == 1:
        botflx = torch.zeros_like(snowh)
    else:
        dtsdz_bot = (stc[..., nl - 1] - tbot) \
            / (0.5 * (zs[..., nl - 2] + zs[..., nl - 1]) - zbotsno)
        dtsdz = torch.cat([dtsdz[..., :nl - 1], col(dtsdz_bot)], dim=-1)
        botflx = -df[..., nl - 1] * dtsdz_bot

    df_prev = shift_down(df)
    dtsdz_prev = shift_down(dtsdz)
    ddz_prev = shift_down(ddz)

    prev_flux = where(is_top, col(ssoil), df_prev * dtsdz_prev)
    eflux = where(is_bot, col(-botflx) - prev_flux,
                  df * dtsdz - prev_flux)

    ai = where(is_top, 0.0, -df_prev * ddz_prev / denom_safe)
    ci = where(is_bot, 0.0, -df * ddz / denom_safe)
    bi = -(ai + ci)
    if opt_stc == 2:
        extra = df / (0.5 * zs * zs * hcpct)
        bi = where(is_top, bi + extra, bi)
    rhsts = eflux / (-denom_safe)

    # hstep: dt scaling + Thomas solve (func:4190-4237)
    a = ai * dt
    b = 1.0 + bi * dt
    c = ci * dt
    d = rhsts * dt
    a, b, c, d = masked_identity_rows(active, a, b, c, d)
    delta = thomas(a, b, c, d)
    return stc + where(active, delta, 0.0)


def frh2o(soil, sltyp, tkelv, smc, swc):
    """Supercooled liquid soil water, Koren99 eq.17 Newton iteration in
    log space with Flerchinger fallback (reference func:4494-4598).
    tkelv, smc, swc: (n, NSOIL)."""
    ck, blim, err = 8.0, 5.5, 0.005
    bx = col(minimum(soil.bexp[sltyp], blim))
    psisat = col(soil.psisat[sltyp])
    smcmax = col(soil.smcmax[sltyp])

    swl0 = clip(smc - swc, 0.0, smc - 0.02)

    # guard the log arguments for the warm branch (result unused there)
    tk_safe = minimum(tkelv, TFRZ - 1.0e-3)
    smc_safe = maximum(smc, 0.021)
    swl = clip(swl0, 0.0, smc_safe - 0.02)

    kcount = torch.zeros_like(swl, dtype=torch.bool)
    # fixed 10 trips, frozen per element once converged
    for _ in range(FRH2O_TRIPS):
        dfn = (torch.log((psisat * GRAV / HFUS) * (1.0 + ck * swl) ** 2
                         * (smcmax / (smc_safe - swl)) ** bx)
               - torch.log(-(tk_safe - TFRZ) / tk_safe))
        denom = 2.0 * ck / (1.0 + ck * swl) + bx / (smc_safe - swl)
        swlk = clip(swl - dfn / denom, 0.0, smc_safe - 0.02)
        dswl = torch.abs(swlk - swl)
        swl = where(kcount, swl, swlk)
        kcount = kcount | (dswl <= err)
    free_iter = smc - swl

    # Flerchinger explicit fallback when the iteration failed (func:4588-4595)
    fk = ((HFUS / (GRAV * (-psisat))
           * ((tk_safe - TFRZ) / tk_safe)) ** (-1.0 / bx)) * smcmax
    fk = maximum(fk, 0.02)
    free_flerch = minimum(fk, smc)
    free = where(kcount, free_iter, free_flerch)
    return where(tkelv > TFRZ - 1.0e-3, smc, free)


class PhaseChangeOut(NamedTuple):
    stc: torch.Tensor
    snice: torch.Tensor
    snliq: torch.Tensor
    sneqv: torch.Tensor
    snowh: torch.Tensor
    smc: torch.Tensor
    swc: torch.Tensor
    qmelt: torch.Tensor
    imelt: torch.Tensor    # (n, NLEVELS) int32: 1 melt, 2 freeze
    ponding: torch.Tensor


def phasechange(soil, sltyp, ist, dt, nsnow, fact, dzsnso, stc, snice,
                snliq, sneqv, snowh, smc, swc,
                opt_frz: int) -> PhaseChangeOut:
    """Melt/freeze of snow and soil water (reference func:4291-4491)."""
    idx = layer_index(stc)
    top = col(MSNOW - nsnow)
    snow_active = (idx < MSNOW) & (idx >= top)
    soil_slot = idx >= MSNOW
    active = snow_active | soil_slot

    dz = dzsnso
    dz_soil = dz[..., MSNOW:]

    mice = torch.cat([snice, (smc - swc) * dz_soil * 1000.0], dim=-1)
    mliq = torch.cat([snliq, swc * dz_soil * 1000.0], dim=-1)
    # zero out inactive snow slots
    mice = where(active, mice, 0.0)
    mliq = where(active, mliq, 0.0)

    wice0 = mice
    wmass0 = mice + mliq

    # supercooled liquid water for soil slots (func:4373-4387)
    stc_soil = stc[..., MSNOW:]
    if opt_frz == 1:
        smp = HFUS * (TFRZ - stc_soil) / (GRAV * stc_soil)
        sc = col(soil.smcmax[sltyp]) * (maximum(smp, MPE)
                                        / col(soil.psisat[sltyp])) \
            ** (-1.0 / col(soil.bexp[sltyp]))
        sc = where(stc_soil < TFRZ, sc, 0.0)
    else:
        sc = frh2o(soil, sltyp, stc_soil, smc, swc)
    supercool_soil = sc * dz_soil * 1000.0
    supercool = torch.cat([torch.zeros_like(snice), supercool_soil],
                          dim=-1)
    supercool = where(col(ist == 1) & soil_slot, supercool, 0.0)

    zero_i = torch.zeros_like(stc, dtype=torch.int32)
    imelt = where(active & (mice > 0.0) & (stc >= TFRZ), 1, zero_i)
    imelt = where(active & (mliq > supercool) & (stc < TFRZ), 2, imelt)
    # thin snow without a layer melts through the first soil slot
    bulk_snow = (nsnow == 0) & (sneqv > 0.0)
    first_soil = idx == MSNOW
    imelt = where(col(bulk_snow) & first_soil & (stc >= TFRZ), 1, imelt)

    # energy surplus/deficit (func:4406-4421)
    hm = where(imelt > 0, (stc - TFRZ) / fact, 0.0)
    stc = where(imelt > 0, TFRZ, stc)
    bad_melt = (imelt == 1) & (hm < 0.0)
    bad_frz = (imelt == 2) & (hm > 0.0)
    hm = where(bad_melt | bad_frz, 0.0, hm)
    imelt = where(bad_melt | bad_frz, 0, imelt)
    xm = hm * dt / HFUS

    # bulk (no-layer) snowmelt acting on the first soil slot (func:4424-4440)
    xm1 = xm[..., MSNOW]
    hm1 = hm[..., MSNOW]
    do_bulk = bulk_snow & (xm1 > 0.0)
    temp1 = sneqv
    sneqv_new = maximum(0.0, temp1 - xm1)
    propor = sneqv_new / maximum(temp1, MPE)
    snowh_new = maximum(0.0, propor * snowh)
    heatr = hm1 - HFUS * (temp1 - sneqv_new) / dt
    xm1_new = where(heatr > 0.0, heatr * dt / HFUS, 0.0)
    hm1_new = where(heatr > 0.0, heatr, 0.0)
    qmelt_b = maximum(0.0, temp1 - sneqv_new) / dt
    ponding_b = temp1 - sneqv_new

    sneqv = where(do_bulk, sneqv_new, sneqv)
    snowh = where(do_bulk, snowh_new, snowh)
    xm = where(first_soil, col(where(do_bulk, xm1_new, xm1)), xm)
    hm = where(first_soil, col(where(do_bulk, hm1_new, hm1)), hm)
    qmelt = where(do_bulk, qmelt_b, 0.0)
    ponding = where(do_bulk, ponding_b, 0.0)

    # melt/freeze mass exchange (func:4443-4479)
    go = (imelt > 0) & (torch.abs(hm) > 0.0)
    mice_melt = maximum(0.0, wice0 - xm)              # xm > 0
    # xm < 0: snow slots
    mice_frz_snow = minimum(wmass0, wice0 - xm)
    # xm < 0: soil slots
    mice_frz_soil = where(
        wmass0 < supercool, 0.0,
        maximum(minimum(wmass0 - supercool, wice0 - xm), 0.0))
    mice_frz = where(soil_slot, mice_frz_soil, mice_frz_snow)
    mice_new = where(xm > 0.0, mice_melt,
                     where(xm < 0.0, mice_frz, mice))
    heatr_l = where(xm != 0.0,
                    hm - HFUS * (wice0 - mice_new) / dt, 0.0)
    mliq_new = maximum(0.0, wmass0 - mice_new)
    stc_adj = stc + fact * heatr_l
    stc_adj = where(~soil_slot & (mliq_new * mice_new > 0.0),
                    TFRZ, stc_adj)
    stc = where(go & (torch.abs(heatr_l) > 0.0), stc_adj, stc)
    mice = where(go, mice_new, mice)
    mliq = where(go, mliq_new, mliq)
    qmelt = qmelt + sum_last(
        where(go & (idx < MSNOW),
              maximum(0.0, wice0 - mice) / dt, 0.0))

    snice_out = mice[..., :MSNOW]
    snliq_out = mliq[..., :MSNOW]
    swc_out = mliq[..., MSNOW:] / (1000.0 * dz_soil)
    smc_out = (mliq[..., MSNOW:] + mice[..., MSNOW:]) / (1000.0 * dz_soil)

    return PhaseChangeOut(stc, snice_out, snliq_out, sneqv, snowh,
                          smc_out, swc_out, qmelt, imelt, ponding)
