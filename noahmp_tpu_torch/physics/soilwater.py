"""Soil moisture: Richards-equation solve with adaptive sub-stepping,
four runoff schemes, equilibrium water table, Schaake infiltration, and
the SIMGM unconfined aquifer
(reference: core/module_noahmp_func.f90:5822-6639).  Counterpart of
``noahmp_tpu/physics/soilwater.py``.

The 4-row tridiagonal moisture solve goes through the batched Thomas
solve (the CUDA kernel when the tensors are on the card).  The
reference's data-dependent sub-step count (3 or 6) is a fixed 6-trip
loop with the trips beyond a point's count masked out, so one step
always launches six solves.
"""

from typing import NamedTuple

import torch

from ..constants import NSOIL, MPE
from ..numerics.ops import (where, maximum, minimum, clip, col, sum_last,
                            shift_down, shift_up, layer_index)
from ..numerics.tridiag import thomas
from ..numerics.select import vsel, cumsum_small


def _like(p, x):
    """Per-point parameter ``p`` (n,) shaped to broadcast against ``x``:
    (n, 1) when ``x`` carries a layer axis."""
    return col(p) if x.dim() > p.dim() else p


def wdfcnd1(soil, sltyp, smc, fcr):
    """Diffusivity/conductivity scaled by unfrozen fraction
    (reference func:6386-6417)."""
    bexp = _like(soil.bexp[sltyp], smc)
    factr = maximum(0.01, smc / _like(soil.smcmax[sltyp], smc))
    wdf = _like(soil.dwsat[sltyp], smc) * factr ** (bexp + 2.0)
    wdf = wdf * (1.0 - fcr)
    wcnd = _like(soil.dksat[sltyp], smc) * factr ** (2.0 * bexp + 3.0)
    wcnd = wcnd * (1.0 - fcr)
    return wdf, wcnd


def wdfcnd2(soil, sltyp, smc, sice):
    """Diffusivity with ice-weighted blend (reference func:6420-6455).
    ``sice`` is per point (n,); ``smc`` per point or per layer."""
    smcmax = _like(soil.smcmax[sltyp], smc)
    bexp = _like(soil.bexp[sltyp], smc)
    dwsat = _like(soil.dwsat[sltyp], smc)
    sice = _like(sice, smc)
    expon = bexp + 2.0
    factr = maximum(0.01, smc / smcmax)
    wdf = dwsat * factr ** expon
    vkwgt = 1.0 / (1.0 + (500.0 * sice) ** 3.0)
    wdf_ice = vkwgt * wdf + (1.0 - vkwgt) * dwsat \
        * (0.2 / smcmax) ** expon
    wdf = where(sice > 0.0, wdf_ice, wdf)
    wcnd = _like(soil.dksat[sltyp], smc) * factr ** (2.0 * bexp + 3.0)
    return wdf, wcnd


def zwteq(soil, sltyp, zsoil, dzsoil, swc):
    """Equilibrium water-table depth on a 100-layer fine grid
    (reference func:6051-6100)."""
    nfine = 100
    smcmax = soil.smcmax[sltyp]
    zbot = zsoil[..., NSOIL - 1]
    wd1 = sum_last((col(smcmax) - swc) * dzsoil)
    dzfine = 3.0 * (-zbot) / nfine
    kk = torch.arange(1, nfine + 1, dtype=swc.dtype, device=swc.device)
    zfine = kk * col(dzfine)
    zwt0 = -3.0 * zbot - 0.001
    temp = 1.0 + (col(zwt0) - zfine) / col(soil.psisat[sltyp])
    incr = col(smcmax) * (1.0 - maximum(temp, MPE)
                          ** (-1.0 / col(soil.bexp[sltyp]))) * col(dzfine)
    wd2 = cumsum_small(incr)
    hit = torch.abs(wd2 - col(wd1)) <= 0.01
    # first-True index: min of the masked layer numbers; nfine when no
    # hit (masked by any(hit) below)
    fine = torch.arange(nfine, dtype=torch.int32, device=swc.device)
    first = torch.where(hit, fine, nfine).amin(dim=-1)
    # zfine[first] == (first+1)*dzfine exactly (how zfine was built)
    zhit = (first + 1).to(swc.dtype) * dzfine
    return where(hit.any(dim=-1), zhit, zwt0)


def infil(soil, sltyp, dt, zsoil, swc, sice, sicemax, qinsrf):
    """Schaake96 maximum infiltration (reference func:6103-6196).
    Returns (qinfil, runsrf) in m/s."""
    cvfrz = 3
    dt1 = dt / 86400.0
    smcmax = col(soil.smcmax[sltyp])
    smcwlt = col(soil.smcwlt[sltyp])
    smcav = smcmax - smcwlt
    dz = shift_down(zsoil) - zsoil
    dice = sum_last(dz * sice)
    dmax = dz * smcav * (1.0 - (swc + sice - smcwlt) / smcav)
    dd = sum_last(dmax)
    val = 1.0 - torch.exp(-soil.kdt[sltyp] * dt1)
    ddt = dd * val
    px = maximum(0.0, qinsrf * dt)
    infmax = (px * (ddt / maximum(px + ddt, MPE))) / dt

    # frozen-soil correction: truncated series for CVFRZ=3 (func:6167-6180)
    acrt = cvfrz * soil.frzx[sltyp] / maximum(dice, MPE)
    series = 1.0 + acrt + acrt ** 2 / 2.0
    fcr = where(dice > 1.0e-2, 1.0 - torch.exp(-acrt) * series, 1.0)
    infmax = infmax * fcr

    _wdf, wcnd = wdfcnd2(soil, sltyp, swc[..., 0], sicemax)
    infmax = maximum(infmax, wcnd)
    infmax = minimum(infmax, px)
    runsrf = maximum(0.0, qinsrf - infmax)
    qinfil = qinsrf - runsrf
    rain = qinsrf > 0.0
    return where(rain, qinfil, 0.0), where(rain, runsrf, 0.0)


def srt(soil, gen, sltyp, slptyp, zsoil, qinfil, etrani, qseva, swc,
        smc, zwt, fcr, sicemax, fcrmax, opt_run: int, opt_inf: int):
    """Assemble the Richards tridiagonal (reference func:6199-6305).
    Returns (a, b, c, rhs, qdrain, wcnd)."""
    if opt_inf == 1:
        wdf, wcnd = wdfcnd1(soil, sltyp, smc, fcr)
        smx = smc
    else:
        wdf, wcnd = wdfcnd2(soil, sltyp, swc, sicemax)
        smx = swc

    z_prev = shift_down(zsoil)
    z_next = shift_up(zsoil)
    smx_next = shift_up(smx)
    idx = layer_index(zsoil)
    is_top = idx == 0
    is_bot = idx == NSOIL - 1

    denom = z_prev - zsoil
    temp1 = where(is_bot, z_prev - zsoil, z_prev - z_next)
    ddz = 2.0 / temp1
    dsmdz = 2.0 * (smx - smx_next) / temp1

    if opt_run in (1, 2):
        qdrain = torch.zeros_like(qinfil)
    elif opt_run == 3:
        qdrain = gen.slope[slptyp] * wcnd[..., NSOIL - 1]
    else:
        qdrain = (1.0 - fcrmax) * wcnd[..., NSOIL - 1]

    wdf_prev = shift_down(wdf)
    wcnd_prev = shift_down(wcnd)
    dsmdz_prev = shift_down(dsmdz)
    ddz_prev = shift_down(ddz)

    up_flux = where(is_top, col(qinfil - qseva),
                    wdf_prev * dsmdz_prev + wcnd_prev)
    wflux = where(is_bot,
                  -up_flux + etrani + col(qdrain),
                  wdf * dsmdz + wcnd - up_flux + etrani)

    a = where(is_top, 0.0, -wdf_prev * ddz_prev / denom)
    c = where(is_bot, 0.0, -wdf * ddz / denom)
    # the reference writes the top-row diagonal directly (func:6292)
    b = where(is_top, wdf * ddz / denom, -(a + c))
    rhs = wflux / (-denom)
    return a, b, c, rhs, qdrain, wcnd


def sstep(soil, sltyp, dt, dzsoil, sice, swc, a, b, c, rhs):
    """dt-scale, Thomas solve, saturation-excess bucket push-up
    (reference func:6308-6383).  ``dt`` is per point (n,).
    Returns (swc, smc, wplus [m])."""
    dtc = col(dt)
    aa = a * dtc
    bb = 1.0 + b * dtc
    cc = c * dtc
    dd = rhs * dtc
    delta = thomas(aa, bb, cc, dd)
    swc = swc + delta

    epore = maximum(1.0e-4, col(soil.smcmax[sltyp]) - sice)
    # push saturation excess upward, bottom -> top (func:6372-6381)
    swc_l = [swc[..., k] for k in range(NSOIL)]
    ep = [epore[..., k] for k in range(NSOIL)]
    dzl = [dzsoil[..., k] for k in range(NSOIL)]
    for k in range(NSOIL - 1, 0, -1):
        wplus_k = maximum(swc_l[k] - ep[k], 0.0) * dzl[k]
        swc_l[k] = minimum(ep[k], swc_l[k])
        swc_l[k - 1] = swc_l[k - 1] + wplus_k / dzl[k - 1]
    wplus = maximum(swc_l[0] - ep[0], 0.0) * dzl[0]
    swc_l[0] = minimum(ep[0], swc_l[0])
    swc = torch.stack(swc_l, dim=-1)
    smc = swc + sice
    return swc, smc, wplus


def _watmin_fixup(mliq):
    """WATMIN bucket fix-up over a list of per-layer liquid [mm]
    (func:6018-6046, 6615-6634).  Returns (list, deficit xs of the
    bottom layer)."""
    watmin = 0.01
    ml = list(mliq)
    for k in range(NSOIL - 1):
        xs = where(ml[k] < 0.0, watmin - ml[k], 0.0)
        ml[k] = ml[k] + xs
        ml[k + 1] = ml[k + 1] - xs
    xs = where(ml[-1] < watmin, watmin - ml[-1], 0.0)
    ml[-1] = ml[-1] + xs
    return ml, xs


class SoilH2OOut(NamedTuple):
    swc: torch.Tensor
    smc: torch.Tensor
    zwt: torch.Tensor
    runsrf: torch.Tensor   # [mm/s]
    runsub: torch.Tensor   # [mm/s] (opt_run==2 topmodel baseflow)
    qdrain: torch.Tensor   # [mm/s]
    wcnd: torch.Tensor     # (n, NSOIL) [m/s]
    fcrmax: torch.Tensor


def soilh2o(soil, gen, veg, sltyp, slptyp, lutyp, dt, zsoil, dzsoil,
            qinsrf, qseva, etrani, sice, swc, smc, zwt,
            opt_run: int, opt_inf: int) -> SoilH2OOut:
    """Soil water driver (reference func:5822-6048).  qinsrf/qseva/etrani
    in m/s."""
    smcmax = soil.smcmax[sltyp]
    # a tensor, so that exp(-a) is evaluated in float32 like the rest
    a_pow = torch.full_like(smcmax, 4.0)

    # clamp super-saturated layers (func:5893-5897)
    epore = maximum(1.0e-4, col(smcmax) - sice)
    rsat = sum_last(maximum(0.0, swc - epore) * dzsoil)
    swc = minimum(epore, swc)

    fice = minimum(1.0, sice / col(smcmax))
    ap = col(a_pow)
    fcr = maximum(0.0, torch.exp(-ap * (1.0 - fice))
                  - torch.exp(-ap)) / (1.0 - torch.exp(-ap))
    sicemax = sice.amax(dim=-1)
    fcrmax = fcr.amax(dim=-1)

    runsub = torch.zeros_like(qinsrf)
    if opt_run == 2:
        zwt = zwteq(soil, sltyp, zsoil, dzsoil, swc)
        runsub = (1.0 - fcrmax) * 4.0 * torch.exp(-gen.timean) \
            * torch.exp(-2.0 * zwt)

    # urban surfaces are nearly impermeable (func:5927)
    fcr0 = where(lutyp == veg.isurban, 0.95, fcr[..., 0])

    rain = qinsrf > 0.0
    if opt_run == 3:
        qinfil, runsrf = infil(soil, sltyp, dt, zsoil, swc, sice,
                               sicemax, qinsrf)
    else:
        if opt_run == 1:
            fsat = gen.fsatmax * torch.exp(-0.5 * 6.0 * (zwt - 2.0))
        elif opt_run == 2:
            fsat = gen.fsatmax * torch.exp(-0.5 * 2.0 * zwt)
        else:
            # BATS: top-2m wetness^4 (func:5953-5968)
            within = cumsum_small(dzsoil) <= 2.0 + MPE
            within = within | (layer_index(dzsoil) == 0)
            dztot = sum_last(where(within, dzsoil, 0.0))
            smctot = sum_last(where(within, smc * dzsoil, 0.0)) / dztot
            fsat = maximum(0.01, smctot / smcmax) ** 4.0
        runsrf = where(rain, qinsrf * ((1.0 - fcr0) * fsat + fcr0), 0.0)
        qinfil = where(rain, qinsrf - runsrf, 0.0)

    # sub-stepping (func:5970-5996): fixed 6 trips, masked beyond niter
    if opt_inf == 1:
        niter = where(qinfil * dt > dzsoil[..., 0] * smcmax, 6,
                      torch.full_like(lutyp, 3, dtype=torch.int32))
        max_iter = 6
    else:
        niter = torch.ones_like(lutyp, dtype=torch.int32)
        max_iter = 1
    dtfine = dt / niter.to(swc.dtype)

    qdrain_save = torch.zeros_like(qinsrf)
    wcnd_out = torch.zeros_like(swc)
    for it in range(max_iter):
        live = niter > it
        live_l = col(live)
        aa, bb, cc, rhs, qdrain, wcnd = srt(
            soil, gen, sltyp, slptyp, zsoil, qinfil, etrani, qseva, swc,
            smc, zwt, fcr, sicemax, fcrmax, opt_run, opt_inf)
        swc_n, smc_n, wplus = sstep(soil, sltyp, dtfine, dzsoil, sice,
                                    swc, aa, bb, cc, rhs)
        swc = where(live_l, swc_n, swc)
        smc = where(live_l, smc_n, smc)
        rsat = where(live, rsat + wplus, rsat)
        qdrain_save = where(live, qdrain_save + qdrain, qdrain_save)
        wcnd_out = where(live_l, wcnd, wcnd_out)

    qdrain = qdrain_save / niter.to(swc.dtype)
    runsrf = runsrf * 1000.0 + rsat * 1000.0 / dt
    qdrain = qdrain * 1000.0

    if opt_run == 2:
        # remove baseflow proportionally to transmissivity (func:6004-6014)
        wtsub = sum_last(wcnd_out * dzsoil)
        mh2o = col(runsub * dt) * (wcnd_out * dzsoil) \
            / col(maximum(wtsub, MPE))
        swc = swc - mh2o / (dzsoil * 1000.0)

    if opt_run != 1:
        # WATMIN bucket fix-up (func:6018-6046)
        mliq, xs = _watmin_fixup(
            [swc[..., k] * dzsoil[..., k] * 1000.0 for k in range(NSOIL)])
        runsub = runsub - xs / dt
        swc = torch.stack([mliq[k] / (dzsoil[..., k] * 1000.0)
                           for k in range(NSOIL)], dim=-1)

    return SoilH2OOut(swc, smc, zwt, runsrf, runsub, qdrain, wcnd_out,
                      fcrmax)


class GroundwaterOut(NamedTuple):
    swc: torch.Tensor
    zwt: torch.Tensor
    wa: torch.Tensor
    wt: torch.Tensor
    qin: torch.Tensor
    qdis: torch.Tensor


def smpfz_f64(s_node, bexp, psisat, at_clip):
    """-PSISAT*1000*S_NODE**(-BEXP) in float64, rounded once to float32.

    Reference semantics (func:6560-6563): S_NODE is the float32
    saturation ratio widened to real*8, except at the lower clamp where
    it is the exact double 0.01 (``at_clip`` marks those points); the
    right-hand side promotes to real*8 through S_NODE and rounds once
    into the real*4 SMPFZ.  The H100 has native float64, so this is the
    one float64 spot of the step.
    """
    s64 = torch.where(at_clip, 0.01, s_node.to(torch.float64))
    v = psisat.to(torch.float64) * 1000.0 * s64 ** (-bexp.to(torch.float64))
    return -v.to(torch.float32)


def groundwater(soil, gen, sltyp, dt, zsoil, sice, wcnd, fcrmax, swc,
                zwt, wa, wt) -> GroundwaterOut:
    """SIMGM unconfined aquifer, opt_run=1 (reference func:6458-6639)."""
    rous, cmic = 0.2, 0.20
    smcmax = soil.smcmax[sltyp]

    z_prev = shift_down(zsoil)
    dzmm = (z_prev - zsoil) * 1.0e3
    znode = -z_prev + 0.5 * (z_prev - zsoil)
    smc = swc + sice
    mliq = swc * dzmm
    epore = maximum(0.01, col(smcmax) - sice)
    hk = 1.0e3 * wcnd

    # first unsaturated layer above the water table (func:6545-6551)
    deeper = col(zwt) <= -zsoil  # True where table at/above layer bottom
    cand = deeper[..., 1:]       # for iz = 2..NSOIL
    ncand = NSOIL - 1
    lay = torch.arange(ncand, dtype=torch.int32, device=zsoil.device)
    first = torch.where(cand, lay, ncand).amin(dim=-1)
    jwt = where(cand.any(dim=-1), first, NSOIL - 1)  # 0-based IWT

    qdis = (1.0 - fcrmax) * 5.0 * torch.exp(-gen.timean) \
        * torch.exp(-6.0 * (zwt - 2.0))

    ratio = vsel(smc, jwt) / smcmax
    s_node = maximum(minimum(ratio, 1.0), 0.01)
    at_clip = ratio <= 0.01
    smpfz = smpfz_f64(s_node, soil.bexp[sltyp], soil.psisat[sltyp],
                      at_clip)
    smpfz = maximum(-120000.0, cmic * smpfz)

    ka = vsel(hk, jwt)
    znode_jwt = vsel(znode, jwt)
    wh_zwt = -zwt * 1.0e3
    wh = smpfz - znode_jwt * 1.0e3
    qin = -ka * (wh_zwt - wh) / maximum((zwt - znode_jwt) * 1.0e3, MPE)
    qin = clip(qin, -10.0 / dt, 10.0 / dt)

    wt = wt + (qin - qdis) * dt

    zbot = zsoil[..., NSOIL - 1]
    deep = jwt == NSOIL - 1
    # water table below the soil column (func:6577-6584)
    wa_d = wa + (qin - qdis) * dt
    wt_d = wa_d
    zwt_d = (-zbot + 25.0) - wa_d / 1000.0 / rous
    mliq_bot_d = mliq[..., NSOIL - 1] - qin * dt \
        + maximum(0.0, wa_d - 5000.0)
    wa_d = minimum(wa_d, 5000.0)

    # water table within the column (func:6587-6606)
    near = jwt == NSOIL - 2
    zwt_near = -zbot - (wt - rous * 1000.0 * 25.0) \
        / epore[..., NSOIL - 1] / 1000.0
    idxs = layer_index(zsoil)
    ws = sum_last(where(idxs >= col(jwt + 2), epore * dzmm, 0.0))
    j1 = minimum(jwt + 1, NSOIL - 1)
    zsoil_j1 = vsel(zsoil, j1)
    epore_j1 = vsel(epore, j1)
    zwt_far = -zsoil_j1 - (wt - rous * 1000.0 * 25.0 - ws) \
        / epore_j1 / 1000.0
    zwt_s = where(near, zwt_near, zwt_far)
    wtsub = sum_last(hk * dzmm)
    mliq_s = mliq - col(qdis * dt) * hk * dzmm / col(maximum(wtsub, MPE))

    mliq_d = torch.cat([mliq[..., :NSOIL - 1], col(mliq_bot_d)], dim=-1)
    mliq = where(col(deep), mliq_d, mliq_s)
    wa = where(deep, wa_d, wa)
    wt = where(deep, wt_d, wt)
    zwt = where(deep, zwt_d, zwt_s)
    zwt = maximum(1.5, zwt)

    # WATMIN fix-up (func:6615-6634)
    ml, xs = _watmin_fixup([mliq[..., k] for k in range(NSOIL)])
    wa = wa - xs
    wt = wt - xs
    swc = torch.stack([ml[k] / dzmm[..., k] for k in range(NSOIL)], dim=-1)

    return GroundwaterOut(swc, zwt, wa, wt, qin, qdis)
