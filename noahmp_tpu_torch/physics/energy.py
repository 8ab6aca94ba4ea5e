"""Surface energy balance orchestration
(reference: core/module_noahmp_func.f90:735-1338).  Counterpart of
``noahmp_tpu/physics/energy.py``.

Tile approach: vegetated-fraction fluxes (vege_flux) and bare-fraction
fluxes (bare_flux) are both evaluated and aggregated weighted by fveg;
the per-point veg/bare branch of the reference becomes a select.
"""

from typing import NamedTuple

import torch

from ..constants import (MSNOW, MPE, TFRZ, GRAV, RVAP, SB, CPAIR,
                         HVAP, HSUB)
from . import thermo, radiation as rad_mod, flux as flux_mod
from . import soiltemp
from ..numerics.ops import (where, maximum, minimum, clip, col, sum_last,
                            layer_index)
from ..numerics.select import vsel

PSIWLT = -150.0   # matric potential at wilting (m) (func:1017)
Z0_BARE = 0.01    # bare-soil roughness length (m) (func:1018)


class EnergyOut(NamedTuple):
    # updated prognostics
    tv: torch.Tensor
    tg: torch.Tensor
    stc: torch.Tensor
    eah: torch.Tensor
    tah: torch.Tensor
    cm: torch.Tensor
    ch: torch.Tensor
    qsfc: torch.Tensor
    albold: torch.Tensor
    tauss: torch.Tensor
    snice: torch.Tensor
    snliq: torch.Tensor
    sneqv: torch.Tensor
    snowh: torch.Tensor
    smc: torch.Tensor
    swc: torch.Tensor
    # fluxes & diagnostics
    fsno: torch.Tensor
    sav: torch.Tensor
    sag: torch.Tensor
    fsa: torch.Tensor
    fsr: torch.Tensor
    fsrv: torch.Tensor
    fsrg: torch.Tensor
    taux: torch.Tensor
    tauy: torch.Tensor
    fira: torch.Tensor
    fsh: torch.Tensor
    fcev: torch.Tensor
    fgev: torch.Tensor
    fctr: torch.Tensor
    trad: torch.Tensor
    t2m: torch.Tensor
    psn: torch.Tensor
    apar: torch.Tensor
    ssoil: torch.Tensor
    btrani: torch.Tensor
    btran: torch.Tensor
    latheav: torch.Tensor
    latheag: torch.Tensor
    frozen_canopy: torch.Tensor
    frozen_ground: torch.Tensor
    imelt: torch.Tensor
    qmelt: torch.Tensor
    ponding: torch.Tensor
    ts: torch.Tensor
    t2mv: torch.Tensor
    t2mb: torch.Tensor
    q2v: torch.Tensor
    q2b: torch.Tensor
    tgv: torch.Tensor
    tgb: torch.Tensor
    chv: torch.Tensor
    chb: torch.Tensor
    emissi: torch.Tensor
    rssun: torch.Tensor
    rssha: torch.Tensor
    bgap: torch.Tensor
    wgap: torch.Tensor
    shg: torch.Tensor
    shc: torch.Tensor
    shb: torch.Tensor
    evg: torch.Tensor
    evb: torch.Tensor
    ghv: torch.Tensor
    ghb: torch.Tensor
    irg: torch.Tensor
    irc: torch.Tensor
    irb: torch.Tensor
    tr: torch.Tensor
    evc: torch.Tensor
    chleaf: torch.Tensor
    chuc: torch.Tensor
    chv2: torch.Tensor
    chb2: torch.Tensor
    fsun: torch.Tensor
    laisun: torch.Tensor
    laisha: torch.Tensor


def energy(params, opts, dt, nsnow, dzsnso, rhoair, sfcprs, psfc,
           qair, sfctmp, thair, lwdn, uu, vv, zref, co2air, o2air,
           solad, solai, cosz, igs, eair, htop, tbot, zsnso, zsoil,
           elai, esai, fwet, foln, fveg, qsnow, canliq, canice,
           tv, tg, stc, snowh, eah, tah, sneqvo, sneqv, swc, smc,
           snice, snliq, albold, cm, ch, tauss, qsfc,
           lutyp, sltyp, slptyp, isc, ist, ice) -> EnergyOut:
    """``lutyp``, ``sltyp``, ``slptyp`` and ``isc`` are int64 table
    indices; per-point inputs are (n,), layer vectors (n, L), bands
    (n, 2)."""
    veg_p, soil_p, gen_p = params.veg, params.soil, params.gen

    ur = maximum(torch.sqrt(uu * uu + vv * vv), 1.0)
    vai = elai + esai
    is_veg = vai > 0.0

    # snow cover fraction (Niu-Yang 2007, func:1048-1054)
    bdsno = sneqv / maximum(snowh, MPE)
    fmelt = (bdsno / 100.0) ** gen_p.mltfct
    fsno = where(snowh > 0.0,
                     torch.tanh(snowh / (2.5 * Z0_BARE * fmelt)), 0.0)

    # ground roughness (func:1056-1065)
    z0mg_lake = where(tg <= TFRZ,
                          0.01 * (1.0 - fsno) + fsno * gen_p.z0sno, 0.01)
    z0mg_soil = Z0_BARE * (1.0 - fsno) + fsno * gen_p.z0sno
    z0mg = where(ist == 2, z0mg_lake, z0mg_soil)

    zpdg = snowh
    z0m = where(is_veg, veg_p.z0mvt[lutyp], z0mg)
    zpd_veg = maximum(0.65 * htop, snowh)
    zpd = where(is_veg, zpd_veg, zpdg)
    zlvl = maximum(zpd, htop) + zref
    zlvl = where(zpdg >= zlvl, zpdg + zref, zlvl)
    cwp = veg_p.cwpvt[lutyp]

    th = thermo.thermoprop(soil_p, veg_p, gen_p, sltyp, lutyp, ist,
                           nsnow, dt, dzsnso, snowh, snice, snliq,
                           gen_p.csoil, smc, swc, stc)

    rad = rad_mod.radiation(veg_p, soil_p, gen_p, lutyp, ist, isc, ice,
                            sneqvo, sneqv, dt, cosz, snowh, tg, tv,
                            fsno, qsnow, fwet, elai, esai, smc[..., 0],
                            solad, solai, fveg, albold, tauss,
                            opts.alb, opts.rad)

    # emissivities (func:1105-1113)
    emv = 1.0 - torch.exp(-(elai + esai) / 1.0)
    emg_base = where(ice == 1, 0.98,
                         where(ist == 1, gen_p.emssoil,
                                   gen_p.emslake))
    emg = emg_base * (1.0 - fsno) + 1.0 * fsno

    # soil moisture stress BTRAN (func:1115-1140)
    nroot = veg_p.nroot[lutyp]
    smcwlt = soil_p.smcwlt[sltyp]
    smcref = soil_p.smcref[sltyp]
    smcmax = soil_p.smcmax[sltyp]
    bexp = soil_p.bexp[sltyp]
    psisat = soil_p.psisat[sltyp]
    in_root = layer_index(swc) < col(nroot)
    if opts.btr == 1:
        gx = (swc - col(smcwlt)) / col(smcref - smcwlt)
    elif opts.btr == 2:
        psi = maximum(PSIWLT, col(-psisat) * (maximum(0.01, swc)
                                              / col(smcmax)) ** col(-bexp))
        gx = (1.0 - psi / PSIWLT) / col(1.0 + psisat / PSIWLT)
    else:
        psi = maximum(PSIWLT, col(-psisat) * (maximum(0.01, swc)
                                              / col(smcmax)) ** col(-bexp))
        gx = 1.0 - torch.exp(-5.8 * torch.log(PSIWLT / psi))
    gx = clip(gx, 0.0, 1.0)
    zroot = -vsel(zsoil, maximum(nroot - 1, 0))
    dz_soil = dzsnso[..., MSNOW:]
    btrani_raw = maximum(MPE, dz_soil / col(zroot) * gx)
    btrani_raw = where(in_root, btrani_raw, 0.0)
    btran = maximum(MPE, sum_last(btrani_raw))
    btrani = where(in_root, btrani_raw / col(btran), 0.0)
    btran = where(ist == 1, btran, 0.0)

    # ground surface & canopy-air humidity resistances (func:1142-1169)
    l_rsurf = (-zsoil[..., 0]) * (torch.exp(
        (1.0 - minimum(1.0, swc[..., 0] / smcmax)) ** 5) - 1.0) \
        / (2.71828 - 1.0)
    d_rsurf = 2.2e-5 * smcmax * smcmax * (1.0 - smcwlt / smcmax) \
        ** (2.0 + 3.0 / bexp)
    rsurf = l_rsurf / d_rsurf
    rsurf = where((swc[..., 0] < 0.01) & (snowh == 0.0), 1.0e6, rsurf)
    psi_s = -psisat * (maximum(0.01, swc[..., 0]) / smcmax) ** (-bexp)
    rhsur = fsno + (1.0 - fsno) * torch.exp(psi_s * GRAV / (RVAP * tg))
    rsurf = where(ist == 2, 1.0, rsurf)
    rhsur = where(ist == 2, 1.0, rhsur)
    rsurf = where((lutyp == veg_p.isurban) & (snowh == 0.0),
                      1.0e6, rsurf)

    # latent heat selection (func:1171-1189)
    frozen_canopy = tv <= TFRZ
    latheav = where(frozen_canopy, HSUB, HVAP)
    gammav = CPAIR * sfcprs / (0.622 * latheav)
    frozen_ground = tg <= TFRZ
    latheag = where(frozen_ground, HSUB, HVAP)
    gammag = CPAIR * sfcprs / (0.622 * latheag)

    # top active layer scalars for the ground heat flux terms
    # (per-point index -> select, numerics/select.py)
    top = MSNOW - nsnow
    stc_top = vsel(stc, top)
    df_top = vsel(th.df, top)
    dz_top = vsel(dzsnso, top)

    # vegetated-tile fluxes (always evaluated; masked into aggregation)
    vf = flux_mod.vege_flux(
        veg_p, gen_p, lutyp, opts, dt, rad.sav, rad.sag, lwdn, ur, uu,
        vv, sfctmp, thair, qair, eair, rhoair, snowh, vai, gammav,
        gammag, fwet, rad.laisun, rad.laisha, cwp,
        maximum(htop, z0mg * 2.0 + MPE), zlvl, zpd,
        maximum(z0m, MPE), maximum(fveg, 0.01), z0mg, emv, emg,
        canliq, canice, stc_top, df_top, dz_top, rsurf, latheav,
        latheag, rad.parsun, rad.parsha, igs, foln, co2air, o2air,
        btran, sfcprs, rhsur, psfc, eah, tah, tv, tg, cm, ch)

    bf = flux_mod.bare_flux(
        veg_p, gen_p, lutyp, opts, dt, rad.sag, lwdn, ur, uu, vv,
        sfctmp, thair, qair, eair, rhoair, snowh, stc_top, df_top,
        dz_top, zlvl, zpdg, z0mg, emg, rsurf, latheag, gammag, rhsur,
        psfc, sfcprs, tg, cm, ch, qsfc)

    # tile aggregation (func:1246-1282)
    use_veg = is_veg & (fveg > 0.0)
    fv1 = where(use_veg, fveg, 0.0)

    def agg(v, b_):
        return where(use_veg, fv1 * v + (1.0 - fv1) * b_, b_)

    taux = agg(vf.tauxv, bf.tauxb)
    tauy = agg(vf.tauyv, bf.tauyb)
    fira = where(use_veg,
                     fv1 * vf.irg + (1.0 - fv1) * bf.irb + vf.irc,
                     bf.irb)
    fsh = where(use_veg,
                    fv1 * vf.shg + (1.0 - fv1) * bf.shb + vf.shc,
                    bf.shb)
    fgev = agg(vf.evg, bf.evb)
    ssoil = agg(vf.ghv, bf.ghb)
    fcev = where(use_veg, vf.evc, 0.0)
    fctr = where(use_veg, vf.tr, 0.0)
    tg_new = agg(vf.tgv, bf.tgb)
    t2m = agg(vf.t2mv, bf.t2mb)
    ts = where(use_veg, fv1 * vf.tv + (1.0 - fv1) * bf.tgb, tg_new)
    cm_new = agg(vf.cmv, bf.cmb)
    ch_new = agg(vf.chv, bf.chb)
    q2e = agg(vf.q2v, bf.q2b)
    # the reference threads ONE inout QSFC through vege_flux then
    # bare_flux (func:1200-1239); bare_flux always runs last and
    # overwrites it before any read (func:3218), so the persisted
    # state QSFC is the bare-tile value even on vegetated tiles (the
    # veg-blended Q1 computed at func:1260 is a write-only local in
    # the caller, func:210).  Mirror that aliasing exactly.  Found by
    # validate/audit_constants.py (the 0.378 literal of Q1 had no
    # oracle counterpart).
    qsfc_new = bf.qsfc
    tv_new = where(use_veg, vf.tv, tv)
    eah_new = where(use_veg, vf.eah, eah)
    tah_new = where(use_veg, vf.tah, tah)
    rssun = where(use_veg, vf.rssun, 0.0)
    rssha = where(use_veg, vf.rssha, 0.0)
    tgv = where(use_veg, vf.tgv, bf.tgb)
    chv = where(use_veg, vf.chv, bf.chb)
    psnsun = where(use_veg, vf.psnsun, 0.0)
    psnsha = where(use_veg, vf.psnsha, 0.0)

    fire = lwdn + fira
    emissi = fv1 * (emg * (1.0 - emv) + emv
                    + emv * (1.0 - emv) * (1.0 - emg)) \
        + (1.0 - fv1) * emg
    trad = ((fire - (1.0 - emissi) * lwdn)
            / (emissi * SB)) ** 0.25

    apar = rad.parsun * rad.laisun + rad.parsha * rad.laisha
    psn = psnsun * rad.laisun + psnsha * rad.laisha

    # snow/soil temperature diffusion (func:1311-1315)
    stc_new = soiltemp.tsnosoi(dt, nsnow, tbot, gen_p.zbot, zsnso,
                               ssoil, th.df, th.hcpct, snowh, stc,
                               opts.tbot, opts.stc)

    tgv_o, tgb_o = tgv, bf.tgb
    if opts.stc == 2:
        cap = (snowh > 0.05) & (tg_new > TFRZ)
        tgv_o = where(cap, TFRZ, tgv_o)
        tgb_o = where(cap, TFRZ, tgb_o)
        tg_new = where(cap, agg(tgv_o, tgb_o), tg_new)
        ts = where(cap, where(use_veg, fv1 * tv_new
                                      + (1.0 - fv1) * tgb_o, tgb_o), ts)

    pc = soiltemp.phasechange(soil_p, sltyp, ist, dt, nsnow, th.fact,
                              dzsnso, stc_new, snice, snliq, sneqv,
                              snowh, smc, swc, opts.frz)

    return EnergyOut(
        tv=tv_new, tg=tg_new, stc=pc.stc, eah=eah_new, tah=tah_new,
        cm=cm_new, ch=ch_new, qsfc=qsfc_new, albold=rad.albold,
        tauss=rad.tauss, snice=pc.snice, snliq=pc.snliq,
        sneqv=pc.sneqv, snowh=pc.snowh, smc=pc.smc, swc=pc.swc,
        fsno=fsno, sav=rad.sav, sag=rad.sag, fsa=rad.fsa, fsr=rad.fsr,
        fsrv=rad.fsrv, fsrg=rad.fsrg, taux=taux, tauy=tauy, fira=fira,
        fsh=fsh, fcev=fcev, fgev=fgev, fctr=fctr, trad=trad, t2m=t2m,
        psn=psn, apar=apar, ssoil=ssoil, btrani=btrani, btran=btran,
        latheav=latheav, latheag=latheag, frozen_canopy=frozen_canopy,
        frozen_ground=frozen_ground, imelt=pc.imelt, qmelt=pc.qmelt,
        ponding=pc.ponding, ts=ts, t2mv=vf.t2mv, t2mb=bf.t2mb,
        q2v=vf.q2v, q2b=bf.q2b, tgv=tgv_o, tgb=tgb_o, chv=chv,
        chb=bf.chb, emissi=emissi, rssun=rssun, rssha=rssha,
        bgap=rad.bgap, wgap=rad.wgap, shg=vf.shg, shc=vf.shc,
        shb=bf.shb, evg=vf.evg, evb=bf.evb, ghv=vf.ghv, ghb=bf.ghb,
        irg=vf.irg, irc=vf.irc, irb=bf.irb, tr=vf.tr, evc=vf.evc,
        chleaf=vf.chleaf, chuc=vf.chuc, chv2=vf.ch2v, chb2=bf.ehb2,
        fsun=rad.fsun, laisun=rad.laisun, laisha=rad.laisha)
