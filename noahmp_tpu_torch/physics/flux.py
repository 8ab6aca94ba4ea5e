"""Tile energy balances: the coupled canopy/ground Newton iteration
(vege_flux) and the bare-ground Newton iteration (bare_flux)
(reference: core/module_noahmp_func.f90:2465-3257).  Counterpart of
``noahmp_tpu/physics/flux.py``.

The reference's early-exit iterations (LITER logic, func:2870-2876)
are fixed-trip Python loops whose updates are frozen, per point, once
the column has converged.  That keeps the serial semantics and never
asks the card whether every point is done: such a test is a host
synchronisation per trip.
"""

from typing import NamedTuple

import torch

from ..constants import MPE, SB, CPAIR, KARMAN, TFRZ
from ..numerics.ops import where, maximum, minimum
from . import sfc

NITERC = 20   # canopy Newton iterations (func:2675)
NITERG = 5    # ground Newton iterations under canopy (func:2677)
NITERB = 5    # bare-ground Newton iterations (func:3115)
DTV_EXIT = 0.01  # K: the canopy loop exits at |dTV| <= this from trip 5

# Chen97 (opt_sfc=2) carry correction.  The reference divides the
# sfcdif2 conductances AKMS/AKHS by the wind speed after every call
# ("CM = CM / UR", func:2769-2771, 3155-3157) but feeds the now
# dimensionless CM/CH straight back in as conductances on the next
# iteration/timestep.  False reproduces that quirk; True re-multiplies
# by UR when seeding the carry (dimensionally consistent Chen97).
CHEN97_FIXED_CARRY = False


class VegeFluxOut(NamedTuple):
    tv: torch.Tensor
    tgv: torch.Tensor
    tah: torch.Tensor
    eah: torch.Tensor
    qsfc: torch.Tensor
    cmv: torch.Tensor
    chv: torch.Tensor
    tauxv: torch.Tensor
    tauyv: torch.Tensor
    irc: torch.Tensor
    irg: torch.Tensor
    shc: torch.Tensor
    shg: torch.Tensor
    evc: torch.Tensor
    evg: torch.Tensor
    tr: torch.Tensor
    ghv: torch.Tensor
    t2mv: torch.Tensor
    q2v: torch.Tensor
    psnsun: torch.Tensor
    psnsha: torch.Tensor
    rssun: torch.Tensor
    rssha: torch.Tensor
    chleaf: torch.Tensor
    chuc: torch.Tensor
    ch2v: torch.Tensor


class BareFluxOut(NamedTuple):
    tgb: torch.Tensor
    qsfc: torch.Tensor
    cmb: torch.Tensor
    chb: torch.Tensor
    tauxb: torch.Tensor
    tauyb: torch.Tensor
    irb: torch.Tensor
    shb: torch.Tensor
    evb: torch.Tensor
    ghb: torch.Tensor
    t2mb: torch.Tensor
    q2b: torch.Tensor
    ehb2: torch.Tensor


class _Canopy(NamedTuple):
    """Carry of the canopy Newton loop."""
    tv: torch.Tensor
    tah: torch.Tensor
    eah: torch.Tensor
    cm: torch.Tensor
    ch: torch.Tensor
    qsfc: torch.Tensor
    h: torch.Tensor
    hg: torch.Tensor
    irc: torch.Tensor
    shc: torch.Tensor
    evc: torch.Tensor
    tr: torch.Tensor
    rahc: torch.Tensor
    rahg: torch.Tensor
    rawg: torch.Tensor
    cvh: torch.Tensor
    fv: torch.Tensor
    fh2: torch.Tensor
    liter: torch.Tensor
    done: torch.Tensor
    s1: sfc.Sfcdif1Carry
    s2: sfc.Sfcdif2Carry
    mozg: torch.Tensor
    fhg: torch.Tensor


def _freeze(done, old, new):
    """Per point: keep ``old`` where ``done``, else take ``new``; walks
    nested NamedTuples leaf by leaf."""
    if isinstance(old, tuple):
        return type(old)(*(_freeze(done, o, n) for o, n in zip(old, new)))
    return torch.where(done, old, new)


def _exchange(opts, gen, first, s1, s2, cm_prev, ch_prev, sfctmp, rhoair,
              h, qair, zlvl, zpd, z0m, ur, thz0, thair):
    """Exchange coefficients by the chosen scheme.  Returns
    (cm, ch, fv, fh2, s1, s2)."""
    if opts.sfc == 1:
        cm, ch, _ch2, s1 = sfc.sfcdif1(first, s1, sfctmp, rhoair, h, qair,
                                       zlvl, zpd, z0m, z0m, ur)
        return cm, ch, s1.fv, s1.fh2, s1, s2
    scale = ur if CHEN97_FIXED_CARRY else 1.0
    s2 = sfc.sfcdif2(first, s2._replace(akms=cm_prev * scale,
                                        akhs=ch_prev * scale),
                     z0m, thz0, thair, ur, gen.czil, zlvl)
    # fh2 is undefined in the reference for opt_sfc=2
    return (s2.akms / ur, s2.akhs / ur, s2.ustar,
            torch.zeros_like(ur), s1, s2)


def vege_flux(veg, gen, lutyp, opts, dt, sav, sag, lwdn, ur, uu, vv,
              sfctmp, thair, qair, eair, rhoair, snowh, vai, gammav,
              gammag, fwet, laisun, laisha, cwp, htop, zlvl, zpd, z0m,
              fveg, z0mg, emv, emg, canliq, canice, stc_top, df_top,
              dz_top, rsurf, latheav, latheag, parsun, parsha, igs,
              foln, co2air, o2air, btran, sfcprs, rhsur, psfc,
              eah0, tah0, tv0, tg0, cm0, ch0) -> VegeFluxOut:
    """Coupled canopy/ground energy balance over the vegetated tile.

    Solves -SAV + IRC[TV]+SHC[TV]+EVC[TV]+TR[TV] = 0 by Newton on TV
    (<=20 iters, masked exit when |dTV|<=0.01 after 5 iters), then
    -SAG + IRG[TG]+SHG[TG]+EVG[TG]+GH[TG] = 0 by 5 Newton steps on TG.
    """
    vaie = minimum(6.0, vai / fveg)
    laisune = minimum(6.0, laisun / fveg)
    laishae = minimum(6.0, laisha / fveg)

    estg, _ = sfc.esat_t(tg0)
    qsfc = 0.622 * eair / (psfc - 0.378 * eair)

    # the reference aborts when HCAN <= ZPD or ZLVL <= ZPD
    # (func:2726-2738); here the caller floors htop and z0m, and
    # sfc.ragrb clamps KH = k*u*(HCAN - ZPD) from below, so a canopy
    # buried by snow stays finite
    hcan = htop
    uc = ur * torch.log(hcan / z0m) / torch.log(zlvl / z0m)

    air = (-emv * (1.0 + (1.0 - emv) * (1.0 - emg)) * lwdn
           - emv * emg * SB * tg0 ** 4)
    cir = (2.0 - emv * (1.0 - emg)) * emv * SB

    z = torch.zeros_like(tv0)
    onec = z + 1.0
    false = torch.zeros_like(tv0, dtype=torch.bool)
    c = _Canopy(tv=tv0, tah=tah0, eah=eah0, cm=cm0, ch=ch0, qsfc=qsfc,
                h=z, hg=z, irc=z, shc=z, evc=z, tr=z, rahc=onec,
                rahg=onec, rawg=onec, cvh=z, fv=z + 0.1, fh2=z,
                liter=false, done=false,
                s1=sfc.sfcdif1_init(z),
                s2=sfc.Sfcdif2Carry(cm0, ch0, z, z, z + 0.1),
                mozg=z, fhg=z)

    rssun = rssha = psnsun = psnsha = None
    # Fortran iteration index is it + 1; all NITERC trips run
    for it in range(NITERC):
        first = it == 0
        z0h = z0m
        z0hg = z0mg
        cm, ch, fv, fh2, s1, s2 = _exchange(
            opts, gen, first, c.s1, c.s2, c.cm, c.ch, sfctmp, rhoair,
            c.h, qair, zlvl, zpd, z0m, ur, c.tah, thair)

        rahc = maximum(1.0, 1.0 / (ch * ur))
        rawc = rahc

        rahg, rawg, rb, (mozg, fhg) = sfc.ragrb(
            veg, lutyp, first, (c.mozg, c.fhg), vaie, rhoair, c.hg,
            c.tah, zpd, z0mg, z0hg, hcan, uc, z0h, fv, cwp)

        estv, destv = sfc.esat_t(c.tv)

        if first:
            # first iteration: stomatal resistance (func:2798-2814)
            if opts.crs == 1:
                rssun, psnsun = sfc.stomata(veg, lutyp, igs, sfcprs,
                                            sfctmp, parsun, c.tv, c.eah,
                                            estv, o2air, co2air, foln,
                                            btran, rb)
                rssha, psnsha = sfc.stomata(veg, lutyp, igs, sfcprs,
                                            sfctmp, parsha, c.tv, c.eah,
                                            estv, o2air, co2air, foln,
                                            btran, rb)
            else:
                rssun, psnsun = sfc.canres(veg, lutyp, sfcprs, c.tv,
                                           parsun, c.eah, btran)
                rssha, psnsha = sfc.canres(veg, lutyp, sfcprs, c.tv,
                                           parsha, c.eah, btran)

        # sensible heat conductances (func:2817-2823)
        cah = 1.0 / rahc
        cvh = 2.0 * vaie / rb
        cgh = 1.0 / rahg
        cond = cah + cvh + cgh
        ata = (sfctmp * cah + tg0 * cgh) / cond
        bta = cvh / cond
        csh = (1.0 - bta) * rhoair * CPAIR * cvh

        # latent heat conductances (func:2826-2834)
        caw = 1.0 / rawc
        cew = fwet * vaie / rb
        ctw = (1.0 - fwet) * (laisune / (rb + rssun)
                              + laishae / (rb + rssha))
        cgw = 1.0 / (rawg + rsurf)
        cond = caw + cew + ctw + cgw
        aea = (eair * caw + estg * cgw) / cond
        bea = (cew + ctw) / cond
        cev = (1.0 - bea) * cew * rhoair * CPAIR / gammav
        ctr = (1.0 - bea) * ctw * rhoair * CPAIR / gammav

        tah = ata + bta * c.tv
        eah = aea + bea * estv

        irc = fveg * (air + cir * c.tv ** 4)
        shc = fveg * rhoair * CPAIR * cvh * (c.tv - tah)
        evc = fveg * rhoair * CPAIR * cew * (estv - eah) / gammav
        tr = fveg * rhoair * CPAIR * ctw * (estv - eah) / gammav
        evc_cap = where(c.tv > TFRZ, canliq, canice) * latheav / dt
        evc = minimum(evc_cap, evc)

        b = sav - irc - shc - evc - tr
        a = fveg * (4.0 * cir * c.tv ** 3 + csh + (cev + ctr) * destv)
        dtv = b / a

        irc = irc + fveg * 4.0 * cir * c.tv ** 3 * dtv
        shc = shc + fveg * csh * dtv
        evc = evc + fveg * cev * destv * dtv
        tr = tr + fveg * ctr * destv * dtv
        tv = c.tv + dtv

        h = rhoair * CPAIR * (tah - sfctmp) / rahc
        hg = rhoair * CPAIR * (tg0 - tah) / rahg
        qsfc_new = (0.622 * eah) / (sfcprs - 0.378 * eah)

        done_before = c.done
        done = c.done | c.liter
        if it + 1 >= 5:
            liter = c.liter | ((torch.abs(dtv) <= DTV_EXIT) & ~c.liter)
        else:
            liter = c.liter

        new = _Canopy(tv=tv, tah=tah, eah=eah, cm=cm, ch=ch,
                      qsfc=qsfc_new, h=h, hg=hg, irc=irc, shc=shc,
                      evc=evc, tr=tr, rahc=rahc, rahg=rahg, rawg=rawg,
                      cvh=cvh, fv=fv, fh2=fh2, liter=liter, done=done,
                      s1=s1, s2=s2, mozg=mozg, fhg=fhg)
        # freeze everything once the column exited the loop (nothing
        # can be frozen on the first trip)
        c = new if first else _freeze(done_before, c, new)

    # under-canopy ground energy balance (func:2879-2914)
    air_g = -emg * (1.0 - emv) * lwdn - emg * emv * SB * c.tv ** 4
    cir_g = emg * SB
    csh_g = rhoair * CPAIR / c.rahg
    cev_g = rhoair * CPAIR / (gammag * (c.rawg + rsurf))
    cgh_g = 2.0 * df_top / dz_top

    tg = tg0
    for _ in range(NITERG):
        estg, destg = sfc.esat_t(tg)
        irg = cir_g * tg ** 4 + air_g
        shg = csh_g * (tg - c.tah)
        evg = cev_g * (estg * rhsur - c.eah)
        gh = cgh_g * (tg - stc_top)
        b = sag - irg - shg - evg - gh
        a = 4.0 * cir_g * tg ** 3 + csh_g + cev_g * destg + cgh_g
        dtg = b / a
        irg = irg + 4.0 * cir_g * tg ** 3 * dtg
        shg = shg + csh_g * dtg
        evg = evg + cev_g * destg * dtg
        gh = gh + cgh_g * dtg
        tg = tg + dtg

    # snow-surface temperature cap (func:2920-2928)
    if opts.stc == 1:
        cap = (snowh > 0.05) & (tg > TFRZ)
        tg_c = where(cap, TFRZ, tg)
        irg = where(cap,
                    cir_g * tg_c ** 4 - emg * (1.0 - emv) * lwdn
                    - emg * emv * SB * c.tv ** 4, irg)
        shg = where(cap, csh_g * (tg_c - c.tah), shg)
        evg = where(cap, cev_g * (estg * rhsur - c.eah), evg)
        gh = where(cap, sag - (irg + shg + evg), gh)
        tg = tg_c

    tauxv = -rhoair * c.cm * ur * uu
    tauyv = -rhoair * c.cm * ur * vv

    # 2-m diagnostics (func:2942-2957)
    z0h = z0m
    cah2 = c.fv * KARMAN / (torch.log((2.0 + z0h) / z0h) - c.fh2)
    small = cah2 < 1.0e-5
    t2mv = where(small, c.tah,
                 c.tah - (shg + c.shc / fveg)
                 / (rhoair * CPAIR) / maximum(cah2, MPE))
    q2v = where(small, c.qsfc,
                c.qsfc - ((c.evc + c.tr) / fveg + evg)
                / (latheav * rhoair) / maximum(cah2, MPE))

    return VegeFluxOut(
        tv=c.tv, tgv=tg, tah=c.tah, eah=c.eah, qsfc=c.qsfc, cmv=c.cm,
        chv=1.0 / c.rahc, tauxv=tauxv, tauyv=tauyv, irc=c.irc, irg=irg,
        shc=c.shc, shg=shg, evc=c.evc, evg=evg, tr=c.tr, ghv=gh,
        t2mv=t2mv, q2v=q2v, psnsun=psnsun, psnsha=psnsha, rssun=rssun,
        rssha=rssha, chleaf=c.cvh, chuc=1.0 / c.rahg, ch2v=cah2)


def bare_flux(veg, gen, lutyp, opts, dt, sag, lwdn, ur, uu, vv, sfctmp,
              thair, qair, eair, rhoair, snowh, stc_top, df_top, dz_top,
              zlvl, zpd, z0m, emg, rsurf, lathea, gamma, rhsur, psfc,
              sfcprs, tgb0, cm0, ch0, qsfc0) -> BareFluxOut:
    """Bare-ground Newton iteration on TGB (reference func:2967-3257)."""
    z = torch.zeros_like(tgb0)

    cir = emg * SB
    cgh = 2.0 * df_top / dz_top

    tgb, cm, ch, qsfc, h = tgb0, cm0, ch0, qsfc0, z
    s1 = sfc.sfcdif1_init(z)
    s2 = sfc.Sfcdif2Carry(cm0, ch0, z, z, z + 0.1)

    for it in range(NITERB):
        cm, ch, fv, fh2, s1, s2 = _exchange(
            opts, gen, it == 0, s1, s2, cm, ch, sfctmp, rhoair, h, qair,
            zlvl, zpd, z0m, ur, tgb, thair)
        if opts.sfc != 1:
            snow = snowh > 0.0
            cm = where(snow, minimum(0.01, cm), cm)
            ch = where(snow, minimum(0.01, ch), ch)

        rahb = maximum(1.0, 1.0 / (ch * ur))
        rawb = rahb

        estg, destg = sfc.esat_t(tgb)
        csh = rhoair * CPAIR / rahb
        cev = rhoair * CPAIR / gamma / (rsurf + rawb)

        irb = cir * tgb ** 4 - emg * lwdn
        shb = csh * (tgb - sfctmp)
        evb = cev * (estg * rhsur - eair)
        ghb = cgh * (tgb - stc_top)
        b = sag - irb - shb - evb - ghb
        a = 4.0 * cir * tgb ** 3 + csh + cev * destg + cgh
        dtg = b / a
        irb = irb + 4.0 * cir * tgb ** 3 * dtg
        shb = shb + csh * dtg
        evb = evb + cev * destg * dtg
        ghb = ghb + cgh * dtg
        tgb = tgb + dtg

        h = csh * (tgb - sfctmp)
        estg, _ = sfc.esat_t(tgb)
        qsfc = 0.622 * (estg * rhsur) / (psfc - 0.378 * (estg * rhsur))

    # snow cap (func:3225-3233)
    if opts.stc == 1:
        cap = (snowh > 0.05) & (tgb > TFRZ)
        tgb = where(cap, TFRZ, tgb)
        irb = where(cap, cir * tgb ** 4 - emg * lwdn, irb)
        shb = where(cap, csh * (tgb - sfctmp), shb)
        evb = where(cap, cev * (estg * rhsur - eair), evb)
        ghb = where(cap, sag - (irb + shb + evb), ghb)

    tauxb = -rhoair * cm * ur * uu
    tauyb = -rhoair * cm * ur * vv

    z0h = z0m
    ehb2 = fv * KARMAN / (torch.log((2.0 + z0h) / z0h) - fh2)
    small = ehb2 < 1.0e-5
    t2mb = where(small, tgb,
                 tgb - shb / (rhoair * CPAIR) / maximum(ehb2, MPE))
    q2b = where(small, qsfc,
                qsfc - evb / (lathea * rhoair)
                * (1.0 / maximum(ehb2, MPE) + rsurf))
    q2b = where(lutyp == veg.isurban, qsfc, q2b)

    return BareFluxOut(tgb=tgb, qsfc=qsfc, cmb=cm, chb=1.0 / rahb,
                       tauxb=tauxb, tauyb=tauyb, irb=irb, shb=shb,
                       evb=evb, ghb=ghb, t2mb=t2mb, q2b=q2b, ehb2=ehb2)
