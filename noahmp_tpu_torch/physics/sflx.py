"""Top-level batched step: one Noah-MP timestep for n land columns
(reference: core/module_noahmp_func.f90:66-476), plus the conservation
diagnostics of the reference's ``error`` subroutine (func:633-732) which
here are *returned* in the Flux container instead of aborting.
Counterpart of ``noahmp_tpu/physics/sflx.py:column_step`` with the
land-point axis written out: per-point values are (n,), layer vectors
(n, L).
"""

import torch

from ..constants import MSNOW, MPE
from ..numerics.ops import (where, maximum, minimum, col, sum_last,
                            shift_down, layer_index)
from ..numerics.select import vsel
from ..state import State, Static, Forcing, Flux
from . import atm as atm_mod
from . import phenology as phen_mod
from . import energy as energy_mod
from . import water as water_mod
from . import carbon as carbon_mod


def step_columns(params, opts, static: Static, forcing: Forcing,
                 st: State, dt):
    """Advance all columns one timestep.  ``dt`` is a 0-d float32 tensor
    on the state's device.  Returns (new_state, flux)."""
    veg_p = params.veg
    # the containers keep int32; the table gathers want int64
    lutyp, sltyp = static.lutyp.long(), static.sltyp.long()
    slptyp, isc = static.slptyp.long(), static.isc.long()
    zsoil = static.zsoil

    a = atm_mod.atm(forcing.sfcprs, forcing.sfctmp, forcing.q2,
                    forcing.prcp, forcing.soldn, forcing.cosz)

    # layer thickness from zsnso (func:322-328)
    dzsnso = shift_down(st.zsnso) - st.zsnso
    active = layer_index(dzsnso) >= col(MSNOW - st.nsnow)
    dzsnso = where(active, dzsnso, 0.0)
    dzsnow = dzsnso[..., :MSNOW]
    dz_soil = dzsnso[..., MSNOW:]

    # water storage at step begin (func:339-344)
    beg_wb = (st.canliq + st.canice + st.sneqv + st.wa
              + sum_last(st.smc * dz_soil) * 1000.0)

    ph = phen_mod.phenology(veg_p, lutyp, st.snowh, st.tv, static.lat,
                            forcing.yearlen, forcing.julian, st.lai,
                            st.sai, opts.veg)
    fveg = phen_mod.green_fraction(veg_p, lutyp, static.shdfac,
                                   static.shdmax, ph.lai, ph.sai,
                                   ph.elai, ph.esai, opts.veg)

    en = energy_mod.energy(
        params, opts, dt, st.nsnow, dzsnso, a.rhoair,
        forcing.sfcprs, forcing.sfcprs, a.qair, forcing.sfctmp,
        a.thair, forcing.lwdn, forcing.uu, forcing.vv, static.zlvl,
        forcing.co2air, forcing.o2air, a.solad, a.solai, forcing.cosz,
        ph.igs, a.eair, ph.htop, static.tbot, st.zsnso, zsoil, ph.elai,
        ph.esai, st.fwet, forcing.foln, fveg, st.qsnow, st.canliq,
        st.canice, st.tv, st.tg, st.stc, st.snowh, st.eah, st.tah,
        st.sneqvo, st.sneqv, st.swc, st.smc, st.snice, st.snliq,
        st.albold, st.cm, st.ch, st.tauss, st.qsfc,
        lutyp, sltyp, slptyp, isc, static.ist, static.ice)

    sneqvo_new = en.sneqv

    qvap = maximum(en.fgev / en.latheag, 0.0)
    qdew = torch.abs(minimum(en.fgev / en.latheag, 0.0))
    edir = qvap - qdew

    wt = water_mod.water(
        params, opts, lutyp, sltyp, slptyp, static.ist, dt,
        zsoil, dzsnow, en.imelt[..., :MSNOW], forcing.uu, forcing.vv,
        en.fcev, en.fctr, a.qprecc, a.qprecl, ph.elai, ph.esai,
        forcing.sfctmp, qvap, qdew, en.btrani, st.ficeold, en.ponding,
        en.tg, fveg, en.latheav, en.latheag, en.frozen_canopy,
        en.frozen_ground, st.nsnow, st.canliq, st.canice, en.tv,
        en.snowh, en.sneqv, en.snice, en.snliq, en.stc, en.swc, en.smc,
        st.zwt, st.wa, st.wt, st.wslake)

    # carbon (func:439-447)
    if opts.veg in (2, 5):
        # root-zone temperature (func:330-335): an argument of the
        # reference's carbon call that nothing downstream reads
        nroot = veg_p.nroot[lutyp]
        zroot = -vsel(zsoil, maximum(nroot - 1, 0))
        troot = sum_last(where(
            layer_index(dz_soil) < col(nroot),
            st.stc[..., MSNOW:] * dz_soil / col(zroot), 0.0))
        cb = carbon_mod.carbon(
            veg_p, lutyp, params.soil.smcmax[sltyp], dt, zsoil,
            wt.dzsnso[..., MSNOW:], wt.stc, wt.smc, wt.tv, en.tg, en.psn,
            forcing.foln, en.btran, en.apar, fveg, ph.igs, troot,
            static.ist, ph.lai, ph.sai, st.lfmass, st.rtmass,
            st.stmass, st.wood, st.stblcp, st.fastcp)
        lai_new, sai_new = cb.lai, cb.sai
        lfmass, rtmass, stmass = cb.lfmass, cb.rtmass, cb.stmass
        wood, stblcp, fastcp = cb.wood, cb.stblcp, cb.fastcp
        gpp, npp, nee = cb.gpp, cb.npp, cb.nee
    else:
        lai_new, sai_new = ph.lai, ph.sai
        lfmass, rtmass, stmass = st.lfmass, st.rtmass, st.stmass
        wood, stblcp, fastcp = st.wood, st.stblcp, st.fastcp
        z = torch.zeros_like(en.tg)
        gpp, npp, nee = z, z, z

    # conservation diagnostics (func:633-732); returned, not asserted
    errsw = a.swdown - (en.fsa + en.fsr)
    erreng = en.sav + en.sag - (en.fira + en.fsh + en.fcev + en.fgev
                                + en.fctr + en.ssoil)
    end_wb = (wt.canliq + wt.canice + wt.sneqv + wt.wa
              + sum_last(wt.smc * wt.dzsnso[..., MSNOW:]) * 1000.0)
    errwat = end_wb - beg_wb - (forcing.prcp - wt.ecan - wt.etran
                                - edir - wt.runsrf - wt.runsub) * dt
    errwat = where(static.ist == 1, errwat, 0.0)

    # urban QSFC override (func:459-463)
    qfx = wt.etran + wt.ecan + edir
    urban = lutyp == veg_p.isurban
    qsfc_new = where(urban, qfx / a.rhoair * en.ch + a.qair,
                         en.qsfc)
    q2b = where(urban, qsfc_new, en.q2b)

    # tiny-snow reset (func:465-468)
    tiny = (wt.snowh <= 1.0e-6) | (wt.sneqv <= 1.0e-3)
    snowh_new = where(tiny, 0.0, wt.snowh)
    sneqv_new = where(tiny, 0.0, wt.sneqv)

    albedo = where(a.swdown != 0.0, en.fsr / maximum(
        a.swdown, MPE), -999.9)

    # snow ice fraction for the next step's compaction
    tot = wt.snice + wt.snliq
    ficeold_new = where(tot > 0.0, wt.snice / maximum(tot, MPE),
                            0.0)

    new_state = State(
        canliq=wt.canliq, canice=wt.canice, tv=wt.tv, eah=en.eah,
        tah=en.tah, fwet=wt.fwet, lai=lai_new, sai=sai_new,
        tg=en.tg, qsfc=qsfc_new, cm=en.cm, ch=en.ch,
        nsnow=wt.nsnow, snowh=snowh_new, sneqv=sneqv_new,
        sneqvo=sneqvo_new, snice=wt.snice, snliq=wt.snliq,
        zsnso=wt.zsnso, albold=en.albold, tauss=en.tauss,
        ficeold=ficeold_new, qsnow=wt.qsnow,
        stc=wt.stc, swc=wt.swc, smc=wt.smc,
        zwt=wt.zwt, wa=wt.wa, wt=wt.wt, wslake=wt.wslake,
        lfmass=lfmass, rtmass=rtmass, stmass=stmass, wood=wood,
        stblcp=stblcp, fastcp=fastcp)

    flux = Flux(
        fsa=en.fsa, fsr=en.fsr, fira=en.fira, fsh=en.fsh, fcev=en.fcev,
        fgev=en.fgev, fctr=en.fctr, ssoil=en.ssoil, trad=en.trad,
        ecan=wt.ecan, etran=wt.etran, edir=edir, runsrf=wt.runsrf,
        runsub=wt.runsub, apar=en.apar, psn=en.psn, sav=en.sav,
        sag=en.sag, fsno=en.fsno, nee=nee, gpp=gpp, npp=npp, fveg=fveg,
        albedo=albedo, qsnbot=wt.qsnbot, ponding=en.ponding,
        rssun=en.rssun, rssha=en.rssha, bgap=en.bgap, wgap=en.wgap,
        tgv=en.tgv, tgb=en.tgb, chv=en.chv, chb=en.chb,
        emissi=en.emissi, t2mv=en.t2mv, t2mb=en.t2mb, q2v=en.q2v,
        q2b=q2b, fpice=wt.fpice,
        irc=en.irc, irg=en.irg, irb=en.irb, shc=en.shc, shg=en.shg,
        shb=en.shb, evc=en.evc, evg=en.evg, evb=en.evb, ghv=en.ghv,
        ghb=en.ghb, tr=en.tr, chleaf=en.chleaf, chuc=en.chuc,
        chv2=en.chv2, chb2=en.chb2, ponding1=wt.ponding1,
        ponding2=wt.ponding2,
        errwat=errwat, errsw=errsw, erreng=erreng)

    return new_state, flux
