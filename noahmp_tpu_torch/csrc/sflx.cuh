// One Noah-MP timestep of one land column, plus the conservation
// diagnostics; counterpart of physics/sflx.py:step_columns.
#pragma once

#include "atm.cuh"
#include "column_args.cuh"
#include "common.cuh"
#include "energy.cuh"
#include "phenology.cuh"
#include "water.cuh"

namespace nm {

NM_FN void column_step(const ParamPt& p, const GenScalars& gen,
                       const ClassScalars& cls, const OptionSet& opt, float dt,
                       const StaticPt& sc, const ForcingPt& fo,
                       const StatePt& st, StatePt& ns, FluxPt& fx) {
  AtmOut a;
  atm(fo.sfcprs, fo.sfctmp, fo.q2, fo.prcp, fo.soldn, fo.cosz, a);

  // layer thickness from zsnso
  float dzsnso[NLEVELS], dzsnow[MSNOW];
#pragma unroll
  for (int k = 0; k < NLEVELS; ++k) {
    const float d = ((k == 0) ? 0.0f : st.zsnso[k - 1]) - st.zsnso[k];
    dzsnso[k] = (k >= MSNOW - st.nsnow) ? d : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) dzsnow[k] = dzsnso[k];

  // water storage at step begin
  float w[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) w[k] = st.smc[k] * dzsnso[MSNOW + k];
  const float beg_wb =
      st.canliq + st.canice + st.sneqv + st.wa + sum_last(w) * 1000.0f;

  PhenologyOut ph;
  phenology(p, cls, sc.lutyp, st.snowh, st.tv, sc.lat, fo.yearlen, fo.julian,
            st.lai, st.sai, opt.veg, ph);
  const float fveg = green_fraction(cls, sc.lutyp, sc.shdfac, sc.shdmax, ph.lai,
                                    ph.sai, ph.elai, ph.esai, opt.veg);

  EnergyOut en;
  energy(p, gen, cls, opt, dt, st.nsnow, dzsnso, a.rhoair, fo.sfcprs,
         fo.sfcprs, a.qair, fo.sfctmp, a.thair, fo.lwdn, fo.uu, fo.vv, sc.zlvl,
         fo.co2air, fo.o2air, a.solad, a.solai, fo.cosz, ph.igs, a.eair,
         ph.htop, sc.tbot, st.zsnso, sc.zsoil, ph.elai, ph.esai, st.fwet,
         fo.foln, fveg, st.qsnow, st.canliq, st.canice, st.tv, st.tg, st.stc,
         st.snowh, st.eah, st.tah, st.sneqvo, st.sneqv, st.swc, st.smc,
         st.snice, st.snliq, st.albold, st.cm, st.ch, st.tauss, st.qsfc,
         sc.lutyp, sc.isc, sc.ist, sc.ice, en);

  const float sneqvo_new = en.sneqv;
  const float qvap = mx(en.fgev / en.latheag, 0.0f);
  const float qdew = fabsf(mn(en.fgev / en.latheag, 0.0f));
  const float edir = qvap - qdew;

  int imelt_snow[MSNOW];
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) imelt_snow[k] = en.imelt[k];

  WaterOut wt;
  water(p, gen, cls, opt, sc.lutyp, sc.ist, dt, sc.zsoil, dzsnow, imelt_snow,
        fo.uu, fo.vv, en.fcev, en.fctr, a.qprecc, a.qprecl, ph.elai, ph.esai,
        fo.sfctmp, qvap, qdew, en.btrani, st.ficeold, en.ponding, en.tg, fveg,
        en.frozen_canopy, en.frozen_ground, st.nsnow, st.canliq, st.canice,
        en.tv, en.snowh, en.sneqv, en.snice, en.snliq, en.stc, en.swc, en.smc,
        st.zwt, st.wa, st.wt, st.wslake, wt);

  // conservation diagnostics; returned, not asserted
  const float errsw = a.swdown - (en.fsa + en.fsr);
  const float erreng = en.sav + en.sag - (en.fira + en.fsh + en.fcev + en.fgev +
                                          en.fctr + en.ssoil);
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) w[k] = wt.smc[k] * wt.dzsnso[MSNOW + k];
  const float end_wb =
      wt.canliq + wt.canice + wt.sneqv + wt.wa + sum_last(w) * 1000.0f;
  float errwat = end_wb - beg_wb -
                 (fo.prcp - wt.ecan - wt.etran - edir - wt.runsrf - wt.runsub) * dt;
  errwat = (sc.ist == 1) ? errwat : 0.0f;

  // urban QSFC override
  const float qfx = wt.etran + wt.ecan + edir;
  const bool urban = sc.lutyp == cls.isurban;
  const float qsfc_new = urban ? qfx / a.rhoair * en.ch + a.qair : en.qsfc;
  const float q2b = urban ? qsfc_new : en.q2b;

  // tiny-snow reset
  const bool tiny = (wt.snowh <= 1.0e-6f) || (wt.sneqv <= 1.0e-3f);

  ns.canliq = wt.canliq;
  ns.canice = wt.canice;
  ns.tv = wt.tv;
  ns.eah = en.eah;
  ns.tah = en.tah;
  ns.fwet = wt.fwet;
  ns.lai = ph.lai;
  ns.sai = ph.sai;
  ns.tg = en.tg;
  ns.qsfc = qsfc_new;
  ns.cm = en.cm;
  ns.ch = en.ch;
  ns.nsnow = wt.nsnow;
  ns.snowh = tiny ? 0.0f : wt.snowh;
  ns.sneqv = tiny ? 0.0f : wt.sneqv;
  ns.sneqvo = sneqvo_new;
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    ns.snice[k] = wt.snice[k];
    ns.snliq[k] = wt.snliq[k];
    // snow ice fraction for the next step's compaction
    const float tot = wt.snice[k] + wt.snliq[k];
    ns.ficeold[k] = (tot > 0.0f) ? wt.snice[k] / mx(tot, MPE) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NLEVELS; ++k) {
    ns.zsnso[k] = wt.zsnso[k];
    ns.stc[k] = wt.stc[k];
  }
  ns.albold = en.albold;
  ns.tauss = en.tauss;
  ns.qsnow = wt.qsnow;
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    ns.swc[k] = wt.swc[k];
    ns.smc[k] = wt.smc[k];
  }
  ns.zwt = wt.zwt;
  ns.wa = wt.wa;
  ns.wt = wt.wt;
  ns.wslake = wt.wslake;
  // the carbon pools pass through: opt_veg 2 and 5 are not built
  ns.lfmass = st.lfmass;
  ns.rtmass = st.rtmass;
  ns.stmass = st.stmass;
  ns.wood = st.wood;
  ns.stblcp = st.stblcp;
  ns.fastcp = st.fastcp;

  fx.fsa = en.fsa;
  fx.fsr = en.fsr;
  fx.fira = en.fira;
  fx.fsh = en.fsh;
  fx.fcev = en.fcev;
  fx.fgev = en.fgev;
  fx.fctr = en.fctr;
  fx.ssoil = en.ssoil;
  fx.trad = en.trad;
  fx.ecan = wt.ecan;
  fx.etran = wt.etran;
  fx.edir = edir;
  fx.runsrf = wt.runsrf;
  fx.runsub = wt.runsub;
  fx.apar = en.apar;
  fx.psn = en.psn;
  fx.sav = en.sav;
  fx.sag = en.sag;
  fx.fsno = en.fsno;
  fx.nee = 0.0f;
  fx.gpp = 0.0f;
  fx.npp = 0.0f;
  fx.fveg = fveg;
  fx.albedo = (a.swdown != 0.0f) ? en.fsr / mx(a.swdown, MPE) : -999.9f;
  fx.qsnbot = wt.qsnbot;
  fx.ponding = en.ponding;
  fx.rssun = en.rssun;
  fx.rssha = en.rssha;
  fx.bgap = en.bgap;
  fx.wgap = en.wgap;
  fx.tgv = en.tgv;
  fx.tgb = en.tgb;
  fx.chv = en.chv;
  fx.chb = en.chb;
  fx.emissi = en.emissi;
  fx.t2mv = en.t2mv;
  fx.t2mb = en.t2mb;
  fx.q2v = en.q2v;
  fx.q2b = q2b;
  fx.fpice = wt.fpice;
  fx.irc = en.irc;
  fx.irg = en.irg;
  fx.irb = en.irb;
  fx.shc = en.shc;
  fx.shg = en.shg;
  fx.shb = en.shb;
  fx.evc = en.evc;
  fx.evg = en.evg;
  fx.evb = en.evb;
  fx.ghv = en.ghv;
  fx.ghb = en.ghb;
  fx.tr = en.tr;
  fx.chleaf = en.chleaf;
  fx.chuc = en.chuc;
  fx.chv2 = en.chv2;
  fx.chb2 = en.chb2;
  fx.ponding1 = wt.ponding1;
  fx.ponding2 = wt.ponding2;
  fx.errwat = errwat;
  fx.errsw = errsw;
  fx.erreng = erreng;
}

}  // namespace nm
