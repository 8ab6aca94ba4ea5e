// One Noah-MP timestep of one land column, plus the conservation
// diagnostics; counterpart of physics/sflx.py:step_columns, cut into the
// stages that the CUDA kernels (column.cu) and the host build
// (column_host.cpp) walk in this order:
//
//   kPrologue  atm, phenology, thermal properties, radiation and the
//              part of the energy balance that both tiles share
//   kVegeTile  the vegetated tile's Newton iterations   } independent:
//   kBareTile  the bare tile's Newton iteration         } separate warps
//   kGround    tile aggregation, snow/soil temperatures, phase change
//   kWater     canopy, snow and soil water; the water residual; with
//              opt_veg 2 or 5 the carbon pools, which need the water
//              stage's soil moisture and temperature and nothing that
//              a later launch could supply
//
// A stage reads its inputs from the step's arrays where it uses them,
// stores each output leaf where it is final, and passes the rest to the
// later stages through the seam (column_io.cuh).
#pragma once

#include "atm.cuh"
#include "carbon.cuh"
#include "column_io.cuh"
#include "common.cuh"
#include "energy.cuh"
#include "phenology.cuh"
#include "water.cuh"

namespace nm {

enum Stage { kPrologue = 0, kVegeTile, kBareTile, kGround, kWater, kNumStages };

NM_INL void stage_prologue(const Point& q) {
  const ColumnArgs& a = q.a;
  const float sfcprs = q.fo.sfcprs(), sfctmp = q.fo.sfctmp();

  AtmOut at;
  atm(sfcprs, sfctmp, q.fo.q2(), q.fo.prcp(), q.fo.soldn(), q.fo.cosz(), at);

  const int nsnow = q.st.nsnow();
  float zsnso[NLEVELS], dzsnso[NLEVELS];
  q.st.zsnso(zsnso);
  layer_thickness(zsnso, nsnow, dzsnso);

  const int lutyp = q.sc.lutyp();
  PhenologyOut ph;
  phenology(q.p, a.cls, lutyp, q.st.snowh(), q.st.tv(), q.sc.lat(),
            q.fo.yearlen(), q.fo.julian(), q.st.lai(), q.st.sai(), a.opt.veg,
            ph);
  const float fveg =
      green_fraction(a.cls, lutyp, q.sc.shdfac(), q.sc.shdmax(), ph.lai,
                     ph.sai, ph.elai, ph.esai, a.opt.veg);

  energy_prologue(q, nsnow, dzsnso, at.rhoair, at.thair, at.eair, at.solad,
                  at.solai, at.swdown, ph.igs, ph.htop, ph.elai, ph.esai,
                  fveg);

  q.ns.lai(ph.lai);
  q.ns.sai(ph.sai);
  q.fx.nee(0.0f);
  q.fx.gpp(0.0f);
  q.fx.npp(0.0f);
}

NM_INL void stage_water(const Point& q) {
  const ColumnArgs& a = q.a;
  const Seam& sm = q.sm;
  const float dt = a.dt;
  const int lutyp = q.sc.lutyp(), ist = q.sc.ist();
  const int nsnow = q.st.nsnow();
  const float prcp = q.fo.prcp();
  const float tv0 = q.st.tv(), tg0 = q.st.tg();
  const float canliq = q.st.canliq(), canice = q.st.canice();
  const float wa = q.st.wa();

  float zsoil[NSOIL], zsnso[NLEVELS], dzsnso[NLEVELS], dzsnow[MSNOW];
  q.sc.zsoil(zsoil);
  q.st.zsnso(zsnso);
  layer_thickness(zsnso, nsnow, dzsnso);
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) dzsnow[k] = dzsnso[k];

  // water storage at step begin
  float w[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) w[k] = q.st.smc(k) * dzsnso[MSNOW + k];
  const float beg_wb =
      canliq + canice + q.st.sneqv() + wa + sum_last(w) * 1000.0f;

  const float qvap = sm.qvap(), qdew = sm.qdew();
  const float edir = qvap - qdew;
  float btrani[NSOIL], ficeold[MSNOW], snice[MSNOW], snliq[MSNOW];
  float stc[NLEVELS], swc[NSOIL], smc[NSOIL];
  int imelt_snow[MSNOW];
  sm.get_btrani(btrani);
  q.st.ficeold(ficeold);
  sm.get_g_snice(snice);
  sm.get_g_snliq(snliq);
  sm.get_g_stc(stc);
  sm.get_g_swc(swc);
  sm.get_g_smc(smc);
  sm.get_g_imelt(imelt_snow);

  WaterOut wt;
  water(q.p, a.gen, a.cls, a.opt, lutyp, ist, dt, zsoil, dzsnow, imelt_snow,
        q.fo.uu(), q.fo.vv(), q.fx.get_fcev(), q.fx.get_fctr(), 0.10f * prcp,
        0.90f * prcp, sm.elai(), sm.esai(), q.fo.sfctmp(), qvap, qdew, btrani,
        ficeold, q.fx.get_ponding(), q.ns.get_tg(), q.fx.get_fveg(),
        tv0 <= TFRZ, tg0 <= TFRZ, nsnow, canliq, canice, sm.v_tv(),
        sm.g_snowh(), q.ns.get_sneqvo(), snice, snliq, stc, swc, smc,
        q.st.zwt(), wa, q.st.wt(), q.st.wslake(), wt);

  // water residual; returned, not asserted
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) w[k] = wt.smc[k] * wt.dzsnso[MSNOW + k];
  const float end_wb =
      wt.canliq + wt.canice + wt.sneqv + wt.wa + sum_last(w) * 1000.0f;
  float errwat = end_wb - beg_wb -
                 (prcp - wt.ecan - wt.etran - edir - wt.runsrf - wt.runsub) * dt;
  errwat = (ist == 1) ? errwat : 0.0f;

  // urban QSFC override
  const float qfx = wt.etran + wt.ecan + edir;
  const bool urban = lutyp == a.cls.isurban;
  const float qsfc_new =
      urban ? qfx / sm.rhoair() * q.ns.get_ch() + q.fo.q2() : sm.b_qsfc();
  const float q2b = urban ? qsfc_new : sm.b_q2b();

  // tiny-snow reset
  const bool tiny = (wt.snowh <= 1.0e-6f) || (wt.sneqv <= 1.0e-3f);

  // snow ice fraction for the next step's compaction
  float ficeold_new[MSNOW];
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    const float tot = wt.snice[k] + wt.snliq[k];
    ficeold_new[k] = (tot > 0.0f) ? wt.snice[k] / mx(tot, MPE) : 0.0f;
  }

  const StateOut& ns = q.ns;
  ns.canliq(wt.canliq);
  ns.canice(wt.canice);
  ns.tv(wt.tv);
  ns.fwet(wt.fwet);
  ns.qsfc(qsfc_new);
  ns.nsnow(wt.nsnow);
  ns.snowh(tiny ? 0.0f : wt.snowh);
  ns.sneqv(tiny ? 0.0f : wt.sneqv);
  ns.snice(wt.snice);
  ns.snliq(wt.snliq);
  ns.zsnso(wt.zsnso);
  ns.ficeold(ficeold_new);
  ns.qsnow(wt.qsnow);
  ns.stc(wt.stc);
  ns.swc(wt.swc);
  ns.smc(wt.smc);
  ns.zwt(wt.zwt);
  ns.wa(wt.wa);
  ns.wt(wt.wt);
  ns.wslake(wt.wslake);

  const FluxOut& fx = q.fx;
  if (a.opt.veg == 2 || a.opt.veg == 5) {
    // the prologue stored phenology's LAI and zeros for the carbon
    // fluxes; carbon's values replace them
    CarbonOut cb;
    carbon(q.p, a.cls, lutyp, dt, zsoil, wt.dzsnso, wt.stc, wt.smc, wt.tv,
           fx.get_psn(), q.fo.foln(), sm.btran(), sm.igs(), ns.get_lai(),
           q.st.lfmass(), q.st.rtmass(), q.st.stmass(), q.st.wood(),
           q.st.stblcp(), q.st.fastcp(), cb);
    ns.lai(cb.lai);
    ns.sai(cb.sai);
    ns.lfmass(cb.lfmass);
    ns.rtmass(cb.rtmass);
    ns.stmass(cb.stmass);
    ns.wood(cb.wood);
    ns.stblcp(cb.stblcp);
    ns.fastcp(cb.fastcp);
    fx.nee(cb.nee);
    fx.gpp(cb.gpp);
    fx.npp(cb.npp);
  } else {
    // without carbon the pools pass through
    ns.lfmass(q.st.lfmass());
    ns.rtmass(q.st.rtmass());
    ns.stmass(q.st.stmass());
    ns.wood(q.st.wood());
    ns.stblcp(q.st.stblcp());
    ns.fastcp(q.st.fastcp());
  }

  fx.ecan(wt.ecan);
  fx.etran(wt.etran);
  fx.runsrf(wt.runsrf);
  fx.runsub(wt.runsub);
  fx.qsnbot(wt.qsnbot);
  fx.q2b(q2b);
  fx.fpice(wt.fpice);
  fx.ponding1(wt.ponding1);
  fx.ponding2(wt.ponding2);
  fx.errwat(errwat);
}

// Every stage but kVegeTile: the launchers walk the vegetated tile's
// passes themselves (energy.cuh:energy_vege_tile), with the list of the
// canopy loop's second pass between them.
NM_INL void run_stage(int stage, const Point& q) {
  switch (stage) {
    case kPrologue: stage_prologue(q); break;
    case kBareTile: energy_bare_tile(q); break;
    case kGround: energy_ground(q); break;
    case kWater: stage_water(q); break;
    default: break;
  }
}

}  // namespace nm
