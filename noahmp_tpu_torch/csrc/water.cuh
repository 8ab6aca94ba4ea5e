// Hydrology driver: canopy water, snowpack driver, soil/lake water
// balance; counterpart of physics/water.py.
#pragma once

#include "column_args.cuh"
#include "common.cuh"
#include "snow.cuh"
#include "soilwater.cuh"

namespace nm {

constexpr float WSLMAX = 5000.0f;

struct CanWaterOut {
  float canliq, canice, tv, cmc, ecan, etran, qrain, qsnow, snowhin, fwet,
      fpice;
};

NM_FN void canwater(const ParamPt& p, float dt, float sfctmp, float uu,
                    float vv, float fcev, float fctr, float qprecc,
                    float qprecl, float elai, float esai, int ist, float tg,
                    float fveg, bool frozen_canopy, float canliq, float canice,
                    float tv, int opt_snf, CanWaterOut& o) {
  // rain/snow partition
  float fpice;
  if (opt_snf == 1) {
    if (sfctmp > F32(273.15 + 2.5)) {
      fpice = 0.0f;
    } else if (sfctmp <= F32(273.15 + 0.5)) {
      fpice = 1.0f;
    } else if (sfctmp <= F32(273.15 + 2.0)) {
      fpice = 1.0f - (-54.632f + 0.2f * sfctmp);
    } else {
      fpice = 0.6f;
    }
  } else if (opt_snf == 2) {
    fpice = (sfctmp >= F32(273.15 + 2.2)) ? 0.0f : 1.0f;
  } else {
    fpice = (sfctmp >= TFRZ) ? 0.0f : 1.0f;
  }

  const float bdfall =
      mn(67.92f + 51.25f * expf(divc(sfctmp - TFRZ, 2.59f)), 120.0f);
  const float prcp = qprecc + qprecl;
  const float rain = prcp * (1.0f - fpice);
  const float snowf = prcp * fpice;
  const float fp = (prcp > 0.0f) ? prcp / mx(10.0f * qprecc + qprecl, MPE) : 0.0f;

  const float vai = elai + esai;
  const bool has_canopy = vai > 0.0f;

  // liquid interception
  const float maxliq = p.canwmxp * vai;
  float qintr = fveg * rain * fp;
  qintr = mn(qintr, (maxliq - canliq) / dt *
                        (1.0f - expf(-rain * dt / mx(maxliq, MPE))));
  qintr = mx(qintr, 0.0f);
  qintr = has_canopy ? qintr : 0.0f;
  const float qdripr = has_canopy ? fveg * rain - qintr : 0.0f;
  const float qthror = has_canopy ? (1.0f - fveg) * rain : rain;

  // canopy evaporation and transpiration by phase
  const float etran = frozen_canopy ? mx(divc(fctr, HSUB), 0.0f)
                                    : mx(divc(fctr, HVAP), 0.0f);
  float qevac = frozen_canopy ? 0.0f : mx(divc(fcev, HVAP), 0.0f);
  const float qdewc = frozen_canopy ? 0.0f : fabsf(mn(divc(fcev, HVAP), 0.0f));
  float qsubc = frozen_canopy ? mx(divc(fcev, HSUB), 0.0f) : 0.0f;
  const float qfroc = frozen_canopy ? fabsf(mn(divc(fcev, HSUB), 0.0f)) : 0.0f;

  qevac = mn(canliq / dt, qevac);
  canliq = mx(canliq + (qintr + qdewc - qevac) * dt, 0.0f);
  canliq = (canliq <= 1.0e-6f) ? 0.0f : canliq;

  // snow interception
  const float maxsno = 6.6f * (0.27f + rdiv(46.0f, bdfall)) * vai;
  float qints = fveg * snowf * fp;
  qints = mn(qints, (maxsno - canice) / dt *
                        (1.0f - expf(-snowf * dt / mx(maxsno, MPE))));
  qints = mx(qints, 0.0f);
  qints = has_canopy ? qints : 0.0f;
  const float ft = mx(divc(tv - 270.15f, 1.87e5f), 0.0f);
  const float fv = divc(sqrtf(uu * uu + vv * vv), 1.56e5f);
  const float qdrips = has_canopy ? mx(canice, 0.0f) * (fv + ft) : 0.0f;
  const float qthros =
      has_canopy ? (1.0f - fveg) * snowf + (fveg * snowf - qints) : snowf;

  qsubc = mn(canice / dt, qsubc);
  canice = mx(canice + (qints - qdrips) * dt + (qfroc - qsubc) * dt, 0.0f);
  canice = (canice <= 1.0e-6f) ? 0.0f : canice;

  // wetted fraction
  float fwet = (canice > 0.0f) ? mx(canice, 0.0f) / mx(maxsno, 1.0e-6f)
                               : mx(canliq, 0.0f) / mx(maxliq, 1.0e-6f);
  fwet = powf(mn(fwet, 1.0f), 0.667f);

  // canopy melt and refreeze
  const bool melt = (canice > 1.0e-6f) && (tv > TFRZ);
  if (melt) {
    const float qmeltc =
        mn(canice / dt, divc((tv - TFRZ) * CICE * canice, DENICE) / (dt * HFUS));
    canice = mx(canice - qmeltc * dt, 0.0f);
    canliq = mx(canliq + qmeltc * dt, 0.0f);
    tv = fwet * TFRZ + (1.0f - fwet) * tv;
  }
  const bool frz = (canliq > 1.0e-6f) && (tv < TFRZ);
  if (frz) {
    const float qfrzc =
        mn(canliq / dt, divc((TFRZ - tv) * CWAT * canliq, DENWAT) / (dt * HFUS));
    canliq = mx(canliq - qfrzc * dt, 0.0f);
    canice = mx(canice + qfrzc * dt, 0.0f);
    tv = fwet * TFRZ + (1.0f - fwet) * tv;
  }

  o.canliq = canliq;
  o.canice = canice;
  o.tv = tv;
  o.cmc = canliq + canice;
  o.ecan = qevac + qsubc - qdewc - qfroc;
  o.etran = etran;
  o.qrain = qdripr + qthror;
  float qsnow = qdrips + qthros;
  float snowhin = qsnow / bdfall;
  if (ist == 2 && tg > TFRZ) {
    qsnow = 0.0f;
    snowhin = 0.0f;
  }
  o.qsnow = qsnow;
  o.snowhin = snowhin;
  o.fwet = fwet;
  o.fpice = fpice;
}

struct SnowWaterOut {
  int nsnow;
  float snowh, sneqv;
  float snice[MSNOW], snliq[MSNOW];
  float stc[NLEVELS], zsnso[NLEVELS], dzsnso[NLEVELS];
  float swc0, sice0;
  float qsnbot, snoflow, ponding1, ponding2;
};

// Snowpack driver.  dzsnow: the snow layer thicknesses of the previous
// dzsnso
NM_FN void snowwater_full(const GenScalars& gen, float dt,
                          const float (&zsoil)[NSOIL],
                          const float (&dzsnow)[MSNOW],
                          const int (&imelt_snow)[MSNOW], float sfctmp,
                          float snowhin, float qsnow, float qsnfro,
                          float qsnsub, float qrain,
                          const float (&ficeold)[MSNOW], int nsnow,
                          float snowh, float sneqv,
                          const float (&snice)[MSNOW],
                          const float (&snliq)[MSNOW], float swc0, float sice0,
                          const float (&stc)[NLEVELS], SnowWaterOut& o) {
  float dz_soil[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k)
    dz_soil[k] = -(zsoil[k] - ((k == 0) ? 0.0f : zsoil[k - 1]));

  Pack p;
  p.nsnow = nsnow;
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    p.dz[k] = dzsnow[k];
    p.ice[k] = snice[k];
    p.liq[k] = snliq[k];
    p.stc[k] = stc[k];
  }
  p.sneqv = sneqv;
  p.snowh = snowh;
  p.swc0 = swc0;
  p.sice0 = sice0;
  p.dzsoil1 = dz_soil[0];
  p.ponding1 = 0.0f;
  p.ponding2 = 0.0f;

  snowfall(p, dt, qsnow, snowhin, sfctmp);
  if (p.nsnow > 0) compact(p, dt, imelt_snow, ficeold);
  if (p.nsnow > 0) combine(p);
  if (p.nsnow > 0) divide(p);
  const float qsnbot = snowh2o(p, dt, qsnfro, qsnsub, qrain, gen.ssi);

  // zero the empty layers
  const int top = MSNOW - p.nsnow;
  float ice[MSNOW], liq[MSNOW], stc3[MSNOW], dz3[MSNOW];
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    const bool active = k >= top;
    ice[k] = active ? p.ice[k] : 0.0f;
    liq[k] = active ? p.liq[k] : 0.0f;
    stc3[k] = active ? p.stc[k] : 0.0f;
    dz3[k] = active ? p.dz[k] : 0.0f;
  }

  // glacier overflow
  const bool over = p.sneqv > 2000.0f;
  constexpr int bot = MSNOW - 1;
  const float bdsnow = ice[bot] / mx(dz3[bot], MPE);
  const float snoflow_mm = over ? p.sneqv - 2000.0f : 0.0f;
  ice[bot] = ice[bot] - snoflow_mm;
  if (over) dz3[bot] = dz3[bot] - snoflow_mm / mx(bdsnow, MPE);
  o.snoflow = snoflow_mm / dt;

  // mass of a layered pack
  float m[MSNOW];
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) m[k] = (k >= top) ? ice[k] + liq[k] : 0.0f;
  o.sneqv = (p.nsnow > 0) ? sum_last(m) : p.sneqv;

  // rebuild zsnso and dzsnso
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < NLEVELS; ++k) {
    const float dzk = (k < MSNOW) ? dz3[k] : dz_soil[k - MSNOW];
    acc = (k == 0) ? dzk : acc + dzk;
    const bool active = k >= top;
    o.zsnso[k] = active ? -acc : 0.0f;
    o.dzsnso[k] = active ? dzk : 0.0f;
    o.stc[k] = (k < MSNOW) ? stc3[k] : stc[k];
  }
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    o.snice[k] = ice[k];
    o.snliq[k] = liq[k];
  }
  o.nsnow = p.nsnow;
  o.snowh = p.snowh;
  o.swc0 = p.swc0;
  o.sice0 = p.sice0;
  o.qsnbot = qsnbot;
  o.ponding1 = p.ponding1;
  o.ponding2 = p.ponding2;
}

struct WaterOut {
  float canliq, canice, tv, fwet;
  int nsnow;
  float snowh, sneqv;
  float snice[MSNOW], snliq[MSNOW];
  float stc[NLEVELS], zsnso[NLEVELS], dzsnso[NLEVELS];
  float swc[NSOIL], smc[NSOIL];
  float zwt, wa, wt, wslake;
  float ecan, etran, runsrf, runsub, qsnow, ponding1, ponding2, qsnbot, fpice;
};

NM_FN void water(const ParamPt& p, const GenScalars& gen,
                 const ClassScalars& cls, const OptionSet& opt, int lutyp,
                 int ist, float dt, const float (&zsoil)[NSOIL],
                 const float (&dzsnow)[MSNOW], const int (&imelt_snow)[MSNOW],
                 float uu, float vv, float fcev, float fctr, float qprecc,
                 float qprecl, float elai, float esai, float sfctmp,
                 float qvap, float qdew, const float (&btrani)[NSOIL],
                 const float (&ficeold)[MSNOW], float ponding, float tg,
                 float fveg, bool frozen_canopy, bool frozen_ground, int nsnow,
                 float canliq, float canice, float tv, float snowh,
                 float sneqv, const float (&snice)[MSNOW],
                 const float (&snliq)[MSNOW], const float (&stc)[NLEVELS],
                 const float (&swc_in)[NSOIL], const float (&smc_in)[NSOIL],
                 float zwt, float wa, float wt, float wslake, WaterOut& o) {
  float sice[NSOIL], swc[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    sice[k] = mx(smc_in[k] - swc_in[k], 0.0f);
    swc[k] = swc_in[k];
  }

  CanWaterOut cw;
  canwater(p, dt, sfctmp, uu, vv, fcev, fctr, qprecc, qprecl, elai, esai, ist,
           tg, fveg, frozen_canopy, canliq, canice, tv, opt.snf, cw);

  // sublimation/frost against soil evaporation/dew
  const bool has_snow = sneqv > 0.0f;
  const float qsnsub = has_snow ? mn(qvap, sneqv / dt) : 0.0f;
  const float qseva = qvap - qsnsub;
  const float qsnfro = has_snow ? qdew : 0.0f;
  const float qsdew = qdew - qsnfro;

  SnowWaterOut sw;
  snowwater_full(gen, dt, zsoil, dzsnow, imelt_snow, sfctmp, cw.snowhin,
                 cw.qsnow, qsnfro, qsnsub, cw.qrain, ficeold, nsnow, snowh,
                 sneqv, snice, snliq, swc[0], sice[0], stc, sw);
  swc[0] = sw.swc0;
  sice[0] = sw.sice0;

  // on frozen ground dew and evaporation act on the soil ice
  const float dz1 = sw.dzsnso[MSNOW];
  const float sice0 = frozen_ground
                          ? sice[0] + (qsdew - qseva) * dt / (dz1 * 1000.0f)
                          : sice[0];
  const float qsdew_g = frozen_ground ? 0.0f : qsdew;
  const float qseva_g = frozen_ground ? 0.0f : qseva;
  const bool neg = frozen_ground && (sice0 < 0.0f);
  swc[0] = neg ? swc[0] + sice0 : swc[0];
  sice[0] = neg ? 0.0f : sice0;

  // surface water input
  float qinsrf = (ponding + sw.ponding1 + sw.ponding2) / dt * 0.001f;
  qinsrf = qinsrf + ((sw.nsnow == 0) ? (sw.qsnbot + qsdew_g + cw.qrain)
                                     : (sw.qsnbot + qsdew_g)) *
                        0.001f;
  const float qseva_m = qseva_g * 0.001f;

  float etrani[NSOIL], dz_soil[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    etrani[k] = cw.etran * btrani[k] * 0.001f;
    dz_soil[k] = sw.dzsnso[MSNOW + k];
  }

  o.canliq = cw.canliq;
  o.canice = cw.canice;
  o.tv = cw.tv;
  o.fwet = cw.fwet;
  o.nsnow = sw.nsnow;
  o.snowh = sw.snowh;
  o.sneqv = sw.sneqv;
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    o.snice[k] = sw.snice[k];
    o.snliq[k] = sw.snliq[k];
  }
#pragma unroll
  for (int k = 0; k < NLEVELS; ++k) {
    o.stc[k] = sw.stc[k];
    o.zsnso[k] = sw.zsnso[k];
    o.dzsnso[k] = sw.dzsnso[k];
  }
  o.ecan = cw.ecan;
  o.etran = cw.etran;
  o.qsnow = cw.qsnow;
  o.ponding1 = sw.ponding1;
  o.ponding2 = sw.ponding2;
  o.qsnbot = sw.qsnbot;
  o.fpice = cw.fpice;

  if (ist == 2) {
    // lake: storage and overflow only; soil water, water table and
    // aquifer stay as they came in
    const float runsrf_lake = (wslake >= WSLMAX) ? qinsrf * 1000.0f : 0.0f;
    o.wslake = wslake + (qinsrf - qseva_m) * 1000.0f * dt - runsrf_lake * dt;
#pragma unroll
    for (int k = 0; k < NSOIL; ++k) {
      o.swc[k] = swc[k];
      o.smc[k] = smc_in[k];
    }
    o.zwt = zwt;
    o.wa = wa;
    o.wt = wt;
    o.runsrf = runsrf_lake;
    o.runsub = 0.0f + sw.snoflow;
    return;
  }

  SoilH2OOut sh;
  soilh2o(p, gen, cls, lutyp, dt, zsoil, dz_soil, qinsrf, qseva_m, etrani,
          sice, swc, smc_in, zwt, opt.run, opt.inf, sh);

  float runsub;
  if (opt.run == 1) {
    GroundwaterOut gw;
    groundwater(p, gen, dt, zsoil, sice, sh.wcnd, sh.fcrmax, sh.swc, sh.zwt, wa,
                wt, gw);
#pragma unroll
    for (int k = 0; k < NSOIL; ++k) o.swc[k] = gw.swc[k];
    o.zwt = gw.zwt;
    o.wa = gw.wa;
    o.wt = gw.wt;
    runsub = gw.qdis;
  } else {
#pragma unroll
    for (int k = 0; k < NSOIL; ++k) o.swc[k] = sh.swc[k];
    o.zwt = sh.zwt;
    o.wa = wa;
    o.wt = wt;
    runsub = sh.runsub;
    if (opt.run == 3 || opt.run == 4) runsub = runsub + sh.qdrain;
  }
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) o.smc[k] = o.swc[k] + sice[k];
  o.runsrf = sh.runsrf;
  o.runsub = runsub + sw.snoflow;
  o.wslake = wslake;
}

}  // namespace nm
