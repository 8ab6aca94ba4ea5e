// Surface energy balance orchestration; counterpart of
// physics/energy.py.  Vegetated-tile and bare-tile fluxes are both
// evaluated on every point and aggregated by fveg, as the plain version
// does: the vegetated-tile diagnostics of a point without vegetation
// come out as whatever that arithmetic gives there (NaN included).
#pragma once

#include "column_args.cuh"
#include "common.cuh"
#include "flux.cuh"
#include "radiation.cuh"
#include "soiltemp.cuh"
#include "thermo.cuh"

namespace nm {

struct EnergyOut {
  // updated prognostics
  float tv, tg, eah, tah, cm, ch, qsfc, albold, tauss;
  float stc[NLEVELS];
  float snice[MSNOW], snliq[MSNOW];
  float sneqv, snowh;
  float smc[NSOIL], swc[NSOIL];
  // fluxes and diagnostics
  float fsno, sav, sag, fsa, fsr, fira, fsh, fcev, fgev, fctr, trad;
  float psn, apar, ssoil;
  float btrani[NSOIL];
  float latheav, latheag;
  bool frozen_canopy, frozen_ground;
  int imelt[NLEVELS];
  float ponding;
  float t2mv, t2mb, q2v, q2b, tgv, tgb, chv, chb, emissi;
  float rssun, rssha, bgap, wgap;
  float shg, shc, shb, evg, evb, ghv, ghb, irg, irc, irb, tr, evc;
  float chleaf, chuc, chv2, chb2;
};

NM_FN void energy(const ParamPt& p, const GenScalars& gen,
                  const ClassScalars& cls, const OptionSet& opt, float dt,
                  int nsnow, const float (&dzsnso)[NLEVELS], float rhoair,
                  float sfcprs, float psfc, float qair, float sfctmp,
                  float thair, float lwdn, float uu, float vv, float zref,
                  float co2air, float o2air, const float (&solad)[2],
                  const float (&solai)[2], float cosz, float igs, float eair,
                  float htop, float tbot, const float (&zsnso)[NLEVELS],
                  const float (&zsoil)[NSOIL], float elai, float esai,
                  float fwet, float foln, float fveg, float qsnow,
                  float canliq, float canice, float tv, float tg,
                  const float (&stc)[NLEVELS], float snowh, float eah,
                  float tah, float sneqvo, float sneqv,
                  const float (&swc)[NSOIL], const float (&smc)[NSOIL],
                  const float (&snice)[MSNOW], const float (&snliq)[MSNOW],
                  float albold, float cm, float ch, float tauss, float qsfc,
                  int lutyp, int isc, int ist, int ice, EnergyOut& o) {
  const float PSIWLT = -150.0f;
  const float Z0_BARE = 0.01f;

  const float ur = mx(sqrtf(uu * uu + vv * vv), 1.0f);
  const float vai = elai + esai;
  const bool is_veg = vai > 0.0f;

  // snow cover fraction (Niu-Yang 2007)
  const float bdsno = sneqv / mx(snowh, MPE);
  const float fmelt = powf(divc(bdsno, 100.0f), gen.mltfct);
  const float fsno =
      (snowh > 0.0f) ? tanhf(snowh / (F32(2.5 * 0.01) * fmelt)) : 0.0f;

  // ground roughness
  const float z0mg_lake =
      (tg <= TFRZ) ? 0.01f * (1.0f - fsno) + fsno * gen.z0sno : 0.01f;
  const float z0mg_soil = Z0_BARE * (1.0f - fsno) + fsno * gen.z0sno;
  const float z0mg = (ist == 2) ? z0mg_lake : z0mg_soil;

  const float zpdg = snowh;
  const float z0m = is_veg ? p.z0mvt : z0mg;
  const float zpd_veg = mx(0.65f * htop, snowh);
  const float zpd = is_veg ? zpd_veg : zpdg;
  float zlvl = mx(zpd, htop) + zref;
  zlvl = (zpdg >= zlvl) ? zpdg + zref : zlvl;
  const float cwp = p.cwpvt;

  ThermoOut th;
  thermoprop(p, cls, gen, lutyp, ist, nsnow, dt, dzsnso, snowh, snice, snliq,
             smc, swc, stc, th);

  RadiationOut rad;
  radiation(p, gen, ist, isc, sneqvo, sneqv, dt, cosz, tg, tv, fsno, qsnow,
            fwet, elai, esai, smc[0], solad, solai, fveg, albold, tauss,
            opt.alb, opt.rad, rad);

  // emissivities
  const float emv = 1.0f - expf(divc(-(elai + esai), 1.0f));
  const float emg_base =
      (ice == 1) ? 0.98f : ((ist == 1) ? gen.emssoil : gen.emslake);
  const float emg = emg_base * (1.0f - fsno) + 1.0f * fsno;

  // soil moisture stress
  const int nroot = p.nroot;
  const float smcwlt = p.smcwlt, smcref = p.smcref, smcmax = p.smcmax;
  const float bexp = p.bexp, psisat = p.psisat;
  const float zroot = -vsel(zsoil, imax(nroot - 1, 0));
  float braw[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    const bool in_root = k < nroot;
    float gx;
    if (opt.btr == 1) {
      gx = (swc[k] - smcwlt) / (smcref - smcwlt);
    } else {
      const float psi =
          mx(-psisat * powf(mx(swc[k], 0.01f) / smcmax, -bexp), PSIWLT);
      if (opt.btr == 2) {
        gx = (1.0f - divc(psi, PSIWLT)) / (1.0f + divc(psisat, PSIWLT));
      } else {
        gx = 1.0f - expf(-5.8f * logf(rdiv(PSIWLT, psi)));
      }
    }
    gx = clipf(gx, 0.0f, 1.0f);
    const float raw = mx(dzsnso[MSNOW + k] / zroot * gx, MPE);
    braw[k] = in_root ? raw : 0.0f;
  }
  float btran = mx(sum_last(braw), MPE);
#pragma unroll
  for (int k = 0; k < NSOIL; ++k)
    o.btrani[k] = (k < nroot) ? braw[k] / btran : 0.0f;
  btran = (ist == 1) ? btran : 0.0f;

  // ground surface and canopy-air humidity resistances
  const float l_rsurf = divc(
      (-zsoil[0]) * (expf(powf(1.0f - mn(swc[0] / smcmax, 1.0f), 5.0f)) - 1.0f),
      F32(2.71828 - 1.0));
  const float d_rsurf = 2.2e-5f * smcmax * smcmax *
                        powf(1.0f - smcwlt / smcmax, 2.0f + rdiv(3.0f, bexp));
  float rsurf = l_rsurf / d_rsurf;
  if (swc[0] < 0.01f && snowh == 0.0f) rsurf = 1.0e6f;
  const float psi_s = -psisat * powf(mx(swc[0], 0.01f) / smcmax, -bexp);
  float rhsur = fsno + (1.0f - fsno) * expf(psi_s * GRAV / (RVAP * tg));
  if (ist == 2) {
    rsurf = 1.0f;
    rhsur = 1.0f;
  }
  if (lutyp == cls.isurban && snowh == 0.0f) rsurf = 1.0e6f;

  // latent heat selection
  const bool frozen_canopy = tv <= TFRZ;
  const float latheav = frozen_canopy ? HSUB : HVAP;
  const float gammav = CPAIR * sfcprs / (0.622f * latheav);
  const bool frozen_ground = tg <= TFRZ;
  const float latheag = frozen_ground ? HSUB : HVAP;
  const float gammag = CPAIR * sfcprs / (0.622f * latheag);

  // top active layer, for the ground heat flux terms
  const int top = MSNOW - nsnow;
  const float stc_top = vsel(stc, top);
  const float df_top = vsel(th.df, top);
  const float dz_top = vsel(dzsnso, top);

  VegeFluxOut vf;
  vege_flux(p, gen, opt, dt, rad.sav, rad.sag, lwdn, ur, uu, vv, sfctmp, thair,
            qair, eair, rhoair, snowh, vai, gammav, gammag, fwet, rad.laisun,
            rad.laisha, cwp, mx(htop, z0mg * 2.0f + MPE), zlvl, zpd,
            mx(z0m, MPE), mx(fveg, 0.01f), z0mg, emv, emg, canliq, canice,
            stc_top, df_top, dz_top, rsurf, latheav, latheag, rad.parsun,
            rad.parsha, igs, foln, co2air, o2air, btran, sfcprs, rhsur, psfc,
            eah, tah, tv, tg, cm, ch, vf);

  BareFluxOut bf;
  bare_flux(gen, cls, opt, lutyp, rad.sag, lwdn, ur, uu, vv, sfctmp, thair,
            qair, eair, rhoair, snowh, stc_top, df_top, dz_top, zlvl, zpdg,
            z0mg, emg, rsurf, latheag, gammag, rhsur, psfc, tg, cm, ch, qsfc,
            bf);

  // tile aggregation
  const bool use_veg = is_veg && (fveg > 0.0f);
  const float fv1 = use_veg ? fveg : 0.0f;
#define NM_AGG(v, b_) (use_veg ? fv1 * (v) + (1.0f - fv1) * (b_) : (b_))
  const float fira =
      use_veg ? fv1 * vf.irg + (1.0f - fv1) * bf.irb + vf.irc : bf.irb;
  const float fsh =
      use_veg ? fv1 * vf.shg + (1.0f - fv1) * bf.shb + vf.shc : bf.shb;
  const float fgev = NM_AGG(vf.evg, bf.evb);
  const float ssoil = NM_AGG(vf.ghv, bf.ghb);
  const float fcev = use_veg ? vf.evc : 0.0f;
  const float fctr = use_veg ? vf.tr : 0.0f;
  float tg_new = NM_AGG(vf.tgv, bf.tgb);
  const float cm_new = NM_AGG(vf.cmv, bf.cmb);
  const float ch_new = NM_AGG(vf.chv, bf.chb);
  // the persisted QSFC is the bare-tile value even on vegetated tiles
  const float qsfc_new = bf.qsfc;
  const float tv_new = use_veg ? vf.tv : tv;
  const float eah_new = use_veg ? vf.eah : eah;
  const float tah_new = use_veg ? vf.tah : tah;
  const float rssun = use_veg ? vf.rssun : 0.0f;
  const float rssha = use_veg ? vf.rssha : 0.0f;
  const float tgv = use_veg ? vf.tgv : bf.tgb;
  const float chv = use_veg ? vf.chv : bf.chb;
  const float psnsun = use_veg ? vf.psnsun : 0.0f;
  const float psnsha = use_veg ? vf.psnsha : 0.0f;

  const float fire = lwdn + fira;
  const float emissi =
      fv1 * (emg * (1.0f - emv) + emv + emv * (1.0f - emv) * (1.0f - emg)) +
      (1.0f - fv1) * emg;
  const float trad =
      powf((fire - (1.0f - emissi) * lwdn) / (emissi * SB), 0.25f);

  const float apar = rad.parsun * rad.laisun + rad.parsha * rad.laisha;
  const float psn = psnsun * rad.laisun + psnsha * rad.laisha;

  // snow/soil temperature diffusion
  float stc_new[NLEVELS];
  tsnosoi(dt, nsnow, tbot, gen.zbot, zsnso, ssoil, th.df, th.hcpct, snowh, stc,
          opt.tbot, opt.stc, stc_new);

  float tgv_o = tgv, tgb_o = bf.tgb;
  if (opt.stc == 2) {
    const bool cap = (snowh > 0.05f) && (tg_new > TFRZ);
    if (cap) {
      tgv_o = TFRZ;
      tgb_o = TFRZ;
      tg_new = NM_AGG(tgv_o, tgb_o);
    }
  }
#undef NM_AGG

  PhaseChangeOut pc;
  phasechange(p, ist, dt, nsnow, th.fact, dzsnso, stc_new, snice, snliq, sneqv,
              snowh, smc, swc, opt.frz, pc);

  o.tv = tv_new;
  o.tg = tg_new;
  o.eah = eah_new;
  o.tah = tah_new;
  o.cm = cm_new;
  o.ch = ch_new;
  o.qsfc = qsfc_new;
  o.albold = rad.albold;
  o.tauss = rad.tauss;
#pragma unroll
  for (int k = 0; k < NLEVELS; ++k) {
    o.stc[k] = pc.stc[k];
    o.imelt[k] = pc.imelt[k];
  }
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    o.snice[k] = pc.snice[k];
    o.snliq[k] = pc.snliq[k];
  }
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    o.smc[k] = pc.smc[k];
    o.swc[k] = pc.swc[k];
  }
  o.sneqv = pc.sneqv;
  o.snowh = pc.snowh;
  o.fsno = fsno;
  o.sav = rad.sav;
  o.sag = rad.sag;
  o.fsa = rad.fsa;
  o.fsr = rad.fsr;
  o.fira = fira;
  o.fsh = fsh;
  o.fcev = fcev;
  o.fgev = fgev;
  o.fctr = fctr;
  o.trad = trad;
  o.psn = psn;
  o.apar = apar;
  o.ssoil = ssoil;
  o.latheav = latheav;
  o.latheag = latheag;
  o.frozen_canopy = frozen_canopy;
  o.frozen_ground = frozen_ground;
  o.ponding = pc.ponding;
  o.t2mv = vf.t2mv;
  o.t2mb = bf.t2mb;
  o.q2v = vf.q2v;
  o.q2b = bf.q2b;
  o.tgv = tgv_o;
  o.tgb = tgb_o;
  o.chv = chv;
  o.chb = bf.chb;
  o.emissi = emissi;
  o.rssun = rssun;
  o.rssha = rssha;
  o.bgap = rad.bgap;
  o.wgap = rad.wgap;
  o.shg = vf.shg;
  o.shc = vf.shc;
  o.shb = bf.shb;
  o.evg = vf.evg;
  o.evb = bf.evb;
  o.ghv = vf.ghv;
  o.ghb = bf.ghb;
  o.irg = vf.irg;
  o.irc = vf.irc;
  o.irb = bf.irb;
  o.tr = vf.tr;
  o.evc = vf.evc;
  o.chleaf = vf.chleaf;
  o.chuc = vf.chuc;
  o.chv2 = vf.ch2v;
  o.chb2 = bf.ehb2;
}

}  // namespace nm
