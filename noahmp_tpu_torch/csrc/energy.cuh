// Surface energy balance orchestration; counterpart of
// physics/energy.py, cut at its seams into the pieces the step's stages
// run: the prologue (everything the two tile balances share), the
// vegetated tile, the bare tile, and the ground stage (tile aggregation,
// snow/soil temperature diffusion, phase change).  The tiles read the
// same inputs and neither reads the other's result, so they run on
// different warps.  Vegetated-tile and bare-tile fluxes are both
// evaluated on every point and aggregated by fveg, as the plain version
// does: the vegetated-tile diagnostics of a point without vegetation
// come out as whatever that arithmetic gives there (NaN included).
#pragma once

#include "column_io.cuh"
#include "common.cuh"
#include "flux.cuh"
#include "radiation.cuh"
#include "soiltemp.cuh"
#include "thermo.cuh"

namespace nm {

// Layer thickness from the interface depths: zero above the top active
// snow layer.
NM_INL void layer_thickness(const float (&zsnso)[NLEVELS], int nsnow,
                            float (&dzsnso)[NLEVELS]) {
#pragma unroll
  for (int k = 0; k < NLEVELS; ++k) {
    const float d = ((k == 0) ? 0.0f : zsnso[k - 1]) - zsnso[k];
    dzsnso[k] = (k >= MSNOW - nsnow) ? d : 0.0f;
  }
}

// Everything up to the tile balances.  Stores what is final (the
// radiation leaves, the snow-age state) and hands the rest on through
// the seam.
NM_INL void energy_prologue(const Point& q, int nsnow,
                            const float (&dzsnso)[NLEVELS], float rhoair,
                            float thair, float eair,
                            const float (&solad)[2], const float (&solai)[2],
                            float swdown, float igs, float htop, float elai,
                            float esai, float fveg) {
  const ColumnArgs& a = q.a;
  const ParamRef& p = q.p;
  const GenScalars& gen = a.gen;
  const float PSIWLT = -150.0f;
  const float Z0_BARE = 0.01f;

  const float dt = a.dt;
  const float uu = q.fo.uu(), vv = q.fo.vv();
  const float sfcprs = q.fo.sfcprs(), cosz = q.fo.cosz();
  const float zref = q.sc.zlvl();
  const int lutyp = q.sc.lutyp(), isc = q.sc.isc(), ist = q.sc.ist();
  const int ice = q.sc.ice();
  const float tv = q.st.tv(), tg = q.st.tg();
  const float snowh = q.st.snowh(), sneqv = q.st.sneqv();
  float zsoil[NSOIL], stc[NLEVELS], swc[NSOIL], smc[NSOIL];
  float snice[MSNOW], snliq[MSNOW];
  q.sc.zsoil(zsoil);
  q.st.stc(stc);
  q.st.swc(swc);
  q.st.smc(smc);
  q.st.snice(snice);
  q.st.snliq(snliq);

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
  const float z0m = is_veg ? p.z0mvt() : z0mg;
  const float zpd_veg = mx(0.65f * htop, snowh);
  const float zpd = is_veg ? zpd_veg : zpdg;
  float zlvl = mx(zpd, htop) + zref;
  zlvl = (zpdg >= zlvl) ? zpdg + zref : zlvl;

  ThermoOut th;
  thermoprop(p, a.cls, gen, lutyp, ist, nsnow, dt, dzsnso, snowh, snice, snliq,
             smc, swc, stc, th);

  RadiationOut rad;
  radiation(p, gen, ist, isc, q.st.sneqvo(), sneqv, dt, cosz, tg, tv, fsno,
            q.st.qsnow(), q.st.fwet(), elai, esai, smc[0], solad, solai, fveg,
            q.st.albold(), q.st.tauss(), a.opt.alb, a.opt.rad, rad);

  // emissivities
  const float emv = 1.0f - expf(divc(-(elai + esai), 1.0f));
  const float emg_base =
      (ice == 1) ? 0.98f : ((ist == 1) ? gen.emssoil : gen.emslake);
  const float emg = emg_base * (1.0f - fsno) + 1.0f * fsno;

  // soil moisture stress
  const int nroot = p.nroot();
  const float smcwlt = p.smcwlt(), smcref = p.smcref(), smcmax = p.smcmax();
  const float bexp = p.bexp(), psisat = p.psisat();
  const float zroot = -vsel(zsoil, imax(nroot - 1, 0));
  float braw[NSOIL], btrani[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    const bool in_root = k < nroot;
    float gx;
    if (a.opt.btr == 1) {
      gx = (swc[k] - smcwlt) / (smcref - smcwlt);
    } else {
      const float psi =
          mx(-psisat * powf(mx(swc[k], 0.01f) / smcmax, -bexp), PSIWLT);
      if (a.opt.btr == 2) {
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
    btrani[k] = (k < nroot) ? braw[k] / btran : 0.0f;
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
  if (lutyp == a.cls.isurban && snowh == 0.0f) rsurf = 1.0e6f;

  // latent heat selection
  const float latheav = (tv <= TFRZ) ? HSUB : HVAP;
  const float gammav = CPAIR * sfcprs / (0.622f * latheav);
  const float latheag = (tg <= TFRZ) ? HSUB : HVAP;
  const float gammag = CPAIR * sfcprs / (0.622f * latheag);

  // top active layer, for the ground heat flux terms
  const int top = MSNOW - nsnow;

  const Seam& sm = q.sm;
  sm.ur(ur);
  sm.thair(thair);
  sm.eair(eair);
  sm.rhoair(rhoair);
  sm.gammav(gammav);
  sm.gammag(gammag);
  sm.laisun(rad.laisun);
  sm.laisha(rad.laisha);
  sm.zlvl(zlvl);
  sm.zpd(zpd);
  sm.z0m(z0m);
  sm.z0mg(z0mg);
  sm.emv(emv);
  sm.emg(emg);
  sm.stc_top(vsel(stc, top));
  sm.df_top(vsel(th.df, top));
  sm.dz_top(vsel(dzsnso, top));
  sm.rsurf(rsurf);
  sm.latheav(latheav);
  sm.latheag(latheag);
  sm.parsun(rad.parsun);
  sm.parsha(rad.parsha);
  sm.igs(igs);
  sm.btran(btran);
  sm.rhsur(rhsur);
  sm.htop(htop);
  sm.elai(elai);
  sm.esai(esai);
  sm.df(th.df);
  sm.hcpct(th.hcpct);
  sm.btrani(btrani);

  q.ns.albold(rad.albold);
  q.ns.tauss(rad.tauss);
  const FluxOut& fx = q.fx;
  fx.fsa(rad.fsa);
  fx.fsr(rad.fsr);
  fx.sav(rad.sav);
  fx.sag(rad.sag);
  fx.fsno(fsno);
  fx.fveg(fveg);
  fx.bgap(rad.bgap);
  fx.wgap(rad.wgap);
  fx.apar(rad.parsun * rad.laisun + rad.parsha * rad.laisha);
  fx.albedo((swdown != 0.0f) ? rad.fsr / mx(swdown, MPE) : -999.9f);
  fx.errsw(swdown - (rad.fsa + rad.fsr));
}

// The vegetated tile's balance.  Its unmasked diagnostics are final;
// what the aggregation may mask goes through the seam.
NM_INL void energy_vege_tile(const Point& q) {
  const ColumnArgs& a = q.a;
  const Seam& sm = q.sm;
  const float sfcprs = q.fo.sfcprs();
  const float htop = sm.htop(), z0mg = sm.z0mg();

  VegeFluxOut vf;
  vege_flux(q.p, a.gen, a.opt, a.dt, q.fx.get_sav(), q.fx.get_sag(),
            q.fo.lwdn(), sm.ur(), q.fo.uu(), q.fo.vv(), q.fo.sfctmp(),
            sm.thair(), q.fo.q2(), sm.eair(), sm.rhoair(), q.st.snowh(),
            sm.elai() + sm.esai(), sm.gammav(), sm.gammag(), q.st.fwet(),
            sm.laisun(), sm.laisha(), q.p.cwpvt(),
            mx(htop, z0mg * 2.0f + MPE), sm.zlvl(), sm.zpd(),
            mx(sm.z0m(), MPE), mx(q.fx.get_fveg(), 0.01f), z0mg, sm.emv(),
            sm.emg(), q.st.canliq(), q.st.canice(), sm.stc_top(), sm.df_top(),
            sm.dz_top(), sm.rsurf(), sm.latheav(), sm.latheag(), sm.parsun(),
            sm.parsha(), sm.igs(), q.fo.foln(), q.fo.co2air(), q.fo.o2air(),
            sm.btran(), sfcprs, sm.rhsur(), sfcprs, q.st.eah(), q.st.tah(),
            q.st.tv(), q.st.tg(), q.st.cm(), q.st.ch(), vf);

  sm.v_tv(vf.tv);
  sm.v_tgv(vf.tgv);
  sm.v_tah(vf.tah);
  sm.v_eah(vf.eah);
  sm.v_cmv(vf.cmv);
  sm.v_chv(vf.chv);
  sm.v_psnsun(vf.psnsun);
  sm.v_psnsha(vf.psnsha);
  sm.v_rssun(vf.rssun);
  sm.v_rssha(vf.rssha);
  const FluxOut& fx = q.fx;
  fx.t2mv(vf.t2mv);
  fx.q2v(vf.q2v);
  fx.shg(vf.shg);
  fx.shc(vf.shc);
  fx.evg(vf.evg);
  fx.ghv(vf.ghv);
  fx.irg(vf.irg);
  fx.irc(vf.irc);
  fx.tr(vf.tr);
  fx.evc(vf.evc);
  fx.chleaf(vf.chleaf);
  fx.chuc(vf.chuc);
  fx.chv2(vf.ch2v);
}

// The bare tile's balance.
NM_INL void energy_bare_tile(const Point& q) {
  const ColumnArgs& a = q.a;
  const Seam& sm = q.sm;
  const float snowh = q.st.snowh();

  BareFluxOut bf;
  bare_flux(a.gen, a.cls, a.opt, q.sc.lutyp(), q.fx.get_sag(), q.fo.lwdn(),
            sm.ur(), q.fo.uu(), q.fo.vv(), q.fo.sfctmp(), sm.thair(),
            q.fo.q2(), sm.eair(), sm.rhoair(), snowh, sm.stc_top(),
            sm.df_top(), sm.dz_top(), sm.zlvl(), snowh, sm.z0mg(), sm.emg(),
            sm.rsurf(), sm.latheag(), sm.gammag(), sm.rhsur(), q.fo.sfcprs(),
            q.st.tg(), q.st.cm(), q.st.ch(), q.st.qsfc(), bf);

  sm.b_tgb(bf.tgb);
  sm.b_qsfc(bf.qsfc);
  sm.b_cmb(bf.cmb);
  sm.b_q2b(bf.q2b);
  const FluxOut& fx = q.fx;
  fx.t2mb(bf.t2mb);
  fx.shb(bf.shb);
  fx.evb(bf.evb);
  fx.ghb(bf.ghb);
  fx.irb(bf.irb);
  fx.chb(bf.chb);
  fx.chb2(bf.ehb2);
}

// Tile aggregation, snow/soil temperature diffusion, phase change.
NM_INL void energy_ground(const Point& q) {
  const ColumnArgs& a = q.a;
  const Seam& sm = q.sm;
  const FluxOut& fx = q.fx;
  const float dt = a.dt;
  const float lwdn = q.fo.lwdn();
  const int nsnow = q.st.nsnow();
  const float snowh = q.st.snowh();
  const float fveg = fx.get_fveg();
  const float emv = sm.emv(), emg = sm.emg();

  const float vf_irg = fx.get_irg(), vf_irc = fx.get_irc();
  const float vf_shg = fx.get_shg(), vf_shc = fx.get_shc();
  const float vf_evg = fx.get_evg(), vf_evc = fx.get_evc();
  const float vf_tr = fx.get_tr(), vf_ghv = fx.get_ghv();
  const float vf_tgv = sm.v_tgv();
  const float bf_irb = fx.get_irb(), bf_shb = fx.get_shb();
  const float bf_evb = fx.get_evb(), bf_ghb = fx.get_ghb();
  const float bf_chb = fx.get_chb();
  const float bf_tgb = sm.b_tgb();

  // tile aggregation
  const bool is_veg = (sm.elai() + sm.esai()) > 0.0f;
  const bool use_veg = is_veg && (fveg > 0.0f);
  const float fv1 = use_veg ? fveg : 0.0f;
#define NM_AGG(v, b_) (use_veg ? fv1 * (v) + (1.0f - fv1) * (b_) : (b_))
  const float fira =
      use_veg ? fv1 * vf_irg + (1.0f - fv1) * bf_irb + vf_irc : bf_irb;
  const float fsh =
      use_veg ? fv1 * vf_shg + (1.0f - fv1) * bf_shb + vf_shc : bf_shb;
  const float fgev = NM_AGG(vf_evg, bf_evb);
  const float ssoil = NM_AGG(vf_ghv, bf_ghb);
  const float fcev = use_veg ? vf_evc : 0.0f;
  const float fctr = use_veg ? vf_tr : 0.0f;
  float tg_new = NM_AGG(vf_tgv, bf_tgb);
  const float cm_new = NM_AGG(sm.v_cmv(), sm.b_cmb());
  const float ch_new = NM_AGG(sm.v_chv(), bf_chb);
  const float tv_new = use_veg ? sm.v_tv() : q.st.tv();
  const float eah_new = use_veg ? sm.v_eah() : q.st.eah();
  const float tah_new = use_veg ? sm.v_tah() : q.st.tah();
  const float rssun = use_veg ? sm.v_rssun() : 0.0f;
  const float rssha = use_veg ? sm.v_rssha() : 0.0f;
  const float tgv = use_veg ? vf_tgv : bf_tgb;
  const float chv = use_veg ? sm.v_chv() : bf_chb;
  const float psnsun = use_veg ? sm.v_psnsun() : 0.0f;
  const float psnsha = use_veg ? sm.v_psnsha() : 0.0f;

  const float fire = lwdn + fira;
  const float emissi =
      fv1 * (emg * (1.0f - emv) + emv + emv * (1.0f - emv) * (1.0f - emg)) +
      (1.0f - fv1) * emg;
  const float trad =
      powf((fire - (1.0f - emissi) * lwdn) / (emissi * SB), 0.25f);

  const float psn = psnsun * sm.laisun() + psnsha * sm.laisha();

  // snow/soil temperature diffusion
  float zsnso[NLEVELS], dzsnso[NLEVELS], stc[NLEVELS];
  float df[NLEVELS], hcpct[NLEVELS], fact[NLEVELS];
  q.st.zsnso(zsnso);
  q.st.stc(stc);
  layer_thickness(zsnso, nsnow, dzsnso);
  sm.get_df(df);
  sm.get_hcpct(hcpct);
#pragma unroll
  for (int k = 0; k < NLEVELS; ++k)
    fact[k] = dt / (hcpct[k] * mx(dzsnso[k], MPE));

  float stc_new[NLEVELS];
  tsnosoi(dt, nsnow, q.sc.tbot(), a.gen.zbot, zsnso, ssoil, df, hcpct, snowh,
          stc, a.opt.tbot, a.opt.stc, stc_new);

  float tgv_o = tgv, tgb_o = bf_tgb;
  if (a.opt.stc == 2) {
    const bool cap = (snowh > 0.05f) && (tg_new > TFRZ);
    if (cap) {
      tgv_o = TFRZ;
      tgb_o = TFRZ;
      tg_new = NM_AGG(tgv_o, tgb_o);
    }
  }
#undef NM_AGG

  float snice[MSNOW], snliq[MSNOW], smc[NSOIL], swc[NSOIL];
  q.st.snice(snice);
  q.st.snliq(snliq);
  q.st.smc(smc);
  q.st.swc(swc);
  PhaseChangeOut pc;
  phasechange(q.p, q.sc.ist(), dt, nsnow, fact, dzsnso, stc_new, snice, snliq,
              q.st.sneqv(), snowh, smc, swc, a.opt.frz, pc);

  // ground evaporation and dew, for the water stage
  const float latheag = sm.latheag();
  const float qvap = mx(fgev / latheag, 0.0f);
  const float qdew = fabsf(mn(fgev / latheag, 0.0f));
  int imelt_snow[MSNOW];
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) imelt_snow[k] = pc.imelt[k];

  sm.v_tv(tv_new);
  sm.qvap(qvap);
  sm.qdew(qdew);
  sm.g_snowh(pc.snowh);
  sm.g_snice(pc.snice);
  sm.g_snliq(pc.snliq);
  sm.g_stc(pc.stc);
  sm.g_swc(pc.swc);
  sm.g_smc(pc.smc);
  sm.g_imelt(imelt_snow);

  const StateOut& ns = q.ns;
  ns.eah(eah_new);
  ns.tah(tah_new);
  ns.tg(tg_new);
  ns.cm(cm_new);
  ns.ch(ch_new);
  ns.sneqvo(pc.sneqv);
  fx.fira(fira);
  fx.fsh(fsh);
  fx.fcev(fcev);
  fx.fgev(fgev);
  fx.fctr(fctr);
  fx.ssoil(ssoil);
  fx.trad(trad);
  fx.edir(qvap - qdew);
  fx.psn(psn);
  fx.ponding(pc.ponding);
  fx.rssun(rssun);
  fx.rssha(rssha);
  fx.tgv(tgv_o);
  fx.tgb(tgb_o);
  fx.chv(chv);
  fx.emissi(emissi);
  fx.erreng(fx.get_sav() + fx.get_sag() -
            (fira + fsh + fcev + fgev + fctr + ssoil));
}

}  // namespace nm
