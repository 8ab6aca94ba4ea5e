// Soil moisture: Richards solve with adaptive sub-stepping, the four
// runoff schemes, equilibrium water table, Schaake infiltration and the
// SIMGM aquifer; counterpart of physics/soilwater.py.  The 4-row system
// goes through thomas_solve<4> (tridiag.cuh).
#pragma once

#include "column_io.cuh"
#include "common.cuh"
#include "tridiag.cuh"

namespace nm {

// Diffusivity/conductivity scaled by the unfrozen fraction
NM_INL void wdfcnd1(const ParamRef& p, float smc, float fcr, float& wdf,
                    float& wcnd) {
  const float factr = mx(smc / p.smcmax(), 0.01f);
  wdf = p.dwsat() * powf(factr, p.bexp() + 2.0f);
  wdf = wdf * (1.0f - fcr);
  wcnd = p.dksat() * powf(factr, 2.0f * p.bexp() + 3.0f);
  wcnd = wcnd * (1.0f - fcr);
}

// Diffusivity with the ice-weighted blend
NM_INL void wdfcnd2(const ParamRef& p, float smc, float sice, float& wdf,
                    float& wcnd) {
  const float expon = p.bexp() + 2.0f;
  const float factr = mx(smc / p.smcmax(), 0.01f);
  wdf = p.dwsat() * powf(factr, expon);
  const float vkwgt = rdiv(1.0f, 1.0f + cube(500.0f * sice));
  const float wdf_ice =
      vkwgt * wdf + (1.0f - vkwgt) * p.dwsat() * powf(rdiv(0.2f, p.smcmax()), expon);
  if (sice > 0.0f) wdf = wdf_ice;
  wcnd = p.dksat() * powf(factr, 2.0f * p.bexp() + 3.0f);
}

// Equilibrium water-table depth on a 100-layer fine grid
NM_INL float zwteq(const ParamRef& p, const float (&zsoil)[NSOIL],
                  const float (&dzsoil)[NSOIL], const float (&swc)[NSOIL]) {
  constexpr int nfine = 100;
  const float smcmax = p.smcmax();
  const float zbot = zsoil[NSOIL - 1];
  float w[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) w[k] = (smcmax - swc[k]) * dzsoil[k];
  const float wd1 = sum_last(w);
  const float dzfine = divc(3.0f * (-zbot), 100.0f);
  const float zwt0 = -3.0f * zbot - 0.001f;
  float wd2 = 0.0f;
  int first = nfine;
  for (int k = 0; k < nfine; ++k) {
    const float zfine = static_cast<float>(k + 1) * dzfine;
    const float temp = 1.0f + (zwt0 - zfine) / p.psisat();
    const float incr =
        smcmax * (1.0f - powf(mx(temp, MPE), rdiv(-1.0f, p.bexp()))) * dzfine;
    wd2 = (k == 0) ? incr : wd2 + incr;
    if (first == nfine && fabsf(wd2 - wd1) <= 0.01f) first = k;
  }
  const float zhit = static_cast<float>(first + 1) * dzfine;
  return (first < nfine) ? zhit : zwt0;
}

// Schaake96 maximum infiltration; qinfil and runsrf in m/s
NM_INL void infil(const ParamRef& p, float dt, const float (&zsoil)[NSOIL],
                 const float (&swc)[NSOIL], const float (&sice)[NSOIL],
                 float sicemax, float qinsrf, float& qinfil, float& runsrf) {
  const float dt1 = divc(dt, 86400.0f);
  const float smcav = p.smcmax() - p.smcwlt();
  float di[NSOIL], dm[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    const float dz = ((k == 0) ? 0.0f : zsoil[k - 1]) - zsoil[k];
    di[k] = dz * sice[k];
    dm[k] = dz * smcav * (1.0f - (swc[k] + sice[k] - p.smcwlt()) / smcav);
  }
  const float dice = sum_last(di);
  const float dd = sum_last(dm);
  const float val = 1.0f - expf(-p.kdt() * dt1);
  const float ddt = dd * val;
  const float px = mx(qinsrf * dt, 0.0f);
  float infmax = (px * (ddt / mx(px + ddt, MPE))) / dt;

  // frozen-soil correction: truncated series for CVFRZ = 3
  const float acrt = 3.0f * p.frzx() / mx(dice, MPE);
  const float series = 1.0f + acrt + divc(acrt * acrt, 2.0f);
  const float fcr = (dice > 1.0e-2f) ? 1.0f - expf(-acrt) * series : 1.0f;
  infmax = infmax * fcr;

  float wdf, wcnd;
  wdfcnd2(p, swc[0], sicemax, wdf, wcnd);
  infmax = mx(infmax, wcnd);
  infmax = mn(infmax, px);
  const float rs = mx(qinsrf - infmax, 0.0f);
  const float qi = qinsrf - rs;
  const bool rain = qinsrf > 0.0f;
  qinfil = rain ? qi : 0.0f;
  runsrf = rain ? rs : 0.0f;
}

// One Richards sub-step: assemble the tridiagonal (srt), scale by the
// sub-step, solve, and push the saturation excess up (sstep)
NM_INL void richards_substep(const ParamRef& p, const float (&zsoil)[NSOIL],
                            const float (&dzsoil)[NSOIL], float qinfil,
                            const float (&etrani)[NSOIL], float qseva,
                            const float (&sice)[NSOIL],
                            const float (&fcr)[NSOIL], float sicemax,
                            float fcrmax, float dtfine, int opt_run,
                            int opt_inf, float (&swc)[NSOIL],
                            float (&smc)[NSOIL], float (&wcnd)[NSOIL],
                            float& qdrain, float& wplus) {
  float wdf[NSOIL], smx[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    if (opt_inf == 1) {
      wdfcnd1(p, smc[k], fcr[k], wdf[k], wcnd[k]);
      smx[k] = smc[k];
    } else {
      wdfcnd2(p, swc[k], sicemax, wdf[k], wcnd[k]);
      smx[k] = swc[k];
    }
  }
  float denom[NSOIL], ddz[NSOIL], dsmdz[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    const float z_prev = (k == 0) ? 0.0f : zsoil[k - 1];
    const float z_next = (k == NSOIL - 1) ? 0.0f : zsoil[k + 1];
    const float smx_next = (k == NSOIL - 1) ? 0.0f : smx[k + 1];
    denom[k] = z_prev - zsoil[k];
    const float temp1 = (k == NSOIL - 1) ? z_prev - zsoil[k] : z_prev - z_next;
    ddz[k] = rdiv(2.0f, temp1);
    dsmdz[k] = 2.0f * (smx[k] - smx_next) / temp1;
  }
  if (opt_run == 1 || opt_run == 2) {
    qdrain = 0.0f;
  } else if (opt_run == 3) {
    qdrain = p.slope() * wcnd[NSOIL - 1];
  } else {
    qdrain = (1.0f - fcrmax) * wcnd[NSOIL - 1];
  }

  float a[NSOIL], b[NSOIL], c[NSOIL], d[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    const bool is_top = k == 0;
    const bool is_bot = k == NSOIL - 1;
    const float wdf_prev = is_top ? 0.0f : wdf[k - 1];
    const float wcnd_prev = is_top ? 0.0f : wcnd[k - 1];
    const float dsmdz_prev = is_top ? 0.0f : dsmdz[k - 1];
    const float ddz_prev = is_top ? 0.0f : ddz[k - 1];
    const float up_flux =
        is_top ? qinfil - qseva : wdf_prev * dsmdz_prev + wcnd_prev;
    const float wflux = is_bot ? -up_flux + etrani[k] + qdrain
                               : wdf[k] * dsmdz[k] + wcnd[k] - up_flux + etrani[k];
    const float ak = is_top ? 0.0f : -wdf_prev * ddz_prev / denom[k];
    const float ck = is_bot ? 0.0f : -wdf[k] * ddz[k] / denom[k];
    // the top-row diagonal is written directly
    const float bk = is_top ? wdf[k] * ddz[k] / denom[k] : -(ak + ck);
    const float rhs = wflux / (-denom[k]);
    a[k] = ak * dtfine;
    b[k] = 1.0f + bk * dtfine;
    c[k] = ck * dtfine;
    d[k] = rhs * dtfine;
  }
  float delta[NSOIL];
  thomas_solve<NSOIL>(a, b, c, d, delta);

  float ep[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    swc[k] = swc[k] + delta[k];
    ep[k] = mx(p.smcmax() - sice[k], 1.0e-4f);
  }
  // push the saturation excess upward, bottom to top
#pragma unroll
  for (int k = NSOIL - 1; k > 0; --k) {
    const float wplus_k = mx(swc[k] - ep[k], 0.0f) * dzsoil[k];
    swc[k] = mn(ep[k], swc[k]);
    swc[k - 1] = swc[k - 1] + wplus_k / dzsoil[k - 1];
  }
  wplus = mx(swc[0] - ep[0], 0.0f) * dzsoil[0];
  swc[0] = mn(ep[0], swc[0]);
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) smc[k] = swc[k] + sice[k];
}

// WATMIN bucket fix-up over the per-layer liquid [mm]; returns the
// deficit of the bottom layer
NM_INL float watmin_fixup(float (&ml)[NSOIL]) {
  const float watmin = 0.01f;
#pragma unroll
  for (int k = 0; k < NSOIL - 1; ++k) {
    const float xs = (ml[k] < 0.0f) ? watmin - ml[k] : 0.0f;
    ml[k] = ml[k] + xs;
    ml[k + 1] = ml[k + 1] - xs;
  }
  const float xs = (ml[NSOIL - 1] < watmin) ? watmin - ml[NSOIL - 1] : 0.0f;
  ml[NSOIL - 1] = ml[NSOIL - 1] + xs;
  return xs;
}

struct SoilH2OOut {
  float swc[NSOIL], smc[NSOIL];
  float zwt, runsrf, runsub, qdrain;
  float wcnd[NSOIL];
  float fcrmax;
};

NM_INL void soilh2o(const ParamRef& p, const GenScalars& gen,
                   const ClassScalars& cls, int lutyp, float dt,
                   const float (&zsoil)[NSOIL], const float (&dzsoil)[NSOIL],
                   float qinsrf, float qseva, const float (&etrani)[NSOIL],
                   const float (&sice)[NSOIL], const float (&swc_in)[NSOIL],
                   const float (&smc_in)[NSOIL], float zwt, int opt_run,
                   int opt_inf, SoilH2OOut& o) {
  const float smcmax = p.smcmax();
  const float a_pow = 4.0f;
  float swc[NSOIL], smc[NSOIL], fcr[NSOIL], rs[NSOIL];

  // clamp super-saturated layers
  float sicemax = 0.0f, fcrmax = 0.0f;
  const float e4 = expf(-a_pow);
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    const float epore = mx(smcmax - sice[k], 1.0e-4f);
    rs[k] = mx(swc_in[k] - epore, 0.0f) * dzsoil[k];
    swc[k] = mn(epore, swc_in[k]);
    smc[k] = smc_in[k];
    const float fice = mn(sice[k] / smcmax, 1.0f);
    fcr[k] = mx(expf(-a_pow * (1.0f - fice)) - e4, 0.0f) / (1.0f - e4);
    sicemax = (k == 0) ? sice[k] : mx(sicemax, sice[k]);
    fcrmax = (k == 0) ? fcr[k] : mx(fcrmax, fcr[k]);
  }
  float rsat = sum_last(rs);

  float runsub = 0.0f;
  if (opt_run == 2) {
    zwt = zwteq(p, zsoil, dzsoil, swc);
    runsub = (1.0f - fcrmax) * 4.0f * expf(-gen.timean) * expf(-2.0f * zwt);
  }

  // urban surfaces are nearly impermeable
  const float fcr0 = (lutyp == cls.isurban) ? 0.95f : fcr[0];

  const bool rain = qinsrf > 0.0f;
  float qinfil, runsrf;
  if (opt_run == 3) {
    infil(p, dt, zsoil, swc, sice, sicemax, qinsrf, qinfil, runsrf);
  } else {
    float fsat;
    if (opt_run == 1) {
      fsat = gen.fsatmax * expf(-3.0f * (zwt - 2.0f));
    } else if (opt_run == 2) {
      fsat = gen.fsatmax * expf(-1.0f * zwt);
    } else {
      // BATS: top-2m wetness to the fourth power
      float cum = 0.0f, dzw[NSOIL], smw[NSOIL];
#pragma unroll
      for (int k = 0; k < NSOIL; ++k) {
        cum = (k == 0) ? dzsoil[k] : cum + dzsoil[k];
        const bool within = (cum <= F32(2.0 + 1.0e-6)) || (k == 0);
        dzw[k] = within ? dzsoil[k] : 0.0f;
        smw[k] = within ? smc[k] * dzsoil[k] : 0.0f;
      }
      const float smctot = sum_last(smw) / sum_last(dzw);
      fsat = powf(mx(smctot / smcmax, 0.01f), 4.0f);
    }
    runsrf = rain ? qinsrf * ((1.0f - fcr0) * fsat + fcr0) : 0.0f;
    qinfil = rain ? qinsrf - runsrf : 0.0f;
  }

  // sub-stepping: 3 or 6 trips with opt_inf 1, else one
  int niter = 1;
  if (opt_inf == 1) niter = (qinfil * dt > dzsoil[0] * smcmax) ? 6 : 3;
  const float dtfine = dt / static_cast<float>(niter);

  float qdrain_save = 0.0f;
  float wcnd[NSOIL] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = 0; it < niter; ++it) {
    float qdrain, wplus;
    richards_substep(p, zsoil, dzsoil, qinfil, etrani, qseva, sice, fcr,
                     sicemax, fcrmax, dtfine, opt_run, opt_inf, swc, smc, wcnd,
                     qdrain, wplus);
    rsat = rsat + wplus;
    qdrain_save = qdrain_save + qdrain;
  }

  float qdrain = qdrain_save / static_cast<float>(niter);
  runsrf = runsrf * 1000.0f + rsat * 1000.0f / dt;
  qdrain = qdrain * 1000.0f;

  if (opt_run == 2) {
    // remove the baseflow in proportion to transmissivity
    float tr[NSOIL];
#pragma unroll
    for (int k = 0; k < NSOIL; ++k) tr[k] = wcnd[k] * dzsoil[k];
    const float wtsub = sum_last(tr);
#pragma unroll
    for (int k = 0; k < NSOIL; ++k) {
      const float mh2o = (runsub * dt) * tr[k] / mx(wtsub, MPE);
      swc[k] = swc[k] - mh2o / (dzsoil[k] * 1000.0f);
    }
  }

  if (opt_run != 1) {
    float ml[NSOIL];
#pragma unroll
    for (int k = 0; k < NSOIL; ++k) ml[k] = swc[k] * dzsoil[k] * 1000.0f;
    const float xs = watmin_fixup(ml);
    runsub = runsub - xs / dt;
#pragma unroll
    for (int k = 0; k < NSOIL; ++k) swc[k] = ml[k] / (dzsoil[k] * 1000.0f);
  }

#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    o.swc[k] = swc[k];
    o.smc[k] = smc[k];
    o.wcnd[k] = wcnd[k];
  }
  o.zwt = zwt;
  o.runsrf = runsrf;
  o.runsub = runsub;
  o.qdrain = qdrain;
  o.fcrmax = fcrmax;
}

// -PSISAT*1000*S_NODE**(-BEXP) in double, rounded once to float: the
// one float64 spot of the step.  S_NODE is the float32 saturation ratio
// widened, except at the lower clamp where it is the exact double 0.01.
NM_INL float smpfz_f64(float s_node, float bexp, float psisat, bool at_clip) {
  const double s64 = at_clip ? 0.01 : static_cast<double>(s_node);
  const double v = static_cast<double>(psisat) * 1000.0 *
                   pow(s64, -static_cast<double>(bexp));
  return -static_cast<float>(v);
}

struct GroundwaterOut {
  float swc[NSOIL];
  float zwt, wa, wt, qin, qdis;
};

// SIMGM unconfined aquifer (opt_run 1)
NM_INL void groundwater(const ParamRef& p, const GenScalars& gen, float dt,
                       const float (&zsoil)[NSOIL], const float (&sice)[NSOIL],
                       const float (&wcnd)[NSOIL], float fcrmax,
                       const float (&swc)[NSOIL], float zwt, float wa, float wt,
                       GroundwaterOut& o) {
  const float rous = 0.2f, cmic = 0.20f;
  const float smcmax = p.smcmax();
  float dzmm[NSOIL], znode[NSOIL], smc[NSOIL], mliq[NSOIL], epore[NSOIL],
      hk[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    const float z_prev = (k == 0) ? 0.0f : zsoil[k - 1];
    dzmm[k] = (z_prev - zsoil[k]) * 1.0e3f;
    znode[k] = -z_prev + 0.5f * (z_prev - zsoil[k]);
    smc[k] = swc[k] + sice[k];
    mliq[k] = swc[k] * dzmm[k];
    epore[k] = mx(smcmax - sice[k], 0.01f);
    hk[k] = 1.0e3f * wcnd[k];
  }

  // first layer whose bottom lies at or below the water table
  int jwt = NSOIL - 1;
  for (int k = NSOIL - 1; k >= 1; --k)
    if (zwt <= -zsoil[k]) jwt = k - 1;

  const float qdis = (1.0f - fcrmax) * 5.0f * expf(-gen.timean) *
                     expf(-6.0f * (zwt - 2.0f));

  const float ratio = vsel(smc, jwt) / smcmax;
  const float s_node = mx(mn(ratio, 1.0f), 0.01f);
  const bool at_clip = ratio <= 0.01f;
  float smpfz = smpfz_f64(s_node, p.bexp(), p.psisat(), at_clip);
  smpfz = mx(cmic * smpfz, -120000.0f);

  const float ka = vsel(hk, jwt);
  const float znode_jwt = vsel(znode, jwt);
  const float wh_zwt = -zwt * 1.0e3f;
  const float wh = smpfz - znode_jwt * 1.0e3f;
  float qin = -ka * (wh_zwt - wh) / mx((zwt - znode_jwt) * 1.0e3f, MPE);
  qin = clipf(qin, rdiv(-10.0f, dt), rdiv(10.0f, dt));

  wt = wt + (qin - qdis) * dt;

  const float zbot = zsoil[NSOIL - 1];
  const bool deep = jwt == NSOIL - 1;
  float zwt_new;
  if (deep) {
    // water table below the soil column
    float wa_d = wa + (qin - qdis) * dt;
    wt = wa_d;
    zwt_new = (-zbot + 25.0f) - divc(divc(wa_d, 1000.0f), rous);
    mliq[NSOIL - 1] = mliq[NSOIL - 1] - qin * dt + mx(wa_d - 5000.0f, 0.0f);
    wa = mn(wa_d, 5000.0f);
  } else {
    // water table within the column
    const float wtx = wt - F32(0.2 * 1000.0 * 25.0);
    if (jwt == NSOIL - 2) {
      zwt_new = -zbot - divc(wtx / epore[NSOIL - 1], 1000.0f);
    } else {
      float e[NSOIL];
#pragma unroll
      for (int k = 0; k < NSOIL; ++k) e[k] = (k >= jwt + 2) ? epore[k] * dzmm[k] : 0.0f;
      const float ws = sum_last(e);
      const int j1 = imin(jwt + 1, NSOIL - 1);
      zwt_new = -vsel(zsoil, j1) - divc((wtx - ws) / vsel(epore, j1), 1000.0f);
    }
    float tr[NSOIL];
#pragma unroll
    for (int k = 0; k < NSOIL; ++k) tr[k] = hk[k] * dzmm[k];
    const float wtsub = sum_last(tr);
#pragma unroll
    for (int k = 0; k < NSOIL; ++k)
      mliq[k] = mliq[k] - (qdis * dt) * hk[k] * dzmm[k] / mx(wtsub, MPE);
  }
  zwt_new = mx(zwt_new, 1.5f);

  const float xs = watmin_fixup(mliq);
  wa = wa - xs;
  wt = wt - xs;
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) o.swc[k] = mliq[k] / dzmm[k];
  o.zwt = zwt_new;
  o.wa = wa;
  o.wt = wt;
  o.qin = qin;
  o.qdis = qdis;
}

}  // namespace nm
