// Snow/soil temperature diffusion and phase change; counterpart of
// physics/soiltemp.py.  The 7-row heat system goes through
// thomas_solve<7> (tridiag.cuh) with identity rows for the inactive
// snow slots, as the plain version passes them.
#pragma once

#include "column_args.cuh"
#include "common.cuh"
#include "tridiag.cuh"

namespace nm {

constexpr int FRH2O_TRIPS = 10;

NM_FN void tsnosoi(float dt, int nsnow, float tbot, float zbot,
                   const float (&zs)[NLEVELS], float ssoil,
                   const float (&df)[NLEVELS], const float (&hcpct)[NLEVELS],
                   float snowh, const float (&stc)[NLEVELS], int opt_tbot,
                   int opt_stc, float (&stc_new)[NLEVELS]) {
  constexpr int nl = NLEVELS;
  const int top = MSNOW - nsnow;
  const float zbotsno = zbot - snowh;

  float denom_safe[nl], ddz[nl], dtsdz[nl];
#pragma unroll
  for (int k = 0; k < nl; ++k) {
    const bool active = k >= top;
    const float zs_prev = (k == 0) ? 0.0f : zs[k - 1];
    const float zs_next = (k == nl - 1) ? 0.0f : zs[k + 1];
    const float stc_next = (k == nl - 1) ? 0.0f : stc[k + 1];
    const float denom = (zs_prev - zs[k]) * hcpct[k];
    denom_safe[k] = active ? denom : -1.0f;
    float temp1 = (k == nl - 1) ? zs_prev - zs[k] : zs_prev - zs_next;
    temp1 = active ? temp1 : -1.0f;
    ddz[k] = rdiv(2.0f, temp1);
    dtsdz[k] = 2.0f * (stc[k] - stc_next) / temp1;
  }
  float botflx;
  if (opt_tbot == 1) {
    botflx = 0.0f;
  } else {
    const float dtsdz_bot =
        (stc[nl - 1] - tbot) / (0.5f * (zs[nl - 2] + zs[nl - 1]) - zbotsno);
    dtsdz[nl - 1] = dtsdz_bot;
    botflx = -df[nl - 1] * dtsdz_bot;
  }

  float a[nl], b[nl], c[nl], d[nl];
#pragma unroll
  for (int k = 0; k < nl; ++k) {
    const bool active = k >= top;
    const bool is_top = k == top;
    const bool is_bot = k == nl - 1;
    const float df_prev = (k == 0) ? 0.0f : df[k - 1];
    const float dtsdz_prev = (k == 0) ? 0.0f : dtsdz[k - 1];
    const float ddz_prev = (k == 0) ? 0.0f : ddz[k - 1];
    const float prev_flux = is_top ? ssoil : df_prev * dtsdz_prev;
    const float eflux =
        is_bot ? -botflx - prev_flux : df[k] * dtsdz[k] - prev_flux;
    const float ai = is_top ? 0.0f : -df_prev * ddz_prev / denom_safe[k];
    const float ci = is_bot ? 0.0f : -df[k] * ddz[k] / denom_safe[k];
    float bi = -(ai + ci);
    if (opt_stc == 2 && is_top) bi = bi + df[k] / (0.5f * zs[k] * zs[k] * hcpct[k]);
    const float rhsts = eflux / (-denom_safe[k]);
    a[k] = active ? ai * dt : 0.0f;
    b[k] = active ? 1.0f + bi * dt : 1.0f;
    c[k] = active ? ci * dt : 0.0f;
    d[k] = active ? rhsts * dt : 0.0f;
  }
  float delta[nl];
  thomas_solve<nl>(a, b, c, d, delta);
#pragma unroll
  for (int k = 0; k < nl; ++k)
    stc_new[k] = stc[k] + ((k >= top) ? delta[k] : 0.0f);
}

// Supercooled liquid water of one soil layer: Koren99 Newton iteration
// in log space with the Flerchinger fallback.  The loop ends at the
// first converged trip; the masked plain version keeps swl from there.
NM_FN float frh2o(const ParamPt& p, float tkelv, float smc, float swc) {
  const float ck = 8.0f, blim = 5.5f, err = 0.005f;
  const float bx = mn(p.bexp, blim);
  const float psisat = p.psisat;
  const float smcmax = p.smcmax;

  const float swl0 = clipf(smc - swc, 0.0f, smc - 0.02f);
  const float tk_safe = mn(tkelv, F32(273.15 - 1.0e-3));
  const float smc_safe = mx(smc, 0.021f);
  float swl = clipf(swl0, 0.0f, smc_safe - 0.02f);

  bool kcount = false;
  for (int it = 0; it < FRH2O_TRIPS; ++it) {
    const float dfn =
        logf(divc(psisat * GRAV, HFUS) * sq(1.0f + ck * swl) *
             powf(smcmax / (smc_safe - swl), bx)) -
        logf(-(tk_safe - TFRZ) / tk_safe);
    const float denom = rdiv(2.0f * 8.0f, 1.0f + ck * swl) + bx / (smc_safe - swl);
    const float swlk = clipf(swl - dfn / denom, 0.0f, smc_safe - 0.02f);
    const float dswl = fabsf(swlk - swl);
    swl = swlk;
    if (dswl <= err) {
      kcount = true;
      break;
    }
  }
  const float free_iter = smc - swl;

  float fk = powf(rdiv(HFUS, GRAV * (-psisat)) * ((tk_safe - TFRZ) / tk_safe),
                  rdiv(-1.0f, bx)) *
             smcmax;
  fk = mx(fk, 0.02f);
  const float free_flerch = mn(fk, smc);
  const float free_w = kcount ? free_iter : free_flerch;
  return (tkelv > F32(273.15 - 1.0e-3)) ? smc : free_w;
}

struct PhaseChangeOut {
  float stc[NLEVELS];
  float snice[MSNOW], snliq[MSNOW];
  float sneqv, snowh;
  float smc[NSOIL], swc[NSOIL];
  float qmelt;
  int imelt[NLEVELS];
  float ponding;
};

NM_FN void phasechange(const ParamPt& p, int ist, float dt, int nsnow,
                       const float (&fact)[NLEVELS],
                       const float (&dz)[NLEVELS],
                       const float (&stc_in)[NLEVELS],
                       const float (&snice)[MSNOW], const float (&snliq)[MSNOW],
                       float sneqv, float snowh, const float (&smc)[NSOIL],
                       const float (&swc)[NSOIL], int opt_frz,
                       PhaseChangeOut& o) {
  constexpr int nl = NLEVELS;
  const int top = MSNOW - nsnow;
  float stc[nl], mice[nl], mliq[nl], supercool[nl];
  bool active[nl];
#pragma unroll
  for (int k = 0; k < nl; ++k) {
    stc[k] = stc_in[k];
    const bool soil_slot = k >= MSNOW;
    active[k] = soil_slot || (k >= top);
    float mi, ml;
    if (soil_slot) {
      const int s = k - MSNOW;
      mi = (smc[s] - swc[s]) * dz[k] * 1000.0f;
      ml = swc[s] * dz[k] * 1000.0f;
    } else {
      mi = snice[k];
      ml = snliq[k];
    }
    mice[k] = active[k] ? mi : 0.0f;
    mliq[k] = active[k] ? ml : 0.0f;
    supercool[k] = 0.0f;
  }

  // supercooled liquid water of the soil slots
#pragma unroll
  for (int s = 0; s < NSOIL; ++s) {
    const int k = MSNOW + s;
    float sc;
    if (opt_frz == 1) {
      const float smp = HFUS * (TFRZ - stc[k]) / (GRAV * stc[k]);
      sc = p.smcmax * powf(mx(smp, MPE) / p.psisat, rdiv(-1.0f, p.bexp));
      sc = (stc[k] < TFRZ) ? sc : 0.0f;
    } else {
      sc = frh2o(p, stc[k], smc[s], swc[s]);
    }
    supercool[k] = (ist == 1) ? sc * dz[k] * 1000.0f : 0.0f;
  }

  const bool bulk_snow = (nsnow == 0) && (sneqv > 0.0f);
  int imelt[nl];
  float hm[nl], xm[nl], wice0[nl], wmass0[nl];
#pragma unroll
  for (int k = 0; k < nl; ++k) {
    wice0[k] = mice[k];
    wmass0[k] = mice[k] + mliq[k];
    int im = (active[k] && mice[k] > 0.0f && stc[k] >= TFRZ) ? 1 : 0;
    if (active[k] && mliq[k] > supercool[k] && stc[k] < TFRZ) im = 2;
    // thin snow without a layer melts through the first soil slot
    if (bulk_snow && k == MSNOW && stc[k] >= TFRZ) im = 1;

    // energy surplus or deficit
    float h = (im > 0) ? (stc[k] - TFRZ) / fact[k] : 0.0f;
    if (im > 0) stc[k] = TFRZ;
    const bool bad = (im == 1 && h < 0.0f) || (im == 2 && h > 0.0f);
    if (bad) {
      h = 0.0f;
      im = 0;
    }
    imelt[k] = im;
    hm[k] = h;
    xm[k] = divc(h * dt, HFUS);
  }

  // bulk (no-layer) snowmelt acting on the first soil slot
  float qmelt = 0.0f, ponding = 0.0f;
  {
    const float xm1 = xm[MSNOW];
    const float hm1 = hm[MSNOW];
    const bool do_bulk = bulk_snow && (xm1 > 0.0f);
    if (do_bulk) {
      const float temp1 = sneqv;
      const float sneqv_new = mx(temp1 - xm1, 0.0f);
      const float propor = sneqv_new / mx(temp1, MPE);
      const float snowh_new = mx(propor * snowh, 0.0f);
      const float heatr = hm1 - HFUS * (temp1 - sneqv_new) / dt;
      xm[MSNOW] = (heatr > 0.0f) ? divc(heatr * dt, HFUS) : 0.0f;
      hm[MSNOW] = (heatr > 0.0f) ? heatr : 0.0f;
      qmelt = mx(temp1 - sneqv_new, 0.0f) / dt;
      ponding = temp1 - sneqv_new;
      sneqv = sneqv_new;
      snowh = snowh_new;
    }
  }

  // melt/freeze mass exchange
  float qm[MSNOW];
#pragma unroll
  for (int k = 0; k < nl; ++k) {
    const bool soil_slot = k >= MSNOW;
    const bool go = (imelt[k] > 0) && (fabsf(hm[k]) > 0.0f);
    float mice_new = mice[k];
    if (xm[k] > 0.0f) {
      mice_new = mx(wice0[k] - xm[k], 0.0f);
    } else if (xm[k] < 0.0f) {
      if (soil_slot) {
        mice_new = (wmass0[k] < supercool[k])
                       ? 0.0f
                       : mx(mn(wmass0[k] - supercool[k], wice0[k] - xm[k]), 0.0f);
      } else {
        mice_new = mn(wmass0[k], wice0[k] - xm[k]);
      }
    }
    const float heatr_l =
        (xm[k] != 0.0f) ? hm[k] - HFUS * (wice0[k] - mice_new) / dt : 0.0f;
    const float mliq_new = mx(wmass0[k] - mice_new, 0.0f);
    float stc_adj = stc[k] + fact[k] * heatr_l;
    if (!soil_slot && (mliq_new * mice_new > 0.0f)) stc_adj = TFRZ;
    if (go && (fabsf(heatr_l) > 0.0f)) stc[k] = stc_adj;
    if (go) {
      mice[k] = mice_new;
      mliq[k] = mliq_new;
    }
    if (k < MSNOW) qm[k] = go ? mx(wice0[k] - mice[k], 0.0f) / dt : 0.0f;
  }
  qmelt = qmelt + sum_last(qm);

#pragma unroll
  for (int k = 0; k < nl; ++k) {
    o.stc[k] = stc[k];
    o.imelt[k] = imelt[k];
  }
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    o.snice[k] = mice[k];
    o.snliq[k] = mliq[k];
  }
#pragma unroll
  for (int s = 0; s < NSOIL; ++s) {
    const int k = MSNOW + s;
    o.swc[s] = mliq[k] / (1000.0f * dz[k]);
    o.smc[s] = (mliq[k] + mice[k]) / (1000.0f * dz[k]);
  }
  o.sneqv = sneqv;
  o.snowh = snowh;
  o.qmelt = qmelt;
  o.ponding = ponding;
}

}  // namespace nm
