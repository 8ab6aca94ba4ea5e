// Shortwave radiation: snow age/albedo, ground albedo, the modified
// two-stream canopy transfer and the flux assembly; counterpart of
// physics/radiation.py.  Band axis: 0 = vis, 1 = nir.
#pragma once

#include "column_io.cuh"
#include "common.cuh"

namespace nm {

struct RadiationOut {
  float fsun, laisun, laisha, parsun, parsha;
  float sav, sag, fsa, fsr, fsrv, fsrg;
  float bgap, wgap, albold, tauss;
};

struct TwoStreamOut {
  float fab[2], fre[2], ftd[2], fti[2], frev[2], freg[2];
  float gdir;
};

// Dickinson/Sellers two-stream with the Niu-Yang gap modification
NM_INL void twostream(const ParamRef& p, const GenScalars& gen, bool direct,
                     float cosz, float vai, float fwet, float t,
                     const float (&albgrd)[2], const float (&albgri)[2],
                     const float (&rho)[2], const float (&tau)[2], float gap,
                     float kopen, TwoStreamOut& o) {
  const float coszi = mx(cosz, 0.001f);
  float chil = clipf(p.xl(), -0.4f, 0.6f);
  chil = (fabsf(chil) <= 0.01f) ? 0.01f : chil;
  const float phi1 = 0.5f - 0.633f * chil - 0.330f * chil * chil;
  const float phi2 = 0.877f * (1.0f - 2.0f * phi1);
  const float gdir = phi1 + phi2 * coszi;
  const float ext = gdir / coszi;
  const float avmu = (1.0f - phi1 / phi2 * logf((phi1 + phi2) / phi1)) / phi2;
  const float tmp0p = gdir + phi2 * coszi;
  const float tmp1p = phi1 * coszi;
  const float asu_pt = 1.0f - tmp1p / tmp0p * logf((tmp1p + tmp0p) / tmp1p);
  const bool frozen = t <= TFRZ;
  const float omegas[2] = {gen.omegas_vis, gen.omegas_nir};
  o.gdir = gdir;

#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const float omegal = rho[b] + tau[b];
    const float asu = 0.5f * omegal * gdir / tmp0p * asu_pt;
    const float betadl = (1.0f + avmu * ext) / (omegal * avmu * ext) * asu;
    const float betail =
        0.5f * (rho[b] + tau[b] + (rho[b] - tau[b]) * sq(divc(1.0f + chil, 2.0f))) /
        omegal;

    // snow-intercepted-canopy adjustment
    float omega = omegal, betad = betadl, betai = betail;
    if (frozen) {
      const float om_frz = (1.0f - fwet) * omegal + fwet * omegas[b];
      betad = ((1.0f - fwet) * omegal * betadl + fwet * omegas[b] * gen.betads) /
              om_frz;
      betai = ((1.0f - fwet) * omegal * betail + fwet * omegas[b] * gen.betais) /
              om_frz;
      omega = om_frz;
    }

    const float bb = 1.0f - omega + omega * betai;
    const float c = omega * betai;
    const float tmp0 = avmu * ext;
    const float d = tmp0 * omega * betad;
    const float f = tmp0 * omega * (1.0f - betad);
    const float tmp1 = bb * bb - c * c;
    const float h = sqrtf(mx(tmp1, MPE)) / avmu;
    float sigma = tmp0 * tmp0 - tmp1;
    if (fabsf(sigma) < 1.0e-6f) sigma = (sigma >= 0.0f) ? 1.0e-6f : -1.0e-6f;
    const float p1 = bb + avmu * h;
    const float p2 = bb - avmu * h;
    const float p3 = bb + tmp0;
    const float p4 = bb - tmp0;
    const float s1 = expf(-mn(h * vai, 50.0f));
    const float s2 = expf(-mn(ext * vai, 50.0f));
    const float albg = direct ? albgrd[b] : albgri[b];
    const float u1 = bb - c / mx(albg, MPE);
    const float u2 = bb - c * albg;
    const float u3 = f + c * albg;
    const float tmp2 = u1 - avmu * h;
    const float tmp3 = u1 + avmu * h;
    const float d1 = p1 * tmp2 / s1 - p2 * tmp3 * s1;
    const float tmp4 = u2 + avmu * h;
    const float tmp5 = u2 - avmu * h;
    const float d2 = tmp4 / s1 - tmp5 * s1;
    const float h1 = -d * p4 - c * f;
    const float tmp6 = d - h1 * p3 / sigma;
    const float tmp7 = (d - c - h1 / sigma * (u1 + tmp0)) * s2;
    const float h2 = (tmp6 * tmp2 / s1 - p2 * tmp7) / d1;
    const float h3 = -(tmp6 * tmp3 * s1 - p1 * tmp7) / d1;
    const float h4 = -f * p3 - c * d;
    const float tmp8 = h4 / sigma;
    const float tmp9 = (u3 - tmp8 * (u2 - tmp0)) * s2;
    const float h5 = -(tmp8 * tmp4 / s1 + tmp9) / d2;
    const float h6 = (tmp8 * tmp5 * s1 + tmp9) / d2;
    const float h7 = (c * tmp2) / (d1 * s1);
    const float h8 = (-c * tmp3 * s1) / d1;
    const float h9 = tmp4 / (d2 * s1);
    const float h10 = (-tmp5 * s1) / d2;

    float ftd, fti, fre, freveg, frebar;
    if (direct) {
      ftd = s2 * (1.0f - gap) + gap;
      fti = (h4 * s2 / sigma + h5 * s1 + h6 / s1) * (1.0f - gap);
      freveg = (h1 / sigma + h2 + h3) * (1.0f - gap);
      frebar = albgrd[b] * gap;
      fre = freveg + frebar;
    } else {
      ftd = 0.0f;
      fti = (h9 * s1 + h10 / s1) * (1.0f - kopen) + kopen;
      fre = (h7 + h8) * (1.0f - kopen) + albgri[b] * kopen;
      freveg = fre;
      frebar = 0.0f;
    }
    o.fab[b] = 1.0f - fre - (1.0f - albgrd[b]) * ftd - (1.0f - albgri[b]) * fti;
    o.fre[b] = fre;
    o.ftd[b] = ftd;
    o.fti[b] = fti;
    o.frev[b] = freveg;
    o.freg[b] = frebar;
  }
}

NM_INL void radiation(const ParamRef& p, const GenScalars& gen, int ist, int isc,
                     float sneqvo, float sneqv, float dt, float cosz, float tg,
                     float tv, float fsno, float qsnow, float fwet, float elai,
                     float esai, float smc0, const float (&solad)[2],
                     const float (&solai)[2], float fveg, float albold,
                     float tauss, int opt_alb, int opt_rad, RadiationOut& o) {
  const float pai = 3.14159265f;
  const float vai = elai + esai;
  const float wl = elai / mx(vai, MPE);
  const float ws = esai / mx(vai, MPE);
  float rho[2], tau[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    rho[b] = mx(p.rhol(b) * wl + p.rhos(b) * ws, MPE);
    tau[b] = mx(p.taul(b) * wl + p.taus(b) * ws, MPE);
  }

  // BATS snow age
  const float dela0 = 1.0e-6f * dt;
  const float arg = 5.0e3f * (F32(1.0 / 273.15) - rdiv(1.0f, tg));
  const float age1 = expf(arg);
  const float age2 = expf(mn(10.0f * arg, 0.0f));
  const float tage = age1 + age2 + 0.3f;
  const float dela = dela0 * tage;
  const float dels = mx(sneqv - sneqvo, 0.0f) / gen.swemax;
  const float sge = (tauss + dela) * (1.0f - dels);
  const float tauss_new =
      (sneqv <= 0.0f || sneqv > 800.0f) ? 0.0f : mx(sge, 0.0f);
  const float fage = tauss_new / (tauss_new + 1.0f);

  // snow albedo, direct (d) and diffuse (i)
  float albsnd[2], albsni[2], albold_new;
  if (opt_alb == 1) {
    const float cf1 = rdiv(1.5f, 1.0f + 4.0f * cosz) - 0.5f;
    const float fzen = mx(cf1, 0.0f);
    albsni[0] = 0.95f * (1.0f - 0.2f * fage);
    albsni[1] = 0.65f * (1.0f - 0.5f * fage);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      albsnd[b] = albsni[b] + 0.4f * fzen * (1.0f - albsni[b]);
    albold_new = albold;
  } else {
    float alb = 0.55f + (albold - 0.55f) * expf(divc(-0.01f * dt, 3600.0f));
    if (qsnow > 0.0f)
      alb = alb + mn(qsnow * dt, gen.swemax) * (0.84f - alb) / gen.swemax;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      albsnd[b] = alb;
      albsni[b] = alb;
    }
    albold_new = alb;
  }

  // ground albedo: soil or lake, blended with snow
  const float alblake[2] = {gen.alblake_vis, gen.alblake_nir};
  const float inc = mx(0.11f - 0.40f * smc0, 0.0f);
  const float lake_d = 0.06f / (powf(mx(cosz, 0.01f), 1.7f) + 0.15f);
  float albgrd[2], albgri[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float albsod, albsoi;
    if (ist == 1) {
      albsod = mn(p.albsat(b) + inc, p.albdry(b));
      albsoi = albsod;
    } else if (tg > TFRZ) {
      albsod = lake_d;
      albsoi = 0.06f;
    } else {
      albsod = alblake[b];
      albsoi = alblake[b];
    }
    if (ist == 1 && isc == 9) {
      albsod = albsod + 0.10f;
      albsoi = albsoi + 0.10f;
    }
    albgrd[b] = albsod * (1.0f - fsno) + albsnd[b] * fsno;
    albgri[b] = albsoi * (1.0f - fsno) + albsni[b] * fsno;
  }

  // canopy gap probabilities
  float gap, kopen, bgap, wgap;
  if (opt_rad == 1) {
    const float rc = mx(p.rcrown(), MPE);
    const float denfveg = -logf(mx(1.0f - fveg, 0.01f)) / (pai * (rc * rc));
    const float hd = p.hvt() - p.hvb();
    const float bb = 0.5f * hd;
    const float c = clipf(mx(cosz, 0.01f), -1.0f, 1.0f);
    const float t = bb / rc * sqrtf(mx(1.0f - c * c, 0.0f)) / c;
    const float cos_thetap = rsqrtf(1.0f + t * t);
    bgap = expf(-denfveg * pai * (rc * rc) / cos_thetap);
    const float fa =
        vai / mx(F32(1.33 * 3.14159265) * cube(rc) * (bb / rc) * denfveg, MPE);
    const float newvai = hd * fa;
    wgap = (1.0f - bgap) * expf(-0.5f * newvai / mx(cosz, 0.001f));
    gap = mn(1.0f - fveg, bgap + wgap);
    kopen = 0.05f;
  } else if (opt_rad == 2) {
    bgap = 0.0f;
    wgap = 0.0f;
    gap = 0.0f;
    kopen = 0.0f;
  } else {
    bgap = 0.0f;
    wgap = 0.0f;
    gap = 1.0f - fveg;
    kopen = 1.0f - fveg;
  }
  if (vai == 0.0f) {
    gap = 1.0f;
    kopen = 1.0f;
    bgap = 0.0f;
    wgap = 0.0f;
  }

  TwoStreamOut td, ti;
  twostream(p, gen, true, cosz, vai, fwet, tv, albgrd, albgri, rho, tau, gap,
            kopen, td);
  twostream(p, gen, false, cosz, vai, fwet, tv, albgrd, albgri, rho, tau, gap,
            kopen, ti);

  // sunlit canopy fraction
  const float ext =
      td.gdir / mx(cosz, 0.001f) * sqrtf(mx(1.0f - rho[0] - tau[0], 0.0f));
  float fsun = (1.0f - expf(-mn(ext * vai, 50.0f))) / mx(ext * vai, MPE);
  fsun = (fsun < 0.01f) ? 0.0f : fsun;

  // night: everything computed for cosz > 0 is zero, and snow age and
  // albedo do not move
  const bool day = cosz > 0.0f;
  if (!day) {
    fsun = 0.0f;
    bgap = 0.0f;
    wgap = 0.0f;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      albgrd[b] = 0.0f;
      albgri[b] = 0.0f;
      td.fab[b] = td.fre[b] = td.ftd[b] = td.fti[b] = 0.0f;
      td.frev[b] = td.freg[b] = 0.0f;
      ti.fab[b] = ti.fre[b] = ti.fti[b] = 0.0f;
      ti.frev[b] = ti.freg[b] = 0.0f;
    }
  }
  o.albold = day ? albold_new : albold;
  o.tauss = day ? tauss_new : tauss;
  o.bgap = bgap;
  o.wgap = wgap;

  // absorbed and reflected fluxes (surrad)
  const float fsha = 1.0f - fsun;
  const float laisun = elai * fsun;
  const float laisha = elai * fsha;
  float cad[2], cai[2], absg[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    cad[b] = solad[b] * td.fab[b];
    cai[b] = solai[b] * ti.fab[b];
    const float trd = solad[b] * td.ftd[b];
    const float tri = solad[b] * td.fti[b] + solai[b] * ti.fti[b];
    absg[b] = trd * (1.0f - albgrd[b]) + tri * (1.0f - albgri[b]);
  }
  const float sav = (cad[0] + cai[0]) + (cad[1] + cai[1]);
  const float sag = absg[0] + absg[1];
  const float laifra = elai / mx(vai, MPE);
  const float parsun_day = (cad[0] + fsun * cai[0]) * laifra / mx(laisun, MPE);
  const float parsha_day = (fsha * cai[0]) * laifra / mx(laisha, MPE);
  const float parsha_night = (cad[0] + cai[0]) * laifra / mx(laisha, MPE);

  o.fsun = fsun;
  o.laisun = laisun;
  o.laisha = laisha;
  o.parsun = (fsun > 0.0f) ? parsun_day : 0.0f;
  o.parsha = (fsun > 0.0f) ? parsha_day : parsha_night;
  o.sav = sav;
  o.sag = sag;
  o.fsa = sav + sag;
  o.fsr = (td.fre[0] * solad[0] + ti.fre[0] * solai[0]) +
          (td.fre[1] * solad[1] + ti.fre[1] * solai[1]);
  o.fsrv = (td.frev[0] * solad[0] + ti.frev[0] * solai[0]) +
           (td.frev[1] * solad[1] + ti.frev[1] * solai[1]);
  o.fsrg = (td.freg[0] * solad[0] + ti.freg[0] * solai[0]) +
           (td.freg[1] * solad[1] + ti.freg[1] * solai[1]);
}

}  // namespace nm
