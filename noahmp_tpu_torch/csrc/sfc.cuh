// Surface-layer building blocks: saturation vapour pressure, saturated
// mixing ratio, Monin-Obukhov and Chen97 exchange coefficients,
// under-canopy resistances, Ball-Berry stomata and Jarvis canopy
// resistance; counterpart of physics/sfc.py.
#pragma once

#include "column_args.cuh"
#include "common.cuh"

namespace nm {

constexpr int STOMATA_TRIPS = 20;

NM_INL float tdc(float t) { return clipf(t - TFRZ, -50.0f, 50.0f); }

NM_INL float poly6(float c0, float c1, float c2, float c3, float c4, float c5,
                   float c6, float t) {
  float acc = c6;
  acc = acc * t + c5;
  acc = acc * t + c4;
  acc = acc * t + c3;
  acc = acc * t + c2;
  acc = acc * t + c1;
  acc = acc * t + c0;
  return 100.0f * acc;
}

// (es, d(es)/dT) at temperature tk [K], water or ice branch
NM_INL void esat_t(float tk, float& es, float& des) {
  const float t = tdc(tk);
  if (t > 0.0f) {
    es = poly6(F32(6.107799961), F32(4.436518521e-1), F32(1.428945805e-2),
               F32(2.650648471e-4), F32(3.031240396e-6), F32(2.034080948e-8),
               F32(6.136820929e-11), t);
    des = poly6(F32(4.438099984e-1), F32(2.857002636e-2), F32(7.938054040e-4),
                F32(1.215215065e-5), F32(1.036561403e-7), F32(3.532421810e-10),
                F32(-7.090244804e-13), t);
  } else {
    es = poly6(F32(6.109177956), F32(5.034698970e-1), F32(1.886013408e-2),
               F32(4.176223716e-4), F32(5.824720280e-6), F32(4.838803174e-8),
               F32(1.838826904e-10), t);
    des = poly6(F32(5.030305237e-1), F32(3.773255020e-2), F32(1.267995369e-3),
                F32(2.477563108e-5), F32(3.005693132e-7), F32(2.158542548e-9),
                F32(7.131097725e-12), t);
  }
}

// saturated mixing ratio (the derivative is not used by the step)
NM_INL float calhum_q2sat(float sfctmp, float sfcprs) {
  const float es =
      0.611f * expf(F32(2.501e6 / 461.0) * (F32(1.0 / 273.15) - rdiv(1.0f, sfctmp)));
  const float sfcprsx = sfcprs * 1.0e-3f;
  const float q2sat = 0.622f * es / (sfcprsx - es) * 1.0e3f;
  return q2sat * 1.0e-3f;
}

struct Sfcdif1Carry {
  float moz;
  int mozsgn;
  float fm, fh, fm2, fh2, fv;
};

NM_INL void sfcdif1_init(Sfcdif1Carry& c) {
  c.moz = 0.0f;
  c.mozsgn = 0;
  c.fm = c.fh = c.fm2 = c.fh2 = 0.0f;
  c.fv = 0.1f;
}

NM_INL void mo_unstable(float m, float& fmn, float& fhn) {
  const float t1 = powf(1.0f - 16.0f * mn(m, 0.0f), 0.25f);
  const float t2 = logf(divc(1.0f + t1 * t1, 2.0f));
  const float t3 = logf(divc(1.0f + t1, 2.0f));
  fmn = 2.0f * t3 + t2 - 2.0f * atanf(t1) + 1.5707963f;
  fhn = 2.0f * t2;
}

NM_INL float guard_mpe(float x) { return (fabsf(x) <= MPE) ? MPE : x; }

// Monin-Obukhov exchange coefficients; updates the carry in place
NM_FN void sfcdif1(bool first, Sfcdif1Carry& c, float sfctmp, float rhoair,
                   float h, float qair, float zlvl, float zpd, float z0m,
                   float z0h, float ur, float& cm, float& ch) {
  const float mozold = c.moz;
  const float dz = mx(zlvl - zpd, MPE);
  const float tmpcm = logf(dz / z0m);
  const float tmpch = logf(dz / z0h);
  const float tmpcm2 = logf((2.0f + z0m) / z0m);
  const float tmpch2 = logf((2.0f + z0h) / z0h);

  float moz, moz2;
  if (first) {
    moz = 0.0f;
    moz2 = 0.0f;
  } else {
    const float tvir = (1.0f + 0.61f * qair) * sfctmp;
    float tmp1 = KARMAN * rdiv(GRAV, tvir) * h / (rhoair * CPAIR);
    tmp1 = guard_mpe(tmp1);
    const float mol = -1.0f * cube(c.fv) / tmp1;
    moz = mn(dz / mol, 1.0f);
    moz2 = mn((2.0f + z0h) / mol, 1.0f);
  }

  const int mozsgn = c.mozsgn + ((mozold * moz < 0.0f) ? 1 : 0);
  const bool flip = mozsgn >= 2;
  float fm = c.fm, fh = c.fh, fm2 = c.fm2, fh2 = c.fh2;
  if (flip) {
    moz = 0.0f;
    moz2 = 0.0f;
    fm = fh = fm2 = fh2 = 0.0f;
  }

  float fmnew, fhnew, fm2new, fh2new;
  if (moz < 0.0f) {
    mo_unstable(moz, fmnew, fhnew);
    mo_unstable(moz2, fm2new, fh2new);
  } else {
    fmnew = -5.0f * moz;
    fhnew = fmnew;
    fm2new = -5.0f * moz2;
    fh2new = fm2new;
  }

  if (first) {
    fm = fmnew;
    fh = fhnew;
    fm2 = fm2new;
    fh2 = fh2new;
  } else {
    fm = 0.5f * (fm + fmnew);
    fh = 0.5f * (fh + fhnew);
    fm2 = 0.5f * (fm2 + fm2new);
    fh2 = 0.5f * (fh2 + fh2new);
  }

  fh = mn(fh, 0.9f * tmpch);
  fm = mn(fm, 0.9f * tmpcm);
  fh2 = mn(fh2, 0.9f * tmpch2);
  fm2 = mn(fm2, 0.9f * tmpcm2);

  const float cmfm = guard_mpe(tmpcm - fm);
  const float chfh = guard_mpe(tmpch - fh);
  const float ch2fh2 = guard_mpe(tmpch2 - fh2);
  cm = rdiv(F32(0.40 * 0.40), cmfm * cmfm);
  ch = rdiv(F32(0.40 * 0.40), cmfm * chfh);
  const float fv = ur * sqrtf(cm);
  (void)ch2fh2;  // the 2-m coefficient KARMAN*fv/ch2fh2 is not consumed

  c.moz = moz;
  c.mozsgn = mozsgn;
  c.fm = fm;
  c.fh = fh;
  c.fm2 = fm2;
  c.fh2 = fh2;
  c.fv = fv;
}

struct Sfcdif2Carry {
  float akms, akhs, rlmo, wstar2, ustar;
};

NM_INL float pspmu(float xx) {
  return -2.0f * logf((xx + 1.0f) * 0.5f) - logf((xx * xx + 1.0f) * 0.5f) +
         2.0f * atanf(xx) - F32(3.14159265 / 2.0);
}

NM_INL float psphu(float xx) { return -2.0f * logf((xx * xx + 1.0f) * 0.5f); }

NM_INL float quarter_root(float z) {
  return sqrtf(sqrtf(mx(1.0f - 16.0f * z, MPE)));
}

// Chen97 exchange coefficients; akms/akhs of the carry are the
// conductances handed in, the carry is updated in place
NM_FN void sfcdif2(bool first, Sfcdif2Carry& c, float z0, float thz0,
                   float thlm, float sfcspd, float czil, float zlm) {
  const float vkrm = 0.40f;
  const float wwst2 = F32(1.2 * 1.2);
  const float excm = 0.001f;
  const float btg = F32(9.80616 / 270.0);
  const float elfc = F32(0.40 * (9.80616 / 270.0));
  const float wold = 0.15f, wnew = 0.85f;
  const float epsu2 = 1.0e-4f, epsust = 0.07f;
  const float ztmin = -5.0f, ztmax = 1.0f;
  const float btgh = F32((9.80616 / 270.0) * 1000.0);
  const float sqvisc = 258.2f;
  (void)btg;

  const float zilfc = -czil * vkrm * sqvisc;
  const float zu = z0;
  const float rdz = rdiv(1.0f, zlm);
  const float cxch = excm * rdz;
  const float dthv = thlm - thz0;
  const float du2 = mx(sfcspd * sfcspd, epsu2);
  const float akms_in = c.akms;
  const float akhs_in = c.akhs;

  float wstar2, ustar, rlmo;
  if (first) {
    const float bad = btgh * akhs_in * dthv;
    wstar2 = (bad != 0.0f) ? wwst2 * powf(fabsf(bad), F32(2.0 / 3.0)) : 0.0f;
    ustar = mx(sqrtf(akms_in * sqrtf(du2 + wstar2)), epsust);
    rlmo = elfc * akhs_in * dthv / cube(ustar);
  } else {
    wstar2 = c.wstar2;
    ustar = c.ustar;
    rlmo = c.rlmo;
  }

  const float zt = mx(expf(zilfc * sqrtf(ustar * z0)) * z0, 1.0e-6f);
  const float zslu = zlm + zu;
  const float zslt = zlm + zt;
  const float rlogu = logf(zslu / zu);
  const float rlogt = logf(zslt / zt);

  const float zetalt = mx(zslt * rlmo, ztmin);
  rlmo = zetalt / zslt;
  const float zetalu = zslu * rlmo;
  const float zetau = zu * rlmo;
  const float zetat = zt * rlmo;

  float simm, simh;
  if (rlmo < 0.0f) {
    // unstable (Paulson) branch
    const float xlu = quarter_root(zetalu);
    const float xlt = quarter_root(zetalt);
    const float xu = quarter_root(zetau);
    const float xt = quarter_root(zetat);
    simm = pspmu(xlu) - pspmu(xu) + rlogu;
    simh = psphu(xlt) - psphu(xt) + rlogt;
  } else {
    const float zetalu_s = mn(zetalu, ztmax);
    const float zetalt_s = mn(zetalt, ztmax);
    simm = 5.0f * zetalu_s - 5.0f * zetau + rlogu;
    simh = 5.0f * zetalt_s - 5.0f * zetat + rlogt;
  }

  ustar = mx(sqrtf(akms_in * sqrtf(du2 + wstar2)), epsust);
  const float ustark = ustar * vkrm;
  const float akms = mx(ustark / simm, cxch);
  const float akhs = mx(ustark / simh, cxch);

  const float bad = btgh * akhs * dthv;
  wstar2 = (bad != 0.0f) ? wwst2 * powf(fabsf(bad), F32(2.0 / 3.0)) : 0.0f;
  const float rlmn = elfc * akhs * dthv / cube(ustar);
  rlmo = rlmo * wold + rlmn * wnew;

  c.akms = akms;
  c.akhs = akhs;
  c.rlmo = rlmo;
  c.wstar2 = wstar2;
  c.ustar = ustar;
}

// Under-canopy aerodynamic and leaf boundary-layer resistances; mozg and
// fhg are the carry
NM_FN void ragrb(float dleaf, bool first, float& mozg, float& fhg, float vai,
                 float rhoair, float hg, float tah, float zpd, float z0mg,
                 float z0hg, float hcan, float uc, float z0h, float fv,
                 float cwp, float& rahg, float& rb) {
  float mozg_new;
  if (first) {
    mozg_new = 0.0f;
  } else {
    float tmp1 = KARMAN * rdiv(GRAV, tah) * hg / (rhoair * CPAIR);
    tmp1 = guard_mpe(tmp1);
    const float molg = -1.0f * cube(fv) / tmp1;
    mozg_new = mn((zpd - z0mg) / molg, 1.0f);
  }
  const float fhgnew = (mozg_new < 0.0f)
                           ? powf(1.0f - 15.0f * mn(mozg_new, 0.0f), -0.25f)
                           : 1.0f + 4.7f * mozg_new;
  const float fhg_new = first ? fhgnew : 0.5f * (fhg + fhgnew);

  const float cwpc = sqrtf(mx(cwp * vai * hcan * fhg_new, MPE));
  const float tmp1 = expf(-cwpc * z0hg / hcan);
  const float tmp2 = expf(-cwpc * (z0h + zpd) / hcan);
  const float tmprah2 = hcan * expf(mn(cwpc, 50.0f)) / cwpc * (tmp1 - tmp2);
  const float kh = mx(KARMAN * fv * (hcan - zpd), MPE);
  rahg = tmprah2 / kh;
  const float tmprb = cwpc * 50.0f / (1.0f - expf(divc(-cwpc, 2.0f)));
  rb = tmprb * sqrtf(dleaf / mx(uc, MPE));
  mozg = mozg_new;
  fhg = fhg_new;
}

// Ball-Berry stomatal resistance and photosynthesis, bisection on the
// internal CO2.  A point leaves the loop once it has converged: from
// then on the masked plain version changes none of its values.
NM_FN void stomata(const ParamPt& p, float igs, float sfcprs, float sfctmp,
                   float apar, float tv, float ea, float ei, float o2,
                   float co2, float foln, float btran, float rb, float& rs_out,
                   float& psn_out) {
  const float cf = sfcprs / (RGAS * sfctmp) * 1.0e6f;
  const float bp = p.bp;
  const float mp_ = p.mp;
  const bool c3 = p.c3c4 == 1;

  const float fnf = mn(foln / mx(p.folnmx, MPE), 1.0f);
  const float tc = tv - TFRZ;
  const float ppf = 4.6f * apar;
  const float j = ppf * p.qe25;
  const float q10 = divc(tc - 25.0f, 10.0f);
  const float kc = p.kc25 * powf(p.akc, q10);
  const float ko = p.ko25 * powf(p.ako, q10);
  const float awc = kc * (1.0f + o2 / ko);
  const float cp = 0.5f * kc / ko * o2 * 0.21f;
  const float vcmx =
      p.vcmx25 /
      (1.0f + expf((-2.2e5f + 710.0f * (tc + TFRZ)) / (8.314f * (tc + TFRZ)))) *
      fnf * btran * powf(p.avcmx, q10);
  const float rlb = rb / cf;

  const float cierr = 5.0e-2f;
  float cilow = 0.0f, cihigh = 1.5f * co2;
  float rs = rdiv(1.0f, bp) + 0.0f;
  float psn = 0.0f;
  for (int it = 0; it < STOMATA_TRIPS; ++it) {
    const float ci = 0.5f * (cihigh + cilow);
    float wj, wc, we;
    if (c3) {
      wj = mx(ci - cp, 0.0f) * j / (ci + 2.0f * cp);
      wc = mx(ci - cp, 0.0f) * vcmx / (ci + awc);
      we = 0.5f * vcmx;
    } else {
      wj = j;
      wc = vcmx;
      we = 4000.0f * vcmx * ci / sfcprs;
    }
    psn = mn(mn(wj, wc), we) * igs;
    const float cs = mx(co2 - 1.37f * rlb * sfcprs * psn, MPE);
    const float a = mp_ * psn * sfcprs * ea / (cs * ei) + bp;
    const float b = (mp_ * psn * sfcprs / cs + bp) * rlb - 1.0f;
    const float c = -rlb;
    const float disc = sqrtf(mx(b * b - 4.0f * a * c, 0.0f));
    const float q = (b >= 0.0f) ? -0.5f * (b + disc) : -0.5f * (b - disc);
    rs = mx(q / a, c / q);
    const float fci = mx(cs - psn * sfcprs * 1.65f * rs, 0.0f);
    const bool conv = ((cihigh - cilow) <= cierr) || (fabsf(fci - ci) <= MPE);
    if (conv) break;
    if (fci > ci) {
      cilow = ci;
    } else {
      cihigh = ci;
    }
  }
  rs = rs * cf;

  // night or out of season
  if (apar <= 0.0f) {
    rs = rdiv(1.0f, bp) * cf;
    psn = 0.0f;
  }
  rs_out = rs;
  psn_out = psn;
}

// Jarvis canopy resistance
NM_FN void canres(const ParamPt& p, float sfcprs, float tv, float par,
                  float eah, float btran, float& rs_out, float& psn_out) {
  float q2 = 0.622f * eah / (sfcprs - 0.378f * eah);
  q2 = q2 / (1.0f + q2);
  const float q2sat = calhum_q2sat(tv, sfcprs);
  const float ff = 2.0f * par / p.rgl;
  const float rcs = clipf((ff + p.rsmin / p.rsmax) / (1.0f + ff), 0.0001f, 1.0f);
  const float rct = clipf(1.0f - 0.0016f * sq(p.topt - tv), 0.0001f, 1.0f);
  const float rcq =
      clipf(rdiv(1.0f, 1.0f + p.hs * mx(q2sat - q2, 0.0f)), 0.01f, 1.0f);
  rs_out = p.rsmin / (rcs * rct * rcq * mx(btran, MPE));
  psn_out = 0.0f;
}

}  // namespace nm
