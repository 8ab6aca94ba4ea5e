// Vegetation phenology and green fraction; counterpart of
// physics/phenology.py.
#pragma once

#include "column_io.cuh"
#include "common.cuh"

namespace nm {

struct PhenologyOut {
  float lai, sai, elai, esai, igs, htop;
};

// torch.remainder on floats: fmod, moved to the divisor's sign
NM_INL float remainder_f(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

NM_INL bool is_nonveg(int lutyp, const ClassScalars& cls) {
  return lutyp == cls.iswater || lutyp == cls.isbarren ||
         lutyp == cls.isice || lutyp == cls.isurban;
}

NM_INL void phenology(const ParamRef& p, const ClassScalars& cls, int lutyp,
                     float snowh, float tv, float lat, float yearlen,
                     float julian, float lai, float sai, int opt_veg,
                     PhenologyOut& o) {
  if (opt_veg == 1 || opt_veg == 3 || opt_veg == 4) {
    // hemisphere-shifted fractional month
    const float day = (lat >= 0.0f)
                          ? julian
                          : remainder_f(julian + 0.5f * yearlen, yearlen);
    const float t = 12.0f * day / yearlen;
    int it1 = static_cast<int>(floorf(t + 0.5f));
    int it2 = it1 + 1;
    const float wt1 = (static_cast<float>(it1) + 0.5f) - t;
    const float wt2 = 1.0f - wt1;
    it1 = (it1 < 1) ? 12 : it1;
    it2 = (it2 > 12) ? 1 : it2;
    // as numerics/select.py:vsel, a month outside the table reads slot 0
    const int m1 = (it1 >= 2 && it1 <= 12) ? it1 - 1 : 0;
    const int m2 = (it2 >= 2 && it2 <= 12) ? it2 - 1 : 0;
    lai = wt1 * p.lai12m(m1) + wt2 * p.lai12m(m2);
    sai = wt1 * p.sai12m(m1) + wt2 * p.sai12m(m2);
  }

  sai = (sai < 0.05f) ? 0.0f : sai;
  lai = (lai < 0.05f || sai == 0.0f) ? 0.0f : lai;
  if (is_nonveg(lutyp, cls)) {
    lai = 0.0f;
    sai = 0.0f;
  }

  // canopy burial by snow
  const float hvt = p.hvt();
  const float hvb = p.hvb();
  const float db = clipf(snowh - hvb, 0.0f, hvt - hvb);
  float fb = db / mx(hvt - hvb, 1.0e-6f);
  const float snowhc = hvt * expf(divc(-snowh, 0.2f));
  const float fb_short = mn(snowh, snowhc) / mx(snowhc, 1.0e-12f);
  fb = (hvt > 0.0f && hvt <= 1.0f) ? fb_short : fb;

  float elai = lai * (1.0f - fb);
  float esai = sai * (1.0f - fb);
  esai = (esai < 0.05f) ? 0.0f : esai;
  elai = (elai < 0.05f || esai == 0.0f) ? 0.0f : elai;

  o.lai = lai;
  o.sai = sai;
  o.elai = elai;
  o.esai = esai;
  o.igs = (tv > p.tmin()) ? 1.0f : 0.0f;
  o.htop = hvt;
}

NM_INL float green_fraction(const ClassScalars& cls, int lutyp, float shdfac,
                            float shdmax, float lai, float sai, float elai,
                            float esai, int opt_veg) {
  float fveg;
  if (opt_veg == 1) {
    fveg = shdfac;
  } else if (opt_veg == 2 || opt_veg == 3) {
    fveg = 1.0f - expf(-0.52f * (lai + sai));
  } else {
    fveg = shdmax;
  }
  fveg = mx(fveg, 0.01f);
  if (lutyp == cls.isurban || lutyp == cls.isbarren) fveg = 0.0f;
  if (elai + esai == 0.0f) fveg = 0.0f;
  return fveg;
}

}  // namespace nm
