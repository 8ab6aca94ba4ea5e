// Thermal properties of the snow/soil column; counterpart of
// physics/thermo.py.
#pragma once

#include "column_io.cuh"
#include "common.cuh"

namespace nm {

struct ThermoOut {
  float df[NLEVELS], hcpct[NLEVELS], fact[NLEVELS];
  float snicev[MSNOW], snliqv[MSNOW], epore[MSNOW];
};

// Peters-Lidard soil thermal conductivity of one layer
NM_INL float tdfcnd(float smcmax, float quartz, float smc, float swc) {
  const float satratio = smc / smcmax;
  const float thks = powf(7.7f, quartz) * powf(2.0f, 1.0f - quartz);
  const float xunfroz = swc / mx(smc, MPE);
  const float xu = xunfroz * smcmax;
  const float thksat = powf(thks, 1.0f - smcmax) * powf(TKICE, smcmax - xu) *
                       powf(0.57f, xu);
  const float gammd = (1.0f - smcmax) * 2700.0f;
  const float thkdry = (0.135f * gammd + 64.7f) / (2700.0f - 0.947f * gammd);
  const bool frozen = (swc + 0.0005f) < smc;
  const float ake_unfrozen =
      (satratio > 0.1f) ? log10f(mx(satratio, MPE)) + 1.0f : 0.0f;
  const float ake = frozen ? satratio : ake_unfrozen;
  return ake * (thksat - thkdry) + thkdry;
}

NM_INL void thermoprop(const ParamRef& p, const ClassScalars& cls,
                      const GenScalars& gen, int lutyp, int ist, int nsnow,
                      float dt, const float (&dzsnso)[NLEVELS], float snowh,
                      const float (&snice)[MSNOW], const float (&snliq)[MSNOW],
                      const float (&smc)[NSOIL], const float (&swc)[NSOIL],
                      const float (&stc)[NLEVELS], ThermoOut& o) {
  // snow heat capacity/conductivity from partial volumes (csnow)
#pragma unroll
  for (int k = 0; k < MSNOW; ++k) {
    const float dz = mx(dzsnso[k], MPE);
    o.snicev[k] = mn(snice[k] / (dz * DENICE), 1.0f);
    o.epore[k] = 1.0f - o.snicev[k];
    o.snliqv[k] = mn(o.epore[k], snliq[k] / (dz * DENWAT));
    const float bdsnoi = (snice[k] + snliq[k]) / dz;
    o.hcpct[k] = CICE * o.snicev[k] + CWAT * o.snliqv[k];
    o.df[k] = 3.2217e-6f * (bdsnoi * bdsnoi);
  }
#pragma unroll
  for (int k = 0; k < NSOIL; ++k) {
    const float soilice = smc[k] - swc[k];
    float hc = swc[k] * CWAT + (1.0f - p.smcmax()) * gen.csoil +
               (p.smcmax() - smc[k]) * CPAIR + soilice * CICE;
    float df = tdfcnd(p.smcmax(), p.quartz(), smc[k], swc[k]);
    if (lutyp == cls.isurban) df = 3.24f;
    if (ist == 2) {
      const bool thawed = stc[MSNOW + k] > TFRZ;
      hc = thawed ? CWAT : CICE;
      df = thawed ? TKWAT : TKICE;
    }
    o.hcpct[MSNOW + k] = hc;
    o.df[MSNOW + k] = df;
  }
#pragma unroll
  for (int k = 0; k < NLEVELS; ++k)
    o.fact[k] = dt / (o.hcpct[k] * mx(dzsnso[k], MPE));

  // snow/soil interface blending of the top soil layer
  const float dz1 = dzsnso[MSNOW];
  const float df1 = o.df[MSNOW];
  const float df1_bulk = (df1 * dz1 + 0.35f * snowh) / (snowh + dz1);
  const float dz0 = dzsnso[MSNOW - 1];
  const float df1_lay = (df1 * dz1 + o.df[MSNOW - 1] * dz0) / mx(dz0 + dz1, MPE);
  o.df[MSNOW] = (nsnow == 0) ? df1_bulk : df1_lay;
}

}  // namespace nm
