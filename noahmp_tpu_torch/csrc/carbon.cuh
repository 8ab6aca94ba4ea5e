// Dynamic vegetation carbon (opt_veg 2 and 5): leaf, stem, root, wood
// and soil carbon pools, LAI and SAI from leaf and stem mass;
// counterpart of physics/carbon.py.  Of the plain version's fifteen
// outputs the step keeps eleven; autors, heters, totsc and totlb are
// diagnostics that nothing reads and are not formed here, nor is the
// root-zone temperature the reference passes in and never uses.
#pragma once

#include "column_io.cuh"
#include "common.cuh"
#include "phenology.cuh"

namespace nm {

struct CarbonOut {
  float lfmass, rtmass, stmass, wood, stblcp, fastcp;
  float lai, sai, gpp, npp, nee;
};

// Carbon pool update (physics/carbon.py:co2flux).
NM_INL void co2flux(const ParamRef& p, const ClassScalars& cls, int lutyp,
                    float igs, float dt, float stc1, float psn, float tv,
                    float wroot, float wstres, float foln, float lapm,
                    float xlai, float lfmass, float rtmass, float stmass,
                    float fastcp, float stblcp, float wood, CarbonOut& o) {
  const float rtovrc = 2.0e-8f;
  const float rswoodc = 3.0e-10f;
  const float bf = 0.90f;
  const float wstrc = 100.0f;
  const float laimin = 0.05f, xsamin = 0.01f;
  const float sapm = F32(3.0 * 0.001);
  // sla = 0 (the classes without leaves, not all of which the gate
  // zeroes) gives inf here and NaN further down, as upstream
  const float lfmsmn = rdiv(laimin, lapm);
  const float stmsmn = F32(0.01 / (3.0 * 0.001));
  const float wdpool = p.wdpool();

  const float rf = (igs == 0.0f) ? 0.5f : 1.0f;
  const float fnf = mn(foln / mx(p.folnmx(), 1.0e-6f), 1.0f);
  const float tf = powf(p.arm(), divc(tv - 298.16f, 10.0f));
  const float resp = p.rmf25() * tf * fnf * xlai * rf * (1.0f - wstres);
  const float rsleaf = mn(lfmass / dt, resp * 12.0e-6f);
  const float rsroot = p.rmr25() * (rtmass * 1.0e-3f) * tf * rf * 12.0e-6f;
  const float rsstem = p.rms25() * (stmass * 1.0e-3f) * tf * rf * 12.0e-6f;
  const float rswood = rswoodc * expf(0.08f * (tv - 298.16f)) * wood * wdpool;

  const float carbfx = psn * 12.0e-6f;

  const float lrate = (lutyp == cls.isegblf) ? 0.50f : 0.75f;
  float leafpt = expf(0.01f * (1.0f - expf(lrate * xlai)) * xlai);
  const float nonlef = 1.0f - leafpt;
  const float stempt = divc(xlai, 10.0f);
  leafpt = leafpt - stempt;

  const float wrr = p.wrrat() * rtmass / mx(wood, MPE);
  const float woodf =
      (wood > 0.0f) ? (1.0f - divc(expf(-bf * wrr), bf)) * wdpool : 0.0f;
  const float rootpt = nonlef * (1.0f - woodf);
  const float woodpt = nonlef * woodf;

  const float ltovrc = p.ltovrc();
  const float lftovr = ltovrc * 1.0e-6f * lfmass;
  const float sttovr = ltovrc * 1.0e-6f * stmass;
  float rttovr = rtovrc * rtmass;
  const float wdtovr = 9.5e-10f * wood;

  const float sc =
      expf(-0.3f * mx(tv - p.tdlef(), 0.0f)) * divc(lfmass, 120.0f);
  const float sd = expf((wstres - 1.0f) * wstrc);
  const float die_rate = p.dilefw() * sd + p.dilefc() * sc;
  float dielf = lfmass * 1.0e-6f * die_rate;
  float diest = stmass * 1.0e-6f * die_rate;

  const float fragr = p.fragr();
  const float grleaf = mx(fragr * (leafpt * carbfx - rsleaf), 0.0f);
  const float grstem = mx(fragr * (stempt * carbfx - rsstem), 0.0f);
  const float grroot = mx(fragr * (rootpt * carbfx - rsroot), 0.0f);
  const float grwood = mx(fragr * (woodpt * carbfx - rswood), 0.0f);

  float addnpplf = mx(leafpt * carbfx - grleaf - rsleaf, 0.0f);
  float addnppst = mx(stempt * carbfx - grstem - rsstem, 0.0f);
  if (tv < p.tmin()) {
    addnpplf = 0.0f;
    addnppst = 0.0f;
  }

  const float lfdel = (lfmass - lfmsmn) / dt;
  const float stdel = (stmass - stmsmn) / dt;
  dielf = mn(dielf, lfdel + addnpplf - lftovr);
  diest = mn(diest, stdel + addnppst - sttovr);

  const float nppl = mx(addnpplf, -lfdel);
  const float npps = mx(addnppst, -stdel);
  const float nppr = rootpt * carbfx - rsroot - grroot;
  const float nppw = woodpt * carbfx - rswood - grwood;

  lfmass = lfmass + (nppl - lftovr - dielf) * dt;
  stmass = stmass + (npps - sttovr - diest) * dt;
  rtmass = rtmass + (nppr - rttovr) * dt;
  // a root pool driven negative gives all of this step's root
  // production to the turnover, before the soil pool takes it up
  if (rtmass < 0.0f) {
    rttovr = nppr;
    rtmass = 0.0f;
  }
  wood = (wood + (nppw - wdtovr) * dt) * wdpool;

  fastcp = fastcp + (rttovr + lftovr + sttovr + wdtovr + dielf) * dt;
  const float fst = powf(2.0f, divc(stc1 - 283.16f, 10.0f));
  const float fsw = wroot / (0.20f + wroot) * 0.23f / (0.23f + wroot);
  const float rssoil =
      fsw * fst * p.mrp() * mx(fastcp * 1.0e-3f, 0.0f) * 12.0e-6f;
  const float stablc = 0.1f * rssoil;
  fastcp = fastcp - (rssoil + stablc) * dt;
  stblcp = stblcp + stablc * dt;

  const float autors = rsroot + rswood + rsleaf + grleaf + grroot + grwood;

  o.lfmass = lfmass;
  o.rtmass = rtmass;
  o.stmass = stmass;
  o.wood = wood;
  o.stblcp = stblcp;
  o.fastcp = fastcp;
  o.lai = mx(lfmass * lapm, laimin);
  o.sai = mx(stmass * sapm, xsamin);
  o.gpp = carbfx;
  o.npp = nppl + nppw + nppr;
  o.nee = divc((autors + rssoil - carbfx) * 44.0f, 12.0f);
}

// Carbon driver (physics/carbon.py:carbon).  dzsnso, stc and smc are the
// water stage's; a non-vegetated class leaves every output zero.
NM_INL void carbon(const ParamRef& p, const ClassScalars& cls, int lutyp,
                   float dt, const float (&zsoil)[NSOIL],
                   const float (&dzsnso)[NLEVELS], const float (&stc)[NLEVELS],
                   const float (&smc)[NSOIL], float tv, float psn, float foln,
                   float btran, float igs, float lai, float lfmass,
                   float rtmass, float stmass, float wood, float stblcp,
                   float fastcp, CarbonOut& o) {
  const int nroot = p.nroot();
  const float lapm = divc(p.sla(), 1000.0f);
  const float wstres = 1.0f - btran;
  const float smcmax = p.smcmax();
  const float zroot = -vsel(zsoil, imax(nroot - 1, 0));
  float w[NSOIL];
#pragma unroll
  for (int k = 0; k < NSOIL; ++k)
    w[k] = (k < nroot) ? smc[k] / smcmax * dzsnso[MSNOW + k] / zroot : 0.0f;
  const float wroot = sum_last(w);

  co2flux(p, cls, lutyp, igs, dt, stc[MSNOW], psn, tv, wroot, wstres, foln,
          lapm, lai, lfmass, rtmass, stmass, fastcp, stblcp, wood, o);

  if (is_nonveg(lutyp, cls)) o = CarbonOut{};
}

}  // namespace nm
