// Tile energy balances: the coupled canopy/ground Newton iteration
// (vege_flux) and the bare-ground Newton iteration (bare_flux);
// counterpart of physics/flux.py.
//
// The plain version runs every trip of the canopy loop and freezes a
// point's values once it has left the loop (done_before).  Here a
// thread breaks at the top of the first trip that would be frozen
// whole: the values it carries are the same.
//
// The canopy loop runs in two passes (column.cu says why): the first
// runs the trips up to kCanopyPassEnd[0], the second the rest.  A point
// still iterating at the end of the first pass hands its CanopyCarry to
// the second, which recomputes the loop's invariants from the same
// inputs with the same expressions, so every point does the same
// arithmetic in the same order whatever the passes.  A build with
// NM_CANOPY_ONE_PASS defined runs the loop in one pass (the tests hold
// the two builds bit for bit against each other).
#pragma once

#include "column_io.cuh"
#include "common.cuh"
#include "sfc.cuh"

namespace nm {

constexpr int NITERC = 20;
constexpr int NITERG = 5;
constexpr int NITERB = 5;

// The trip at which each pass ends.  The first pass runs the first trip
// alone, the one that computes the stomatal resistances.
#if defined(NM_CANOPY_ONE_PASS)
constexpr int kCanopyPassEnd[] = {NITERC};
#else
constexpr int kCanopyPassEnd[] = {1, NITERC};
#endif
constexpr int kCanopyPasses = sizeof(kCanopyPassEnd) / sizeof(int);
static_assert(kCanopyPasses <= 2 && kCanopyPassEnd[kCanopyPasses - 1] == NITERC,
              "one pass or two, the last ending at NITERC");

// the trips pass p of the canopy loop runs: canopy_first_trip(p) up to
// canopy_pass_end(p)
__host__ __device__ constexpr int canopy_pass_end(int pass) {
  return kCanopyPassEnd[pass];
}

__host__ __device__ constexpr int canopy_first_trip(int pass) {
  return pass == 0 ? 0 : kCanopyPassEnd[pass - 1];
}

// What a trip of the canopy loop reads from the trips before it.  A
// point that enters the second pass is not done, so the pass's first
// trip runs and rewrites every other value of the carry before anything
// reads it.  s1 is read under opt_sfc 1, s2 otherwise.
struct CanopyCarry {
  float tv, tah, cm, ch, h, hg, mozg, fhg;
  bool liter;
  Sfcdif1Carry s1;
  Sfcdif2Carry s2;
  float rssun, rssha, psnsun, psnsha;  // set by the first trip
};

struct VegeFluxOut {
  float tv, tgv, tah, eah, qsfc, cmv, chv, tauxv, tauyv;
  float irc, irg, shc, shg, evc, evg, tr, ghv, t2mv, q2v;
  float psnsun, psnsha, rssun, rssha, chleaf, chuc, ch2v;
};

struct BareFluxOut {
  float tgb, qsfc, cmb, chb, tauxb, tauyb, irb, shb, evb, ghb;
  float t2mb, q2b, ehb2;
};

// Exchange coefficients by the chosen scheme (flux.py:_exchange)
NM_INL void exchange(int opt_sfc, int chen97_fixed_carry, float czil,
                     bool first, Sfcdif1Carry& s1, Sfcdif2Carry& s2,
                     float cm_prev, float ch_prev,
                     float sfctmp, float rhoair, float h, float qair,
                     float zlvl, float zpd, float z0m, float ur, float thz0,
                     float thair, float& cm, float& ch, float& fv,
                     float& fh2) {
  if (opt_sfc == 1) {
    sfcdif1(first, s1, sfctmp, rhoair, h, qair, zlvl, zpd, z0m, z0m, ur, cm,
            ch);
    fv = s1.fv;
    fh2 = s1.fh2;
    return;
  }
  // the conductances are fed back undivided (the reference's quirk), or
  // multiplied by the wind speed again (flux.py:CHEN97_FIXED_CARRY)
  const float scale = chen97_fixed_carry ? ur : 1.0f;
  s2.akms = cm_prev * scale;
  s2.akhs = ch_prev * scale;
  sfcdif2(first, s2, z0m, thz0, thair, ur, czil, zlvl);
  cm = s2.akms / ur;
  ch = s2.akhs / ur;
  fv = s2.ustar;
  fh2 = 0.0f;
}

// Trips IT0 .. IT1 - 1 of the canopy loop, from the carry k unless
// IT0 is 0.  Returns false, k holding the carry, if the point is still
// iterating after them; else finishes the tile into o and returns true.
template <int IT0, int IT1>
NM_INL bool vege_flux(const ParamRef& p, const GenScalars& gen,
                     const OptionSet& opt, int chen97_fixed_carry, float dt,
                     float sav, float sag, float lwdn, float ur, float uu,
                     float vv, float sfctmp,
                     float thair, float qair, float eair, float rhoair,
                     float snowh, float vai, float gammav, float gammag,
                     float fwet, float laisun, float laisha, float cwp,
                     float htop, float zlvl, float zpd, float z0m, float fveg,
                     float z0mg, float emv, float emg, float canliq,
                     float canice, float stc_top, float df_top, float dz_top,
                     float rsurf, float latheav, float latheag, float parsun,
                     float parsha, float igs, float foln, float co2air,
                     float o2air, float btran, float sfcprs, float rhsur,
                     float psfc, float eah0, float tah0, float tv0, float tg0,
                     float cm0, float ch0, CanopyCarry& k,
                     VegeFluxOut& o) {
  (void)latheag;
  const float vaie = mn(vai / fveg, 6.0f);
  const float laisune = mn(laisun / fveg, 6.0f);
  const float laishae = mn(laisha / fveg, 6.0f);

  float estg, destg;
  esat_t(tg0, estg, destg);

  const float hcan = htop;
  const float uc = ur * logf(hcan / z0m) / logf(zlvl / z0m);

  const float air = -emv * (1.0f + (1.0f - emv) * (1.0f - emg)) * lwdn -
                    emv * emg * SB * powf(tg0, 4.0f);
  const float cir = (2.0f - emv * (1.0f - emg)) * emv * SB;

  // carry of the canopy Newton loop
  float c_tv = tv0, c_tah = tah0, c_eah = eah0, c_cm = cm0, c_ch = ch0;
  float c_qsfc = 0.622f * eair / (psfc - 0.378f * eair);
  float c_h = 0.0f, c_hg = 0.0f, c_irc = 0.0f, c_shc = 0.0f, c_evc = 0.0f;
  float c_tr = 0.0f, c_rahc = 1.0f, c_rahg = 1.0f, c_rawg = 1.0f;
  float c_cvh = 0.0f, c_fv = 0.1f, c_fh2 = 0.0f;
  float c_mozg = 0.0f, c_fhg = 0.0f;
  bool c_liter = false, c_done = false;
  Sfcdif1Carry s1;
  sfcdif1_init(s1);
  Sfcdif2Carry s2 = {cm0, ch0, 0.0f, 0.0f, 0.1f};

  float rssun = 0.0f, rssha = 0.0f, psnsun = 0.0f, psnsha = 0.0f;
  if (IT0 > 0) {
    c_tv = k.tv;
    c_tah = k.tah;
    c_cm = k.cm;
    c_ch = k.ch;
    c_h = k.h;
    c_hg = k.hg;
    c_mozg = k.mozg;
    c_fhg = k.fhg;
    c_liter = k.liter;
    s1 = k.s1;
    s2 = k.s2;
    rssun = k.rssun;
    rssha = k.rssha;
    psnsun = k.psnsun;
    psnsha = k.psnsha;
  }
  const float z0h = z0m;
  const float z0hg = z0mg;

  for (int it = IT0; it < IT1; ++it) {
    const bool first = it == 0;
    if (!first && c_done) break;

    float cm, ch, fv, fh2;
    exchange(opt.sfc, chen97_fixed_carry, gen.czil, first, s1, s2, c_cm,
             c_ch, sfctmp, rhoair, c_h, qair, zlvl, zpd, z0m, ur, c_tah,
             thair, cm, ch, fv, fh2);

    const float rahc = mx(rdiv(1.0f, ch * ur), 1.0f);
    const float rawc = rahc;

    float rahg, rb;
    ragrb(p.dleaf(), first, c_mozg, c_fhg, vaie, rhoair, c_hg, c_tah, zpd, z0mg,
          z0hg, hcan, uc, z0h, fv, cwp, rahg, rb);
    const float rawg = rahg;

    float estv, destv;
    esat_t(c_tv, estv, destv);

    if (first) {
      if (opt.crs == 1) {
        stomata(p, igs, sfcprs, sfctmp, parsun, c_tv, c_eah, estv, o2air,
                co2air, foln, btran, rb, rssun, psnsun);
        stomata(p, igs, sfcprs, sfctmp, parsha, c_tv, c_eah, estv, o2air,
                co2air, foln, btran, rb, rssha, psnsha);
      } else {
        canres(p, sfcprs, c_tv, parsun, c_eah, btran, rssun, psnsun);
        canres(p, sfcprs, c_tv, parsha, c_eah, btran, rssha, psnsha);
      }
    }

    // sensible heat conductances
    const float cah = rdiv(1.0f, rahc);
    const float cvh = 2.0f * vaie / rb;
    const float cgh = rdiv(1.0f, rahg);
    float cond = cah + cvh + cgh;
    const float ata = (sfctmp * cah + tg0 * cgh) / cond;
    const float bta = cvh / cond;
    const float csh = (1.0f - bta) * rhoair * CPAIR * cvh;

    // latent heat conductances
    const float caw = rdiv(1.0f, rawc);
    const float cew = fwet * vaie / rb;
    const float ctw =
        (1.0f - fwet) * (laisune / (rb + rssun) + laishae / (rb + rssha));
    const float cgw = rdiv(1.0f, rawg + rsurf);
    cond = caw + cew + ctw + cgw;
    const float aea = (eair * caw + estg * cgw) / cond;
    const float bea = (cew + ctw) / cond;
    const float cev = (1.0f - bea) * cew * rhoair * CPAIR / gammav;
    const float ctr = (1.0f - bea) * ctw * rhoair * CPAIR / gammav;

    const float tah = ata + bta * c_tv;
    const float eah = aea + bea * estv;

    const float tv3 = cube(c_tv);
    float irc = fveg * (air + cir * powf(c_tv, 4.0f));
    float shc = fveg * rhoair * CPAIR * cvh * (c_tv - tah);
    float evc = fveg * rhoair * CPAIR * cew * (estv - eah) / gammav;
    float tr = fveg * rhoair * CPAIR * ctw * (estv - eah) / gammav;
    const float evc_cap = ((c_tv > TFRZ) ? canliq : canice) * latheav / dt;
    evc = mn(evc_cap, evc);

    const float b = sav - irc - shc - evc - tr;
    const float a = fveg * (4.0f * cir * tv3 + csh + (cev + ctr) * destv);
    const float dtv = b / a;

    irc = irc + fveg * 4.0f * cir * tv3 * dtv;
    shc = shc + fveg * csh * dtv;
    evc = evc + fveg * cev * destv * dtv;
    tr = tr + fveg * ctr * destv * dtv;
    const float tv = c_tv + dtv;

    const float h = rhoair * CPAIR * (tah - sfctmp) / rahc;
    const float hg = rhoair * CPAIR * (tg0 - tah) / rahg;
    const float qsfc_new = (0.622f * eah) / (sfcprs - 0.378f * eah);

    // order of the flag updates as in the plain version: done takes the
    // liter of the trip before
    const bool done = c_done || c_liter;
    bool liter = c_liter;
    if (it + 1 >= 5) liter = c_liter || ((fabsf(dtv) <= 0.01f) && !c_liter);

    c_tv = tv;
    c_tah = tah;
    c_eah = eah;
    c_cm = cm;
    c_ch = ch;
    c_qsfc = qsfc_new;
    c_h = h;
    c_hg = hg;
    c_irc = irc;
    c_shc = shc;
    c_evc = evc;
    c_tr = tr;
    c_rahc = rahc;
    c_rahg = rahg;
    c_rawg = rawg;
    c_cvh = cvh;
    c_fv = fv;
    c_fh2 = fh2;
    c_liter = liter;
    c_done = done;
  }
  if (IT1 < NITERC && !c_done) {
    k = CanopyCarry{c_tv, c_tah, c_cm, c_ch, c_h, c_hg, c_mozg, c_fhg,
                    c_liter, s1, s2, rssun, rssha, psnsun, psnsha};
    return false;
  }

  // under-canopy ground energy balance
  const float air_g =
      -emg * (1.0f - emv) * lwdn - emg * emv * SB * powf(c_tv, 4.0f);
  const float cir_g = emg * SB;
  const float csh_g = rhoair * CPAIR / c_rahg;
  const float cev_g = rhoair * CPAIR / (gammag * (c_rawg + rsurf));
  const float cgh_g = 2.0f * df_top / dz_top;

  float tg = tg0;
  float irg = 0.0f, shg = 0.0f, evg = 0.0f, gh = 0.0f;
  for (int it = 0; it < NITERG; ++it) {
    esat_t(tg, estg, destg);
    const float tg3 = cube(tg);
    irg = cir_g * powf(tg, 4.0f) + air_g;
    shg = csh_g * (tg - c_tah);
    evg = cev_g * (estg * rhsur - c_eah);
    gh = cgh_g * (tg - stc_top);
    const float b = sag - irg - shg - evg - gh;
    const float a = 4.0f * cir_g * tg3 + csh_g + cev_g * destg + cgh_g;
    const float dtg = b / a;
    irg = irg + 4.0f * cir_g * tg3 * dtg;
    shg = shg + csh_g * dtg;
    evg = evg + cev_g * destg * dtg;
    gh = gh + cgh_g * dtg;
    tg = tg + dtg;
  }

  // snow-surface temperature cap
  if (opt.stc == 1) {
    const bool cap = (snowh > 0.05f) && (tg > TFRZ);
    if (cap) {
      tg = TFRZ;
      irg = cir_g * powf(tg, 4.0f) - emg * (1.0f - emv) * lwdn -
            emg * emv * SB * powf(c_tv, 4.0f);
      shg = csh_g * (tg - c_tah);
      evg = cev_g * (estg * rhsur - c_eah);
      gh = sag - (irg + shg + evg);
    }
  }

  o.tauxv = -rhoair * c_cm * ur * uu;
  o.tauyv = -rhoair * c_cm * ur * vv;

  // 2-m diagnostics
  const float cah2 = c_fv * KARMAN / (logf((2.0f + z0h) / z0h) - c_fh2);
  const bool small = cah2 < 1.0e-5f;
  o.t2mv = small ? c_tah
                 : c_tah - (shg + c_shc / fveg) / (rhoair * CPAIR) / mx(cah2, MPE);
  o.q2v = small ? c_qsfc
                : c_qsfc - ((c_evc + c_tr) / fveg + evg) / (latheav * rhoair) /
                               mx(cah2, MPE);

  o.tv = c_tv;
  o.tgv = tg;
  o.tah = c_tah;
  o.eah = c_eah;
  o.qsfc = c_qsfc;
  o.cmv = c_cm;
  o.chv = rdiv(1.0f, c_rahc);
  o.irc = c_irc;
  o.irg = irg;
  o.shc = c_shc;
  o.shg = shg;
  o.evc = c_evc;
  o.evg = evg;
  o.tr = c_tr;
  o.ghv = gh;
  o.psnsun = psnsun;
  o.psnsha = psnsha;
  o.rssun = rssun;
  o.rssha = rssha;
  o.chleaf = c_cvh;
  o.chuc = rdiv(1.0f, c_rahg);
  o.ch2v = cah2;
  return true;
}

NM_INL void bare_flux(const GenScalars& gen, const ClassScalars& cls,
                     const OptionSet& opt, int chen97_fixed_carry, int lutyp,
                     float sag, float lwdn, float ur, float uu, float vv,
                     float sfctmp, float thair,
                     float qair, float eair, float rhoair, float snowh,
                     float stc_top, float df_top, float dz_top, float zlvl,
                     float zpd, float z0m, float emg, float rsurf,
                     float lathea, float gamma, float rhsur, float psfc,
                     float tgb0, float cm0, float ch0, float qsfc0,
                     BareFluxOut& o) {
  const float cir = emg * SB;
  const float cgh = 2.0f * df_top / dz_top;

  float tgb = tgb0, cm = cm0, ch = ch0, qsfc = qsfc0, h = 0.0f;
  float fv = 0.0f, fh2 = 0.0f;
  float rahb = 1.0f, csh = 0.0f, cev = 0.0f, estg = 0.0f, destg = 0.0f;
  float irb = 0.0f, shb = 0.0f, evb = 0.0f, ghb = 0.0f;
  Sfcdif1Carry s1;
  sfcdif1_init(s1);
  Sfcdif2Carry s2 = {cm0, ch0, 0.0f, 0.0f, 0.1f};

  for (int it = 0; it < NITERB; ++it) {
    float cm_new, ch_new;
    exchange(opt.sfc, chen97_fixed_carry, gen.czil, it == 0, s1, s2, cm, ch,
             sfctmp, rhoair, h, qair, zlvl, zpd, z0m, ur, tgb, thair, cm_new,
             ch_new, fv, fh2);
    cm = cm_new;
    ch = ch_new;
    if (opt.sfc != 1 && snowh > 0.0f) {
      cm = mn(cm, 0.01f);
      ch = mn(ch, 0.01f);
    }

    rahb = mx(rdiv(1.0f, ch * ur), 1.0f);
    const float rawb = rahb;

    esat_t(tgb, estg, destg);
    csh = rhoair * CPAIR / rahb;
    cev = rhoair * CPAIR / gamma / (rsurf + rawb);

    const float tgb3 = cube(tgb);
    irb = cir * powf(tgb, 4.0f) - emg * lwdn;
    shb = csh * (tgb - sfctmp);
    evb = cev * (estg * rhsur - eair);
    ghb = cgh * (tgb - stc_top);
    const float b = sag - irb - shb - evb - ghb;
    const float a = 4.0f * cir * tgb3 + csh + cev * destg + cgh;
    const float dtg = b / a;
    irb = irb + 4.0f * cir * tgb3 * dtg;
    shb = shb + csh * dtg;
    evb = evb + cev * destg * dtg;
    ghb = ghb + cgh * dtg;
    tgb = tgb + dtg;

    h = csh * (tgb - sfctmp);
    esat_t(tgb, estg, destg);
    qsfc = 0.622f * (estg * rhsur) / (psfc - 0.378f * (estg * rhsur));
  }

  // snow cap
  if (opt.stc == 1) {
    const bool cap = (snowh > 0.05f) && (tgb > TFRZ);
    if (cap) {
      tgb = TFRZ;
      irb = cir * powf(tgb, 4.0f) - emg * lwdn;
      shb = csh * (tgb - sfctmp);
      evb = cev * (estg * rhsur - eair);
      ghb = sag - (irb + shb + evb);
    }
  }

  o.tauxb = -rhoair * cm * ur * uu;
  o.tauyb = -rhoair * cm * ur * vv;

  const float z0h = z0m;
  const float ehb2 = fv * KARMAN / (logf((2.0f + z0h) / z0h) - fh2);
  const bool small = ehb2 < 1.0e-5f;
  o.t2mb = small ? tgb : tgb - shb / (rhoair * CPAIR) / mx(ehb2, MPE);
  float q2b = small ? qsfc
                    : qsfc - evb / (lathea * rhoair) *
                                 (rdiv(1.0f, mx(ehb2, MPE)) + rsurf);
  if (lutyp == cls.isurban) q2b = qsfc;

  o.tgb = tgb;
  o.qsfc = qsfc;
  o.cmb = cm;
  o.chb = rdiv(1.0f, rahb);
  o.irb = irb;
  o.shb = shb;
  o.evb = evb;
  o.ghb = ghb;
  o.q2b = q2b;
  o.ehb2 = ehb2;
}

}  // namespace nm
