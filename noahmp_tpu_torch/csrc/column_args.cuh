// Argument layout of the fused column-step kernel: the one list of
// every tensor the kernel reads and writes, in order.
//
// Each list is an X-macro: XS(name, type) is a per-point scalar (n,),
// XV(name, type, width) a per-point vector (n, width), both contiguous
// with the land-point axis first.  The Python wrapper
// (kernels/column.py) builds its pointer arrays from State._fields,
// Flux._fields, Forcing._fields, Static._fields and the gathered
// parameter list in the same order; a CPU test parses this file and
// holds the two against each other, so neither side can drift.
//
// Pointer order in ColumnArgs::in : STATIC, FORCING, STATE, PARAM.
// Pointer order in ColumnArgs::out: STATE, FLUX.
//
// NM_SEAM_FIELDS lists the words that cross from one stage of the step
// to a later one through the scratch buffer (ColumnArgs::scratch), laid
// out (words, slab): word w of the slab's point j lies at
// scratch[w * slab + j], so neighbouring threads touch neighbouring
// addresses.  After the slab's words come kPassCounters int32 words: the
// number of points at each end of the list of points that go on to the
// canopy loop's second pass (flux.cuh:kCanopyPassEnd).  kernels/column.py
// sizes the buffer from its own copy of the list (SEAM_FIELDS), held
// against this one by the same test.
#pragma once

#include <cstdint>

#define NM_STATIC_FIELDS(XS, XV) \
  XS(lat, float)                 \
  XS(lutyp, int)                 \
  XS(sltyp, int)                 \
  XS(slptyp, int)                \
  XS(isc, int)                   \
  XS(ist, int)                   \
  XS(ice, int)                   \
  XV(zsoil, float, 4)            \
  XS(shdfac, float)              \
  XS(shdmax, float)              \
  XS(tbot, float)                \
  XS(zlvl, float)

#define NM_FORCING_FIELDS(XS, XV) \
  XS(sfctmp, float)               \
  XS(sfcprs, float)               \
  XS(psfc, float)                 \
  XS(uu, float)                   \
  XS(vv, float)                   \
  XS(q2, float)                   \
  XS(soldn, float)                \
  XS(lwdn, float)                 \
  XS(prcp, float)                 \
  XS(cosz, float)                 \
  XS(co2air, float)               \
  XS(o2air, float)                \
  XS(foln, float)                 \
  XS(julian, float)               \
  XS(yearlen, float)

#define NM_STATE_FIELDS(XS, XV) \
  XS(canliq, float)             \
  XS(canice, float)             \
  XS(tv, float)                 \
  XS(eah, float)                \
  XS(tah, float)                \
  XS(fwet, float)               \
  XS(lai, float)                \
  XS(sai, float)                \
  XS(tg, float)                 \
  XS(qsfc, float)               \
  XS(cm, float)                 \
  XS(ch, float)                 \
  XS(nsnow, int)                \
  XS(snowh, float)              \
  XS(sneqv, float)              \
  XS(sneqvo, float)             \
  XV(snice, float, 3)           \
  XV(snliq, float, 3)           \
  XV(zsnso, float, 7)           \
  XS(albold, float)             \
  XS(tauss, float)              \
  XV(ficeold, float, 3)         \
  XS(qsnow, float)              \
  XV(stc, float, 7)             \
  XV(swc, float, 4)             \
  XV(smc, float, 4)             \
  XS(zwt, float)                \
  XS(wa, float)                 \
  XS(wt, float)                 \
  XS(wslake, float)             \
  XS(lfmass, float)             \
  XS(rtmass, float)             \
  XS(stmass, float)             \
  XS(wood, float)               \
  XS(stblcp, float)             \
  XS(fastcp, float)

#define NM_FLUX_FIELDS(XS, XV) \
  XS(fsa, float)               \
  XS(fsr, float)               \
  XS(fira, float)              \
  XS(fsh, float)               \
  XS(fcev, float)              \
  XS(fgev, float)              \
  XS(fctr, float)              \
  XS(ssoil, float)             \
  XS(trad, float)              \
  XS(ecan, float)              \
  XS(etran, float)             \
  XS(edir, float)              \
  XS(runsrf, float)            \
  XS(runsub, float)            \
  XS(apar, float)              \
  XS(psn, float)               \
  XS(sav, float)               \
  XS(sag, float)               \
  XS(fsno, float)              \
  XS(nee, float)               \
  XS(gpp, float)               \
  XS(npp, float)               \
  XS(fveg, float)              \
  XS(albedo, float)            \
  XS(qsnbot, float)            \
  XS(ponding, float)           \
  XS(rssun, float)             \
  XS(rssha, float)             \
  XS(bgap, float)              \
  XS(wgap, float)              \
  XS(tgv, float)               \
  XS(tgb, float)               \
  XS(chv, float)               \
  XS(chb, float)               \
  XS(emissi, float)            \
  XS(t2mv, float)              \
  XS(t2mb, float)              \
  XS(q2v, float)               \
  XS(q2b, float)               \
  XS(fpice, float)             \
  XS(irc, float)               \
  XS(irg, float)               \
  XS(irb, float)               \
  XS(shc, float)               \
  XS(shg, float)               \
  XS(shb, float)               \
  XS(evc, float)               \
  XS(evg, float)               \
  XS(evb, float)               \
  XS(ghv, float)               \
  XS(ghb, float)               \
  XS(tr, float)                \
  XS(chleaf, float)            \
  XS(chuc, float)              \
  XS(chv2, float)              \
  XS(chb2, float)              \
  XS(ponding1, float)          \
  XS(ponding2, float)          \
  XS(errwat, float)            \
  XS(errsw, float)             \
  XS(erreng, float)

// Per-point parameters: every table field the physics indexes by land
// use, soil type, soil colour or slope class, gathered once when the
// step is built (params/gathered.py:GATHERED_FIELDS).
#define NM_PARAM_FIELDS(XS, XV) \
  XS(xl, float)                 \
  XV(rhol, float, 2)            \
  XV(rhos, float, 2)            \
  XV(taul, float, 2)            \
  XV(taus, float, 2)            \
  XV(lai12m, float, 12)         \
  XV(sai12m, float, 12)         \
  XS(nroot, int)                \
  XS(canwmxp, float)            \
  XS(dleaf, float)              \
  XS(z0mvt, float)              \
  XS(hvt, float)                \
  XS(hvb, float)                \
  XS(den, float)                \
  XS(rcrown, float)             \
  XS(cwpvt, float)              \
  XS(sla, float)                \
  XS(dilefc, float)             \
  XS(dilefw, float)             \
  XS(fragr, float)              \
  XS(ltovrc, float)             \
  XS(wrrat, float)              \
  XS(wdpool, float)             \
  XS(tdlef, float)              \
  XS(c3c4, int)                 \
  XS(rgl, float)                \
  XS(hs, float)                 \
  XS(kc25, float)               \
  XS(akc, float)                \
  XS(ko25, float)               \
  XS(ako, float)                \
  XS(vcmx25, float)             \
  XS(avcmx, float)              \
  XS(bp, float)                 \
  XS(rsmax, float)              \
  XS(rsmin, float)              \
  XS(mp, float)                 \
  XS(qe25, float)               \
  XS(aqe, float)                \
  XS(rmf25, float)              \
  XS(rms25, float)              \
  XS(rmr25, float)              \
  XS(folnmx, float)             \
  XS(topt, float)               \
  XS(tmin, float)               \
  XS(arm, float)                \
  XS(mrp, float)                \
  XS(slarea, float)             \
  XV(eps, float, 5)             \
  XS(bexp, float)               \
  XS(smcmax, float)             \
  XS(smcref, float)             \
  XS(smcwlt, float)             \
  XS(psisat, float)             \
  XS(dksat, float)              \
  XS(dwsat, float)              \
  XS(quartz, float)             \
  XS(kdt, float)                \
  XS(frzx, float)               \
  XV(albsat, float, 2)          \
  XV(albdry, float, 2)          \
  XS(slope, float)

// What crosses a seam between two stages, by the stage that writes it.
// An output leaf that is final when a stage has it is stored to its
// leaf there and read back from the leaf by a later stage; only what is
// no output, or not final yet, goes through the scratch.
#define NM_SEAM_FIELDS(XS, XV)                                             \
  /* prologue -> flux, ground, water */                                    \
  XS(ur, float) XS(thair, float) XS(eair, float) XS(rhoair, float)         \
  XS(gammav, float) XS(gammag, float) XS(laisun, float) XS(laisha, float)  \
  XS(zlvl, float) XS(zpd, float) XS(z0m, float) XS(z0mg, float)            \
  XS(emv, float) XS(emg, float) XS(stc_top, float) XS(df_top, float)       \
  XS(dz_top, float) XS(rsurf, float) XS(latheav, float)                    \
  XS(latheag, float) XS(parsun, float) XS(parsha, float) XS(igs, float)    \
  XS(btran, float) XS(rhsur, float) XS(htop, float) XS(elai, float)        \
  XS(esai, float) XV(df, float, 7) XV(hcpct, float, 7)                     \
  XV(btrani, float, 4)                                                     \
  /* flux (vegetated tile) -> ground; ground rewrites v_tv for water */    \
  XS(v_tv, float) XS(v_tgv, float) XS(v_tah, float) XS(v_eah, float)       \
  XS(v_cmv, float) XS(v_chv, float) XS(v_psnsun, float)                    \
  XS(v_psnsha, float) XS(v_rssun, float) XS(v_rssha, float)                \
  /* flux (bare tile) -> ground, water */                                  \
  XS(b_tgb, float) XS(b_qsfc, float) XS(b_cmb, float) XS(b_q2b, float)     \
  /* ground -> water */                                                    \
  XS(qvap, float) XS(qdew, float) XS(g_snowh, float)                       \
  XV(g_snice, float, 3) XV(g_snliq, float, 3) XV(g_stc, float, 7)          \
  XV(g_swc, float, 4) XV(g_smc, float, 4) XV(g_imelt, int, 3)              \
  /* canopy loop, first pass -> second (flux.cuh:CanopyCarry), at */      \
  /* the point's own slot; the list of the points, entry k at k */         \
  XS(c_tv, float) XS(c_tah, float) XS(c_cm, float) XS(c_ch, float)         \
  XS(c_h, float) XS(c_hg, float) XS(c_mozg, float) XS(c_fhg, float)        \
  XS(c_liter, int) XS(c1_moz, float) XS(c1_mozsgn, int) XS(c1_fm, float)   \
  XS(c1_fh, float) XS(c1_fm2, float) XS(c1_fh2, float) XS(c1_fv, float)    \
  XS(c2_akms, float) XS(c2_akhs, float) XS(c2_rlmo, float)                 \
  XS(c2_wstar2, float) XS(c2_ustar, float) XS(c_rssun, float)              \
  XS(c_rssha, float) XS(c_psnsun, float) XS(c_psnsha, float)               \
  XS(pending, int)

// The 12 option switches (options.py:Options), uniform over the grid.
#define NM_OPTION_FIELDS(X) \
  X(veg) X(crs) X(btr) X(run) X(sfc) X(frz) X(inf) X(rad) X(alb) X(snf) \
  X(tbot) X(stc)

// Table scalars, uniform over the grid: the special land-use classes
// (int; isegblf is read by the carbon branch alone) and the general
// parameters (float; the three band pairs are spelled out as _vis/_nir).
#define NM_CLASS_SCALARS(X) \
  X(isurban) X(iswater) X(isbarren) X(isice) X(isegblf)

#define NM_GEN_SCALARS(X)                                              \
  X(csoil) X(zbot) X(czil) X(timean) X(fsatmax) X(mltfct) X(z0sno)     \
  X(ssi) X(swemax) X(alblake_vis) X(alblake_nir) X(omegas_vis)         \
  X(omegas_nir) X(betads) X(betais) X(emssoil) X(emslake)

#define NM_COUNT_S(name, type) +1
#define NM_COUNT_V(name, type, width) +1
#define NM_COUNT_X(name) +1

constexpr int kNumStatic = 0 NM_STATIC_FIELDS(NM_COUNT_S, NM_COUNT_V);
constexpr int kNumForcing = 0 NM_FORCING_FIELDS(NM_COUNT_S, NM_COUNT_V);
constexpr int kNumState = 0 NM_STATE_FIELDS(NM_COUNT_S, NM_COUNT_V);
constexpr int kNumFlux = 0 NM_FLUX_FIELDS(NM_COUNT_S, NM_COUNT_V);
constexpr int kNumParam = 0 NM_PARAM_FIELDS(NM_COUNT_S, NM_COUNT_V);
constexpr int kNumOption = 0 NM_OPTION_FIELDS(NM_COUNT_X);
constexpr int kNumClass = 0 NM_CLASS_SCALARS(NM_COUNT_X);
constexpr int kNumGen = 0 NM_GEN_SCALARS(NM_COUNT_X);

constexpr int kNumIn = kNumStatic + kNumForcing + kNumState + kNumParam;
constexpr int kNumOut = kNumState + kNumFlux;

#define NM_WORDS_S(name, type) +1
#define NM_WORDS_V(name, type, width) +(width)
constexpr int kSeamWords = 0 NM_SEAM_FIELDS(NM_WORDS_S, NM_WORDS_V);

// the list of the canopy loop's second pass fills from both ends, a
// counter for each
constexpr int kPassCounters = 2;

#define NM_MEMBER_I(name) int name;
#define NM_MEMBER_F(name) float name;

struct OptionSet { NM_OPTION_FIELDS(NM_MEMBER_I) };
struct ClassScalars { NM_CLASS_SCALARS(NM_MEMBER_I) };
struct GenScalars { NM_GEN_SCALARS(NM_MEMBER_F) };

// What the launcher is handed, by value as every stage kernel's
// parameter (about 1.9 KB, under the 4 KB limit).  kernels/column.py
// mirrors it as a ctypes.Structure, field for field.  scratch holds
// kSeamWords * slab + kPassCounters words; the launcher walks the n
// points slab by slab, every stage on one slab before the next slab
// begins.
struct ColumnArgs {
  const void* in[kNumIn];
  void* out[kNumOut];
  void* scratch;
  int64_t slab;
  int64_t n;
  float dt;
  OptionSet opt;
  int chen97_fixed_carry;  // physics/flux.py:CHEN97_FIXED_CARRY, 0 or 1
  ClassScalars cls;
  GenScalars gen;
};
