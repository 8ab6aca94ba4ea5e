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

// The 12 option switches (options.py:Options), uniform over the grid.
#define NM_OPTION_FIELDS(X) \
  X(veg) X(crs) X(btr) X(run) X(sfc) X(frz) X(inf) X(rad) X(alb) X(snf) \
  X(tbot) X(stc)

// Table scalars, uniform over the grid: the special land-use classes
// (int) and the general parameters (float; the three band pairs are
// spelled out as _vis/_nir).
#define NM_CLASS_SCALARS(X) X(isurban) X(iswater) X(isbarren) X(isice)

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

// Per-point containers generated from the lists.
#define NM_MEMBER_S(name, type) type name;
#define NM_MEMBER_V(name, type, width) type name[width];
#define NM_MEMBER_I(name) int name;
#define NM_MEMBER_F(name) float name;

struct StaticPt { NM_STATIC_FIELDS(NM_MEMBER_S, NM_MEMBER_V) };
struct ForcingPt { NM_FORCING_FIELDS(NM_MEMBER_S, NM_MEMBER_V) };
struct StatePt { NM_STATE_FIELDS(NM_MEMBER_S, NM_MEMBER_V) };
struct FluxPt { NM_FLUX_FIELDS(NM_MEMBER_S, NM_MEMBER_V) };
struct ParamPt { NM_PARAM_FIELDS(NM_MEMBER_S, NM_MEMBER_V) };
struct OptionSet { NM_OPTION_FIELDS(NM_MEMBER_I) };
struct ClassScalars { NM_CLASS_SCALARS(NM_MEMBER_I) };
struct GenScalars { NM_GEN_SCALARS(NM_MEMBER_F) };

// What the launcher is handed, by value as the kernel's one parameter
// (about 1.9 KB, under the 4 KB limit).  kernels/column.py mirrors it
// as a ctypes.Structure, field for field.
struct ColumnArgs {
  const void* in[kNumIn];
  void* out[kNumOut];
  int64_t n;
  float dt;
  OptionSet opt;
  ClassScalars cls;
  GenScalars gen;
};
