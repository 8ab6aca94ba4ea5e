// Constants and scalar helpers shared by the column physics headers.
//
// The headers are written from noahmp_tpu_torch/physics/*.py line by
// line, one thread (or, on the host, one loop trip) per land point.
// What the plain version does with a tensor operation, the helpers here
// do with the same rounding as that operation has on the card:
//
//   mx, mn      torch.maximum / torch.minimum / clamp: NaN propagates
//   rdiv(c, x)  Python scalar c divided by a tensor x: PyTorch computes
//               reciprocal(x) * c
//   divc(x, c)  tensor x divided by a Python scalar c: PyTorch
//               multiplies by the float32 reciprocal of c
//   F32(expr)   a constant that Python folds in double before it meets
//               a float32 tensor; narrowed once, at compile time
//
// A tensor divided by a tensor (0-d tensors such as dt and the table
// scalars included) is a plain IEEE division.  Every literal carries
// its f suffix: a bare 0.5 would widen the expression to double.
#pragma once

#include <cmath>
#include <cstdint>

#if !defined(__CUDACC__)
#include "host_compat.h"
#endif

// Every function of the physics headers is forced inline into the
// stage kernel that calls it.  That takes the per-point structs the
// modules hand each other out of local memory (0-56 bytes a thread are
// left, where __noinline__ module functions left 216-960) and made the
// step a quarter faster on an H100, for 5-15 s of nvcc.
#define NM_INL static __device__ __forceinline__

#define F32(expr) (static_cast<float>(expr))

namespace nm {

constexpr int NSOIL = 4;
constexpr int MSNOW = 3;
constexpr int NLEVELS = MSNOW + NSOIL;

constexpr float MPE = 1.0e-6f;
constexpr float GRAV = 9.80616f;
constexpr float SB = 5.67e-8f;
constexpr float RGAS = F32(8.3144598);
constexpr float KARMAN = 0.40f;
constexpr float TFRZ = 273.15f;
constexpr float TTRI = 273.16f;
constexpr float HSUB = 2.8440e6f;
constexpr float HVAP = 2.5104e6f;
constexpr float HFUS = 0.3336e6f;
constexpr float CWAT = 4.188e6f;
constexpr float CICE = 2.094e6f;
constexpr float CPAIR = 1004.64f;
constexpr float TKWAT = 0.6f;
constexpr float TKICE = 2.2f;
constexpr float RAIR = 287.04f;
constexpr float RVAP = 461.269f;
constexpr float DENWAT = 1000.0f;
constexpr float DENICE = 917.0f;

// A comparison with a NaN is false, so when only b is NaN the select
// already yields b: one test of a is all the NaN handling needs.
NM_INL float mx(float a, float b) {
  if (a != a) return a;
  return a > b ? a : b;
}

NM_INL float mn(float a, float b) {
  if (a != a) return a;
  return a < b ? a : b;
}

NM_INL float clipf(float x, float lo, float hi) { return mn(mx(x, lo), hi); }

NM_INL float rdiv(float c, float x) { return (1.0f / x) * c; }

NM_INL float divc(float x, float c) { return x * (1.0f / c); }

NM_INL float sq(float x) { return x * x; }

NM_INL float cube(float x) { return (x * x) * x; }

NM_INL int imin(int a, int b) { return a < b ? a : b; }

NM_INL int imax(int a, int b) { return a > b ? a : b; }

// x[idx] over a tiny axis as the unrolled select chain of
// numerics/select.py:vsel: an index outside 1..L-1 yields x[0].
template <int L>
NM_INL float vsel(const float (&x)[L], int idx) {
  float acc = x[0];
#pragma unroll
  for (int k = 1; k < L; ++k) acc = (idx == k) ? x[k] : acc;
  return acc;
}

// Strict left-to-right sum (numerics/ops.py:sum_last).
template <int L>
NM_INL float sum_last(const float (&x)[L]) {
  float acc = x[0];
#pragma unroll
  for (int k = 1; k < L; ++k) acc = acc + x[k];
  return acc;
}

}  // namespace nm
