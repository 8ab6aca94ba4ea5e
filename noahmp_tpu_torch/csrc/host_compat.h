// Lets the column physics headers compile as plain C++ for the host
// (column_host.cpp), so that their arithmetic can be held against the
// plain PyTorch step on a machine without a card.  Never included by
// nvcc.
#pragma once

#include <cmath>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__ __restrict

// round-to-nearest intrinsics of csrc/tridiag.cuh; the host file is
// built with -ffp-contract=off, so a plain operator rounds the same way
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
