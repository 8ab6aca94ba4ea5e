// One land point through the step: load its inputs from the batch-major
// arrays of a ColumnArgs, run column_step, store its outputs.  Shared by
// the CUDA kernel (column.cu, one thread a point) and the host build
// (column_host.cpp, one loop trip a point).
#pragma once

#include "column_args.cuh"
#include "common.cuh"
#include "sflx.cuh"

namespace nm {

template <typename T>
NM_INL T load_word(const T* src) {
#if defined(__CUDACC__)
  return __ldg(src);
#else
  return *src;
#endif
}

template <typename T>
NM_INL void load_leaf(const void* base, int64_t i, T& dst) {
  dst = load_word(static_cast<const T*>(base) + i);
}

template <typename T, int W>
NM_INL void load_leaf(const void* base, int64_t i, T (&dst)[W]) {
  const T* src = static_cast<const T*>(base) + i * W;
#pragma unroll
  for (int k = 0; k < W; ++k) dst[k] = load_word(src + k);
}

template <typename T>
NM_INL void store_leaf(void* base, int64_t i, const T& src) {
  static_cast<T*>(base)[i] = src;
}

template <typename T, int W>
NM_INL void store_leaf(void* base, int64_t i, const T (&src)[W]) {
  T* dst = static_cast<T*>(base) + i * W;
#pragma unroll
  for (int k = 0; k < W; ++k) dst[k] = src[k];
}

#define NM_LOAD_S(name, type) load_leaf(in[slot++], i, pt.name);
#define NM_LOAD_V(name, type, width) load_leaf(in[slot++], i, pt.name);
#define NM_STORE_S(name, type) store_leaf(out[slot++], i, pt.name);
#define NM_STORE_V(name, type, width) store_leaf(out[slot++], i, pt.name);

// Pointer order: in = STATIC, FORCING, STATE, PARAM; out = STATE, FLUX.
NM_INL void run_point(const ColumnArgs& args, int64_t i) {
  const void* const* in = args.in;
  void* const* out = args.out;

  StaticPt sc;
  ForcingPt fo;
  StatePt st;
  ParamPt p;
  int slot = 0;
  {
    StaticPt& pt = sc;
    NM_STATIC_FIELDS(NM_LOAD_S, NM_LOAD_V)
  }
  {
    ForcingPt& pt = fo;
    NM_FORCING_FIELDS(NM_LOAD_S, NM_LOAD_V)
  }
  {
    StatePt& pt = st;
    NM_STATE_FIELDS(NM_LOAD_S, NM_LOAD_V)
  }
  {
    ParamPt& pt = p;
    NM_PARAM_FIELDS(NM_LOAD_S, NM_LOAD_V)
  }

  StatePt ns;
  FluxPt fx;
  column_step(p, args.gen, args.cls, args.opt, args.dt, sc, fo, st, ns, fx);

  slot = 0;
  {
    const StatePt& pt = ns;
    NM_STATE_FIELDS(NM_STORE_S, NM_STORE_V)
  }
  {
    const FluxPt& pt = fx;
    NM_FLUX_FIELDS(NM_STORE_S, NM_STORE_V)
  }
}

#undef NM_LOAD_S
#undef NM_LOAD_V
#undef NM_STORE_S
#undef NM_STORE_V

}  // namespace nm
