// One land point's view of the step's arrays: thin accessors that read
// a field from its batch-major (n,) or (n, L) array where the physics
// uses it and store an output where it is final.  Nothing is copied
// into per-point containers first, so a parameter is loaded only on the
// option branch that reads it and no input lives in local memory.
// Shared by the CUDA kernels (column.cu) and the host build
// (column_host.cpp).
//
// Each accessor struct is generated from its X-macro list in
// column_args.cuh: StaticRef, ForcingRef, StateRef and ParamRef have one
// getter a field (name() for a scalar, name(k) and name(array) for a
// vector); StateOut and FluxOut have one setter a field and a get_name()
// for the later stage that reads a stored leaf back; Seam has both for
// the words that cross between stages through the scratch buffer.
#pragma once

#include "column_args.cuh"
#include "common.cuh"

namespace nm {

#define NM_MEM __device__ __forceinline__

// Inputs are read-only for the whole step: through the read-only path.
template <typename T>
NM_INL T load_word(const T* src) {
#if defined(__CUDACC__)
  return __ldg(src);
#else
  return *src;
#endif
}

#define NM_GET_S(name, type)                                      \
  NM_MEM type name() const {                                      \
    return load_word(static_cast<const type*>(leaf[name##_]) + i); \
  }
#define NM_GET_V(name, type, width)                                   \
  NM_MEM type name(int k) const {                                     \
    return load_word(static_cast<const type*>(leaf[name##_]) +        \
                     i * (width) + k);                                \
  }                                                                   \
  NM_MEM void name(type (&dst)[width]) const {                        \
    _Pragma("unroll") for (int k = 0; k < (width); ++k) dst[k] = name(k); \
  }

#define NM_SLOT_NAME_S(name, type) name##_,
#define NM_SLOT_NAME_V(name, type, width) name##_,

// leaf: the list's pointers within ColumnArgs::in; i: the point
#define NM_DEFINE_IN_REF(Ref, FIELDS)                    \
  struct Ref {                                           \
    enum { FIELDS(NM_SLOT_NAME_S, NM_SLOT_NAME_V) };     \
    const void* const* leaf;                             \
    int64_t i;                                           \
    FIELDS(NM_GET_S, NM_GET_V)                           \
  };

NM_DEFINE_IN_REF(StaticRef, NM_STATIC_FIELDS)
NM_DEFINE_IN_REF(ForcingRef, NM_FORCING_FIELDS)
NM_DEFINE_IN_REF(StateRef, NM_STATE_FIELDS)
NM_DEFINE_IN_REF(ParamRef, NM_PARAM_FIELDS)

#define NM_PUT_S(name, type)                                  \
  NM_MEM void name(type v) const {                            \
    static_cast<type*>(leaf[name##_])[i] = v;                 \
  }                                                           \
  NM_MEM type get_##name() const {                            \
    return static_cast<const type*>(leaf[name##_])[i];        \
  }
#define NM_PUT_V(name, type, width)                                    \
  NM_MEM void name(const type (&src)[width]) const {                   \
    type* dst = static_cast<type*>(leaf[name##_]) + i * (width);       \
    _Pragma("unroll") for (int k = 0; k < (width); ++k) dst[k] = src[k]; \
  }

// leaf: the list's pointers within ColumnArgs::out; i: the point
#define NM_DEFINE_OUT_REF(Ref, FIELDS)                   \
  struct Ref {                                           \
    enum { FIELDS(NM_SLOT_NAME_S, NM_SLOT_NAME_V) };     \
    void* const* leaf;                                   \
    int64_t i;                                           \
    FIELDS(NM_PUT_S, NM_PUT_V)                           \
  };

NM_DEFINE_OUT_REF(StateOut, NM_STATE_FIELDS)
NM_DEFINE_OUT_REF(FluxOut, NM_FLUX_FIELDS)

// Offsets of the seam's words: a vector takes width consecutive words.
#define NM_OFF_S(name, type) name##_,
#define NM_OFF_V(name, type, width) name##_, name##_last_ = name##_ + (width)-1,

#define NM_SEAM_S(name, type)                                            \
  NM_MEM void name(type v) const {                                       \
    reinterpret_cast<type*>(base)[name##_ * slab + j] = v;               \
  }                                                                      \
  NM_MEM type name() const {                                             \
    return reinterpret_cast<const type*>(base)[name##_ * slab + j];      \
  }
#define NM_SEAM_V(name, type, width)                                     \
  NM_MEM void name(const type (&src)[width]) const {                     \
    _Pragma("unroll") for (int k = 0; k < (width); ++k)                  \
        reinterpret_cast<type*>(base)[(name##_ + k) * slab + j] = src[k]; \
  }                                                                      \
  NM_MEM void get_##name(type (&dst)[width]) const {                     \
    _Pragma("unroll") for (int k = 0; k < (width); ++k) dst[k] =         \
        reinterpret_cast<const type*>(base)[(name##_ + k) * slab + j];   \
  }

// base: ColumnArgs::scratch; slab: points it holds; j: the point's
// place in its slab
struct Seam {
  enum { NM_SEAM_FIELDS(NM_OFF_S, NM_OFF_V) words_ };
  float* base;
  int64_t slab;
  int64_t j;
  NM_SEAM_FIELDS(NM_SEAM_S, NM_SEAM_V)
};
static_assert(Seam::words_ == kSeamWords, "seam offsets and word count differ");

// Everything one point of one stage touches.
struct Point {
  const ColumnArgs& a;
  StaticRef sc;
  ForcingRef fo;
  StateRef st;
  ParamRef p;
  StateOut ns;
  FluxOut fx;
  Seam sm;
};

// i: the point; j: its place in the slab being walked
NM_INL Point make_point(const ColumnArgs& a, int64_t i, int64_t j) {
  const void* const* in = a.in;
  void* const* out = a.out;
  return Point{a,
               StaticRef{in, i},
               ForcingRef{in + kNumStatic, i},
               StateRef{in + kNumStatic + kNumForcing, i},
               ParamRef{in + kNumStatic + kNumForcing + kNumState, i},
               StateOut{out, i},
               FluxOut{out + kNumState, i},
               Seam{static_cast<float*>(a.scratch), a.slab, j}};
}

}  // namespace nm
