// Measurement probes for chip_smoke.py; nothing in the package calls
// them and no step of the model runs through them.
//
// noahmp_probe_op prices one float32 operation of the column kernels in
// issue slots.  Every thread runs a dependent chain
//     v = v + step;  acc = acc + f(v, w);
// for `trips` trips, at an occupancy that hides the chain's latency, so
// the kernel's time over the time of the same loop with f(v, w) = v
// says what f costs the schedulers, slow paths and special-function
// unit included.  The file is built with the column kernels' flags
// (--fmad=false, IEEE division and square root, libdevice's expf, logf,
// powf), so an operation costs here what it costs there.  v runs from
// the thread's input (0.5 .. 1.5) upwards by `step` a trip; w is the
// thread's second input, unknown to the compiler.
//
// noahmp_probe_empty launches a kernel that does nothing, on a grid of
// the caller's choosing: the floor under the time of any launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

enum Op {
  kIdentity = 0, kAdd, kMul, kDiv, kSqrt, kRsqrt, kExp, kLog, kLog10, kPow,
  kTanh, kAtan, kFmod, kFloor, kFabs, kMax, kNumOps
};

template <int OP>
__device__ __forceinline__ float apply(float v, float w) {
  switch (OP) {
    case kAdd: return v + w;
    case kMul: return v * w;
    case kDiv: return v / w;
    case kSqrt: return sqrtf(v);
    case kRsqrt: return rsqrtf(v);
    case kExp: return expf(v);
    case kLog: return logf(v);
    case kLog10: return log10f(v);
    case kPow: return powf(v, w);
    case kTanh: return tanhf(v);
    case kAtan: return atanf(v);
    case kFmod: return fmodf(v, w);
    case kFloor: return floorf(v);
    case kFabs: return fabsf(v);
    case kMax: return nm::mx(v, w);
    default: return v;
  }
}

constexpr int kThreads = 256;

template <int OP>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ in, float* __restrict__ out,
             int64_t threads, int trips, float step) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= threads) return;
  float v = in[i];
  const float w = in[threads + i];
  float acc = 0.0f;
#pragma unroll 4
  for (int t = 0; t < trips; ++t) {
    v = v + step;
    acc = acc + apply<OP>(v, w);
  }
  out[i] = acc;
}

__global__ void empty_kernel() {}

template <int OP>
void launch(const float* in, float* out, int64_t threads, int trips,
            float step, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  probe_kernel<OP><<<blocks, kThreads, 0, stream>>>(in, out, threads, trips,
                                                    step);
}

}  // namespace

// in: 2 * threads floats (v then w); out: threads floats
extern "C" int noahmp_probe_op(int op, const void* in, void* out,
                               int64_t threads, int trips, float step,
                               void* stream) {
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kIdentity: launch<kIdentity>(i, o, threads, trips, step, s); break;
    case kAdd: launch<kAdd>(i, o, threads, trips, step, s); break;
    case kMul: launch<kMul>(i, o, threads, trips, step, s); break;
    case kDiv: launch<kDiv>(i, o, threads, trips, step, s); break;
    case kSqrt: launch<kSqrt>(i, o, threads, trips, step, s); break;
    case kRsqrt: launch<kRsqrt>(i, o, threads, trips, step, s); break;
    case kExp: launch<kExp>(i, o, threads, trips, step, s); break;
    case kLog: launch<kLog>(i, o, threads, trips, step, s); break;
    case kLog10: launch<kLog10>(i, o, threads, trips, step, s); break;
    case kPow: launch<kPow>(i, o, threads, trips, step, s); break;
    case kTanh: launch<kTanh>(i, o, threads, trips, step, s); break;
    case kAtan: launch<kAtan>(i, o, threads, trips, step, s); break;
    case kFmod: launch<kFmod>(i, o, threads, trips, step, s); break;
    case kFloor: launch<kFloor>(i, o, threads, trips, step, s); break;
    case kFabs: launch<kFabs>(i, o, threads, trips, step, s); break;
    case kMax: launch<kMax>(i, o, threads, trips, step, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int noahmp_probe_empty(unsigned blocks, unsigned threads,
                                  void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
