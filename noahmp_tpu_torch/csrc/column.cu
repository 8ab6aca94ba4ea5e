// Fused column step for Hopper (sm_90a): one launch advances every land
// point through the whole Noah-MP timestep.  Replaces the TPU kernel
// noahmp_tpu/pallas/column.py (make_pallas_step, inner kernel).
//
// One thread per land point.  A thread loads its point's Static,
// Forcing, State and gathered parameters once (batch-major (n,) and
// (n, L) arrays, read as they lie: no transposes, no padding), runs the
// physics of sflx.cuh as straight scalar C++ with the layer vectors in
// fixed-size local arrays, and stores the 36 State and 61 Flux leaves
// once.  The grid masks i < n itself, so any n runs.
//
// A point moves about 1.1 KB against some ten thousand float32
// operations, so on paper the bytes bound the kernel; in practice it
// sits far above that bound because a point is one long dependent
// scalar chain that spills to local memory and, at n = 65,536, the card
// holds under 500 threads an SM.  Capping a thread at 128 registers (4
// blocks of 128 threads an SM) lets all 512 blocks of n = 65,536 be
// resident at once and was a third faster there than 168 or 252
// registers (NVIDIA H100 80GB HBM3, 700 W).  The module-level device
// functions are __noinline__
// to keep nvcc's time and the register allocator's job bounded.  The
// file is built with --fmad=false: the plain PyTorch step rounds every
// product before the add, and the Newton loops compare against
// thresholds.
//
// C interface: noahmp_column_step takes a ColumnArgs (column_args.cuh)
// and the stream, launches, and returns cudaGetLastError().  It does
// not synchronise and allocates nothing.  noahmp_column_abi reports the
// layout's counts and size so that the caller can refuse a mismatch;
// noahmp_column_attributes reports registers and local bytes a thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "column_args.cuh"
#include "column_io.cuh"

namespace {

// Launch shape: threads a block, and the least number of blocks an SM
// should hold at once (which caps a thread at 128 registers).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
column_kernel(const __grid_constant__ ColumnArgs args) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < args.n) nm::run_point(args, i);
}

}  // namespace

extern "C" int noahmp_column_step(const ColumnArgs* args, void* stream) {
  if (args->n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks =
      static_cast<unsigned>((args->n + kThreads - 1) / kThreads);
  column_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

// counts[0..7]: inputs, outputs, options, class scalars, general
// scalars, sizeof(ColumnArgs), threads a block, launches a step
extern "C" void noahmp_column_abi(int* counts) {
  counts[0] = kNumIn;
  counts[1] = kNumOut;
  counts[2] = kNumOption;
  counts[3] = kNumClass;
  counts[4] = kNumGen;
  counts[5] = static_cast<int>(sizeof(ColumnArgs));
  counts[6] = kThreads;
  counts[7] = 1;
}

// attrs[0..2]: registers a thread, local (spill and stack) bytes a
// thread, the most threads a block may have; returns the CUDA error
extern "C" int noahmp_column_attributes(int* attrs) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, column_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = fa.maxThreadsPerBlock;
  return 0;
}
