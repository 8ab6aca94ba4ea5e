// Fused column step for Hopper (sm_90a): every land point through the
// whole Noah-MP timestep, enqueued by one C call.  Replaces the TPU
// kernel noahmp_tpu/pallas/column.py (make_pallas_step, inner kernel).
//
// What bounds it on this card.  A point moves about 1.1 KB against some
// nine thousand float32 operations, so on paper the bytes bound the
// step.  In practice it is instruction issue: a division costs the
// schedulers 15 adds, logf 29, powf 82 under this build's flags, which
// puts the least time the card could issue the step in at 0.083 ms for
// 65,536 points, four times the bytes' 0.022 ms (chip_smoke.py measures
// both).  A point is also one long dependent scalar chain, and one
// thread a point gives the card only 2,048 warps at that size.  As a
// single kernel the step has more live values than a thread has
// registers: built so, with its per-point containers handed between
// __noinline__ module functions, it took 2.6 KB of local memory a
// thread, more than the caches hold, and 0.31 ms where this design
// takes 0.18 (NVIDIA H100 80GB HBM3, 700 W).
//
// What the design does about it.
//  - The step is four launches (sflx.cuh): prologue, flux, ground,
//    water.  Each stage is its own __global__ function with its own
//    register budget and holds only its own live values; with every
//    physics function forced inline (common.cuh) a stage keeps them in
//    registers (0-56 bytes of local memory a thread).  What crosses a
//    seam goes through a scratch buffer laid out (words, slab), so that
//    every access is coalesced.
//  - The launcher walks n in slabs, every stage on one slab before the
//    next, so that the scratch is bounded whatever n is.  A slab is as
//    large as the caller makes the scratch: small slabs cost more than
//    they save (at n = 1,048,576, slabs of 65,536 took 2.88 ms, one pass
//    2.12 ms: each launch then has its own tail and cannot fill the
//    card), so the wrapper uses slabs of 1,048,576 points.
//  - In the flux stage a point has two threads in different warps
//    (blockIdx.y): one runs the vegetated tile's Newton loops, one the
//    bare tile's.  They read the same inputs and neither reads the
//    other's result; the ground stage blends them.  Lanes of one warp
//    that run different functions would take turns.
//  - Inputs are read where they are used, through accessors on the
//    batch-major (n,) and (n, L) arrays as they lie (column_io.cuh): no
//    transposes, no padding, no per-point copies, and a parameter is
//    loaded only on the option branch that reads it.  Outputs are stored
//    where they are final.  The grid masks i < n itself, so any n runs.
//  - 128 threads a block and at least 4 blocks an SM (128 registers a
//    thread) for every stage: fewer blocks and more registers were a
//    third slower at 65,536 points, more blocks and fewer registers 5%
//    slower there and 2-10% faster in the flux and ground stages at
//    1,048,576; 64 or 256 threads a block made no difference.
//
// The file is built with --fmad=false: the plain PyTorch step rounds
// every product before the add, and the Newton loops compare against
// thresholds.
//
// C interface.  noahmp_column_step takes a ColumnArgs (column_args.cuh)
// and the stream, enqueues every launch of the step, and returns the
// first CUDA error.  It does not synchronise and allocates nothing: the
// caller owns the scratch (kSeamWords * slab words).
// noahmp_column_stage enqueues one stage alone, for timing it.
// noahmp_column_abi reports the layout's counts and size so that the
// caller can refuse a mismatch; noahmp_column_attributes reports
// registers, local bytes and launch shape of each stage's kernel.
#include <cuda_runtime.h>

#include <cstdint>

#include "column_args.cuh"
#include "column_io.cuh"
#include "sflx.cuh"

namespace {

// Launch shape of every stage: threads a block, and the least number of
// blocks an SM should hold at once, which caps a thread at
// 65,536 / (128 * 4) = 128 registers.
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;

// the four launches of a step
enum Launch { kLaunchPrologue = 0, kLaunchFlux, kLaunchGround, kLaunchWater,
              kNumLaunches };

#define NM_STAGE_KERNEL(name, stage)                                      \
  __global__ void __launch_bounds__(kThreads, kMinBlocks)                 \
  name(const __grid_constant__ ColumnArgs args, int64_t i0, int64_t m) {  \
    const int64_t j =                                                     \
        static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;        \
    if (j < m) nm::run_stage(stage, nm::make_point(args, i0 + j, j));     \
  }

NM_STAGE_KERNEL(prologue_kernel, nm::kPrologue)
NM_STAGE_KERNEL(ground_kernel, nm::kGround)
NM_STAGE_KERNEL(water_kernel, nm::kWater)

// blockIdx.y picks the tile, so the two tiles of a point never share a
// warp.
constexpr unsigned kFluxRows = 2;
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flux_kernel(const __grid_constant__ ColumnArgs args, int64_t i0, int64_t m) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= m) return;
  const nm::Point q = nm::make_point(args, i0 + j, j);
  if (blockIdx.y == 0) {
    nm::energy_vege_tile(q);
  } else {
    nm::energy_bare_tile(q);
  }
}

using StageKernel = void (*)(ColumnArgs, int64_t, int64_t);

StageKernel stage_kernel(int launch) {
  switch (launch) {
    case kLaunchPrologue: return prologue_kernel;
    case kLaunchFlux: return flux_kernel;
    case kLaunchGround: return ground_kernel;
    default: return water_kernel;
  }
}

// one launch: points i0 .. i0 + m - 1, which are one slab or less
cudaError_t enqueue(const ColumnArgs& args, int launch, int64_t i0, int64_t m,
                    cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kThreads - 1) / kThreads),
                  launch == kLaunchFlux ? kFluxRows : 1u);
  stage_kernel(launch)<<<grid, kThreads, 0, stream>>>(args, i0, m);
  return cudaGetLastError();
}

// launches first..last of every slab, slab after slab
int walk(const ColumnArgs* args, int first, int last, void* stream) {
  if (args->n <= 0) return static_cast<int>(cudaSuccess);
  if (args->slab <= 0 || args->scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t i0 = 0; i0 < args->n; i0 += args->slab) {
    const int64_t m = (args->n - i0 < args->slab) ? args->n - i0 : args->slab;
    for (int launch = first; launch <= last; ++launch) {
      const cudaError_t err =
          enqueue(*args, launch, i0, m, static_cast<cudaStream_t>(stream));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" int noahmp_column_step(const ColumnArgs* args, void* stream) {
  return walk(args, 0, kNumLaunches - 1, stream);
}

// one of the four launches alone, over every slab; the scratch must
// hold what the launches before it wrote
extern "C" int noahmp_column_stage(const ColumnArgs* args, int launch,
                                   void* stream) {
  if (launch < 0 || launch >= kNumLaunches)
    return static_cast<int>(cudaErrorInvalidValue);
  return walk(args, launch, launch, stream);
}

// counts[0..8]: inputs, outputs, options, class scalars, general
// scalars, sizeof(ColumnArgs), threads a block, launches a slab, words
// of scratch a point
extern "C" void noahmp_column_abi(int* counts) {
  counts[0] = kNumIn;
  counts[1] = kNumOut;
  counts[2] = kNumOption;
  counts[3] = kNumClass;
  counts[4] = kNumGen;
  counts[5] = static_cast<int>(sizeof(ColumnArgs));
  counts[6] = kThreads;
  counts[7] = kNumLaunches;
  counts[8] = kSeamWords;
}

// attrs[5 * launch + 0..4]: registers a thread, local (spill and stack)
// bytes a thread, threads a block, least blocks an SM, rows of the grid
// (threads a point); returns the CUDA error
extern "C" int noahmp_column_attributes(int* attrs) {
  for (int launch = 0; launch < kNumLaunches; ++launch) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(
        &fa, reinterpret_cast<const void*>(stage_kernel(launch)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attrs[5 * launch + 0] = fa.numRegs;
    attrs[5 * launch + 1] = static_cast<int>(fa.localSizeBytes);
    attrs[5 * launch + 2] = kThreads;
    attrs[5 * launch + 3] = kMinBlocks;
    attrs[5 * launch + 4] =
        launch == kLaunchFlux ? static_cast<int>(kFluxRows) : 1;
  }
  return 0;
}
