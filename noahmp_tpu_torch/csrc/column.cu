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
//  - The step is four stages (sflx.cuh): prologue, flux, ground,
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
//  - The flux stage is two launches, because lanes that take different
//    branches take turns too.  On a winter continental domain about
//    half the points have no canopy (elai + esai = 0): the vegetated
//    tile's arithmetic gives them NaN from the canopy loop's first trip
//    on, every trip takes the NaN branches, and they never leave the
//    loop, while the points with a canopy take others and leave it after
//    6 to 20 trips.  So the first launch runs the first trip of the loop
//    (the one that computes the stomatal resistances) over the slab, in
//    its order, and stores each point's carry in the scratch; each
//    point then joins a list, at its front with a canopy and at its
//    back without one (one atomicAdd a warp for each end).  The second
//    launch, flux_kernel_rest, runs the remaining trips and the rest of
//    the tile over the list, so that nearly every warp holds one kind of
//    point.  It holds fewer live values than the first and runs 7
//    blocks an SM.  On the spin-up cell's domain (1,048,576 points,
//    after its 60 days from a cold start, mean over four hours of the
//    next day) a step took 4.08 ms in one launch and 3.14 ms so (NVIDIA
//    H100 80GB HBM3, 700.00 W); 3.35 with the list sorted at 4 blocks an
//    SM, 3.63 unsorted at 6.  A first pass of 11 trips, after which only
//    the points still iterating went on in their order, gave 3.94: half
//    the points never leave the loop, so no trip count keeps a warp from
//    its slowest lane, and each earlier end of the first pass moved more
//    trips out of the mixed warps and was faster.  A step of the uniform
//    case at that size went from 2.04 to 1.97 ms.
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
// first CUDA error.  It does not synchronise, never reads the card, and
// allocates nothing: the caller owns the scratch (kSeamWords * slab +
// kPassCounters words); the prologue empties the list on the card.
// noahmp_column_stage enqueues one stage alone, for timing it.
// noahmp_column_abi reports the layout's counts and size so that the
// caller can refuse a mismatch; noahmp_column_attributes reports
// registers, local bytes and launch shape of each kernel.
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

// the four stages of a step; the flux stage is one launch a pass of the
// canopy loop
enum StageLaunch { kStagePrologue = 0, kStageFlux, kStageGround, kStageWater,
                   kNumStages };
constexpr int kNumLaunches = kNumStages - 1 + nm::kCanopyPasses;

#define NM_STAGE_KERNEL(name, stage)                                      \
  __global__ void __launch_bounds__(kThreads, kMinBlocks)                 \
  name(const __grid_constant__ ColumnArgs args, int64_t i0, int64_t m) {  \
    const int64_t j =                                                     \
        static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;        \
    if (j < m) nm::run_stage(stage, nm::make_point(args, i0 + j, j));     \
  }

NM_STAGE_KERNEL(ground_kernel, nm::kGround)
NM_STAGE_KERNEL(water_kernel, nm::kWater)

// The prologue also empties the slab's list of points for the canopy
// loop's second pass, before the flux stage of the same slab on the
// same stream.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
prologue_kernel(const __grid_constant__ ColumnArgs args, int64_t i0,
                int64_t m) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j == 0) {
    int* count = nm::pass_counters(args);
    for (int c = 0; c < kPassCounters; ++c) count[c] = 0;
  }
  if (j < m) nm::run_stage(nm::kPrologue, nm::make_point(args, i0 + j, j));
}

// Slab point j of the m joins the second pass's list: at its front with
// a canopy, at its back without one, so that a warp of the second pass
// holds one kind of point.  One atomicAdd a warp for each end, each
// lane's entry after those of the lanes below it that join the same end.
__device__ __forceinline__ void append_pending(const ColumnArgs& args,
                                               int64_t m, int64_t j,
                                               nm::VegePass kind) {
  const bool back = kind == nm::kVegeGoesOnBare;
  const unsigned lanes = __activemask();
  const unsigned backs = __ballot_sync(lanes, back);
  const unsigned mine = back ? backs : lanes & ~backs;
  const int leader = __ffs(mine) - 1;
  const int lane = static_cast<int>(threadIdx.x % 32);
  int base = 0;
  if (lane == leader)
    base = atomicAdd(nm::pass_counters(args) + (back ? 1 : 0), __popc(mine));
  base = __shfl_sync(lanes, base, leader);
  const int64_t at = base + __popc(mine & ((1u << lane) - 1u));
  nm::pending_list(args)[back ? m - 1 - at : at] = static_cast<int>(j);
}

// The first pass of the flux stage: both tiles of every point of the
// slab, the vegetated one up to the end of the canopy loop's first
// pass.  blockIdx.y picks the tile, so the two tiles of a point never
// share a warp.
constexpr unsigned kFluxRows = 2;
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flux_kernel(const __grid_constant__ ColumnArgs args, int64_t i0, int64_t m) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= m) return;
  const nm::Point q = nm::make_point(args, i0 + j, j);
  if (blockIdx.y == 0) {
    const nm::VegePass kind = nm::energy_vege_tile<0>(q);
    if (kind != nm::kVegeDone) append_pending(args, m, j, kind);
  } else {
    nm::energy_bare_tile(q);
  }
}

// The canopy loop's second pass (launched only where it has one): the
// points of the list, one a thread, those from its front first, then
// those from its back; the grid covers the slab and the threads past
// the list's points return.  It holds fewer live values than the first
// pass, and more blocks an SM hide more of its latency.
constexpr int kRestMinBlocks = 7;
__global__ void __launch_bounds__(kThreads, kRestMinBlocks)
flux_kernel_rest(const __grid_constant__ ColumnArgs args, int64_t i0,
                 int64_t m) {
  const int* count = nm::pass_counters(args);
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int front = count[0];
  if (k >= front + count[1]) return;
  const int* list = nm::pending_list(args);
  const int64_t j = k < front ? list[k] : list[m - 1 - (k - front)];
  nm::energy_vege_tile<nm::kCanopyPasses - 1>(nm::make_point(args, i0 + j, j));
}

using StageKernel = void (*)(ColumnArgs, int64_t, int64_t);

// launch l of a slab: the prologue, the flux stage's passes, ground,
// water
StageKernel launch_kernel(int l) {
  if (l == 0) return prologue_kernel;
  if (l == 1) return flux_kernel;
  if (l == 2 && nm::kCanopyPasses == 2) return flux_kernel_rest;
  return l == kNumLaunches - 2 ? ground_kernel : water_kernel;
}

int first_launch(int stage) {
  return stage <= kStageFlux ? stage : stage - 1 + nm::kCanopyPasses;
}

// one launch: points i0 .. i0 + m - 1, which are one slab or less
cudaError_t enqueue(const ColumnArgs& args, int l, int64_t i0, int64_t m,
                    cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kThreads - 1) / kThreads),
                  l == first_launch(kStageFlux) ? kFluxRows : 1u);
  launch_kernel(l)<<<grid, kThreads, 0, stream>>>(args, i0, m);
  return cudaGetLastError();
}

// stages first..last of every slab, slab after slab; a walk that starts
// at the flux stage empties the lists itself, the prologue does not run
int walk(const ColumnArgs* args, int first, int last, void* stream) {
  if (args->n <= 0) return static_cast<int>(cudaSuccess);
  if (args->slab <= 0 || args->scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  for (int64_t i0 = 0; i0 < args->n; i0 += args->slab) {
    const int64_t m = (args->n - i0 < args->slab) ? args->n - i0 : args->slab;
    if (first == kStageFlux) {
      const cudaError_t err = cudaMemsetAsync(
          nm::pass_counters(*args), 0, kPassCounters * sizeof(int), s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (int l = first_launch(first); l < first_launch(last + 1); ++l) {
      const cudaError_t err = enqueue(*args, l, i0, m, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" int noahmp_column_step(const ColumnArgs* args, void* stream) {
  return walk(args, 0, kNumStages - 1, stream);
}

// the launches of one of the four stages alone, over every slab; the
// scratch must hold what the stages before it wrote
extern "C" int noahmp_column_stage(const ColumnArgs* args, int stage,
                                   void* stream) {
  if (stage < 0 || stage >= kNumStages)
    return static_cast<int>(cudaErrorInvalidValue);
  return walk(args, stage, stage, stream);
}

// counts[0..9]: inputs, outputs, options, class scalars, general
// scalars, sizeof(ColumnArgs), threads a block, launches a slab, words
// of scratch a point, words of scratch after the slab's
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
  counts[9] = kPassCounters;
}

// attrs[5 * l + 0..4] for launch l of a slab: registers a thread, local
// (spill and stack) bytes a thread, threads a block, least blocks an
// SM, rows of the grid (threads a point); returns the CUDA error
extern "C" int noahmp_column_attributes(int* attrs) {
  for (int l = 0; l < kNumLaunches; ++l) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(
        &fa, reinterpret_cast<const void*>(launch_kernel(l)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attrs[5 * l + 0] = fa.numRegs;
    attrs[5 * l + 1] = static_cast<int>(fa.localSizeBytes);
    attrs[5 * l + 2] = kThreads;
    attrs[5 * l + 3] = launch_kernel(l) == flux_kernel_rest ? kRestMinBlocks
                                                            : kMinBlocks;
    attrs[5 * l + 4] =
        l == first_launch(kStageFlux) ? static_cast<int>(kFluxRows) : 1;
  }
  return 0;
}
