// The column physics of sflx.cuh compiled as plain C++ for the host:
// the same headers the CUDA kernels are built from, the same stages
// walked through the same scratch buffer, slab after slab, with a loop
// over a slab's points where the card has a grid.  It exists so that
// the kernels' arithmetic and the seams between the stages can be held
// against the plain PyTorch step on a machine without a card
// (tests/test_torch_column_host.py) and the operations of each stage
// counted (chip_smoke.py); nothing in the package calls it.  The
// vegetated tile's stage runs both passes of the canopy loop, the
// second over the list the first built, as the card does.
//
//   g++ -O1 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libcolumn_host.so column_host.cpp
#include "host_compat.h"

#include <cstdint>

#include "column_args.cuh"
#include "column_io.cuh"
#include "sflx.cuh"

namespace {

// the vegetated tile as the card runs it: the canopy loop's first pass
// over the slab, each point that goes on joining the list, at its back
// without a canopy; then the second pass over the list, front first
void vege_tile(const ColumnArgs& a, int64_t i0, int64_t m) {
  int* count = nm::pass_counters(a);
  int* list = nm::pending_list(a);
  count[0] = count[1] = 0;
  for (int64_t j = 0; j < m; ++j) {
    const nm::VegePass kind =
        nm::energy_vege_tile<0>(nm::make_point(a, i0 + j, j));
    if (kind == nm::kVegeGoesOn) list[count[0]++] = static_cast<int>(j);
    if (kind == nm::kVegeGoesOnBare)
      list[m - 1 - count[1]++] = static_cast<int>(j);
  }
  if (nm::kCanopyPasses == 1) return;
  for (int64_t k = 0; k < count[0] + count[1]; ++k) {
    const int64_t j = k < count[0] ? list[k] : list[m - 1 - (k - count[0])];
    nm::energy_vege_tile<nm::kCanopyPasses - 1>(nm::make_point(a, i0 + j, j));
  }
}

// stages first..last on every slab; with slab = 1 a point runs through
// all of them before the next point begins
int walk(const ColumnArgs* args, int first, int last) {
  if (args->n <= 0) return 0;
  if (args->slab <= 0 || args->scratch == nullptr) return 1;
  for (int64_t i0 = 0; i0 < args->n; i0 += args->slab) {
    const int64_t m = (args->n - i0 < args->slab) ? args->n - i0 : args->slab;
    for (int stage = first; stage <= last; ++stage) {
      if (stage == nm::kVegeTile) {
        vege_tile(*args, i0, m);
        continue;
      }
      for (int64_t j = 0; j < m; ++j)
        nm::run_stage(stage, nm::make_point(*args, i0 + j, j));
    }
  }
  return 0;
}

}  // namespace

extern "C" int noahmp_column_host(const ColumnArgs* args) {
  return walk(args, 0, nm::kNumStages - 1);
}

// one stage (sflx.cuh:Stage) alone over every slab
extern "C" int noahmp_column_host_stage(const ColumnArgs* args, int stage) {
  if (stage < 0 || stage >= nm::kNumStages) return 1;
  return walk(args, stage, stage);
}

extern "C" void noahmp_column_abi(int* counts) {
  counts[0] = kNumIn;
  counts[1] = kNumOut;
  counts[2] = kNumOption;
  counts[3] = kNumClass;
  counts[4] = kNumGen;
  counts[5] = static_cast<int>(sizeof(ColumnArgs));
  counts[6] = 1;
  counts[7] = nm::kNumStages;
  counts[8] = kSeamWords;
  counts[9] = kPassCounters;
}
