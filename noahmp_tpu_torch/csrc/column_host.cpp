// The column physics of sflx.cuh compiled as plain C++ for the host:
// the same headers the CUDA kernel is built from, walked over the
// points in a loop.  It exists so that the kernel's arithmetic can be
// held against the plain PyTorch step on a machine without a card
// (tests/test_torch_column_host.py) and its executed operations counted
// (chip_smoke.py); nothing in the package calls it.
//
//   g++ -O1 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libcolumn_host.so column_host.cpp
#include "host_compat.h"

#include <cstdint>

#include "column_args.cuh"
#include "column_io.cuh"

extern "C" int noahmp_column_host(const ColumnArgs* args) {
  for (int64_t i = 0; i < args->n; ++i) nm::run_point(*args, i);
  return 0;
}

extern "C" void noahmp_column_abi(int* counts) {
  counts[0] = kNumIn;
  counts[1] = kNumOut;
  counts[2] = kNumOption;
  counts[3] = kNumClass;
  counts[4] = kNumGen;
  counts[5] = static_cast<int>(sizeof(ColumnArgs));
  counts[6] = 1;
  counts[7] = 1;
}
