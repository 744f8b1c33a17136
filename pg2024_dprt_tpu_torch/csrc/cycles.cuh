// Cycle counters for measuring where a kernel spends its time
// (scripts/torch_grouped_probe.py --parts route,k3,nets). They exist only in a
// build with -DPG_CYCLES, which the probe makes into a copy of the library
// under build/cycles/; the package's own build compiles every macro below to
// nothing, so the kernels it ships carry no counter.
//
//   CYCLES_NOW(v)         declares v = clock64()
//   CYCLES_ADD(slot, v)   adds clock64() - v to counter `slot`
//   CYCLES_COUNT(slot, n) adds n to counter `slot`
//
// The probe clears and reads the counters through cycles_clear() /
// cycles_read(out), out holding kCycleSlots unsigned 64-bit values.
#pragma once

#ifdef PG_CYCLES
#include <cuda_runtime.h>

namespace cycles {
constexpr int kCycleSlots = 64;
__device__ unsigned long long g_counts[kCycleSlots];
}  // namespace cycles

#define CYCLES_NOW(v) const long long v = clock64()
#define CYCLES_ADD(slot, v) \
  atomicAdd(&cycles::g_counts[slot], static_cast<unsigned long long>(clock64() - (v)))
#define CYCLES_COUNT(slot, n) \
  atomicAdd(&cycles::g_counts[slot], static_cast<unsigned long long>(n))

extern "C" int cycles_read(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, cycles::g_counts, sizeof(cycles::g_counts)));
}

extern "C" int cycles_clear() {
  unsigned long long zero[cycles::kCycleSlots] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(cycles::g_counts, zero, sizeof(zero)));
}
#else
#define CYCLES_NOW(v)
#define CYCLES_ADD(slot, v)
#define CYCLES_COUNT(slot, n)
#endif
