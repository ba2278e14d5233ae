// Phase stamps for timing a kernel's parts on the card.  Built with
// -DACHELOUS_PHASE_CLOCKS=1 (achelous_tpu_torch/kernels/phase_clocks.py
// builds such a library beside the shipped one), thread 0 of each of the
// first kPhaseBlocks blocks writes clock64() at each PHASE(k) into its
// file's g_phase_clock, which the file's *_phase_clocks entry point copies
// out.  The shipped build compiles every PHASE(k) away.
#pragma once

#ifndef ACHELOUS_PHASE_CLOCKS
#define ACHELOUS_PHASE_CLOCKS 0
#endif

namespace {

constexpr int kPhases = 8, kPhaseBlocks = 4096;

#if ACHELOUS_PHASE_CLOCKS
__device__ long long g_phase_clock[kPhaseBlocks * kPhases];
#define PHASE(k)                                                          \
  do {                                                                    \
    const int blk_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *   \
                                                  blockIdx.z);            \
    if (threadIdx.x == 0 && blk_ < kPhaseBlocks)                          \
      g_phase_clock[blk_ * kPhases + (k)] = clock64();                    \
  } while (0)
#else
#define PHASE(k) \
  do {           \
  } while (0)
#endif

}  // namespace
