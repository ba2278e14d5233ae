// Phase stamps for timing a kernel's parts on the card.  Built with
// -DACHELOUS_PHASE_CLOCKS=1 (achelous_tpu_torch/kernels/phase_clocks.py
// builds such a library beside the shipped one), thread 0 of each of the
// first kPhaseBlocks blocks writes into its file's g_phase_clock, which the
// file's *_phase_clocks entry point copies out:
//   PHASE(k)           clock64() at phase k of a kernel that runs once
//                      through its phases;
//   PHASE_SUM_BEGIN()  then PHASE_SUM(k) inside a loop: the cycles since
//                      the last stamp added to slot k, so a loop's parts
//                      are summed over its steps; PHASE_SUM_END(k, steps)
//                      writes the sums, the whole loop's cycles to slot k
//                      and `steps` to slot k + 1.
// The shipped build compiles every stamp away.
#pragma once

#ifndef ACHELOUS_PHASE_CLOCKS
#define ACHELOUS_PHASE_CLOCKS 0
#endif

namespace {

constexpr int kPhases = 8, kPhaseBlocks = 4096;

#if ACHELOUS_PHASE_CLOCKS
__device__ long long g_phase_clock[kPhaseBlocks * kPhases];
#define PHASE_BLOCK_ \
  (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define PHASE(k)                                                  \
  do {                                                            \
    const int blk_ = PHASE_BLOCK_;                                \
    if (threadIdx.x == 0 && blk_ < kPhaseBlocks)                  \
      g_phase_clock[blk_ * kPhases + (k)] = clock64();            \
  } while (0)
#define PHASE_SUM_BEGIN()                                         \
  long long phase_sum_[kPhases] = {};                             \
  const long long phase_t0_ = clock64();                          \
  long long phase_t_ = phase_t0_
#define PHASE_SUM(k)                                              \
  do {                                                            \
    const long long t_ = clock64();                               \
    phase_sum_[k] += t_ - phase_t_;                               \
    phase_t_ = t_;                                                \
  } while (0)
#define PHASE_SUM_END(k, steps)                                   \
  do {                                                            \
    const int blk_ = PHASE_BLOCK_;                                \
    if (threadIdx.x == 0 && blk_ < kPhaseBlocks) {                \
      for (int i_ = 0; i_ < (k); ++i_)                            \
        g_phase_clock[blk_ * kPhases + i_] = phase_sum_[i_];      \
      g_phase_clock[blk_ * kPhases + (k)] = clock64() - phase_t0_; \
      g_phase_clock[blk_ * kPhases + (k) + 1] = (steps);          \
    }                                                             \
  } while (0)
#else
#define PHASE(k) \
  do {           \
  } while (0)
#define PHASE_SUM_BEGIN() \
  do {                    \
  } while (0)
#define PHASE_SUM(k) \
  do {               \
  } while (0)
#define PHASE_SUM_END(k, steps) \
  do {                          \
  } while (0)
#endif

}  // namespace
