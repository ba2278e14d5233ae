// Farthest point sampling for Hopper (sm_90a), with a plain C interface
// bound by ctypes in achelous_tpu_torch/ops/hopper_pointops.py.
//
// K4 fps_kernel
//   Replaces achelous_tpu/ops/pallas_pointops.py
//   `pallas_farthest_point_sample` (_fps_kernel): FPS of xyz [B, N, 3]
//   float32 into int64 indices [B, npoint], starting at point 0, taking the
//   first maximum on ties; points masked out by `valid` hold distance -1
//   and are never picked while a valid point remains.
//   Bound: latency.  At the PointNet++ shapes (512 -> 128, 128 -> 32,
//   32 -> 8, 8 -> 4 at batch 1) the whole input is at most 6 KB and each
//   step is ~10 operations a point, but the npoint steps depend on each
//   other, so the time is npoint times the latency of one step.
//   Design: one block per batch element and the whole loop inside the
//   kernel, one launch per call.  What a step costs is kept short:
//   - Each thread owns the points p = tid + k*T (k < kPPT, interleaved, so
//     its own first maximum is its lowest index) and keeps their
//     coordinates and distances in registers: no shared-memory round trip
//     for its own points.  Shared memory holds only a float4 copy of every
//     point, from which the step's centre is one broadcast read.  The
//     update has no branch a point (a masked point's -1 survives fminf;
//     padding past N holds -inf), and a thread takes its own first maximum
//     as floats by a tournament (depth log2 kPPT, not a chain of kPPT).
//   - The argmax runs on an ordered 32-bit key (ordered_key: larger
//     distance, larger key; -1 below every distance >= 0): a warp takes
//     the max key with one redux.sync and then the min index among the
//     lanes holding it with a second, instead of ten shuffles.
//   - One barrier a step: each warp's winner, packed as (key << 32 |
//     ~index) so that the larger word is the larger key and then the lower
//     index, goes to a slot buffer indexed by the step's parity, and after
//     the one __syncthreads every warp takes the max of the words itself,
//     by a read a lane and two redux.sync or, with `tree` (up to 4 warps),
//     by four broadcast reads and a tree of three 64-bit compares.  The
//     wrapper takes the tree up to 4 warps: on the H100 at 128 x 4
//     (512 -> 128) it read 29.7 us a call against 34.5 for redux.sync,
//     211 against 256 cycles a step in the barrier phase (kernels/sweep.py
//     and phase_clocks.py read both).  The next write to a slot comes
//     after the next step's barrier, which every reader of the slot has
//     passed.  A one-warp block has no barrier at all.
//   The launcher takes T and kPPT from the caller (hopper_pointops.fps_plan
//   picks ~4 points a thread, the best of kernels/sweep.py at 512 and
//   128 points); fps_max_threads gives each kPPT's limit, which
//   hopper_pointops.FPS_MAX_THREADS repeats and the CUDA tests hold to it:
//   kPPT <= 8 up to 1024 threads (<= 64 registers), 16 and 24 up to 512
//   (<= 128 registers for 96 floats of points), so FPS_MAX_POINTS = 12288
//   fits as 512 x 24.  An earlier one-warp
//   version kept ~16 contiguous points a thread in shared memory (a
//   16-way bank conflict a read) and ran slower than a thread a point.
//   Exactness: the squared distance is (dx*dx + dy*dy) + dz*dz with every
//   product and sum rounded on its own (__fmul_rn / __fadd_rn stop nvcc
//   from contracting them into FMAs), the order of the plain version in
//   ops/pointops.py, so the indices equal the plain version's exactly.
//   Phase stamps (-DACHELOUS_PHASE_CLOCKS=1, kernels/phase_clocks.py):
//   thread 0 sums a step's cycles in three parts, the centre read,
//   distance update and tournament, the warp reduce, and slot write +
//   barrier + cross-warp reduce.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase_clock.cuh"

namespace {

constexpr float kInit = 1e10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;
constexpr int kMaxSmem = 232448;

// A float's bits made to sort as unsigned integers in the float's order:
// flip every bit of a negative float, only the sign bit of a positive one.
// Distances are -1 (masked out) or >= +0, so -1 keys below all of them.
__device__ __forceinline__ unsigned ordered_key(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The (key, index) pair of a warp that has the largest key, and among
// lanes with that key the lowest index: two redux.sync.
__device__ __forceinline__ unsigned warp_argmax(unsigned key, unsigned idx,
                                                unsigned& top) {
  top = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == top ? idx : kNoIndex);
}

// the most threads a block of kPPT points a thread runs with
__host__ __device__ constexpr int fps_max_threads(int kPPT) {
  return kPPT <= 8 ? 1024 : 512;
}

template <int kPPT>
__global__ void __launch_bounds__(fps_max_threads(kPPT))
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
           int64_t* __restrict__ out, int N, int npoint, int tree) {
  extern __shared__ float4 s_pts[];     // [N] (x, y, z, -)
  __shared__ unsigned long long s_win[2][32];   // per warp, by parity

  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const float* xb = xyz + (int64_t)b * N * 3;
  const uint8_t* vb = valid ? valid + (int64_t)b * N : nullptr;
  int64_t* ob = out + (int64_t)b * npoint;

  // points past N sit at the origin with distance -inf: below -1, so
  // they never win against a real point, and fminf keeps them there
  float px[kPPT], py[kPPT], pz[kPPT], pd[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int p = tid + k * T;
    px[k] = py[k] = pz[k] = 0.f;
    pd[k] = -INFINITY;
    if (p < N) {
      px[k] = xb[3 * p];
      py[k] = xb[3 * p + 1];
      pz[k] = xb[3 * p + 2];
      pd[k] = (vb == nullptr || vb[p]) ? kInit : -1.f;
      s_pts[p] = make_float4(px[k], py[k], pz[k], 0.f);
    }
  }
  for (int i = tid; i < 64; i += T) (&s_win[0][0])[i] = 0ull;
  __syncthreads();
  PHASE_SUM_BEGIN();

  int far = 0;
  for (int it = 0; it < npoint; ++it) {
    // warp 0 stores (one transaction, no divergent branch a step)
    if (warp == 0) ob[it] = far;
    const float4 c = s_pts[far];
    // no branch a point, so the points' updates interleave: a distance of
    // -1 or -inf stays as it is under fminf with a distance >= 0
    float v[kPPT];
    int vk[kPPT];
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const float dx = __fsub_rn(px[k], c.x);
      const float dy = __fsub_rn(py[k], c.y);
      const float dz = __fsub_rn(pz[k], c.z);
      const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      pd[k] = fminf(pd[k], dd);
      v[k] = pd[k];
      vk[k] = k;
    }
    // the thread's first maximum by a tournament: the left side of every
    // match holds the lower points, so a strict > keeps the first
#pragma unroll
    for (int st = 1; st < kPPT; st *= 2) {
#pragma unroll
      for (int k = 0; k + st < kPPT; k += 2 * st)
        if (v[k + st] > v[k]) { v[k] = v[k + st]; vk[k] = vk[k + st]; }
    }
    PHASE_SUM(0);
    unsigned top;
    const unsigned wi = warp_argmax(ordered_key(v[0]),
                                    (unsigned)(tid + vk[0] * T), top);
    PHASE_SUM(1);
    if (nwarps == 1) {
      far = (int)wi;
    } else {
      // (key, ~index) in one word: its max is the larger key, then the
      // lower index
      const int slot = it & 1;
      if (lane == 0)
        s_win[slot][warp] = (unsigned long long)top << 32 | (unsigned)~wi;
      __syncthreads();
      unsigned long long w;
      if (tree) {
        // up to 4 warps: four broadcast reads (unused slots hold 0) and a
        // tree of three 64-bit compares
        const unsigned long long* sw = s_win[slot];
        const unsigned long long a = sw[0] > sw[1] ? sw[0] : sw[1];
        const unsigned long long c = sw[2] > sw[3] ? sw[2] : sw[3];
        w = a > c ? a : c;
      } else {
        w = lane < nwarps ? s_win[slot][lane] : 0ull;
        const unsigned hi = __reduce_max_sync(kFull, (unsigned)(w >> 32));
        const unsigned lo = __reduce_max_sync(
            kFull, (unsigned)(w >> 32) == hi ? (unsigned)w : 0u);
        w = (unsigned long long)hi << 32 | lo;
      }
      far = (int)~(unsigned)w;
    }
    PHASE_SUM(2);
  }
  PHASE_SUM_END(3, npoint);
}

template <int kPPT>
cudaError_t launch_fps(const float* xyz, const uint8_t* valid, int64_t* out,
                       int B, int N, int npoint, int threads, int tree,
                       cudaStream_t stream) {
  if (threads > fps_max_threads(kPPT) || threads * kPPT < N ||
      (tree && threads > 128))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float4) * (size_t)N;
  if (smem > (size_t)kMaxSmem - 512) return cudaErrorInvalidValue;
  // opting in costs a CUDA API call: make it once per size reached
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<kPPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  fps_kernel<kPPT><<<B, threads, smem, stream>>>(xyz, valid, out, N, npoint,
                                                 tree);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz [B,N,3] float32, valid [B,N] bytes or null, out [B,npoint] int64;
// `threads` (a multiple of 32) x `ppt` points a thread must cover N, with
// ppt one of 1, 2, 4, 8, 16, 24; `tree` (up to 128 threads) takes the
// cross-warp winner by a compare tree instead of redux.sync.  Returns a
// cudaError_t (0 = launched).
int achelous_farthest_point_sample(const void* xyz, const void* valid,
                                   void* out, int B, int N, int npoint,
                                   int threads, int ppt, int tree,
                                   void* stream) {
  if (B <= 0 || N <= 0 || npoint < 0 || threads < 32 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  auto x = static_cast<const float*>(xyz);
  auto v = static_cast<const uint8_t*>(valid);
  auto o = static_cast<int64_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (ppt) {
    case 1: return (int)launch_fps<1>(x, v, o, B, N, npoint, threads, tree, s);
    case 2: return (int)launch_fps<2>(x, v, o, B, N, npoint, threads, tree, s);
    case 4: return (int)launch_fps<4>(x, v, o, B, N, npoint, threads, tree, s);
    case 8: return (int)launch_fps<8>(x, v, o, B, N, npoint, threads, tree, s);
    case 16:
      return (int)launch_fps<16>(x, v, o, B, N, npoint, threads, tree, s);
    case 24:
      return (int)launch_fps<24>(x, v, o, B, N, npoint, threads, tree, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#if ACHELOUS_PHASE_CLOCKS
// K4's summed phase cycles since the last call (kPhaseBlocks x kPhases:
// update, warp reduce, barrier + cross-warp reduce, whole loop, steps)
// into host memory; then zeroes them.
int achelous_pointops_phase_clocks(long long* dst) {
  cudaError_t err =
      cudaMemcpyFromSymbol(dst, g_phase_clock, sizeof(g_phase_clock));
  void* dev = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&dev, g_phase_clock);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(g_phase_clock));
  return (int)err;
}
#endif

}  // extern "C"
