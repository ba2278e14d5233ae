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
//   Design: one block per batch element with its points and distances
//   resident in shared memory (16 bytes a point: 8 KB at N = 512), and the
//   whole loop inside the kernel, one launch per call.  Each step reads the
//   last centre from shared memory, lowers each point's distance, and runs
//   a block-wide argmax over (value, index) pairs: warp shuffles, then one
//   warp over the per-warp winners.  Larger value wins; on equal values
//   the lower index.  A thread a point (up to 512 threads): a version
//   with ~16 points a thread, one warp at N = 512 and no barrier across
//   warps, read slower at 512 -> 128 (~188 us against ~83 us).
//   Exactness: the squared distance is (dx*dx + dy*dy) + dz*dz with every
//   product and sum rounded on its own (__fmul_rn / __fadd_rn stop nvcc
//   from contracting them into FMAs), the order of the plain version in
//   ops/pointops.py, so the indices equal the plain version's exactly.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kInit = 1e10f;

// (v, i) beats (bv, bi): larger value, or equal value and lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, s);
    const int oi = __shfl_down_sync(0xffffffffu, i, s);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
           int64_t* __restrict__ out, int N, int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;            // [N] each: coordinates, then distances
  float* sy = sx + N;
  float* sz = sy + N;
  float* sd = sz + N;          // -1 marks a point masked out by `valid`
  __shared__ float red_v[kMaxWarps];
  __shared__ int red_i[kMaxWarps];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const float* xb = xyz + (int64_t)b * N * 3;
  const uint8_t* vb = valid ? valid + (int64_t)b * N : nullptr;
  int64_t* ob = out + (int64_t)b * npoint;

  for (int p = tid; p < N; p += nthreads) {
    sx[p] = xb[3 * p];
    sy[p] = xb[3 * p + 1];
    sz[p] = xb[3 * p + 2];
    sd[p] = (vb == nullptr || vb[p]) ? kInit : -1.f;
  }
  __syncthreads();

  int far = 0;
  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) ob[it] = far;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float best = -INFINITY;
    int besti = INT_MAX;
    // each thread walks its points in increasing order, so a strict > keeps
    // its first maximum
    for (int p = tid; p < N; p += nthreads) {
      float d = sd[p];
      if (d >= 0.f) {
        const float dx = __fsub_rn(sx[p], cx);
        const float dy = __fsub_rn(sy[p], cy);
        const float dz = __fsub_rn(sz[p], cz);
        const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        d = fminf(d, dd);
        sd[p] = d;
      }
      if (d > best) { best = d; besti = p; }
    }
    warp_argmax(best, besti);
    if (lane == 0) { red_v[warp] = best; red_i[warp] = besti; }
    __syncthreads();
    if (warp == 0) {
      float v = lane < nwarps ? red_v[lane] : -INFINITY;
      int i = lane < nwarps ? red_i[lane] : INT_MAX;
      warp_argmax(v, i);
      if (lane == 0) s_far = i;
    }
    __syncthreads();
    far = s_far;
  }
}

}  // namespace

extern "C" {

// xyz [B,N,3] float32, valid [B,N] bytes or null, out [B,npoint] int64.
// Returns a cudaError_t (0 = launched).
int achelous_farthest_point_sample(const void* xyz, const void* valid,
                                   void* out, int B, int N, int npoint,
                                   void* stream) {
  if (B <= 0 || N <= 0 || npoint < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 4 * (size_t)N;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // a thread a point up to 512: a step's latency is its points' shared
  // memory round trips, which more threads overlap
  int threads = (N + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  fps_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const uint8_t*>(valid),
      static_cast<int64_t*>(out), N, npoint);
  return (int)cudaGetLastError();
}

}  // extern "C"
