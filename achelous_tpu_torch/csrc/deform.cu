// RCNet's deformable-conv kernels for Hopper (sm_90a), with a plain C
// interface bound by ctypes in achelous_tpu_torch/ops/hopper_deform.py.
//
// Both kernels take float32 or bf16 tensors in NCHW and compute in float32.
// Tap order is ki = ky*3 + kx; offset channel 2ki is dy and 2ki+1 is dx; a
// tap samples (y + ky - 1 + dy, x + kx - 1 + dx) bilinearly, with corners
// outside the image reading 0.  An integer band clips dy/dx to
// [-band, band] first.  The bilinear weights come from the offset's own
// fractional part, o - floor(o), exactly as the plain versions in
// ops/deform.py compute them.
//
// K1 fused_radarconv_kernel
//   Replaces achelous_tpu/ops/pallas_deform.py `pallas_fused_radarconv`
//   (_fused_impl / _fused_kernel): a whole RadarConv - 3x3 avg-pool,
//   offset and modulator convs, banded sampling, [9C -> Cout] projection -
//   with only the raw input and the Cout planes in device memory.
//   Bound: at batch 1 nothing here is large.  RCNet block 0 (C = 3 at
//   320^2) moves about 1.2 MB of bf16 (0.6 MB in, 0.6 MB out) for roughly
//   0.2 GFLOP, microseconds of bandwidth or math on an H100, so latency
//   and the number of warps in flight bound it.
//   Design:
//   - One launch a call.  The weights come packed by the caller
//     (ops/hopper_deform.py pack_radarconv_weights, cached by the module):
//     for each tap, its three conv outputs (dy, dx, modulator) over the 9C
//     inputs as a float4 row, so a thread reads them with one broadcast
//     128-bit shared load an input.
//   - Square output tiles; 9 / k threads a pixel, each with k taps of it
//     (k = 1, 3 or 9).  A tap needs only its own three conv outputs, so
//     the 27-output conv splits by taps with no recompute, and a pooled
//     value read once feeds 3k accumulators.  The launch takes the largest
//     tile and k that still put ~16 warps on each of the 132 SMs: 16x16
//     tiles with k = 9 at 320^2 (400 blocks of 8 warps; the larger tile
//     pools less halo), 8x8 with k = 3 at 160^2 (400 of 6), 8x8 with k = 1
//     at 80^2 (100 of 18).
//     Taps are uniform across a warp, so every weight read is a broadcast;
//     each thread samples its taps for the C channels and forms its Cout
//     projection partials, which meet in shared memory and are summed in
//     tap order.  Channel loops are unrolled to the cap of 8 and guarded.
//   - The raw tile with a halo of band + 3 is staged in shared memory by
//     16-byte cp.async copies, its column window widened to 16-byte
//     boundaries (chunks outside the image are zero-filled by plain
//     stores; a width or base address that breaks the alignment takes
//     scalar loads instead).  The 3x3 pool is separable in shared memory:
//     3-tap row sums, then 3-tap column sums over 9.
//   - The conv runs as float32 FMAs for both input types: its inputs are
//     the pooled values, which are not bf16-exact, so tensor cores would
//     need a hi/lo split for either dtype.  At block 0 its 149 M FMAs take
//     ~4.5 us of the card's float32 rate: the floor of this design there.
//   At band 4, C = 8: 12.8 KB pooled tile, 8.4 KB raw tile (bf16), 14 KB
//   row sums (reused for the partials) and 12.8 KB weights: ~48 KB, above
//   the default 48 KB, so the launch opts in to what it needs.
//
// K2 deform_samples_kernel
//   Replaces achelous_tpu/ops/pallas_deform.py `pallas_deform_samples_cfio`
//   (and its NHWC siblings; _pallas_deform_cf_impl / _deform_kernel): the
//   modulated samples [B, 9C, H, W] of blocks whose offsets come from
//   convs outside the kernel; the projection stays a matmul, as in JAX.
//   Bound: memory and latency.  RCNet blocks 4-7 at batch 1 are 40^2 and
//   20^2 maps with C = 12 and 24; the largest call writes 0.35 MB of bf16.
//   The first design, a thread per (batch, tap, pixel) looping over all C
//   channels from global memory, gave 57 blocks at 40^2 and 15 at 20^2 on
//   132 SMs, and each thread waited ~C rounds of L2 latency.
//   Design:
//   - A block takes (batch, an output tile of 8 or 4 rows x 8 pixels, a
//     group of G channels), a thread per (tap, pixel): 576 or 288 threads,
//     the tap uniform across each warp.  The plan
//     (hopper_deform.deform_samples_plan, in Python so the CPU tests pin
//     it) takes the largest G in 8, 4, 2, 1, then the taller tile, that
//     still give two blocks per SM: G = 2 on 4x8 tiles at 40^2 with
//     C = 12 (300 blocks), G = 1 on 4x8 at 20^2 with C = 24 (360).
//   - Each thread reads its tap's offset and mask, clips the offset to the
//     band, and forms its base corner, four bilinear weights and four
//     in-image tests once; then it loops over the G channels, unrolled by
//     the compile-time G, gathering the four corners from global memory
//     (L1 and L2 hold the whole map at these sizes) and writing rows of the
//     tile.  The same kernel serves every band and band = None (offsets
//     unbounded): an out-of-image corner is skipped, so it reads 0.
//   - Staging the band-limited window in shared memory by cp.async, the
//     first design of this kernel's redesign, was built and measured on
//     the H100 against this gather on the same tiles, and dropped: at
//     band 4, bf16, the staged blocks' first phase (offsets, copies,
//     barrier) took 1990-3470 cycles against 420-940, and the gather was
//     0.5-1.4 us a call faster at both serving shapes in each of seven
//     calls (kernels/sweep.py; PERF.md, K2's findings).  A map is 19-38 KB
//     of bf16, which L2 holds between the calls that write and read it, so
//     staging only added a copy and a barrier before the first sample.

// The TPU kernels' row tiling, 8-aligned halos and per-image offset tiers
// were TPU cost devices that change no value; a direct 4-corner gather
// replaces them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_clock.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kMaxC = 8;       // K1 channel cap, in and out

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float clip_band(float o, int band) {
  return band < 0 ? o : fminf(fmaxf(o, -(float)band), (float)band);
}

// a K1 launch aims for this many warps in flight (132 SMs x 16)
constexpr int kFillWarps = 132 * 16;


__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory plan of one K1 block, in floats (every part starts on a
// 16-byte boundary): packed weights, the pooled tile, then a region that
// holds the raw tile and its row sums and, once the pool is built, the
// projection partials of the `groups` tap groups.
struct FusedPlan {
  int P, AR, RH, RW, PS;              // halos, raw tile, pooled tile edge
  int wconv, bconv, wproj, pool, raw, hsum, part, total;
  __host__ __device__ FusedPlan(int kT, int C, int Cout, int band, int vec,
                                int groups) {
    P = band + 2;                       // pooled halo: tap 1 + band + corner 1
    const int R = P + 1;                // raw halo: one more for the pool
    AR = (R + vec - 1) / vec * vec;     // raw column halo, 16-byte aligned
    RH = kT + 2 * R;
    RW = kT + 2 * AR;
    PS = kT + 2 * P;
    wconv = 0;
    bconv = wconv + kTaps * kTaps * C * 4;
    wproj = bconv + kTaps * 4;
    pool = wproj + kTaps * C * kMaxC;   // rows padded to kMaxC
    raw = pool + up4(C * PS * PS);
    // the raw tile in floats: its elements take 16 / vec bytes each
    hsum = raw + up4((C * RH * RW * (16 / vec) + 3) / 4);
    part = raw;
    const int end = hsum + C * RH * PS;
    total = max(end, part + groups * Cout * kT * kT);
  }
};

// kT x kT output tiles, kTPT taps a thread (1, 3 or 9): 9 / kTPT
// threads a pixel
// (16x16 tiles with 9 taps a thread hold <= 64 registers, so that 4
// blocks share an SM: 528 places for the 400 blocks of a 320^2 map)
template <typename T, int kT, int kTPT>
__global__ void __launch_bounds__(kTaps / kTPT * kT * kT, kTPT == 9 ? 4 : 1)
fused_radarconv_kernel(const T* __restrict__ x, const float* __restrict__ wconv,
                       const float* __restrict__ bconv,
                       const float* __restrict__ wproj, T* __restrict__ out,
                       int C, int Cout, int H, int W, int band, int vec_ok) {
  constexpr int kPix = kT * kT;
  constexpr int kGroups = kTaps / kTPT;
  constexpr int kThreads = kGroups * kPix;
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) float smem[];
  PHASE(0);
  const FusedPlan plan(kT, C, Cout, band, kVec, kGroups);
  const int P = plan.P, AR = plan.AR, RH = plan.RH, RW = plan.RW,
            PS = plan.PS;
  float* s_wconv = smem + plan.wconv;    // [9 taps][9C][4]
  float* s_bconv = smem + plan.bconv;    // [9 taps][4]
  float* s_wproj = smem + plan.wproj;    // [9C][8], 0 past Cout
  float* s_pool = smem + plan.pool;      // [C][PS][PS], 0 outside the image
  T* s_raw = reinterpret_cast<T*>(smem + plan.raw);   // [C][RH][RW]
  float* s_hsum = smem + plan.hsum;      // [C][RH][PS]
  float* s_part = smem + plan.part;      // [groups][Cout][64]

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kT, tx0 = blockIdx.x * kT;
  const int tid = threadIdx.x;
  const int HW = H * W;
  const T* xb = x + (int64_t)b * C * HW;
  const int ry0 = ty0 - P - 1, rx0 = tx0 - AR;   // raw tile origin

  // stage weights and the raw tile
  const int nconv4 = kTaps * kTaps * C + kTaps;   // wconv then bconv
  for (int i = tid; i < nconv4; i += kThreads)
    cp_async16(smem + 4 * i, i < kTaps * kTaps * C
               ? wconv + 4 * i : bconv + 4 * (i - kTaps * kTaps * C));
  for (int i = tid; i < kTaps * C * kMaxC; i += kThreads) {
    const int row = i / kMaxC, co = i % kMaxC;
    if (co < Cout)
      cp_async4(s_wproj + i, wproj + row * Cout + co);
    else
      s_wproj[i] = 0.f;
  }
  const int chunks = RW / kVec;
  for (int i = tid; i < C * RH * chunks; i += kThreads) {
    const int c = i / (RH * chunks), r = (i / chunks) % RH, j = i % chunks;
    const int gy = ry0 + r, gx = rx0 + j * kVec;
    T* dst = s_raw + (c * RH + r) * RW + j * kVec;
    const T* src = xb + (int64_t)c * HW + (int64_t)gy * W + gx;
    const bool row_in = gy >= 0 && gy < H;
    if (vec_ok) {
      // W is a multiple of kVec, so a chunk is wholly in or out
      if (row_in && gx >= 0 && gx < W)
        cp_async16(dst, src);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    } else {
      for (int e = 0; e < kVec; ++e) {
        const bool in = row_in && gx + e >= 0 && gx + e < W;
        dst[e] = in ? src[e] : T(0.f);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  PHASE(1);

  // 3x3 stride-1 avg-pool, count_include_pad, separable: row sums of 3 ...
  // (rows and columns stepped without a division an element)
  const int drow = kThreads / PS, dcol = kThreads % PS;
  for (int row = tid / PS, j = tid % PS; row < C * RH;) {
    const T* rr = s_raw + row * RW + AR - P - 1 + j;
    s_hsum[row * PS + j] = load_f32(rr) + load_f32(rr + 1) + load_f32(rr + 2);
    row += drow;
    j += dcol;
    if (j >= PS) j -= PS, ++row;
  }
  __syncthreads();
  PHASE(2);
  // ... then column sums of 3 over 9; pooled values outside the image are 0
  for (int c = tid / PS / PS, r = tid / PS % PS, j = tid % PS; c < C;) {
    const int gy = ty0 - P + r, gx = tx0 - P + j;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* hs = s_hsum + (c * RH + r) * PS + j;
      v = (hs[0] + hs[PS] + hs[2 * PS]) * (1.f / 9.f);
    }
    s_pool[(c * PS + r) * PS + j] = v;
    r += drow;
    j += dcol;
    if (j >= PS) j -= PS, ++r;
    while (r >= PS) r -= PS, ++c;
  }
  __syncthreads();
  PHASE(3);

  // one (tap group, pixel) a thread; the group is uniform across each warp
  const int grp = tid / kPix, pix = tid % kPix;
  const int ly = pix / kT, lx = pix % kT;
  const int tap0 = grp * kTPT;

  // the taps' offset (dy, dx) and modulator convs, 3x3 SAME over the
  // pool: each pooled value feeds the 3 kTPT accumulators it meets
  const float4* wt = reinterpret_cast<const float4*>(s_wconv);
  float acc[kTPT][3];
#pragma unroll
  for (int t = 0; t < kTPT; ++t) {
#pragma unroll
    for (int o = 0; o < 3; ++o) acc[t][o] = s_bconv[4 * (tap0 + t) + o];
  }
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const float* pr = s_pool + (ly + P - 1 + k / 3) * PS + lx + P - 1 + k % 3;
#pragma unroll
    for (int ci = 0; ci < kMaxC; ++ci) {
      if (ci < C) {
        const float pv = pr[ci * PS * PS];
#pragma unroll
        for (int t = 0; t < kTPT; ++t) {
          const float4 w4 = wt[((tap0 + t) * kTaps + k) * C + ci];
          acc[t][0] = fmaf(w4.x, pv, acc[t][0]);
          acc[t][1] = fmaf(w4.y, pv, acc[t][1]);
          acc[t][2] = fmaf(w4.z, pv, acc[t][2]);
        }
      }
    }
  }

  PHASE(4);
  float proj[kMaxC];
#pragma unroll
  for (int co = 0; co < kMaxC; ++co) proj[co] = 0.f;
#pragma unroll
  for (int t = 0; t < kTPT; ++t) {
    const int tap = tap0 + t;
    const float oy = clip_band(acc[t][0], band);
    const float ox = clip_band(acc[t][1], band);
    const float m = 2.f / (1.f + expf(-acc[t][2]));
    const float fy = floorf(oy), fx = floorf(ox);
    const float wy1 = oy - fy, wx1 = ox - fx;
    const float w00 = (1.f - wy1) * (1.f - wx1), w01 = (1.f - wy1) * wx1;
    const float w10 = wy1 * (1.f - wx1), w11 = wy1 * wx1;
    // tile coordinates: |o| <= band keeps every corner inside the halo
    const int sy = ly + P + tap / 3 - 1 + (int)fy;
    const int sx = lx + P + tap % 3 - 1 + (int)fx;
#pragma unroll
    for (int ci = 0; ci < kMaxC; ++ci) {
      if (ci < C) {
        const float* pc = s_pool + (ci * PS + sy) * PS + sx;
        float s = pc[0] * w00;
        s += pc[1] * w01;
        s += pc[PS] * w10;
        s += pc[PS + 1] * w11;
        s *= m;
        // a padded row: two broadcast 128-bit loads, 0 past Cout
        const float4* wp =
            reinterpret_cast<const float4*>(s_wproj + (tap * C + ci) * kMaxC);
        const float4 w0 = wp[0], w1 = wp[1];
        proj[0] = fmaf(w0.x, s, proj[0]);
        proj[1] = fmaf(w0.y, s, proj[1]);
        proj[2] = fmaf(w0.z, s, proj[2]);
        proj[3] = fmaf(w0.w, s, proj[3]);
        proj[4] = fmaf(w1.x, s, proj[4]);
        proj[5] = fmaf(w1.y, s, proj[5]);
        proj[6] = fmaf(w1.z, s, proj[6]);
        proj[7] = fmaf(w1.w, s, proj[7]);
      }
    }
  }
  // the raw tile and row sums are dead: their space takes the partials
#pragma unroll
  for (int co = 0; co < kMaxC; ++co)
    if (co < Cout) s_part[(grp * Cout + co) * kPix + pix] = proj[co];
  __syncthreads();
  PHASE(5);

  for (int i = tid; i < Cout * kPix; i += kThreads) {
    const int co = i / kPix, p = i % kPix;
    const int y = ty0 + p / kT, xq = tx0 + p % kT;
    if (y >= H || xq >= W) continue;
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      sum += s_part[(g * Cout + co) * kPix + p];
    store(out + ((int64_t)b * Cout + co) * HW + y * W + xq, sum);
  }
  PHASE(6);
}

template <typename T, int kT, int kTPT>
cudaError_t launch_fused_tile(const T* x, const float* wconv,
                              const float* bconv, const float* wproj, T* out,
                              int B, int C, int Cout, int H, int W, int band,
                              cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kThreads = kTaps / kTPT * kT * kT;
  const size_t smem = sizeof(float) *
      FusedPlan(kT, C, Cout, band, kVec, kTaps / kTPT).total;
  if (smem > 232448) return cudaErrorInvalidValue;   // band too large
  // opting in costs a driver call: make it once per size reached
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_radarconv_kernel<T, kT, kTPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const int vec_ok =
      W % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT, B);
  fused_radarconv_kernel<T, kT, kTPT><<<grid, kThreads, smem, stream>>>(
      x, wconv, bconv, wproj, out, C, Cout, H, W, band, vec_ok);
  return cudaGetLastError();
}

// Tile and taps a thread from the grid: the fewest threads a pixel, on the
// largest tile (less halo to pool), that still put kFillWarps warps in
// flight.  Serving shapes: 320^2 takes 16x16 tiles with 9 taps a thread
// (400 blocks of 8 warps), 160^2 8x8 with 3 (400 of 6), 80^2 8x8 with 1
// (100 of 18).
template <typename T>
cudaError_t launch_fused(const void* x, const float* wconv, const float* bconv,
                         const float* wproj, void* out, int B, int C, int Cout,
                         int H, int W, int band, cudaStream_t stream) {
  // the packed weights are copied 16 bytes at a time
  if (reinterpret_cast<uintptr_t>(wconv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bconv) % 16 != 0)
    return cudaErrorMisalignedAddress;
  auto blocks = [&](int t) {
    return (int64_t)B * ((H + t - 1) / t) * ((W + t - 1) / t);
  };
  auto xt = static_cast<const T*>(x);
  auto ot = static_cast<T*>(out);
  if (blocks(16) * 8 >= kFillWarps)
    return launch_fused_tile<T, 16, 9>(xt, wconv, bconv, wproj, ot, B, C,
                                       Cout, H, W, band, stream);
  if (blocks(8) * 6 >= kFillWarps)
    return launch_fused_tile<T, 8, 3>(xt, wconv, bconv, wproj, ot, B, C,
                                      Cout, H, W, band, stream);
  return launch_fused_tile<T, 8, 1>(xt, wconv, bconv, wproj, ot, B, C, Cout,
                                    H, W, band, stream);
}

// K2: the samples of one (batch, kTH x 8 output tile, group of kG channels)
// a block, a thread per (tap, pixel), the four corners gathered from
// global memory.
constexpr int kSampTile = 8;                       // tile width

template <typename T, int kTH, int kG>
__global__ void __launch_bounds__(kTaps * kTH * kSampTile, 2)
deform_samples_kernel(const T* __restrict__ x, const T* __restrict__ off,
                      const T* __restrict__ mask, T* __restrict__ out,
                      int C, int H, int W, int band) {
  constexpr int kSampPix = kTH * kSampTile;        // a multiple of 32
  PHASE(0);
  const int groups = (C + kG - 1) / kG;
  const int b = blockIdx.z / groups;
  const int cg = (blockIdx.z - b * groups) * kG;   // first channel
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kSampTile;
  const int HW = H * W;
  const int tid = threadIdx.x;

  const int tap = tid / kSampPix, pix = tid % kSampPix;
  const int y = y0 + pix / kSampTile, xq = x0 + pix % kSampTile;
  if (y >= H || xq >= W) return;
  const int p = y * W + xq;
  // the wrapper keeps every index below 2^31
  const float oy = clip_band(load_f32(off + (b * 2 * kTaps + 2 * tap) * HW + p),
                             band);
  const float ox = clip_band(
      load_f32(off + (b * 2 * kTaps + 2 * tap + 1) * HW + p), band);
  const float m = load_f32(mask + (b * kTaps + tap) * HW + p);
  PHASE(1);

  // the base corner and four bilinear weights, once for the kG channels
  const float fy = floorf(oy), fx = floorf(ox);
  const float wy1 = oy - fy, wx1 = ox - fx;     // the offset's own fraction
  const float w00 = (1.f - wy1) * (1.f - wx1), w01 = (1.f - wy1) * wx1;
  const float w10 = wy1 * (1.f - wx1), w11 = wy1 * wx1;
  // clamping the integer part keeps far-out offsets outside the image and
  // the float->int cast in range
  const int yb = y + tap / 3 - 1 +
      (int)fminf(fmaxf(fy, -(float)(H + 2)), (float)(H + 2));
  const int xb = xq + tap % 3 - 1 +
      (int)fminf(fmaxf(fx, -(float)(W + 2)), (float)(W + 2));
  const bool vy0 = yb >= 0 && yb < H, vy1 = yb + 1 >= 0 && yb + 1 < H;
  const bool vx0 = xb >= 0 && xb < W, vx1 = xb + 1 >= 0 && xb + 1 < W;
  const bool v00 = vy0 && vx0, v01 = vy0 && vx1;
  const bool v10 = vy1 && vx0, v11 = vy1 && vx1;
  const int base = yb * W + xb;
  PHASE(2);

  T* ob = out + ((b * kTaps + tap) * C + cg) * HW + p;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (cg + g < C) {
      const T* xc = x + (b * C + cg + g) * HW + base;
      float s = 0.f;
      if (v00) s += load_f32(xc) * w00;
      if (v01) s += load_f32(xc + 1) * w01;
      if (v10) s += load_f32(xc + W) * w10;
      if (v11) s += load_f32(xc + W + 1) * w11;
      store(ob + g * HW, s * m);
    }
  }
  PHASE(3);
}

template <typename T, int kTH, int kG>
cudaError_t launch_samples(const T* x, const T* off, const T* mask, T* out,
                           int B, int C, int H, int W, int band,
                           cudaStream_t stream) {
  constexpr int kSampThreads = kTaps * kTH * kSampTile;
  const int groups = (C + kG - 1) / kG;
  const dim3 grid((W + kSampTile - 1) / kSampTile, (H + kTH - 1) / kTH,
                  B * groups);
  if (grid.y > 65535 || (int64_t)B * groups > 65535)
    return cudaErrorInvalidValue;
  deform_samples_kernel<T, kTH, kG><<<grid, kSampThreads, 0, stream>>>(
      x, off, mask, out, C, H, W, band);
  return cudaGetLastError();
}

template <typename T, int kTH>
cudaError_t dispatch_group(const T* x, const T* off, const T* mask, T* out,
                           int B, int C, int H, int W, int band, int group,
                           cudaStream_t s) {
  switch (group) {
    case 1:
      return launch_samples<T, kTH, 1>(x, off, mask, out, B, C, H, W, band, s);
    case 2:
      return launch_samples<T, kTH, 2>(x, off, mask, out, B, C, H, W, band, s);
    case 4:
      return launch_samples<T, kTH, 4>(x, off, mask, out, B, C, H, W, band, s);
    case 8:
      return launch_samples<T, kTH, 8>(x, off, mask, out, B, C, H, W, band, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_samples(const void* x, const void* off, const void* mask,
                             void* out, int B, int C, int H, int W, int band,
                             int rows, int group, cudaStream_t s) {
  auto xt = static_cast<const T*>(x);
  auto ot = static_cast<const T*>(off);
  auto mt = static_cast<const T*>(mask);
  auto st = static_cast<T*>(out);
  if (rows == 8)
    return dispatch_group<T, 8>(xt, ot, mt, st, B, C, H, W, band, group, s);
  if (rows == 4)
    return dispatch_group<T, 4>(xt, ot, mt, st, B, C, H, W, band, group, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bf16.  Returns a cudaError_t (0 = launched).
int achelous_fused_radarconv(const void* x, const void* wconv,
                             const void* bconv, const void* wproj, void* out,
                             int B, int C, int Cout, int H, int W, int band,
                             int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C < 1 || C > kMaxC || Cout < 1 ||
      Cout > kMaxC || band < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto wc = static_cast<const float*>(wconv);
  auto bc = static_cast<const float*>(bconv);
  auto wp = static_cast<const float*>(wproj);
  return (int)(dtype == 0
      ? launch_fused<float>(x, wc, bc, wp, out, B, C, Cout, H, W, band, s)
      : launch_fused<__nv_bfloat16>(x, wc, bc, wp, out, B, C, Cout, H, W,
                                    band, s));
}

// band < 0: no clip.  dtype as above.  The launch plan comes from
// hopper_deform.deform_samples_plan: tiles of `rows` (8 or 4) x 8 pixels,
// `group` channels a block (1, 2, 4 or 8).
int achelous_deform_samples(const void* x, const void* off, const void* mask,
                            void* out, int B, int C, int H, int W, int band,
                            int dtype, int rows, int group, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
      ? dispatch_samples<float>(x, off, mask, out, B, C, H, W, band, rows,
                                group, s)
      : dispatch_samples<__nv_bfloat16>(x, off, mask, out, B, C, H, W, band,
                                        rows, group, s));
}

#if ACHELOUS_PHASE_CLOCKS
// The phase stamps since the last call (kPhaseBlocks x kPhases) into
// host memory; then zeroes them.
int achelous_deform_phase_clocks(long long* dst) {
  cudaError_t err =
      cudaMemcpyFromSymbol(dst, g_phase_clock, sizeof(g_phase_clock));
  void* dev = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&dev, g_phase_clock);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(g_phase_clock));
  return (int)err;
}
#endif

const char* achelous_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
