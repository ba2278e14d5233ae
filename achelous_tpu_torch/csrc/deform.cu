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
//   0.2 GFLOP, microseconds of bandwidth or math on an H100, so launch and
//   latency bound it.  Design: one launch per RadarConv, which removes the
//   pool, the two convs, the samples tensor and the projection as separate
//   launches and round trips.  A 16x16 block stages the pooled tile with a
//   halo of band+2 in shared memory (the raw tile is not kept: each pooled
//   value reads its 9 raw inputs through L1), holds the conv and projection
//   weights in shared memory, and each thread keeps its pixel's 27
//   offset/modulator values and Cout <= 8 accumulators in registers.
//   At band 4, C = 8: 25 KB pooled tile + 10 KB weights, under the 48 KB a
//   block gets without opting in (larger bands opt in below).
//
// K2 deform_samples_kernel
//   Replaces achelous_tpu/ops/pallas_deform.py `pallas_deform_samples_cfio`
//   (and its NHWC siblings; _pallas_deform_cf_impl / _deform_kernel): the
//   modulated samples [B, 9C, H, W] of blocks whose offsets come from
//   convs outside the kernel; the projection stays a matmul, as in JAX.
//   Bound: memory and latency.  RCNet blocks 4-7 at batch 1 are 40^2 and
//   20^2 maps with C = 12 and 24; the largest call writes 0.35 MB of bf16.
//   Design: one thread per (batch, tap, pixel), so even the 20^2 maps give
//   3600 threads; neighbouring threads take neighbouring pixels of one tap,
//   so offset/mask reads and sample writes coalesce, and the 4-corner
//   gathers hit L1/L2.  band < 0 means no clip: the same kernel serves the
//   exact (unbanded) path.
//
// The TPU kernels' row tiling, 8-aligned halos and per-image offset tiers
// were TPU cost devices that change no value; a direct 4-corner gather
// replaces them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int kMaxC = 8;       // K1 channel cap, in and out
constexpr int kTile = 16;      // K1 output tile edge

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

template <typename T>
__global__ void __launch_bounds__(256)
deform_samples_kernel(const T* __restrict__ x, const T* __restrict__ off,
                      const T* __restrict__ mask, T* __restrict__ out,
                      int B, int C, int H, int W, int band) {
  const int HW = H * W;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * kTaps * HW) return;
  const int p = idx % HW;
  const int ki = (idx / HW) % kTaps;
  const int b = idx / (HW * kTaps);
  const int y = p / W, xq = p % W;

  const float oy = clip_band(load_f32(off + (b * 2 * kTaps + 2 * ki) * HW + p), band);
  const float ox = clip_band(load_f32(off + (b * 2 * kTaps + 2 * ki + 1) * HW + p), band);
  const float m = load_f32(mask + (b * kTaps + ki) * HW + p);
  const float fy = floorf(oy), fx = floorf(ox);
  const float wy1 = oy - fy, wx1 = ox - fx;
  // clamping the integer part keeps far-out offsets outside the image and
  // the float->int cast in range
  const int y0 = y + ki / 3 - 1 + (int)fminf(fmaxf(fy, -(float)(H + 2)), (float)(H + 2));
  const int x0 = xq + ki % 3 - 1 + (int)fminf(fmaxf(fx, -(float)(W + 2)), (float)(W + 2));
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const float w00 = (1.f - wy1) * (1.f - wx1), w01 = (1.f - wy1) * wx1;
  const float w10 = wy1 * (1.f - wx1), w11 = wy1 * wx1;

  const T* xb = x + (int64_t)b * C * HW;
  T* ob = out + ((int64_t)b * kTaps + ki) * C * HW + p;
  for (int c = 0; c < C; ++c) {
    const T* xc = xb + c * HW;
    float s = 0.f;
    if (vy0 && vx0) s += load_f32(xc + y0 * W + x0) * w00;
    if (vy0 && vx1) s += load_f32(xc + y0 * W + x0 + 1) * w01;
    if (vy1 && vx0) s += load_f32(xc + (y0 + 1) * W + x0) * w10;
    if (vy1 && vx1) s += load_f32(xc + (y0 + 1) * W + x0 + 1) * w11;
    store(ob + c * HW, s * m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
fused_radarconv_kernel(const T* __restrict__ x, const float* __restrict__ wconv,
                       const float* __restrict__ bconv,
                       const float* __restrict__ wproj, T* __restrict__ out,
                       int C, int Cout, int H, int W, int band) {
  extern __shared__ float smem[];
  const int P = band + 2;                  // pooled halo: tap 1 + band + corner 1
  const int SH = kTile + 2 * P, SW = kTile + 2 * P;
  float* s_pool = smem;                    // [C][SH][SW], 0 outside the image
  float* s_wconv = s_pool + C * SH * SW;   // [9C][27]
  float* s_bconv = s_wconv + kTaps * C * 27;
  float* s_wproj = s_bconv + 27;           // [9C][Cout]

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kTile;
  const int HW = H * W;
  const T* xb = x + (int64_t)b * C * HW;

  for (int i = tid; i < kTaps * C * 27; i += nthreads) s_wconv[i] = wconv[i];
  for (int i = tid; i < 27; i += nthreads) s_bconv[i] = bconv[i];
  for (int i = tid; i < kTaps * C * Cout; i += nthreads) s_wproj[i] = wproj[i];

  // 3x3 stride-1 avg-pool, count_include_pad: the sum of the in-image
  // inputs over 9; pooled values outside the image are 0
  for (int i = tid; i < C * SH * SW; i += nthreads) {
    const int c = i / (SH * SW), r = i % (SH * SW);
    const int gy = ty0 - P + r / SW, gx = tx0 - P + r % SW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const T* xc = xb + c * HW;
      float s = 0.f;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = gy + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = gx + dx;
          if (xx >= 0 && xx < W) s += load_f32(xc + yy * W + xx);
        }
      }
      v = s * (1.f / 9.f);
    }
    s_pool[i] = v;
  }
  __syncthreads();

  const int ly = threadIdx.y, lx = threadIdx.x;
  const int y = ty0 + ly, xq = tx0 + lx;
  if (y >= H || xq >= W) return;

  // offset (0..17) and modulator (18..26) convs, 3x3 SAME over the pooled map
  float acc[27];
#pragma unroll
  for (int o = 0; o < 27; ++o) acc[o] = 0.f;
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      for (int ci = 0; ci < C; ++ci) {
        const float pv = s_pool[(ci * SH + ly + P - 1 + ky) * SW + lx + P - 1 + kx];
        const float* wr = s_wconv + ((ky * 3 + kx) * C + ci) * 27;
#pragma unroll
        for (int o = 0; o < 27; ++o) acc[o] = fmaf(wr[o], pv, acc[o]);
      }
    }
  }

  float proj[kMaxC];
#pragma unroll
  for (int co = 0; co < kMaxC; ++co) proj[co] = 0.f;
#pragma unroll
  for (int ki = 0; ki < kTaps; ++ki) {
    const float oy = clip_band(acc[2 * ki] + s_bconv[2 * ki], band);
    const float ox = clip_band(acc[2 * ki + 1] + s_bconv[2 * ki + 1], band);
    const float m = 2.f / (1.f + expf(-(acc[18 + ki] + s_bconv[18 + ki])));
    const float fy = floorf(oy), fx = floorf(ox);
    const float wy1 = oy - fy, wx1 = ox - fx;
    const float w00 = (1.f - wy1) * (1.f - wx1), w01 = (1.f - wy1) * wx1;
    const float w10 = wy1 * (1.f - wx1), w11 = wy1 * wx1;
    // tile coordinates: |o| <= band keeps every corner inside the halo
    const int sy = ly + P + ki / 3 - 1 + (int)fy;
    const int sx = lx + P + ki % 3 - 1 + (int)fx;
    for (int ci = 0; ci < C; ++ci) {
      const float* pc = s_pool + (ci * SH + sy) * SW + sx;
      float s = pc[0] * w00;
      s += pc[1] * w01;
      s += pc[SW] * w10;
      s += pc[SW + 1] * w11;
      s *= m;
      const float* wp = s_wproj + (ki * C + ci) * Cout;
#pragma unroll
      for (int co = 0; co < kMaxC; ++co)
        if (co < Cout) proj[co] = fmaf(wp[co], s, proj[co]);
    }
  }
  T* ob = out + (int64_t)b * Cout * HW + y * W + xq;
#pragma unroll
  for (int co = 0; co < kMaxC; ++co)
    if (co < Cout) store(ob + co * HW, proj[co]);
}

template <typename T>
cudaError_t launch_fused(const void* x, const float* wconv, const float* bconv,
                         const float* wproj, void* out, int B, int C, int Cout,
                         int H, int W, int band, cudaStream_t stream) {
  const int P = band + 2;
  const size_t smem = sizeof(float) *
      ((size_t)C * (kTile + 2 * P) * (kTile + 2 * P) + kTaps * C * 27 + 27 +
       kTaps * C * Cout);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_radarconv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  dim3 block(kTile, kTile);
  fused_radarconv_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), wconv, bconv, wproj, static_cast<T*>(out), C,
      Cout, H, W, band);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_samples(const void* x, const void* off, const void* mask,
                           void* out, int B, int C, int H, int W, int band,
                           cudaStream_t stream) {
  const int total = B * kTaps * H * W;
  const int threads = 256;
  deform_samples_kernel<T><<<(total + threads - 1) / threads, threads, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(off),
      static_cast<const T*>(mask), static_cast<T*>(out), B, C, H, W, band);
  return cudaGetLastError();
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

// band < 0: no clip.  dtype as above.
int achelous_deform_samples(const void* x, const void* off, const void* mask,
                            void* out, int B, int C, int H, int W, int band,
                            int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
      ? launch_samples<float>(x, off, mask, out, B, C, H, W, band, s)
      : launch_samples<__nv_bfloat16>(x, off, mask, out, B, C, H, W, band, s));
}

const char* achelous_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
