// Attention with a relative-position bias and talking heads for Hopper
// (sm_90a), with a plain C interface bound by ctypes in
// achelous_tpu_torch/ops/hopper_attention.py.
//
// K3 bias_attention_kernel
//   Replaces achelous_tpu/ops/pallas_attention.py `fused_bias_attention`
//   (_attn_kernel): for each batch element and query row n,
//     S_h[n, m]  = (q_h[n] . k_h[m]) * scale + bias[h, n, m]
//     A_g        = sum_h th1_w[g, h] * S_h + th1_b[g]       (head mix)
//     P_g        = softmax over the N keys m of A_g
//     Q_g        = sum_h th2_w[g, h] * P_h + th2_b[g]       (head mix)
//     out_g[n]   = sum_m Q_g[n, m] * v_g[m]
//   in float32, from float32 or bf16 inputs, to the input dtype.  The head
//   mixes are the reference's 1x1 convs, weights [g_out, h_in].
//   Bound: at the EfficientFormerV2-S0 shapes (h = 8, N = 100, dk = 32,
//   dv = 128, batch 1) one call reads ~0.4 MB of bf16 (q, k, v, the bias
//   table) and writes 0.2 MB, for ~26 MFLOP: a microsecond or less of
//   either on an H100, so latency and the short grid bound it.
//   Design: the head mixes couple all heads, so a block holds every head
//   for its query rows: one block per (batch, block of up to 4 query rows;
//   25 blocks at the S0 shape), its [h, rows, N] float32 logits in shared
//   memory beside its q rows.  Each thread computes logits for (head, key)
//   pairs from a key row held in registers; the head mixes run per (row,
//   key) column in registers, in place; the softmax runs one warp a row,
//   max-subtracted, over the N real keys (loop bounds replace the TPU
//   kernel's padding to 128 and its -1e9 mask); then v streams through
//   shared memory head by head, up to 64 KB of keys at a time, loaded by
//   every thread at once, and each thread accumulates up to 4 outputs of
//   the head.  Plain FMA loops: the products are the kernel's own, as in
//   the TPU kernel.  Rows per block drop below 4 only where the logits
//   would not fit in shared memory (large N).  (A first version with 16
//   rows a block and v read straight from memory, one key at a time, took
//   ~129 us a call at the S0 shape: 7 blocks, each waiting on a memory
//   round trip per key.  Batching 16 loads a thread into the staging and
//   hoisting the bias loads read slower, ~69 us against ~56 us, and was
//   taken out.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 4;      // query rows per block
constexpr int kMaxHeads = 8;
constexpr int kMaxDk = 64;
constexpr int kOut = 4;          // P.v outputs a thread holds at once
constexpr int kVChunk = 16384;   // floats of v staged at once (64 KB)
constexpr size_t kMaxSmem = 232448;   // what a block can opt into on sm_90

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// out_g = sum_h w[g, h] * s[h] + b[g] over every (row, key) column of the
// logits, in place
__device__ void head_mix(float* s_logit, const float* w, const float* bvec,
                         int H, int R, int N, int rows) {
  for (int i = threadIdx.x; i < rows * N; i += kThreads) {
    const int r = i / N, m = i % N;
    float s[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      s[h] = h < H ? s_logit[(h * R + r) * N + m] : 0.f;
#pragma unroll
    for (int g = 0; g < kMaxHeads; ++g) {
      if (g < H) {
        float acc = 0.f;
#pragma unroll
        for (int h = 0; h < kMaxHeads; ++h)
          if (h < H) acc = fmaf(w[g * H + h], s[h], acc);
        s_logit[(g * R + r) * N + m] = acc + bvec[g];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bias_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ bias,
                      const T* __restrict__ th1w, const T* __restrict__ th1b,
                      const T* __restrict__ th2w, const T* __restrict__ th2b,
                      T* __restrict__ out, int H, int N, int dk, int dv,
                      int R, int KC, float scale) {
  extern __shared__ float smem[];
  float* s_logit = smem;                  // [H][R][N]
  float* s_q = s_logit + H * R * N;       // [H][R][dk]
  float* s_w1 = s_q + H * R * dk;         // [H][H], then b1 [H]
  float* s_b1 = s_w1 + H * H;
  float* s_w2 = s_b1 + H;                 // [H][H], then b2 [H]
  float* s_b2 = s_w2 + H * H;
  float* s_v = s_b2 + H;                  // [KC][dv]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, N - row0);
  const int tid = threadIdx.x;
  const int64_t bh = (int64_t)b * H;

  for (int i = tid; i < H * R * dk; i += kThreads) {
    const int h = i / (R * dk), r = (i / dk) % R, c = i % dk;
    s_q[i] = r < rows ? load_f32(q + ((bh + h) * N + row0 + r) * dk + c) : 0.f;
  }
  for (int i = tid; i < H * H; i += kThreads) {
    s_w1[i] = load_f32(th1w + i);
    s_w2[i] = load_f32(th2w + i);
  }
  for (int i = tid; i < H; i += kThreads) {
    s_b1[i] = load_f32(th1b + i);
    s_b2[i] = load_f32(th2b + i);
  }
  __syncthreads();

  // logits: one (head, key) pair a thread, its key row in registers
  for (int i = tid; i < H * N; i += kThreads) {
    const int h = i / N, m = i % N;
    const T* kr = k + ((bh + h) * N + m) * dk;
    float kreg[kMaxDk];
#pragma unroll
    for (int c = 0; c < kMaxDk; ++c) kreg[c] = c < dk ? load_f32(kr + c) : 0.f;
    const T* br = bias + ((int64_t)h * N + row0) * N + m;
    for (int r = 0; r < rows; ++r) {
      const float* qr = s_q + (h * R + r) * dk;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxDk; ++c)
        if (c < dk) s = fmaf(qr[c], kreg[c], s);
      s_logit[(h * R + r) * N + m] = s * scale + load_f32(br + (int64_t)r * N);
    }
  }
  __syncthreads();

  head_mix(s_logit, s_w1, s_b1, H, R, N, rows);
  __syncthreads();

  // softmax over the N keys, one warp a (head, row)
  const int lane = tid & 31, warp = tid >> 5;
  for (int row = warp; row < H * rows; row += kThreads / 32) {
    float* p = s_logit + ((row / rows) * R + row % rows) * N;
    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) mx = fmaxf(mx, p[m]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < N; m += 32) {
      const float e = expf(p[m] - mx);
      p[m] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int m = lane; m < N; m += 32) p[m] = p[m] / sum;
  }
  __syncthreads();

  head_mix(s_logit, s_w2, s_b2, H, R, N, rows);
  __syncthreads();

  // out = P @ v, head by head: a chunk of KC keys of v_g (contiguous in
  // memory) is staged in shared memory by every thread at once, so one
  // round trip to memory serves the whole chunk; each thread then owns up
  // to kOut (row, value column) outputs of the head
  for (int g = 0; g < H; ++g) {
    const T* vg = v + (bh + g) * N * dv;
    const float* pg = s_logit + g * R * N;
    for (int o0 = 0; o0 < rows * dv; o0 += kThreads * kOut) {
      float acc[kOut];
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[j] = 0.f;
      for (int m0 = 0; m0 < N; m0 += KC) {
        const int kc = min(KC, N - m0);
        __syncthreads();                  // the last chunk is consumed
        for (int i = tid; i < kc * dv; i += kThreads)
          s_v[i] = load_f32(vg + (int64_t)m0 * dv + i);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          const int o = o0 + j * kThreads + tid;
          if (o < rows * dv) {
            const float* p = pg + (o / dv) * N + m0;
            const float* vc = s_v + o % dv;
            float a = acc[j];
            for (int m = 0; m < kc; ++m) a = fmaf(p[m], vc[m * dv], a);
            acc[j] = a;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int o = o0 + j * kThreads + tid;
        if (o < rows * dv)
          store(out + ((bh + g) * N + row0 + o / dv) * dv + o % dv, acc[j]);
      }
    }
  }
}

size_t smem_bytes(int H, int R, int N, int dk, int KC, int dv) {
  return sizeof(float) * ((size_t)H * R * N + (size_t)H * R * dk +
                          2 * (size_t)H * H + 2 * H + (size_t)KC * dv);
}

template <typename T>
cudaError_t launch_attention(const void* const* in, void* out, int B, int H,
                             int N, int dk, int dv, float scale,
                             cudaStream_t stream) {
  const int KC = max(1, min(N, kVChunk / dv));
  int R = kMaxRows;
  while (R > 1 && smem_bytes(H, R, N, dk, KC, dv) > kMaxSmem) R /= 2;
  const size_t smem = smem_bytes(H, R, N, dk, KC, dv);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bias_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((N + R - 1) / R, B);
  bias_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<T*>(out), H, N, dk, dv, R, KC, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k [B,H,N,dk]; v [B,H,N,dv]; bias [H,N,N]; th1w, th2w [H,H]; th1b, th2b
// [H]; out [B,H,N,dv]; all contiguous, of one dtype: 0 = float32, 1 = bf16.
// Returns a cudaError_t (0 = launched).
int achelous_bias_attention(const void* q, const void* k, const void* v,
                            const void* bias, const void* th1w,
                            const void* th1b, const void* th2w,
                            const void* th2b, void* out, int B, int H, int N,
                            int dk, int dv, float scale, int dtype,
                            void* stream) {
  if (B <= 0 || H < 1 || H > kMaxHeads || N <= 0 || dk < 1 || dk > kMaxDk ||
      dv <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* in[8] = {q, k, v, bias, th1w, th1b, th2w, th2b};
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
      ? launch_attention<float>(in, out, B, H, N, dk, dv, scale, s)
      : launch_attention<__nv_bfloat16>(in, out, B, H, N, dk, dv, scale, s));
}

}  // extern "C"
