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
//   either on an H100, so latency and the work a block does in sequence
//   bound it.
//   Design:
//   - One block a (16 query rows, output head g, 64 value columns): 112
//     blocks of 8 warps at the S0 shape, within the 132 SMs.  The head
//     mixes couple every head, so each block computes all heads' logits
//     for its rows (cheap on tensor cores); a block forms only its own
//     head's mixed probabilities and reads only its slice of v_g.
//   - Both products on tensor cores, mma.sync m16n8k16 bf16 with float32
//     accumulation.  A warp takes 16 keys at a time for every head, so the
//     accumulator fragments of the 8 heads hold the same (row, key)
//     positions in one thread: bias, the th1 mix, the mask, the softmax,
//     the th2 row of head g all run in registers, and the two 8-key
//     fragments of P_g are the A operand of P_g . v_g as they stand.
//     q.k^T: bf16 inputs are exact.  P_g is float32: it goes in as bf16 hi
//     + lo (two products), so the result is within ~2^-16 of float32 before
//     the output's one rounding.  float32 inputs are split into three bf16
//     planes each (24 bits) and every product keeps the six plane pairs
//     above 2^-24; two planes (three products) read up to 1.1e-4 off the
//     plain version at N = 400, dv = 1024, past the 1e-4 the tests hold.
//   - Two passes over the keys: the first takes the softmax's running max
//     and sum for every (head, row), the second recomputes the logits and
//     accumulates P_g . v_g.  No [h, rows, N] buffer, so N is bounded only
//     by the grid; at N <= 256 all keys sit in shared memory once and the
//     second pass re-reads them there.
//   - q, k (all heads), the block's bias rows and v_g are staged in
//     shared memory by cp.async copies issued at block start, v_g in its
//     own group so its copy overlaps the first pass.  q, k and v rows go
//     16 bytes at a time (rows whose size or address is not a multiple of
//     16 bytes, and float32 inputs, which are split on the way, take plain
//     loads); the bias's rows are N elements, 200 bytes at N = 100, so
//     they go in the widest copy that divides them (8 bytes there).  q, k
//     and v rows are padded by 16 bytes so ldmatrix reads them without
//     bank conflicts.
//   - The 8 warps' partial outputs meet in shared memory (reusing the
//     staging space) and are summed in warp order.
//   - EfficientFormerV2's shape (8 heads, dk = 32) runs a copy of the
//     kernel with both fixed at compile time; other shapes the general one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phase_clock.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;        // query rows a block: one mma M tile
constexpr int kMaxHeads = 8;
constexpr int kMaxDk = 64;
constexpr int kDvSlice = 64;     // value columns a block
constexpr int kMaxKeys = 256;    // keys staged at once
constexpr size_t kMaxSmem = 232448;   // what a block can opt into on sm_90

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
// 4 or 8 bytes (cp.async.ca); the address of both ends a multiple of it
template <int kBytes>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// d += a . b, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float d[4], const unsigned a[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(bf16 lo_col, bf16 hi_col) {
  const __nv_bfloat162 v = __halves2bfloat162(lo_col, hi_col);
  return *reinterpret_cast<const unsigned*>(&v);
}

// bf16 planes of a float32 operand: x = x_0 + x_1 + ..., each plane the
// rounding of what the planes before it left.  Three planes hold all 24
// bits; a product of two split operands keeps the terms of planes i, j
// with i + j < 3 (the rest are below 2^-24 of it).
template <typename T>
constexpr int kPlanes = sizeof(T) == 4 ? 3 : 1;   // q, k, v: bf16 is exact
template <typename T>
constexpr bool kSplit = kPlanes<T> > 1;

// (m, l) of a softmax over two key sets, merged; m = -inf means empty
__device__ __forceinline__ void merge_stats(float& m, float& l, float m2,
                                            float l2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  l = l * __expf(m - mx) + l2 * __expf(m2 - mx);
  m = mx;
}

// Shared-memory plan of one block, in bytes; every part starts on a
// 16-byte boundary.  Staged operands are bf16 rows padded by 8 elements,
// `planes` of each (3 for float32 inputs).
struct AttnPlan {
  int dkp, kpitch, dvp, vpitch;
  size_t mix, stat, fin, q, k, v, bias, red, total;
  __host__ __device__ AttnPlan(int H, int dk, int dv, int KC, int planes,
                               int tsize) {
    dkp = (dk + 15) / 16 * 16;
    kpitch = dkp + 8;
    dvp = min((dv + 15) / 16 * 16, kDvSlice);
    vpitch = dvp + 8;
    mix = 0;                           // th1 [8][8], b1, th2 row g, b2_g
    stat = mix + sizeof(float) * 96;   // [warp][h][16] (m, l)
    fin = stat + sizeof(float) * kWarps * kMaxHeads * kRows * 2;
    q = fin + sizeof(float) * kMaxHeads * kRows * 2;   // M, 1/L [h][16]
    k = q + sizeof(bf16) * planes * H * kRows * kpitch;
    v = k + sizeof(bf16) * planes * H * KC * kpitch;
    bias = v + sizeof(bf16) * planes * KC * vpitch;   // [h][16][KC] as T
    const size_t kv_end = bias + (size_t)tsize * H * kRows * KC;
    red = k;                           // after the last pass
    const size_t red_end = red + sizeof(float) * kWarps * kRows * dvp;
    total = kv_end > red_end ? kv_end : red_end;
  }
};

// rows x cols (cols a multiple of 8) of a row-major source, row r at
// src + r * src_pitch, into bf16 rows of `pitch` at dst; entries past
// rows_valid / cols_valid are 0.  bf16 sources in 16-byte chunks by
// cp.async where `vec` allows; float32 sources are split into kPlanes
// planes, each `plane` elements after the one before.
template <typename T>
__device__ void stage(bf16* dst, int pitch, int plane, const T* src,
                      int64_t src_pitch, int rows, int rows_valid, int cols,
                      int cols_valid, bool vec) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    bf16* d = dst + r * pitch + c;
    const T* s = src + r * src_pitch + c;
    if (!kSplit<T> && vec && r < rows_valid && c + 8 <= cols_valid) {
      cp_async16(d, s);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float val =
          r < rows_valid && c + e < cols_valid ? load_f32(s + e) : 0.f;
      float rest = val;
#pragma unroll
      for (int pl = 0; pl < kPlanes<T>; ++pl) {
        const bf16 x = __float2bfloat16(rest);
        d[pl * plane + e] = x;
        rest -= __bfloat162float(x);
      }
    }
  }
}

// The bias rows of a block, [h][16 rows][KC keys from m0] in the input
// dtype, 0 past N: by cp.async in chunks of kBytes (16, 8 or 4: what the
// row pitch N allows), else element by element.
template <typename T, int kBytes>
__device__ void stage_bias(T* dst, const T* bias, int H, int N, int row0,
                           int m0, int KC) {
  constexpr int kE = kBytes / sizeof(T) > 0 ? kBytes / sizeof(T) : 1;
  const int chunks = KC / kE;
  for (int i = threadIdx.x; i < H * kRows * chunks; i += kThreads) {
    const int hr = i / chunks, c = (i % chunks) * kE;
    const int h = hr / kRows, r = row0 + hr % kRows, m = m0 + c;
    T* d = dst + hr * KC + c;
    const T* s = bias + ((int64_t)h * N + r) * N + m;
    if (r < N && m + kE <= N && kBytes >= 4) {
      if constexpr (kBytes == 16) cp_async16(d, s);
      else if constexpr (kBytes >= 4) cp_async_small<kBytes>(d, s);
      continue;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e)
      d[e] = r < N && m + e < N ? s[e] : T(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void stage_bias_any(T* dst, const T* bias, int H,
                                               int N, int row0, int m0,
                                               int KC, int bias_bytes) {
  if (bias_bytes == 16)
    stage_bias<T, 16>(dst, bias, H, N, row0, m0, KC);
  else if (bias_bytes == 8)
    stage_bias<T, 8>(dst, bias, H, N, row0, m0, KC);
  else if (bias_bytes == 4)
    stage_bias<T, 4>(dst, bias, H, N, row0, m0, KC);
  else
    stage_bias<T, 2>(dst, bias, H, N, row0, m0, KC);
}

// What mixed_logits reads, fixed for a block.
template <typename T>
struct Block {
  const bf16 *s_q, *s_k;
  const float *s_w1, *s_b1;
  const T* s_bias;
  int H, N, KC, kp, dkp, qplane, kplane, row0;
  float scale;
};

// Logits of 8 keys (chunk columns kk..kk+7, keys m0 + kk + ...) for every
// head, then the bias, the th1 mix and the key mask: a[h'][i] is at row
// gq + 8 (i / 2) and key 2 tq + i % 2 of the 8, for lane = 4 gq + tq.
// kH, kDkp: the heads and padded key width when fixed at compile time
// (0: read from bk).
template <typename T, int kH, int kDkp>
__device__ __forceinline__ void mixed_logits(const Block<T>& bk,
                                             float (&a)[kMaxHeads][4],
                                             int kk, int m0, int lane) {
  constexpr int kP = kPlanes<T>;
  const int gq = lane >> 2, tq = lane & 3, kp = bk.kp;
  const int H = kH ? kH : bk.H, dkp = kDkp ? kDkp : bk.dkp;
  float s[kMaxHeads][4];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[h][i] = 0.f;
    if (h >= H) continue;
#pragma unroll
    for (int ks = 0; ks < kMaxDk; ks += 16) {
      if (ks >= dkp) break;
      unsigned qa[kP][4], kb[kP][2];
      const bf16* qp = bk.s_q + (h * kRows + (lane & 15)) * kp + ks +
                       (lane >> 4) * 8;
      const bf16* kq = bk.s_k + (h * bk.KC + kk + (lane & 7)) * kp + ks +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int pl = 0; pl < kP; ++pl) {
        ldmatrix_x4(qa[pl], qp + pl * bk.qplane);
        ldmatrix_x2(kb[pl], kq + pl * bk.kplane);
      }
#pragma unroll
      for (int i = kP - 1; i >= 0; --i) {
#pragma unroll
        for (int j = kP - 1 - i; j >= 0; --j)
          mma(s[h], qa[i], kb[j][0], kb[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float bv = load_f32(bk.s_bias + (h * kRows + gq + 8 * (i >> 1)) *
                                bk.KC + kk + 2 * tq + (i & 1));
      s[h][i] = fmaf(s[h][i], bk.scale, bv);
    }
  }
#pragma unroll
  for (int gg = 0; gg < kMaxHeads; ++gg) {
    const float4 w0 = reinterpret_cast<const float4*>(bk.s_w1)[2 * gg];
    const float4 w1 = reinterpret_cast<const float4*>(bk.s_w1)[2 * gg + 1];
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float acc = bk.s_b1[gg];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < H) acc = fmaf(w[h], s[h][i], acc);
      // the mask comes after the mix, as in the TPU kernel
      a[gg][i] = m0 + kk + 2 * tq + (i & 1) < bk.N ? acc : -INFINITY;
    }
  }
}

template <typename T, int kH, int kDkp>
__global__ void __launch_bounds__(kThreads, 1)
bias_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ bias,
                      const T* __restrict__ th1w, const T* __restrict__ th1b,
                      const T* __restrict__ th2w, const T* __restrict__ th2b,
                      T* __restrict__ out, int H, int N, int dk, int dv,
                      int KC, float scale, int vec_qk, int vec_v,
                      int bias_bytes) {
  constexpr int kP = kPlanes<T>;
  constexpr int kPP = kSplit<T> ? 3 : 2;   // planes of P_g (float32)
  extern __shared__ __align__(16) unsigned char smem[];
  PHASE(0);
  if constexpr (kH != 0) H = kH;
  const AttnPlan plan(H, dk, dv, KC, kP, sizeof(T));
  float* s_w1 = reinterpret_cast<float*>(smem + plan.mix);  // [g'][h], 8x8
  float* s_b1 = s_w1 + 64;
  float* s_w2 = s_b1 + 8;                                   // th2[g][h]
  float* s_b2 = s_w2 + 8;                                   // th2_b[g]
  float* s_stat = reinterpret_cast<float*>(smem + plan.stat);
  float* s_M = reinterpret_cast<float*>(smem + plan.fin);   // [h][16]
  float* s_Linv = s_M + kMaxHeads * kRows;
  bf16* s_q = reinterpret_cast<bf16*>(smem + plan.q);   // [plane][h][16][kp]
  bf16* s_k = reinterpret_cast<bf16*>(smem + plan.k);   // [plane][h][KC][kp]
  bf16* s_v = reinterpret_cast<bf16*>(smem + plan.v);   // [plane][KC][vp]
  T* s_bias = reinterpret_cast<T*>(smem + plan.bias);  // [h][16][KC]
  float* s_red = reinterpret_cast<float*>(smem + plan.red);  // [w][16][dvp]
  const int kp = plan.kpitch, vp = plan.vpitch, dkp = plan.dkp,
            dvp = plan.dvp;
  const int qplane = H * kRows * kp, kplane = H * KC * kp, vplane = KC * vp;

  const int row0 = blockIdx.x * kRows;
  const int g = blockIdx.y % H, dv0 = (blockIdx.y / H) * kDvSlice;
  const int dvs = min(kDvSlice, dv - dv0);
  const int64_t bh = (int64_t)blockIdx.z * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int nchunks = (N + KC - 1) / KC;

  auto stage_k = [&](int m0) {        // and the bias rows of those keys
    for (int h = 0; h < H; ++h)
      stage(s_k + h * KC * kp, kp, kplane, k + ((bh + h) * N + m0) * dk, dk,
            KC, N - m0, dkp, dk, vec_qk);
    stage_bias_any(s_bias, bias, H, N, row0, m0, KC, bias_bytes);
  };
  auto stage_v = [&](int m0) {
    stage(s_v, vp, vplane, v + ((bh + g) * N + m0) * dv + dv0, dv, KC,
          N - m0, dvp, dvs, vec_v);
  };

  for (int h = 0; h < H; ++h)
    stage(s_q + h * kRows * kp, kp, qplane, q + ((bh + h) * N + row0) * dk,
          dk, kRows, N - row0, dkp, dk, vec_qk);
  stage_k(0);
  cp_async_commit();
  if (nchunks == 1) stage_v(0);
  cp_async_commit();
  for (int i = tid; i < 64; i += kThreads) {
    const int gg = i / 8, h = i % 8;
    s_w1[i] = gg < H && h < H ? load_f32(th1w + gg * H + h) : 0.f;
  }
  if (tid < 8) {
    s_b1[tid] = tid < H ? load_f32(th1b + tid) : 0.f;
    s_w2[tid] = tid < H ? load_f32(th2w + g * H + tid) : 0.f;
  }
  if (tid == 0) s_b2[0] = load_f32(th2b + g);
  const Block<T> bk{s_q, s_k, s_w1, s_b1, s_bias, H, N, KC, kp, dkp, qplane,
                    kplane, row0, scale};
  cp_async_wait<1>();
  __syncthreads();
  PHASE(1);

  // pass 1: the softmax's running max and sum, per (head, row half)
  float rm[kMaxHeads][2], rl[kMaxHeads][2];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
#pragma unroll
    for (int j = 0; j < 2; ++j) rm[h][j] = -INFINITY, rl[h][j] = 0.f;
  }
  for (int c = 0; c < nchunks; ++c) {
    const int m0 = c * KC;
    if (c > 0) {
      __syncthreads();
      stage_k(m0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int kk = warp * 8; kk < min(KC, N - m0); kk += kWarps * 8) {
      float a[kMaxHeads][4];
      mixed_logits<T, kH, kDkp>(bk, a, kk, m0, lane);
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x0 = a[h][2 * j], x1 = a[h][2 * j + 1];
          const float mx = fmaxf(rm[h][j], fmaxf(x0, x1));
          if (mx == -INFINITY) continue;
          rl[h][j] = rl[h][j] * __expf(rm[h][j] - mx) + __expf(x0 - mx) +
                     __expf(x1 - mx);
          rm[h][j] = mx;
        }
      }
    }
  }
  PHASE(2);
  // merge over the quad that shares a row, then over the warps
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      for (int sh = 1; sh <= 2; sh <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, rm[h][j], sh);
        const float l2 = __shfl_xor_sync(0xffffffffu, rl[h][j], sh);
        merge_stats(rm[h][j], rl[h][j], m2, l2);
      }
      if (tq == 0) {
        float* st =
            s_stat + ((warp * kMaxHeads + h) * kRows + gq + 8 * j) * 2;
        st[0] = rm[h][j];
        st[1] = rl[h][j];
      }
    }
  }
  __syncthreads();
  if (tid < kMaxHeads * kRows) {
    float m = -INFINITY, l = 0.f;
    for (int w = 0; w < kWarps; ++w)
      merge_stats(m, l, s_stat[(w * kMaxHeads * kRows + tid) * 2],
                  s_stat[(w * kMaxHeads * kRows + tid) * 2 + 1]);
    s_M[tid] = m;
    s_Linv[tid] = l > 0.f ? 1.f / l : 0.f;
  }

  // pass 2: P_g = th2 row g of the softmaxes, then out += P_g . v_g over
  // 16 keys at a time
  float o[kDvSlice / 8][4];
#pragma unroll
  for (int j = 0; j < kDvSlice / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  }
  for (int c = 0; c < nchunks; ++c) {
    const int m0 = c * KC;
    __syncthreads();
    if (nchunks > 1) {
      stage_k(m0);
      stage_v(m0);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (c == 0) PHASE(3);
    for (int kk0 = warp * 16; kk0 < min(KC, N - m0); kk0 += kWarps * 16) {
      float p[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float a[kMaxHeads][4];
        mixed_logits<T, kH, kDkp>(bk, a, kk0 + 8 * t, m0, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = gq + 8 * (i >> 1);
          float acc = s_b2[0];
#pragma unroll
          for (int h = 0; h < kMaxHeads; ++h)
            if (h < H)
              acc = fmaf(s_w2[h], __expf(a[h][i] - s_M[h * kRows + r]) *
                                      s_Linv[h * kRows + r], acc);
          p[t][i] = m0 + kk0 + 8 * t + 2 * tq + (i & 1) < N ? acc : 0.f;
        }
      }
      // the two fragments of P_g are the A operand, in bf16 planes
      unsigned ap[kPP][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float r0 = p[i >> 1][2 * (i & 1)], r1 = p[i >> 1][2 * (i & 1) + 1];
#pragma unroll
        for (int pl = 0; pl < kPP; ++pl) {
          const bf16 x0 = __float2bfloat16(r0), x1 = __float2bfloat16(r1);
          ap[pl][i] = pack_bf16(x0, x1);
          r0 -= __bfloat162float(x0);
          r1 -= __bfloat162float(x1);
        }
      }
#pragma unroll
      for (int j = 0; j < kDvSlice / 16; ++j) {
        if (16 * j >= dvp) break;
        unsigned vb[kP][4];
        const bf16* vq = s_v + (kk0 + (lane & 15)) * vp + 16 * j +
                         (lane >> 4) * 8;
#pragma unroll
        for (int pl = 0; pl < kP; ++pl)
          ldmatrix_x4_trans(vb[pl], vq + pl * vplane);
        // planes (i of P, l of v) with i + l < kPP, smallest terms first
#pragma unroll
        for (int i = kPP - 1; i >= 0; --i) {
#pragma unroll
          for (int l = kP - 1; l >= 0; --l) {
            if (i + l >= kPP) continue;
            mma(o[2 * j], ap[i], vb[l][0], vb[l][1]);
            mma(o[2 * j + 1], ap[i], vb[l][2], vb[l][3]);
          }
        }
      }
    }
  }

  // the warps' partial outputs, summed in warp order
  PHASE(4);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kDvSlice / 8; ++j) {
    if (8 * j >= dvp) break;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s_red[(warp * kRows + gq + 8 * (i >> 1)) * dvp + 8 * j + 2 * tq +
            (i & 1)] = o[j][i];
  }
  __syncthreads();
  for (int i = tid; i < kRows * dvs; i += kThreads) {
    const int r = i / dvs, col = i % dvs;
    if (row0 + r >= N) continue;
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w)
      acc += s_red[(w * kRows + r) * dvp + col];
    store(out + ((bh + g) * N + row0 + r) * dv + dv0 + col, acc);
  }
  PHASE(5);
}

template <typename T, int kH, int kDkp>
cudaError_t launch_attention_k(const void* const* in, void* out, int B, int H,
                               int N, int dk, int dv, float scale,
                               cudaStream_t stream) {
  int KC = min((N + 15) / 16 * 16, kMaxKeys);
  while (KC > 16 &&
         AttnPlan(H, dk, dv, KC, kPlanes<T>, sizeof(T)).total > kMaxSmem)
    KC = max(16, (KC / 2 + 15) / 16 * 16);
  const size_t smem = AttnPlan(H, dk, dv, KC, kPlanes<T>, sizeof(T)).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // opting in costs a driver call: make it once per size reached
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        bias_attention_kernel<T, kH, kDkp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_qk = dk % 8 == 0 && aligned(in[0]) && aligned(in[1]);
  const int vec_v = dv % 8 == 0 && aligned(in[2]);
  // the bias's rows are N elements: the widest copy that divides them
  int bias_bytes = 2;
  for (int bytes = 16; bytes >= 4; bytes /= 2) {
    if (bytes >= (int)sizeof(T) && (N * sizeof(T)) % bytes == 0 &&
        reinterpret_cast<uintptr_t>(in[3]) % bytes == 0) {
      bias_bytes = bytes;
      break;
    }
  }
  dim3 grid((N + kRows - 1) / kRows, H * ((dv + kDvSlice - 1) / kDvSlice), B);
  bias_attention_kernel<T, kH, kDkp><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const T*>(in[7]),
      static_cast<T*>(out), H, N, dk, dv, KC, scale, vec_qk, vec_v,
      bias_bytes);
  return cudaGetLastError();
}

// EfficientFormerV2's shape (8 heads, dk = 32) with its loops fixed at
// compile time, so the heads' products interleave; any other in the
// general kernel.
template <typename T>
cudaError_t launch_attention(const void* const* in, void* out, int B, int H,
                             int N, int dk, int dv, float scale,
                             cudaStream_t stream) {
  if (H == 8 && (dk + 15) / 16 * 16 == 32)
    return launch_attention_k<T, 8, 32>(in, out, B, H, N, dk, dv, scale,
                                        stream);
  return launch_attention_k<T, 0, 0>(in, out, B, H, N, dk, dv, scale,
                                     stream);
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
  if (B <= 0 || B > 65535 || H < 1 || H > kMaxHeads || N <= 0 || dk < 1 ||
      dk > kMaxDk || dv <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* in[8] = {q, k, v, bias, th1w, th1b, th2w, th2b};
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
      ? launch_attention<float>(in, out, B, H, N, dk, dv, scale, s)
      : launch_attention<bf16>(in, out, B, H, N, dk, dv, scale, s));
}

#if ACHELOUS_PHASE_CLOCKS
// The phase stamps since the last call (kPhaseBlocks x kPhases) into
// host memory; then zeroes them.
int achelous_attention_phase_clocks(long long* dst) {
  cudaError_t err =
      cudaMemcpyFromSymbol(dst, g_phase_clock, sizeof(g_phase_clock));
  void* dev = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&dev, g_phase_clock);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(g_phase_clock));
  return (int)err;
}
#endif

}  // extern "C"
