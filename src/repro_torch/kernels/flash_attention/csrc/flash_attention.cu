// flash_attention: causal / sliding-window GQA attention with an online
// softmax, written for Hopper (sm_90a).
//
//   q: (B, Hq, S, D), k, v: (B, Hkv, S, D), out: (B, Hq, S, D)
//   out[b,h,r] = sum_c softmax_c(q[b,h,r] . k[b,g,c] / sqrt(D)) v[b,g,c]
//   over the keys c with c <= r (causal) and c > r - window (window >= 1),
//   g = h / (Hq / Hkv); a row with no such key gives 0.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (`flash_attention`, body
// `_flash_kernel`).  That kernel walks the KV blocks on the innermost,
// sequential grid axis and keeps the running max m, sum l and the f32
// accumulator in VMEM scratch between grid steps.  Here no state crosses
// blocks: a block owns a query tile of one (b, q-head) and loops over the
// KV tiles itself, with m, l and the accumulator in registers.  The KV
// head is read in place (h / (Hq / Hkv)), never replicated in memory.
//
// Two kernels, chosen by the input type alone (the C entry point below):
//
// - bfloat16, every head dim: flash_attention_wgmma.cuh, on the tensor
//   cores (wgmma, TMA, warp-specialised); its note gives the design.
// - float32: the kernel in this file, f32 FMAs on the CUDA cores.  f32
//   inputs must match the reference to 2e-5, which TF32 on the tensor
//   cores would not.  At the main path's shape (llama3.2-3b prefill,
//   B = 4, S = 2048, 24 q-heads of D = 128) the f32 work is bound by the
//   f32 FMA rate (67 TFLOP/s: ~1.5 ms); this kernel is further bound by
//   shared-memory loads (two FMAs per load in the inner loops).  What the
//   design does about the rest: one block of 256 threads owns a 64-row
//   query tile; q, k and v tiles are read from device memory once per
//   block in 16-byte loads and staged in shared memory, rows padded to an
//   odd word stride so that the inner loops are free of bank conflicts;
//   at D >= 64 a tile's probabilities reuse K's buffer once the scores
//   are computed, so that at D = 128 a block takes 99 KB of shared memory
//   and two fit on an SM; K/V rows past S are staged as zeros; KV tiles
//   that the causal or window mask empties entirely are skipped (half the
//   work of a causal prefill); the query tiles with the most keys are
//   scheduled first.
//
// Given an f32 (B, Hq, S) buffer, both kernels also write each row's
// log-sum-exp of its scores times log2(e) (base 2; -inf for a row with no
// allowed key), which the backward (flash_attention_bwd.cu) reads; the
// entry point flash_attention_lse_launch takes it, flash_attention_launch
// (prefill) does not.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: 4 query rows x (4 keys | D/16 dims)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Rows [r0, r0 + 64) of a (S, D) matrix into dst (64 x (D + 1) f32),
// zero beyond S.  Every thread moves 16-byte vectors; consecutive
// threads take consecutive vectors of the (contiguous) tile.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int S) {
  constexpr int kLd = D + 1;
  constexpr int kVecs = kBQ * D / 4;
  for (int i = threadIdx.x; i < kVecs; i += kThreads) {
    const int e = i * 4;
    const int row = e / D, col = e % D;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < S) {
      v = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + row) * D + col);
    }
    float* d = dst + row * kLd + col;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

// The probabilities of a tile (kBQ x (kBK + 1) f32) reuse K's buffer
// where it is large enough: at D = 128 that keeps two blocks on an SM.
template <int D>
__host__ __device__ constexpr bool p_in_k() {
  return kBK + 1 <= D + 1;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int Hq, int Hkv, int S,
                       int causal, int window, float scale_log2) {
  constexpr int kLd = D + 1;       // odd word stride: no bank conflicts
  constexpr int kLdP = kBK + 1;
  constexpr int kNJ = D / 16;      // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;                // kBQ x kLd
  float* ks = qs + kBQ * kLd;      // kBK x kLd
  float* vs = ks + kBK * kLd;      // kBK x kLd
  // kBQ x kLdP probabilities: in K's buffer, once the scores are read
  // out of it, where they fit (D >= 64), else after V
  float* ps = p_in_k<D>() ? ks : vs + kBK * kLd;

  const int n_q = (S + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int64_t q_base = (static_cast<int64_t>(b) * Hq + h) * S * D;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + g) * S * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(qs, q + q_base, q0, S);

  float acc[4][kNJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }

  // KV tiles that hold at least one key of this query tile
  const int k_hi = causal ? min(S, q0 + kBQ) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = k_lo / kBK; t * kBK < k_hi; ++t) {
    const int c0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, k + kv_base, c0, S);
    load_tile<D>(vs, v + kv_base, c0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    if (p_in_k<D>()) __syncthreads();  // every thread is done with K

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        ok[j] = col < S && (!causal || col <= row) &&
                (window <= 0 || col > row - window);
        s[i][j] = ok[j] ? s[i][j] * scale_log2 : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? exp2f(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * kLdP + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float vv = vs[c * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    float* dst = out + q_base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) dst[tx + 16 * j] = acc[i][j] / safe;
    if (lse != nullptr && tx == 0) {
      lse[(static_cast<int64_t>(b) * Hq + h) * S + row] =
          l[i] == 0.f ? __int_as_float(0xff800000) : m[i] + log2f(l[i]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Hq, int Hkv, int S, int causal, int window,
           cudaStream_t stream) {
  constexpr int kLd = D + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * kLd +
                       (p_in_k<D>() ? 0 : static_cast<size_t>(kBQ) *
                                              (kBK + 1)));
  const cudaError_t err =
      fa_wgmma::opt_in_smem<flash_attention_kernel<D>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Hq, Hkv,
      S, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int Hq, int Hkv, int S, int D,
                 int causal, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, s);
    case 32: return launch<32>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, s);
    case 64: return launch<64>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, s);
    case 128: return launch<128>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// launches that succeeded, by kernel: 0 = CUDA cores (f32), 1 = tensor
// cores (bf16)
unsigned long long g_launches[2] = {0, 0};

int launch_any(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Hq, int Hkv, int S, int D, int causal,
               int window, int dtype, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 ||
      Hq % Hkv != 0 || S < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == 0
          ? dispatch_f32(q, k, v, out, lse, B, Hq, Hkv, S, D, causal, window,
                         s)
          : fa_wgmma::dispatch(q, k, v, out, lse, B, Hq, Hkv, S, D, causal,
                               window, s);
  if (rc == 0) ++g_launches[dtype];
  return rc;
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core kernel); window <= 0 means no window.  Returns
// cudaGetLastError() after the launch (0 on success); refuses shapes the
// kernels do not take with cudaErrorInvalidValue, before launching
// anything.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Hq, int Hkv, int S, int D,
                                      int causal, int window, int dtype,
                                      void* stream) {
  return launch_any(q, k, v, out, nullptr, B, Hq, Hkv, S, D, causal, window,
                    dtype, stream);
}

// The same, also writing each row's log-sum-exp into lse ((B, Hq, S) f32,
// 16-byte aligned), for the backward.
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          float* lse, int B, int Hq, int Hkv,
                                          int S, int D, int causal,
                                          int window, int dtype,
                                          void* stream) {
  return launch_any(q, k, v, out, lse, B, Hq, Hkv, S, D, causal, window,
                    dtype, stream);
}

// How many launches of kernel `variant` (0 = CUDA cores, 1 = tensor
// cores) have succeeded in this process.
extern "C" unsigned long long flash_attention_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? g_launches[variant] : 0;
}
