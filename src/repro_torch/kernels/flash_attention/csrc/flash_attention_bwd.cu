// flash_attention backward: the gradients of causal / sliding-window GQA
// attention, written for Hopper (sm_90a).
//
//   q, o, do, dq: (B, Hq, S, D); k, v, dk, dv: (B, Hkv, S, D), all contiguous
//   z[r][c] = q[r] . k[c] / sqrt(D) over the allowed keys c of row r (c <= r
//   when causal, c > r - window when window >= 1), P = softmax_c(z),
//   o = P v.  With delta[r] = sum_d do[r][d] o[r][d]:
//     dP = do v^T,  dZ = P (dP - delta),
//     dq = dZ k / sqrt(D),  dk = dZ^T q / sqrt(D),  dv = P^T do,
//   query head h reading KV head h / (Hq / Hkv), so dk and dv sum over
//   the group's query heads.  A row with no allowed key has P = 0: it
//   gives zero gradients, as its output is 0.
//
// The TPU package has no backward kernel: its Pallas `flash_attention`
// (src/repro/kernels/flash_attention/kernel.py) is forward-only and its
// training differentiates the jnp oracle (ref.py).  This is the backward
// of the port's forward kernels (flash_attention.cu), following
// FlashAttention-2's backward (arXiv:2307.08691, Algorithm 2).  lse, each
// row's log-sum-exp of its scores times log2(e) (base 2), comes from the
// forward (flash_attention_lse_launch), which has it at no cost.  Two
// designs, chosen by the input type alone, as the forward's:
//
// - bfloat16, every head dim: flash_attention_bwd_wgmma.cuh, on the
//   tensor cores (wgmma, TMA, warp-specialised); its note gives the design.
// - float32: the kernels below, FA2's passes as f32 FMAs out of shared
//   memory on the CUDA cores (f32 inputs must match the reference to
//   1e-4, which TF32 on the tensor cores would not).
//
// Both start with `fa_bwd_prep`, per (b, q head, 64-row query tile):
// delta = rowsum(do o), a pass bound by memory.  The f32 design then runs
// `fa_bwd_dkdv`, per (b, kv head, 64-key tile): dk and dv in registers,
// over the group's query heads and only the query tiles that can see the
// key tile; P and dZ of each (query tile, key tile) pass through shared
// memory; and `fa_bwd_dq`, per (b, q head, query tile): dq over the
// visible key tiles.
//
// No atomics anywhere, so every gradient is summed in a fixed order: the
// result is deterministic.  Bound at llama3.2-3b's training shape (B = 4,
// 24 q heads over 8 kv heads, S = 2048, D = 128): the five products q.k,
// do.v, P^T do, dZ^T q, dZ k over the causal half, 2.5x the forward's
// FLOPs; 0.26 ms at the bf16 tensor-core rate, 3.8 ms at the f32 rate.
// The f32 kernels are further bound by shared-memory loads (two FMAs a
// load in the inner loops).  Tiles are staged in shared memory as f32 with
// rows padded to an odd word stride (no bank conflicts in the inner
// loops), rows past S zero-filled; key tiles the mask empties are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_bwd_wgmma.cuh"

namespace {

constexpr int kTile = 64;      // query rows and keys a tile
constexpr int kThreads = 256;  // 16 x 16: 4 rows x (4 columns | D/16 dims)
constexpr int kLdP = kTile + 1;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Rows [r0, r0 + 64) of a contiguous (S, D) f32 matrix into dst
// (64 x (D + 1) f32), zero beyond S, in 16-byte loads.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int S) {
  constexpr int kLd = D + 1;
  constexpr int kVecs = kTile * D / 4;
  for (int i = threadIdx.x; i < kVecs; i += kThreads) {
    const int e = i * 4;
    const int row = e / D, col = e % D;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < S)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + row) * D + col);
    float* d = dst + row * kLd + col;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

using fa_bwd_wgmma::allowed;

// The key tiles [lo, hi) holding at least one allowed key of query tile
// q0: the forward's bounds.
__device__ __forceinline__ void key_tiles(int q0, int S, int causal,
                                          int window, int& lo, int& hi) {
  const int k_hi = causal ? min(S, q0 + kTile) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = k_lo / kTile;
  hi = (k_hi + kTile - 1) / kTile;
}

// scores[a][j] = A[ty*4 + a] . B[tx + 16 j] over D, both staged tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* as, const float* bs,
                                         int ty, int tx, float (&s)[4][4]) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = as[(ty * 4 + a) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = fmaf(av[a], bv[j], s[a][j]);
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(do o) per row, for both designs
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_prep(const T* __restrict__ o, const T* __restrict__ dout,
            float* __restrict__ delta, int Hq, int S) {
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t q_base = (static_cast<int64_t>(b) * Hq + h) * S * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    float dsum = 0.f;
    if (row < S) {
      const T* orow = o + q_base + static_cast<int64_t>(row) * D;
      const T* drow = dout + q_base + static_cast<int64_t>(row) * D;
      for (int d = tx; d < D; d += 16)
        dsum = fmaf(to_f32(drow[d]), to_f32(orow[d]), dsum);
    }
    // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (tx == 0 && row < S)
      delta[(static_cast<int64_t>(b) * Hq + h) * S + row] = dsum;
  }
}

// P and dZ of a (query tile, key tile) pair, from the staged q, do, k, v
// tiles and the query rows' lse and delta: written to ps and dzs
// (64 x 65 each, [query row][key]).
template <int D>
__device__ __forceinline__ void probs_and_dz(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, float* ps, float* dzs, int q0,
    int c0, int S, int causal, int window, float scale_log2, int ty,
    int tx) {
  float s[4][4], dp[4][4];
  tile_dot<D>(qs, ks, ty, tx, s);
  tile_dot<D>(dos, vs, ty, tx, dp);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = allowed(q0 + r, c0 + c, S, causal, window)
                          ? exp2f(s[a][j] * scale_log2 - lse_s[r])
                          : 0.f;
      ps[r * kLdP + c] = p;
      dzs[r * kLdP + c] = p * (dp[a][j] - delta_s[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: dk, dv per (b, kv head, key tile)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv,
            int S,
            int causal, int window, float scale_log2, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kNJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  float* dos = qs + kTile * kLd;
  float* ps = dos + kTile * kLd;
  float* dzs = ps + kTile * kLdP;
  float* lse_s = dzs + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const int c0 = blockIdx.x * kTile;
  const int g = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + g) * S * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(ks, k + kv_base, c0, S);
  load_tile<D>(vs, v + kv_base, c0, S);

  float dk_acc[4][kNJ], dv_acc[4][kNJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) dk_acc[a][j] = dv_acc[a][j] = 0.f;

  // the query rows that can see a key of this tile
  const int c_last = min(c0 + kTile, S) - 1;
  const int r_lo = causal ? c0 : 0;
  const int r_hi = window > 0 ? min(S - 1, c_last + window - 1) : S - 1;
  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    const int64_t q_base = (static_cast<int64_t>(b) * Hq + h) * S * D;
    const int64_t row_base = (static_cast<int64_t>(b) * Hq + h) * S;
    for (int qt = r_lo / kTile; qt <= r_hi / kTile && r_lo <= r_hi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous pair's readers are done
      load_tile<D>(qs, q + q_base, q0, S);
      load_tile<D>(dos, dout + q_base, q0, S);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lse[row_base + row] : 0.f;
        delta_s[threadIdx.x] = row < S ? delta[row_base + row] : 0.f;
      }
      __syncthreads();
      probs_and_dz<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dzs, q0, c0, S,
                      causal, window, scale_log2, ty, tx);
      __syncthreads();
      // dv[c] += sum_r P[r][c] do[r], dk[c] += sum_r dZ[r][c] q[r]; this
      // thread's keys ty*4 + a, dims tx + 16 j
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pv[4], zv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = ps[r * kLdP + ty * 4 + a];
          zv[a] = dzs[r * kLdP + ty * 4 + a];
        }
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float dov = dos[r * kLd + tx + 16 * j];
          const float qv = qs[r * kLd + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            dv_acc[a][j] = fmaf(pv[a], dov, dv_acc[a][j]);
            dk_acc[a][j] = fmaf(zv[a], qv, dk_acc[a][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = c0 + ty * 4 + a;
    if (c >= S) continue;
    const int64_t at = kv_base + static_cast<int64_t>(c) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      dk[at + tx + 16 * j] = dk_acc[a][j] * scale;
      dv[at + tx + 16 * j] = dv_acc[a][j];
    }
  }
}

// ---------------------------------------------------------------------------
// f32: dq per (b, q head, query tile)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Hq, int Hkv, int S, int causal,
          int window, float scale_log2, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kNJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kLd;
  float* ks = dos + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* dzs = vs + kTile * kLd;
  float* ps = dzs + kTile * kLdP;
  float* lse_s = ps + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  // the query tiles with the most keys first
  const int n_q = (S + kTile - 1) / kTile;
  const int q0 = (causal ? n_q - 1 - static_cast<int>(blockIdx.x)
                         : static_cast<int>(blockIdx.x)) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int64_t q_base = (static_cast<int64_t>(b) * Hq + h) * S * D;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + g) * S * D;
  const int64_t row_base = (static_cast<int64_t>(b) * Hq + h) * S;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(qs, q + q_base, q0, S);
  load_tile<D>(dos, dout + q_base, q0, S);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < S ? lse[row_base + row] : 0.f;
    delta_s[threadIdx.x] = row < S ? delta[row_base + row] : 0.f;
  }
  float acc[4][kNJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[a][j] = 0.f;

  int lo, hi;
  key_tiles(q0, S, causal, window, lo, hi);
  for (int t = lo; t < hi; ++t) {
    const int c0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, k + kv_base, c0, S);
    load_tile<D>(vs, v + kv_base, c0, S);
    __syncthreads();
    probs_and_dz<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dzs, q0, c0, S,
                    causal, window, scale_log2, ty, tx);
    __syncthreads();
    // dq[r] += sum_c dZ[r][c] k[c]; this thread's rows ty*4 + a, dims
    // tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float zv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) zv[a] = dzs[(ty * 4 + a) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float kv = ks[c * kLd + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(zv[a], kv, acc[a][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= S) continue;
    const int64_t at = q_base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      dq[at + tx + 16 * j] = acc[a][j] * scale;
    }
  }
}

using fa_wgmma::opt_in_smem;

// delta, then the f32 kernels
template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv,
               const float* lse, float* delta, int B, int Hq, int Hkv,
               int S, int causal, int window, cudaStream_t stream) {
  constexpr size_t kTileBytes = sizeof(float) * kTile * (D + 1);
  constexpr size_t kPBytes = sizeof(float) * kTile * kLdP;
  constexpr size_t kRowBytes = sizeof(float) * 2 * kTile;
  constexpr size_t kPairs = 4 * kTileBytes + 2 * kPBytes + kRowBytes;
  cudaError_t err = opt_in_smem<fa_bwd_dkdv<D>>(kPairs);
  if (err == cudaSuccess) err = opt_in_smem<fa_bwd_dq<D>>(kPairs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e * scale;
  const int n_tiles = (S + kTile - 1) / kTile;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  fa_bwd_prep<float, D><<<dim3(n_tiles, Hq, B), kThreads, 0, stream>>>(
      static_cast<const float*>(o), tdo, delta, Hq, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dkdv<D><<<dim3(n_tiles, Hkv, B), kThreads, kPairs, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Hq, Hkv, S, causal, window, scale_log2,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dq<D><<<dim3(n_tiles, Hq, B), kThreads, kPairs, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), Hq, Hkv, S,
      causal, window, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

// delta, then the tensor-core kernels
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv,
                const float* lse, float* delta, int B, int Hq, int Hkv,
                int S, int causal, int window, cudaStream_t stream) {
  const int n_tiles = (S + kTile - 1) / kTile;
  fa_bwd_prep<bf16, D><<<dim3(n_tiles, Hq, B), kThreads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
      Hq, S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return fa_bwd_wgmma::launch<D>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hkv, S, causal, window, stream);
}

int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, const float* lse,
             float* delta, int B, int Hq, int Hkv, int S, int D, int causal,
             int window, int dtype, cudaStream_t s) {
#define FA_BWD_CASE(DIM)                                                   \
  case DIM:                                                                \
    return dtype == 0                                                      \
               ? launch_f32<DIM>(q, k, v, o, dout, dq, dk, dv, lse, delta, \
                                 B, Hq, Hkv, S, causal, window, s)         \
               : launch_bf16<DIM>(q, k, v, o, dout, dq, dk, dv, lse,       \
                                  delta, B, Hq, Hkv, S, causal, window, s);
  switch (D) {
    FA_BWD_CASE(16)
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_BWD_CASE
}

// calls that succeeded, by design: 0 = CUDA cores (f32), 1 = tensor cores
// (bf16)
unsigned long long g_launches[2] = {0, 0};

}  // namespace

// q, o, dout, dq: (B, Hq, S, D); k, v, dk, dv: (B, Hkv, S, D); lse: (B,
// Hq, S) f32, each row's log-sum-exp as the forward wrote it
// (flash_attention_lse_launch), read only; delta: (B, Hq, S) f32 scratch;
// every tensor contiguous, 16-byte aligned.  dtype: 0 = float32 (the
// CUDA-core kernels), 1 = bfloat16 (the tensor-core kernels), all of
// q..dv alike.  window <= 0 means no window.  Three launches on `stream`;
// returns cudaGetLastError() after the last (0 on success), or the first
// error; refuses shapes it does not take with cudaErrorInvalidValue,
// before launching anything.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int B, int Hq, int Hkv, int S, int D, int causal, int window, int dtype,
    void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 ||
      Hq % Hkv != 0 || S < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = dispatch(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Hq,
                          Hkv, S, D, causal, window, dtype,
                          static_cast<cudaStream_t>(stream));
  if (rc == 0) ++g_launches[dtype];
  return rc;
}

// How many calls of design `variant` (0 = CUDA cores, 1 = tensor cores)
// have succeeded in this process.
extern "C" unsigned long long flash_attention_backward_variant_launches(
    int variant) {
  return variant == 0 || variant == 1 ? g_launches[variant] : 0;
}
