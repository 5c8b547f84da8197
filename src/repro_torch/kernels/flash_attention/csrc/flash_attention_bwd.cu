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
// of the port's forward kernels (flash_attention.cu, on the tensor cores
// for bf16), following FlashAttention-2's backward (arXiv:2307.08691,
// Algorithm 2) on the CUDA cores in f32, for f32 and bf16 inputs:
//
// 1. `fa_bwd_prep`, per (b, q head, 64-row query tile): the row's
//    log-sum-exp over its allowed keys, recomputed as the forward does
//    (the forward writes none), and delta.
// 2. `fa_bwd_dkdv`, per (b, kv head, 64-key tile): dk and dv in registers,
//    over the group's query heads and only the query tiles that can see
//    the key tile; P and dZ of each (query tile, key tile) pass through
//    shared memory.  The GQA sum stays in registers: no atomics.
// 3. `fa_bwd_dq`, per (b, q head, query tile): dq over the visible key
//    tiles.
//
// No atomics anywhere, so every gradient is summed in a fixed order: the
// result is deterministic.  Bound at llama3.2-3b's training shape (B = 4,
// 24 q heads over 8 kv heads, S = 2048, D = 128, bf16): the work is ~2.5x
// the forward's FLOPs (the five products q.k, do.v, P^T do, dZ^T q, dZ k
// over the causal half; the forward has two), 0.26 ms at the bf16 tensor
// core rate; this kernel runs them as f32 FMAs out of shared memory (two
// FMAs a shared load in the inner loops), so it is bound by the CUDA
// cores' f32 rate and their shared-memory bandwidth, some 50-100x above
// that bound: a simple kernel that is right, to be moved onto the tensor
// cores later.  Tiles are staged in shared memory as f32 with rows padded
// to an odd word stride (no bank conflicts in the inner loops), rows past
// S zero-filled; key tiles the mask empties are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows and keys a tile
constexpr int kThreads = 256;  // 16 x 16: 4 rows x (4 columns | D/16 dims)
constexpr int kLdP = kTile + 1;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, bf16* dst) {
  *dst = __float2bfloat16(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// 16 bytes at p as f32: 4 floats or 8 bf16.
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// Rows [r0, r0 + 64) of a contiguous (S, D) matrix into dst (64 x (D + 1)
// f32), zero beyond S, in 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S) {
  constexpr int kLd = D + 1;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecs = kTile * D / kVec;
  for (int i = threadIdx.x; i < kVecs; i += kThreads) {
    const int e = i * kVec;
    const int row = e / D, col = e % D;
    float x[kVec];
    if (r0 + row < S) {
      load_vec(src + static_cast<int64_t>(r0 + row) * D + col, x);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = 0.f;
    }
    float* d = dst + row * kLd + col;
#pragma unroll
    for (int j = 0; j < kVec; ++j) d[j] = x[j];
  }
}

__device__ __forceinline__ bool allowed(int row, int col, int S, int causal,
                                        int window) {
  return row < S && col < S && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

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
// 1. log-sum-exp (base 2, of the scores times log2(e)) and delta per row
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_prep(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ o, const T* __restrict__ dout,
            float* __restrict__ lse, float* __restrict__ delta, int Hq,
            int Hkv, int S, int causal, int window, float scale_log2) {
  constexpr int kLd = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * kLd;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int64_t q_base = (static_cast<int64_t>(b) * Hq + h) * S * D;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + g) * S * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, D>(qs, q + q_base, q0, S);
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
  }
  int lo, hi;
  key_tiles(q0, S, causal, window, lo, hi);
  for (int t = lo; t < hi; ++t) {
    const int c0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(ks, k + kv_base, c0, S);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty * 4 + a;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = allowed(row, c0 + tx + 16 * j, S, causal, window);
        s[a][j] = ok ? s[a][j] * scale_log2 : kNegInf;
        mt = fmaxf(mt, s[a][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[a], mt);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        psum += s[a][j] > 0.5f * kNegInf ? exp2f(s[a][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[a] = exp2f(m[a] - m_new) * l[a] + psum;
      m[a] = m_new;
    }
  }

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
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (tx == 0 && row < S) {
      const int64_t at = (static_cast<int64_t>(b) * Hq + h) * S + row;
      // a row with no allowed key: P = 0 whatever its lse
      lse[at] = l[a] > 0.f ? m[a] + log2f(l[a]) : 0.f;
      delta[at] = dsum;
    }
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
// 2. dk, dv per (b, kv head, key tile)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int S,
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

  load_tile<T, D>(ks, k + kv_base, c0, S);
  load_tile<T, D>(vs, v + kv_base, c0, S);

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
      load_tile<T, D>(qs, q + q_base, q0, S);
      load_tile<T, D>(dos, dout + q_base, q0, S);
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
      store(dk_acc[a][j] * scale, dk + at + tx + 16 * j);
      store(dv_acc[a][j], dv + at + tx + 16 * j);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq per (b, q head, query tile)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Hq, int Hkv, int S, int causal, int window,
          float scale_log2, float scale) {
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

  load_tile<T, D>(qs, q + q_base, q0, S);
  load_tile<T, D>(dos, dout + q_base, q0, S);
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
    load_tile<T, D>(ks, k + kv_base, c0, S);
    load_tile<T, D>(vs, v + kv_base, c0, S);
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
      store(acc[a][j] * scale, dq + at + tx + 16 * j);
    }
  }
}

// The >48 KB shared-memory opt-in, once per device and kernel (one
// instance per kernel: kernels of one signature must not share the flag),
// so that later launches can be captured in a CUDA graph.
template <auto Kernel>
cudaError_t opt_in_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int B, int Hq, int Hkv, int S, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t kTileBytes = sizeof(float) * kTile * (D + 1);
  constexpr size_t kPBytes = sizeof(float) * kTile * kLdP;
  constexpr size_t kRowBytes = sizeof(float) * 2 * kTile;
  constexpr size_t kPrep = 2 * kTileBytes;
  constexpr size_t kPairs = 4 * kTileBytes + 2 * kPBytes + kRowBytes;
  cudaError_t err = opt_in_smem<fa_bwd_prep<T, D>>(kPrep);
  if (err == cudaSuccess) err = opt_in_smem<fa_bwd_dkdv<T, D>>(kPairs);
  if (err == cudaSuccess) err = opt_in_smem<fa_bwd_dq<T, D>>(kPairs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e * scale;
  const int n_tiles = (S + kTile - 1) / kTile;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  fa_bwd_prep<T, D><<<dim3(n_tiles, Hq, B), kThreads, kPrep, stream>>>(
      tq, tk, static_cast<const T*>(o), tdo, lse, delta, Hq, Hkv, S, causal,
      window, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dkdv<T, D><<<dim3(n_tiles, Hkv, B), kThreads, kPairs, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hkv, S, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dq<T, D><<<dim3(n_tiles, Hq, B), kThreads, kPairs, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), Hq, Hkv, S, causal,
      window, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* delta, int B, int Hq, int Hkv, int S, int D, int causal,
             int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                  B, Hq, Hkv, S, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                  B, Hq, Hkv, S, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                  B, Hq, Hkv, S, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse,
                                    delta, B, Hq, Hkv, S, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq: (B, Hq, S, D); k, v, dk, dv: (B, Hkv, S, D); lse and
// delta: (B, Hq, S) f32 scratch; every tensor contiguous, 16-byte
// aligned.  dtype: 0 = float32, 1 = bfloat16 (all of q..dv alike).
// window <= 0 means no window.  Three launches on `stream`; returns
// cudaGetLastError() after the last (0 on success), or the first error;
// refuses shapes it does not take with cudaErrorInvalidValue, before
// launching anything.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int B, int Hq, int Hkv, int S, int D, int causal, int window, int dtype,
    void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 ||
      Hq % Hkv != 0 || S < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, B,
                               Hq, Hkv, S, D, causal, window, s)
             : dispatch<bf16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B,
                              Hq, Hkv, S, D, causal, window, s);
}
