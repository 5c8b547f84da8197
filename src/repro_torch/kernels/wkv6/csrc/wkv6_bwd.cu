// wkv6 backward: the gradients of the RWKV6 (Finch) WKV recurrence,
// written for Hopper (sm_90a).
//
//   r, k, v, w, do, dr, dk, dv, dw: (B, H, T, D); u, du: (H, D)
//   forward, per (b, h) from S_0 = 0 (a D x D f32 state):
//     o_t = r_t (S_t + diag(u) k_t^T v_t),  S_{t+1} = diag(w_t) S_t + k_t^T v_t
//   backward, a reverse scan from dS_T = 0:
//     dS_t  = diag(w_t) dS_{t+1} + r_t^T do_t
//     dr_t  = do_t (S_t + diag(u) k_t^T v_t)^T
//     dk_t  = u * r_t (v_t . do_t) + dS_{t+1} v_t^T
//     dv_t  = (r_t * u * k_t) . 1 do_t + k_t dS_{t+1}
//     dw_t  = rowsum(dS_{t+1} * S_t)
//     du    = sum over b and t of r_t * k_t (v_t . do_t)
//
// The TPU package has no backward kernel: its Pallas `wkv`
// (src/repro/kernels/wkv6/kernel.py) is forward-only and its training
// differentiates the jnp scan (ref.py).  This is the backward of the
// port's forward kernel (wkv6.cu), on the CUDA cores in f32 for f32 and
// bf16 inputs, gradients in the input type.  It takes its layout from the
// per-channel design of the public RWKV-LM wkv6 CUDA backward (BlinkDL):
// rows and columns of the state evolve alone, since the decay scales
// rows.  Three launches:
//
// 1. `wkv6_bwd_rows`, one block per (b, h), four lanes of a quad per state
//    row i, each lane holding the columns lane + 4 c: dr, dk and dw of row
//    i are sums along it (partial sums in each lane, then two shuffles),
//    and the row's du is summed over t in a register.  dw needs S_t in the
//    reverse scan; it is never recovered by dividing by the decay
//    (rwkv6-1.6b's decays reach 2.6e-10, and exactly 0 is allowed) but
//    recomputed: a forward pass checkpoints S every 64 steps to device
//    memory; the reverse pass walks each 64-step chunk from its
//    checkpoint, writing S at every 8th step to a per-block scratch, and
//    each 8-step sub-chunk's states into shared memory, which the reverse
//    steps then read back.  The chunk's r, k, v, w and do are staged in
//    shared memory as f32.
// 2. `wkv6_bwd_dv`, per (b, h, group of up to 32 state columns), four
//    lanes a column: dv_t[j] = sum_i k_t[i] (dS_{t+1}[i][j] + u[i] r_t[i]
//    do_t[j]) is the forward's recurrence run backwards in time with r and
//    k swapped and do for v, so it is the forward scan's column split.
// 3. `wkv6_bwd_du`: du[h] as the sum of the (b, h) partials in the order
//    of b, so du, like every other gradient here, is deterministic.
//
// Bound at rwkv6-1.6b's training shape (B = 4, H = 32, T = 2048, D = 64,
// bf16): five (B, H, T, D) inputs read and four written, 302 MB, 0.090 ms
// at 3.35 TB/s; the recurrences' least work (one forward pass of the state,
// the reverse scan with its row sums, and dv: 14 D^2 FLOP a step, 1.5e10
// FLOP) is below that at the bf16 tensor-core rate, and 0.22 ms at the f32
// rate of 67 TFLOP/s.  This kernel does 22 D^2 a step (three forward
// passes) on the CUDA cores, and the (b, h) blocks of the row pass fill
// only as many SMs as there are heads.  The checkpoints add 64 MB (level
// 1) and 16 MB (level 2) of scratch at that shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, bf16* dst) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// ---------------------------------------------------------------------------
// 1. dr, dk, dw and the du partials, by state row
// ---------------------------------------------------------------------------
constexpr int kL1 = 64;  // steps a chunk: staged, its start checkpointed
constexpr int kL2 = 8;   // steps a sub-chunk: its states in shared memory
constexpr int kSubs = kL1 / kL2;

template <int D>
struct Rows {
  static constexpr int kThreads = 4 * D;  // a quad per state row
  static constexpr int kCW = D / 4;       // state columns a lane
  static constexpr int kStage = 5 * kL1 * D;      // r, k, v, w, do (f32)
  static constexpr int kStates = kL2 * D * D;     // a sub-chunk's states
  static constexpr size_t kBytes = sizeof(float) * (kStage + kStates);
};

template <typename T, int D>
__global__ void __launch_bounds__(Rows<D>::kThreads)
wkv6_bwd_rows(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ w,
              const T* __restrict__ u, const T* __restrict__ dout,
              T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dw,
              float* __restrict__ du_part, float* __restrict__ ckpt1,
              float* __restrict__ ckpt2, int H, int T_len) {
  using R = Rows<D>;
  constexpr int kCW = R::kCW;
  constexpr int kN = R::kThreads;
  extern __shared__ float smem[];
  float* rs = smem;
  float* ks = rs + kL1 * D;
  float* vs = ks + kL1 * D;
  float* ws = vs + kL1 * D;
  float* dos = ws + kL1 * D;
  float* states = smem + R::kStage;

  const int bh = blockIdx.x;
  const int i = threadIdx.x >> 2, lane = threadIdx.x & 3;
  const int64_t base = static_cast<int64_t>(bh) * T_len * D;
  const int n1 = (T_len + kL1 - 1) / kL1;
  float* c1 = ckpt1 + static_cast<int64_t>(bh) * n1 * D * D;
  float* c2 = ckpt2 + static_cast<int64_t>(bh) * kSubs * D * D;
  const float uu = to_f32(u[(bh % H) * D + i]);

  // row i, columns lane + 4 c: this thread's part of the state; each
  // thread reads back only what it wrote itself
  float S[kCW];
  auto save = [&](float* dst) {
#pragma unroll
    for (int c = 0; c < kCW; ++c) dst[i * D + lane + 4 * c] = S[c];
  };
  auto load = [&](const float* src) {
#pragma unroll
    for (int c = 0; c < kCW; ++c) S[c] = src[i * D + lane + 4 * c];
  };
  auto step = [&](int s) {  // S_{t+1} from S_t, staged step s
    const float kk = ks[s * D + i], ww = ws[s * D + i];
#pragma unroll
    for (int c = 0; c < kCW; ++c)
      S[c] = fmaf(ww, S[c], kk * vs[s * D + lane + 4 * c]);
  };
  auto stage = [&](float* dst, const T* src, int t0) {
    for (int e = threadIdx.x; e < kL1 * D; e += kN) {
      const int t = t0 + e / D;
      dst[e] = t < T_len ? to_f32(src[base + static_cast<int64_t>(t0) * D +
                                      e])
                         : 0.f;
    }
  };

  // forward: the state at the start of every chunk
#pragma unroll
  for (int c = 0; c < kCW; ++c) S[c] = 0.f;
  for (int m1 = 0; m1 < n1; ++m1) {
    const int t0 = m1 * kL1;
    save(c1 + static_cast<int64_t>(m1) * D * D);
    __syncthreads();  // the previous chunk's readers are done
    stage(ks, k, t0);
    stage(vs, v, t0);
    stage(ws, w, t0);
    __syncthreads();
    const int n = min(kL1, T_len - t0);
    for (int s = 0; s < n; ++s) step(s);
  }

  // reverse: dS_{t+1} in registers, a chunk at a time
  float dS[kCW];
#pragma unroll
  for (int c = 0; c < kCW; ++c) dS[c] = 0.f;
  float du_acc = 0.f;
  for (int m1 = n1 - 1; m1 >= 0; --m1) {
    const int t0 = m1 * kL1;
    const int n = min(kL1, T_len - t0);
    __syncthreads();
    stage(rs, r, t0);
    stage(ks, k, t0);
    stage(vs, v, t0);
    stage(ws, w, t0);
    stage(dos, dout, t0);
    __syncthreads();
    load(c1 + static_cast<int64_t>(m1) * D * D);
    for (int s = 0; s < n; ++s) {
      if (s % kL2 == 0) save(c2 + (s / kL2) * D * D);
      step(s);
    }
    for (int m2 = (n - 1) / kL2; m2 >= 0; --m2) {
      const int s0 = m2 * kL2;
      const int ns = min(kL2, n - s0);
      load(c2 + m2 * D * D);
      for (int q = 0; q < ns; ++q) {
#pragma unroll
        for (int c = 0; c < kCW; ++c)
          states[(q * kCW + c) * kN + threadIdx.x] = S[c];
        step(s0 + q);
      }
      for (int q = ns - 1; q >= 0; --q) {
        const int s = s0 + q;
#pragma unroll
        for (int c = 0; c < kCW; ++c)
          S[c] = states[(q * kCW + c) * kN + threadIdx.x];
        const float rr = rs[s * D + i], kk = ks[s * D + i];
        const float ww = ws[s * D + i];
        float p_dr = 0.f, p_dk = 0.f, p_dw = 0.f, p_vdo = 0.f;
#pragma unroll
        for (int c = 0; c < kCW; ++c) {
          const float dd = dos[s * D + lane + 4 * c];
          const float vv = vs[s * D + lane + 4 * c];
          p_dr = fmaf(dd, S[c], p_dr);
          p_dk = fmaf(dS[c], vv, p_dk);
          p_dw = fmaf(dS[c], S[c], p_dw);
          p_vdo = fmaf(vv, dd, p_vdo);
        }
        p_dr = quad_sum(p_dr);
        p_dk = quad_sum(p_dk);
        p_dw = quad_sum(p_dw);
        p_vdo = quad_sum(p_vdo);
        const int64_t at = base + static_cast<int64_t>(t0 + s) * D + i;
        if (lane == 0) store(fmaf(uu * kk, p_vdo, p_dr), dr + at);
        if (lane == 1) store(fmaf(rr * uu, p_vdo, p_dk), dk + at);
        if (lane == 2) store(p_dw, dw + at);
        du_acc = fmaf(rr * kk, p_vdo, du_acc);
#pragma unroll
        for (int c = 0; c < kCW; ++c)
          dS[c] = fmaf(ww, dS[c], rr * dos[s * D + lane + 4 * c]);
      }
    }
  }
  if (lane == 0) du_part[static_cast<int64_t>(bh) * D + i] = du_acc;
}

// ---------------------------------------------------------------------------
// 2. dv, by state column
// ---------------------------------------------------------------------------
constexpr int kDvChunk = 32;  // steps staged in shared memory at once

template <int D>
struct Dv {
  static constexpr int kCols = D < 32 ? D : 32;  // state columns a block
  static constexpr int kThreads = kCols * 4;
  static constexpr int kGroups = D / kCols;       // blocks per (b, h)
  static constexpr int kRows = D / 4;             // rows lane + 4 c
  static constexpr size_t kBytes = sizeof(float) * 4 * kDvChunk * D;
};

template <typename T, int D>
__global__ void __launch_bounds__(Dv<D>::kThreads)
wkv6_bwd_dv(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ w, const T* __restrict__ u,
            const T* __restrict__ dout, T* __restrict__ dv, int H,
            int T_len) {
  using V = Dv<D>;
  constexpr int kRows = V::kRows;
  extern __shared__ float smem[];
  float* rs = smem;
  float* ks = rs + kDvChunk * D;
  float* ws = ks + kDvChunk * D;
  float* dos = ws + kDvChunk * D;
  const int bh = blockIdx.x / V::kGroups;
  const int j = (blockIdx.x % V::kGroups) * V::kCols + threadIdx.x / 4;
  const int lane = threadIdx.x & 3;
  const int64_t base = static_cast<int64_t>(bh) * T_len * D;

  float X[kRows], uu[kRows];  // dS_{t+1}[lane + 4 c][j]
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    X[c] = 0.f;
    uu[c] = to_f32(u[(bh % H) * D + lane + 4 * c]);
  }
  auto stage = [&](float* dst, const T* src, int t0) {
    for (int e = threadIdx.x; e < kDvChunk * D; e += V::kThreads) {
      const int t = t0 + e / D;
      dst[e] = t < T_len ? to_f32(src[base + static_cast<int64_t>(t0) * D +
                                      e])
                         : 0.f;
    }
  };
  const int n_chunks = (T_len + kDvChunk - 1) / kDvChunk;
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kDvChunk;
    __syncthreads();  // the previous chunk's readers are done
    stage(rs, r, t0);
    stage(ks, k, t0);
    stage(ws, w, t0);
    stage(dos, dout, t0);
    __syncthreads();
    for (int s = min(kDvChunk, T_len - t0) - 1; s >= 0; --s) {
      const float dd = dos[s * D + j];
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kRows; ++c) {
        const int ii = lane + 4 * c;
        const float rr = rs[s * D + ii];
        acc = fmaf(ks[s * D + ii], fmaf(uu[c] * rr, dd, X[c]), acc);
        X[c] = fmaf(ws[s * D + ii], X[c], rr * dd);
      }
      acc = quad_sum(acc);
      if (lane == 0) {
        store(acc, dv + base + static_cast<int64_t>(t0 + s) * D + j);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. du: the (b, h) partials summed over b, in order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            T* __restrict__ du, int B, int HD) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= HD) return;
  float sum = 0.f;
  for (int b = 0; b < B; ++b) {
    sum += du_part[static_cast<int64_t>(b) * HD + e];
  }
  store(sum, du + e);
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dout, void* dr, void* dk, void* dv,
           void* dw, void* du, float* du_part, float* ckpt1, float* ckpt2,
           int B, int H, int T_len, cudaStream_t stream) {
  cudaError_t err = opt_in_smem<wkv6_bwd_rows<T, D>>(Rows<D>::kBytes);
  if (err == cudaSuccess) {
    err = opt_in_smem<wkv6_bwd_dv<T, D>>(Dv<D>::kBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* tr = static_cast<const T*>(r);
  const T* tk = static_cast<const T*>(k);
  const T* tw = static_cast<const T*>(w);
  const T* tu = static_cast<const T*>(u);
  const T* tdo = static_cast<const T*>(dout);
  wkv6_bwd_rows<T, D><<<B * H, Rows<D>::kThreads, Rows<D>::kBytes,
                        stream>>>(
      tr, tk, static_cast<const T*>(v), tw, tu, tdo, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dw), du_part, ckpt1, ckpt2, H,
      T_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_dv<T, D><<<B * H * Dv<D>::kGroups, Dv<D>::kThreads,
                      Dv<D>::kBytes, stream>>>(tr, tk, tw, tu, tdo,
                                               static_cast<T*>(dv), H, T_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hd = H * D;
  wkv6_bwd_du<T><<<(hd + 255) / 256, 256, 0, stream>>>(
      du_part, static_cast<T*>(du), B, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* dout, void* dr, void* dk, void* dv,
             void* dw, void* du, float* du_part, float* ckpt1, float* ckpt2,
             int B, int H, int T_len, int D, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(r, k, v, w, u, dout, dr, dk, dv, dw, du,
                                du_part, ckpt1, ckpt2, B, H, T_len, s);
    case 16: return launch<T, 16>(r, k, v, w, u, dout, dr, dk, dv, dw, du,
                                  du_part, ckpt1, ckpt2, B, H, T_len, s);
    case 32: return launch<T, 32>(r, k, v, w, u, dout, dr, dk, dv, dw, du,
                                  du_part, ckpt1, ckpt2, B, H, T_len, s);
    case 64: return launch<T, 64>(r, k, v, w, u, dout, dr, dk, dv, dw, du,
                                  du_part, ckpt1, ckpt2, B, H, T_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw: (B, H, T, D); u, du: (H, D); all
// contiguous, one type (dtype 0 = float32, 1 = bfloat16).  Scratch, f32:
// du_part (B, H, D), ckpt1 (B, H, ceil(T / 64), D, D), ckpt2 (B, H, 8, D,
// D).  Three launches on `stream`; returns cudaGetLastError() after the
// last (0 on success), or the first error; refuses shapes it does not
// take with cudaErrorInvalidValue, before launching anything.
extern "C" int wkv6_backward_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* dout, void* dr, void* dk, void* dv, void* dw,
    void* du, float* du_part, float* ckpt1, float* ckpt2, int B, int H,
    int T_len, int D, int dtype, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 ||
      static_cast<int64_t>(B) * H * (D < 32 ? 1 : D / 32) > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(r, k, v, w, u, dout, dr, dk, dv, dw, du,
                                   du_part, ckpt1, ckpt2, B, H, T_len, D, s);
    case 1: return dispatch<bf16>(r, k, v, w, u, dout, dr, dk, dv, dw, du,
                                  du_part, ckpt1, ckpt2, B, H, T_len, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
