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
// port's forward kernel (wkv6.cu), gradients in the input type.  dw needs
// S_t beside dS_{t+1}; it is never recovered by dividing by a decay
// (rwkv6-1.6b's decays reach 2.6e-10, and exactly 0 is allowed) but
// recomputed.  No float atomics anywhere: every gradient is
// deterministic.  Two designs, chosen by type as the forward's:
//
// * bfloat16 at D >= 16, the type the models train in: the chunked form
//   on the tensor cores (ref.wkv_chunked_backward is its plain twin).
//   Three launches:
//   1. `wkv6_bwd_states`, 2 B H blocks: half walk T forward a 64-step
//      chunk at a time and write the state S at every chunk's start, half
//      walk it backward and write dS at every chunk's end, each update
//      S <- diag(G) S + (k * b)^T v (dS <- diag(G) dS + (r * f)^T do) as
//      mma.sync m16n8k16 bf16 products with f32 accumulation; the two
//      directions need nothing of each other.
//   2. `wkv6_bwd_chunk`, per (b, h, 64-step chunk): B H T / 64
//      independent items, taken in turn by one persistent block an SM,
//      which sends the next item's rows and states towards L2 as it
//      starts on one.  It rebuilds S at the start and dS at the end of
//      each 16-step sub-chunk from its chunk's two, then per sub-chunk of
//      steps st..e, with f_t = prod_{st<=tau<t} w_tau, b_t =
//      prod_{t<tau<=e} w_tau, d(s, t) = prod_{s<tau<t} w_tau, M = dO V^T
//      and A the forward's intra-sub-chunk scores (bonus on its diagonal):
//        dr_t = f_t (do_t S_0^T) + sum_{s<t} M[t,s] d(s,t) k_s + u k_t M[t,t]
//        dk_s = b_s (v_s dS_E^T) + sum_{t>s} M[t,s] d(s,t) r_t + u r_s M[s,s]
//        dv_s = (k_s b_s) dS_E + sum_{t>=s} A[t,s] do_t
//        dw_t = f_t b_t rowsum(dS_E S_0) + b_t sum_{s<t} d(s,t) X_s
//             + f_t sum_{t'>t} d(t,t') Y_t' + sum_{s<t<t'} d(s,t) d(t,t')
//               k_s r_t' M[t',s]
//      with X = K * (V dS_E^T), Y = R * (dO S_0^T) and the last term by
//      the scan U_{t+1}[t'] = w_t U_t[t'] + k_t M[t',t].  The D x D-sized
//      products (dO S_0^T, V dS_E^T, (K * b) dS_E, A^T dO, M and the
//      state updates) run on the tensor cores, D / 4 warps sharing them
//      out by 16 output columns; the per-channel sums and scans, and A
//      (as the forward builds it), on the CUDA cores, two threads per
//      (sub-chunk, channel): one walks the sub-chunk forward (dr, and dw
//      but for its third term), the other backward (dk, dw's third term,
//      du).  The chunk's inputs, A, the four S and one dS as bf16
//      hi and lo parts and the f32 products take 226 KB of shared memory
//      at D = 64.  Every decay factor is a product of decays in [0, 1],
//      never a quotient.  Each f32 operand that is not a bf16 input (S,
//      dS, r * f, k * b, A) is split into bf16 high and low parts and
//      multiplied as hi.hi + hi.lo + lo.hi, as the forward does.
//   3. `wkv6_bwd_du`: du as the sum of the (b, h, chunk) partials, in
//      order.
// * float32 (held to 2e-3 of the gradients, which TF32 would not meet),
//   and bfloat16 at D = 8: the scan on the CUDA cores, after the
//   per-channel design of the public RWKV-LM wkv6 CUDA backward
//   (BlinkDL): rows and columns of the state evolve alone, since the
//   decay scales rows.  Three launches:
//   1. `wkv6_bwd_rows`, one block per (b, h), four lanes of a quad per
//      state row i, each lane holding the columns lane + 4 c: dr, dk and
//      dw of row i are sums along it (partial sums in each lane, then two
//      shuffles), and the row's du is summed over t in a register.  A
//      forward pass checkpoints S every 64 steps to device memory; the
//      reverse pass walks each 64-step chunk from its checkpoint, writing
//      S at every 8th step to a per-block scratch, and each 8-step
//      sub-chunk's states into shared memory, which the reverse steps then
//      read back.
//   2. `wkv6_bwd_dv`, per (b, h, group of up to 32 state columns), four
//      lanes a column: dv_t[j] = sum_i k_t[i] (dS_{t+1}[i][j] + u[i] r_t[i]
//      do_t[j]) is the forward's recurrence run backwards in time with r
//      and k swapped and do for v, so it is the forward scan's column
//      split.
//   3. `wkv6_bwd_du`, as above, over (b, h) partials.
//
// Bound at rwkv6-1.6b's training shape (B = 4, H = 32, T = 2048, D = 64,
// bf16): five (B, H, T, D) inputs read and four written, 302 MB, 0.090 ms
// at 3.35 TB/s; the recurrences' least work (14 D^2 FLOP a step) is below
// that at the bf16 tensor-core rate.  The chunked design's own floor adds
// its two boundary buffers, (B, H, T / 64, D, D) f32 each (67 MB), written
// once and read once: 570 MB, 0.170 ms.  Its products, splits included,
// are 1792 D^2 + 6144 D FLOP a chunk, 3.2e10 (0.032 ms at 989 TFLOP/s).
// The scan design does 22 D^2 f32 FLOP a step on the CUDA cores in (b, h)
// blocks, a dependent chain of T steps each.
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
// The scan design on the CUDA cores (f32; bf16 at D = 8)
// ---------------------------------------------------------------------------
// 1. dr, dk, dw and the du partials, by state row
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

// 2. dv, by state column
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
// The chunked design on the tensor cores (bf16, D >= 16)
// ---------------------------------------------------------------------------
constexpr int kL = 64;    // steps a chunk: one block of `wkv6_bwd_chunk`
constexpr int kSub = 16;  // steps a sub-chunk: one mma tile deep
constexpr int kNSub = kL / kSub;
constexpr int kLdS = kSub + 8;  // row stride of A's bf16 (t, s) tiles

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x as bf16 high and low parts: hi + lo holds x to ~2**-17.
__device__ __forceinline__ void split(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}
// Two floats as bf16 pairs, high and low parts; a in the low half.
__device__ __forceinline__ void split2(float a, float b, uint32_t* hi,
                                       uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// mma.sync m16n8k16 fragments (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), g = lane / 4, q = lane % 4:
//   A (16 x 16, row-major M x K): {(g, 2q..), (g + 8, 2q..), (g, 2q + 8..),
//                                  (g + 8, 2q + 8..)}
//   B (16 x 8, K x N):            {(2q.., g), (2q + 8.., g)}
//   C (16 x 8 f32):               {(g, 2q), (g, 2q + 1), (g + 8, 2q),
//                                  (g + 8, 2q + 1)}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix: four 8 x 8 bf16 tiles, row addresses from the lanes (lanes
// 8m..8m+7 give tile m's rows); .trans hands each lane the transpose.
__device__ __forceinline__ void ldsm4(const bf16* p, uint32_t (&x)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(const bf16* p, uint32_t (&x)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(smem_addr(p)));
}
// This lane's row address in a 16 x 16 tile at p (row stride ld) for
// tiles (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
__device__ __forceinline__ const bf16* rows_a(const bf16* p, int ld,
                                              int lane) {
  return p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
// Tiles (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15).
__device__ __forceinline__ const bf16* rows_at(const bf16* p, int ld,
                                               int lane) {
  return p + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}
// The four fragment loads of a 16 x 16 tile at p, each giving an A
// fragment or the B fragments of two 8-column tiles ({x0, x1} and
// {x2, x3}):
//   A of a row-major M x K tile        ldsm4(rows_a)
//   A of the transpose of a K x M tile ldsm4_t(rows_at)
//   B of a row-major K x N tile        ldsm4_t(rows_a)
//   B of the transpose of an N x K tile ldsm4(rows_at)
__device__ __forceinline__ void a_mk(const bf16* p, int ld, int lane,
                                     uint32_t (&x)[4]) {
  ldsm4(rows_a(p, ld, lane), x);
}
__device__ __forceinline__ void a_km(const bf16* p, int ld, int lane,
                                     uint32_t (&x)[4]) {
  ldsm4_t(rows_at(p, ld, lane), x);
}
__device__ __forceinline__ void b_kn(const bf16* p, int ld, int lane,
                                     uint32_t (&x)[4]) {
  ldsm4_t(rows_a(p, ld, lane), x);
}
__device__ __forceinline__ void b_nk(const bf16* p, int ld, int lane,
                                     uint32_t (&x)[4]) {
  ldsm4(rows_at(p, ld, lane), x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// 4 bf16 at p (8-byte aligned) as f32
__device__ __forceinline__ float4 bf4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// A D x D f32 state held in mma accumulators, in units of 16 rows x 16
// columns (two 8-column tiles): unit u of (D / 16)^2 covers rows
// [16 (u / (D / 16)), +16) and columns [16 (u % (D / 16)), +16); warp w
// of Warps holds units w, w + Warps, ...
template <int D, int Warps>
struct State {
  static constexpr int kWarps = Warps;
  static constexpr int kUnits = (D / 16) * (D / 16);
  static constexpr int kMine = (kUnits + kWarps - 1) / kWarps;
  float acc[kMine][2][4];

  __device__ static int unit(int x, int warp) { return warp + kWarps * x; }
  // element e of 8-column tile nn of unit x: its row and column
  __device__ static int row(int x, int warp, int lane, int e) {
    return 16 * (unit(x, warp) / (D / 16)) + lane / 4 + (e >= 2 ? 8 : 0);
  }
  __device__ static int col(int x, int warp, int lane, int nn) {
    return 16 * (unit(x, warp) % (D / 16)) + 8 * nn + 2 * (lane % 4);
  }
  __device__ void load(const float* src, int warp, int lane) {
#pragma unroll
    for (int x = 0; x < kMine; ++x) {
      if (unit(x, warp) >= kUnits) continue;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float2 s = *reinterpret_cast<const float2*>(
              src + row(x, warp, lane, e) * D + col(x, warp, lane, nn));
          acc[x][nn][e] = s.x;
          acc[x][nn][e + 1] = s.y;
        }
      }
    }
  }
  __device__ void store(float* dst, int warp, int lane) const {
#pragma unroll
    for (int x = 0; x < kMine; ++x) {
      if (unit(x, warp) >= kUnits) continue;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          *reinterpret_cast<float2*>(dst + row(x, warp, lane, e) * D +
                                     col(x, warp, lane, nn)) =
              make_float2(acc[x][nn][e], acc[x][nn][e + 1]);
        }
      }
    }
  }
  // as bf16 high and low parts into two (i, j) tiles of row stride ld
  __device__ void store_split(bf16* hi, bf16* lo, int ld, int warp,
                              int lane) const {
#pragma unroll
    for (int x = 0; x < kMine; ++x) {
      if (unit(x, warp) >= kUnits) continue;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int at = row(x, warp, lane, e) * ld + col(x, warp, lane, nn);
          split2(acc[x][nn][e], acc[x][nn][e + 1],
                 reinterpret_cast<uint32_t*>(hi + at),
                 reinterpret_cast<uint32_t*>(lo + at));
        }
      }
    }
  }
  // S <- diag(g) S + P^T X over `steps` x 16 steps: P (t, i) as hi and lo
  // bf16 tiles, X (t, j) bf16, both of row stride ld
  __device__ void update(const float* g, const bf16* p_hi, const bf16* p_lo,
                         const bf16* xs, int ld, int steps, int warp,
                         int lane) {
#pragma unroll
    for (int x = 0; x < kMine; ++x) {
      if (unit(x, warp) >= kUnits) continue;
      const int i0 = 16 * (unit(x, warp) / (D / 16));
      const int j0 = 16 * (unit(x, warp) % (D / 16));
      const float g0 = g[i0 + lane / 4], g1 = g[i0 + lane / 4 + 8];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        acc[x][nn][0] *= g0;
        acc[x][nn][1] *= g0;
        acc[x][nn][2] *= g1;
        acc[x][nn][3] *= g1;
      }
      for (int kk = 0; kk < steps; ++kk) {
        uint32_t a_hi[4], a_lo[4], b[4];
        a_km(p_hi + 16 * kk * ld + i0, ld, lane, a_hi);
        a_km(p_lo + 16 * kk * ld + i0, ld, lane, a_lo);
        b_kn(xs + 16 * kk * ld + j0, ld, lane, b);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          mma(acc[x][nn], a_hi, b[2 * nn], b[2 * nn + 1]);
          mma(acc[x][nn], a_lo, b[2 * nn], b[2 * nn + 1]);
        }
      }
    }
  }
};

// 1. The states at the chunks' boundaries
template <int D>
struct States {
  static constexpr int kThreads = 4 * D;  // a thread per (sub-chunk, row)
  static constexpr int kLd = D + 8;       // bf16 row stride: spreads banks
  static constexpr int kTile = kL * kLd;
  // 2 buffers x (the decayed operand, the other, w) as loaded, then the
  // decayed operand's hi and lo parts, then each sub-chunk's decay
  static constexpr int kRaw = 0;
  static constexpr int kOp = kRaw + 2 * 3 * kTile * 2;
  static constexpr int kG = kOp + 2 * kTile * 2;
  static constexpr int kGc = kG + kNSub * D * 4;  // the chunk's decay
  static constexpr int kBytes = kGc + D * 4;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

// Blocks [0, B H) walk chunk c = 0, 1, ... writing S at each chunk's start
// to states[b, h, c] and then S <- diag(G_c) S + (k * b)^T v, b_s the
// decay from s to the chunk's end; blocks [B H, 2 B H) walk c = n - 1,
// ..., 0 writing dS at each chunk's end to dstates[b, h, c] and then
// dS <- diag(G_c) dS + (r * f)^T do, f_t the decay from the chunk's start
// to t.  Rows past T are zero-filled and only reach a state past T.
template <int D>
__global__ void __launch_bounds__(States<D>::kThreads)
wkv6_bwd_states(const bf16* __restrict__ r, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ w,
                const bf16* __restrict__ dout, float* __restrict__ states,
                float* __restrict__ dstates, int BH, int T_len, int n) {
  using C = States<D>;
  constexpr int kLd = C::kLd, kTile = C::kTile;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* raw = reinterpret_cast<bf16*>(smem_tc + C::kRaw);
  bf16* op_hi = reinterpret_cast<bf16*>(smem_tc + C::kOp);
  bf16* op_lo = op_hi + kTile;
  float* gs = reinterpret_cast<float*>(smem_tc + C::kG);
  float* gc = reinterpret_cast<float*>(smem_tc + C::kGc);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool rev = static_cast<int>(blockIdx.x) >= BH;
  const int bh = blockIdx.x - (rev ? BH : 0);
  const int64_t base = static_cast<int64_t>(bh) * T_len * D;
  const bf16* decayed = rev ? r : k;
  const bf16* other = rev ? dout : v;
  float* out = (rev ? dstates : states) + static_cast<int64_t>(bh) * n * D * D;
  const int p = tid / D, i = tid % D;  // this thread's sub-chunk and row

  auto chunk = [&](int it) { return rev ? n - 1 - it : it; };
  // chunk c's rows of the decayed operand, the other and w into buffer
  // it % 2, in 16-byte asynchronous copies; rows past T are zero-filled
  auto issue = [&](int it) {
    constexpr int kSegs = kL * D / 8;
    const int t0 = chunk(it) * kL;
    bf16* dst = raw + (it & 1) * 3 * kTile;
    for (int idx = tid; idx < 3 * kSegs; idx += C::kThreads) {
      const int a = idx / kSegs, rem = idx % kSegs;
      const int row = rem / (D / 8), col = (rem % (D / 8)) * 8;
      const bool valid = t0 + row < T_len;
      const bf16* arr = a == 0 ? decayed : a == 1 ? other : w;
      cp_async16(dst + a * kTile + row * kLd + col,
                 arr + base + static_cast<int64_t>(valid ? t0 + row : 0) * D +
                     col,
                 valid);
    }
    cp_async_commit();
  };

  State<D, D / 8> s;
#pragma unroll
  for (int x = 0; x < State<D, D / 8>::kMine; ++x) {
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s.acc[x][nn][e] = 0.f;
    }
  }
  issue(0);
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // chunk it has landed; chunk it - 1 is done with
    if (it + 1 < n) issue(it + 1);  // the buffer this refills
    s.store(out + static_cast<int64_t>(chunk(it)) * D * D, warp, lane);
    if (it + 1 == n) break;
    const bf16* buf = raw + (it & 1) * 3 * kTile;
    const bf16* xr = buf;              // the decayed operand
    const bf16* wr = buf + 2 * kTile;  // w
    // each sub-chunk's decay, per row (the previous chunk's readers of
    // gs, op and gc passed the barrier above)
    float gp = 1.f;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      gp *= __bfloat162float(wr[(kSub * p + t) * kLd + i]);
    }
    gs[p * D + i] = gp;
    __syncthreads();
    // the decayed operand times its decay to the chunk's end (forward) or
    // from its start (reverse), a product of the sub-chunks' decays past
    // (before) this one and the steps' within it
    float m = 1.f;
    for (int q = 0; q < kNSub; ++q) {
      if (rev ? q < p : q > p) m *= gs[q * D + i];
    }
#pragma unroll
    for (int x = 0; x < kSub; ++x) {
      const int row = kSub * p + (rev ? x : kSub - 1 - x);
      split(__bfloat162float(xr[row * kLd + i]) * m,
            op_hi + row * kLd + i, op_lo + row * kLd + i);
      m *= __bfloat162float(wr[row * kLd + i]);
    }
    if (p == 0) {  // the whole chunk's decay, per row
      gc[i] = gs[i] * gs[D + i] * gs[2 * D + i] * gs[3 * D + i];
    }
    __syncthreads();
    s.update(gc, op_hi, op_lo, buf + kTile, kLd, kNSub, warp, lane);
  }
}

// 2. The gradients, a block per (b, h, chunk)
template <int D>
struct Chunk {
  // two threads per (sub-chunk, row): the work on r and on k
  static constexpr int kThreads = 8 * D;
  static constexpr int kWarps = D / 4;
  static constexpr int kLd = D + 8;   // bf16 row stride: spreads the banks
  static constexpr int kLdF = D + 4;  // f32 row stride
  static constexpr int kTile = kL * kLd;  // one (t, i) bf16 tile
  static constexpr int kSlot = D * kLd;   // one (i, j) bf16 tile
  // r, k, v, w, do as loaded
  static constexpr int kRaw = 0;
  // r * f and k * b, each as hi and lo parts
  static constexpr int kOp = kRaw + 5 * kTile * 2;
  // A, hi and lo parts, (t, s) per sub-chunk
  static constexpr int kA = kOp + 4 * kTile * 2;
  // five state tiles, hi and lo parts: S at the sub-chunks' starts in 0-3,
  // then dS at sub-chunk p's end in p + 1 (S_0 of p + 1 is spent by then)
  static constexpr int kSlots = kA + 2 * kL * kLdS * 2;
  // f32 (t, i) tiles: r and k times their decays within their 4-step
  // block (for A), then dO S_0^T and V dS_E^T
  static constexpr int kF32 = kSlots + 10 * kSlot * 2;
  // each 4-step block's decay (for A), then M per sub-chunk and the
  // rowsum(dS_E S_0) partials per sub-chunk and 16 columns
  static constexpr int kSmall = kF32 + 2 * kL * kLdF * 4;
  static constexpr int kM = kNSub * kSub * kSub;
  static constexpr int kSmallFloats =
      16 * D > kM + kNSub * D * D / 16 ? 16 * D : kM + kNSub * D * D / 16;
  static constexpr int kG = kSmall + kSmallFloats * 4;  // G per sub-chunk
  static constexpr int kU = kG + kNSub * D * 4;
  static constexpr int kDu = kU + D * 4;  // du per sub-chunk
  static constexpr int kBytes = kDu + kNSub * D * 4;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

template <int D>
__global__ void __launch_bounds__(Chunk<D>::kThreads, 1)
wkv6_bwd_chunk(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ w,
               const bf16* __restrict__ u, const bf16* __restrict__ dout,
               bf16* __restrict__ dr, bf16* __restrict__ dk,
               bf16* __restrict__ dv, bf16* __restrict__ dw,
               float* __restrict__ du_part,
               const float* __restrict__ states,
               const float* __restrict__ dstates, int H, int T_len, int n,
               int items) {
  using C = Chunk<D>;
  using St = State<D, C::kWarps>;
  constexpr int kLd = C::kLd, kLdF = C::kLdF, kTile = C::kTile;
  constexpr int kSlot = C::kSlot, NT = C::kThreads, kWarps = C::kWarps;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* raw = reinterpret_cast<bf16*>(smem_tc + C::kRaw);
  const bf16* rr = raw;
  const bf16* kr = raw + kTile;
  const bf16* vr = raw + 2 * kTile;
  const bf16* wr = raw + 3 * kTile;
  const bf16* dor = raw + 4 * kTile;
  bf16* rf_hi = reinterpret_cast<bf16*>(smem_tc + C::kOp);
  bf16* rf_lo = rf_hi + kTile;
  bf16* kb_hi = rf_hi + 2 * kTile;
  bf16* kb_lo = rf_hi + 3 * kTile;
  bf16* a_hi = reinterpret_cast<bf16*>(smem_tc + C::kA);
  bf16* a_lo = a_hi + kL * kLdS;
  bf16* slots = reinterpret_cast<bf16*>(smem_tc + C::kSlots);
  auto slot_hi = [&](int q) { return slots + 2 * q * kSlot; };
  auto slot_lo = [&](int q) { return slots + (2 * q + 1) * kSlot; };
  float* f1 = reinterpret_cast<float*>(smem_tc + C::kF32);
  float* f2 = f1 + kL * kLdF;
  float* g4 = reinterpret_cast<float*>(smem_tc + C::kSmall);
  float* mm = g4;
  float* rho = g4 + C::kM;
  float* gs = reinterpret_cast<float*>(smem_tc + C::kG);
  float* uf = reinterpret_cast<float*>(smem_tc + C::kU);
  float* dus = reinterpret_cast<float*>(smem_tc + C::kDu);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // A is lower triangular: what lies above the diagonal stays 0
  for (int e = tid; e < 2 * kL * kLdS; e += NT) {
    a_hi[e] = __float2bfloat16(0.f);
  }
  // persistent: item bh n + c is chunk c of (b, h)
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c = item % n, bh = item / n;
    const int t0 = c * kL;
    const int64_t base = static_cast<int64_t>(bh) * T_len * D;
    const int64_t at_state = (static_cast<int64_t>(bh) * n + c) * D * D;

    // the chunk's rows of r, k, v, w and do, in 16-byte asynchronous copies;
    // rows past T are zero-filled (they add nothing, and are not written)
    {
      constexpr int kSegs = kL * D / 8;
      for (int idx = tid; idx < 5 * kSegs; idx += NT) {
        const int a = idx / kSegs, rem = idx % kSegs;
        const int row = rem / (D / 8), col = (rem % (D / 8)) * 8;
        const bool valid = t0 + row < T_len;
        const bf16* arr = a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? w
                                                                        : dout;
        cp_async16(raw + a * kTile + row * kLd + col,
                   arr + base + static_cast<int64_t>(valid ? t0 + row : 0) * D +
                       col,
                   valid);
      }
      cp_async_commit();
    }
    // the chunk's state and gradient, into the accumulators, early
    St s, ds;
    s.load(states + at_state, warp, lane);
    ds.load(dstates + at_state, warp, lane);
    for (int e = tid; e < D; e += NT) {
      uf[e] = __bfloat162float(u[(bh % H) * D + e]);
    }
    cp_async_wait_all();
    __syncthreads();
    // the next item's rows and states towards L2 while this one computes
    if (item + static_cast<int>(gridDim.x) < items) {
      const int nx = item + gridDim.x;
      const int cn = nx % n, tn = (nx % n) * kL;
      const int64_t bn = static_cast<int64_t>(nx / n) * T_len * D;
      const int rows = min(kL, T_len - tn);
      for (int e = tid; e < 5 * rows; e += NT) {
        const int a = e / rows;
        const bf16* arr = a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? w
                                                                    : dout;
        prefetch_l2(arr + bn + static_cast<int64_t>(tn + e % rows) * D);
      }
      const int64_t sn = (static_cast<int64_t>(nx / n) * n + cn) * D * D;
      for (int e = 32 * tid; e < D * D; e += 32 * NT) {
        prefetch_l2(states + sn + e);
        prefetch_l2(dstates + sn + e);
      }
    }

    // ---- per sub-chunk p and row i, threads [0, 4 D) on r and the rest on
    // k: r * f and k * b (hi and lo parts), G; r and k times their decays
    // within their 4-step block, each block's decay (for A)
    const bool on_r = tid < 4 * D;
    const int p = (tid % (4 * D)) / D, i = tid % D, r0 = kSub * p;
    if (on_r) {
      float f = 1.f, f4 = 1.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const int row = r0 + t;
        const float x = __bfloat162float(rr[row * kLd + i]);
        f1[row * kLdF + i] = x * f4;
        split(x * f, rf_hi + row * kLd + i, rf_lo + row * kLd + i);
        const float ww = __bfloat162float(wr[row * kLd + i]);
        f *= ww;
        f4 *= ww;
        if (t % 4 == 3) {
          g4[(row / 4) * D + i] = f4;
          f4 = 1.f;
        }
      }
      gs[p * D + i] = f;
    } else {
      float b = 1.f, b4 = 1.f;
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t) {
        const int row = r0 + t;
        const float x = __bfloat162float(kr[row * kLd + i]);
        f2[row * kLdF + i] = x * b4;
        split(x * b, kb_hi + row * kLd + i, kb_lo + row * kLd + i);
        const float ww = __bfloat162float(wr[row * kLd + i]);
        b *= ww;
        b4 *= ww;
        if (t % 4 == 0) b4 = 1.f;
      }
    }
    __syncthreads();
    // ---- A per sub-chunk, as the forward builds it (wkv6.cu): a 4 x 4 block
    // (target block a, source block bb <= a) a warp task: lane = (t, c8),
    // each lane a row t and the channels 4 c8 + 32 m.., its 4 sources s
    // summed over the row's 8 lanes.  Off the diagonal blocks, A[t][s] =
    // sum_i rs_t[i] ks_s[i] M[i], M the decay of the 4-step blocks strictly
    // between; on them, the decay prod_{s<tau<t} w_tau per channel, and the
    // bonus u at s = t.
    {
      const float* rs = f1;
      const float* ks = f2;
      const int tl = lane >> 3, c8 = lane & 7;
      for (int wt = warp; wt < kNSub * 10; wt += kWarps) {
        const int pp = wt / 10, pr = wt % 10;
        // pr -> (a, bb): (0,0) (1,0) (1,1) (2,0) (2,1) (2,2) (3,0) ...
        const int a = pr < 1 ? 0 : pr < 3 ? 1 : pr < 6 ? 2 : 3;
        const int bb = pr - (a * (a + 1)) / 2;
        const int t = pp * kSub + 4 * a + tl;
        const int s0 = pp * kSub + 4 * bb;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (bb < a) {
          const float* m1 = g4 + (pp * 4 + a - 1) * D;
          const float* m2 = g4 + (pp * 4 + a - 2) * D;
          for (int ii = 4 * c8; ii < D; ii += 32) {
            float4 x = ld4(rs + t * kLdF + ii);
            if (a - bb >= 2) x = mul4(x, ld4(m1 + ii));
            if (a - bb == 3) x = mul4(x, ld4(m2 + ii));
#pragma unroll
            for (int sl = 0; sl < 4; ++sl) {
              acc[sl] = dot4(x, ld4(ks + (s0 + sl) * kLdF + ii), acc[sl]);
            }
          }
        } else {
          for (int ii = 4 * c8; ii < D; ii += 32) {
            const float4 rt = bf4(rr + t * kLd + ii);
            const float4 w1 = bf4(wr + (s0 + 1) * kLd + ii);
            const float4 w2 = bf4(wr + (s0 + 2) * kLd + ii);
            const float4 uk = mul4(ld4(uf + ii), bf4(kr + t * kLd + ii));
#pragma unroll
            for (int sl = 0; sl < 4; ++sl) {
              // sources past t give values that are not written
              const int gap = tl - sl;
              float4 x = gap == 0 ? uk : bf4(kr + (s0 + sl) * kLd + ii);
              if (gap >= 2) x = mul4(x, sl == 0 ? w1 : w2);
              if (gap == 3) x = mul4(x, w2);
              acc[sl] = dot4(rt, x, acc[sl]);
            }
          }
        }
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
#pragma unroll
          for (int off = 1; off < 8; off <<= 1) {
            acc[sl] += __shfl_xor_sync(0xffffffffu, acc[sl], off);
          }
        }
        if (c8 == 0) {
#pragma unroll
          for (int sl = 0; sl < 4; ++sl) {
            if (bb < a || sl <= tl) {
              const int at = t * kLdS + 4 * bb + sl;
              split(acc[sl], a_hi + at, a_lo + at);
            }
          }
        }
      }
    }
    __syncthreads();  // A is made; f1, f2 and g4 are free

    // ---- S at each sub-chunk's start, from the chunk's
#pragma unroll 1
    for (int q = 0; q < kNSub; ++q) {
      s.store_split(slot_hi(q), slot_lo(q), kLd, warp, lane);
      if (q + 1 < kNSub) {
        s.update(gs + q * D, kb_hi + q * kSub * kLd, kb_lo + q * kSub * kLd,
                 vr + q * kSub * kLd, kLd, 1, warp, lane);
      }
    }

    // ---- dS at each sub-chunk's end, from the chunk's, walking back; per
    // sub-chunk the products on the tensor cores
#pragma unroll 1
    for (int q = kNSub - 1; q >= 0; --q) {
      const int q0 = q * kSub;
      const bf16* sh = slot_hi(q);
      const bf16* sl = slot_lo(q);
      bf16* dh = slot_hi(q + 1);
      bf16* dl = slot_lo(q + 1);
      ds.store_split(dh, dl, kLd, warp, lane);
      // rowsum(dS_E S_0) over each unit's 16 columns
#pragma unroll
      for (int x = 0; x < St::kMine; ++x) {
        if (St::unit(x, warp) >= St::kUnits) continue;
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int at = St::row(x, warp, lane, e) * kLd +
                           St::col(x, warp, lane, nn);
            const float2 hi = bf2(sh + at), lo = bf2(sl + at);
            part[e / 2] = fmaf(ds.acc[x][nn][e], hi.x + lo.x,
                               fmaf(ds.acc[x][nn][e + 1], hi.y + lo.y,
                                    part[e / 2]));
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          part[e] += __shfl_xor_sync(0xffffffffu, part[e], 1);
          part[e] += __shfl_xor_sync(0xffffffffu, part[e], 2);
        }
        if (lane % 4 == 0) {
          const int ni = St::unit(x, warp) % (D / 16);
          float* dst = rho + (q * (D / 16) + ni) * D;
          dst[St::row(x, warp, lane, 0)] = part[0];
          dst[St::row(x, warp, lane, 2)] = part[1];
        }
      }
      __syncthreads();  // dS_E of sub-chunk q is in its slot
      // tasks of 16 output columns: dO S_0^T, V dS_E^T, dv (each D / 16),
      // then M = dO V^T
      const int g = lane / 4, qd = lane % 4;
      for (int task = warp; task < 3 * (D / 16) + 1; task += kWarps) {
        const int kind = task / (D / 16), x16 = 16 * (task % (D / 16));
        float o[2][4] = {};
        if (kind != 2) {
          const bf16* ap = (kind == 1 ? vr : dor) + q0 * kLd;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            a_mk(ap + 16 * kk, kLd, lane, a);
            if (kind == 3) {
              uint32_t b[4];
              b_nk(vr + q0 * kLd + 16 * kk, kLd, lane, b);
              mma(o[0], a, b[0], b[1]);
              mma(o[1], a, b[2], b[3]);
            } else {
              uint32_t bh4[4], bl4[4];
              b_nk((kind == 0 ? sh : dh) + x16 * kLd + 16 * kk, kLd, lane, bh4);
              b_nk((kind == 0 ? sl : dl) + x16 * kLd + 16 * kk, kLd, lane, bl4);
#pragma unroll
              for (int nn = 0; nn < 2; ++nn) {
                mma(o[nn], a, bh4[2 * nn], bh4[2 * nn + 1]);
                mma(o[nn], a, bl4[2 * nn], bl4[2 * nn + 1]);
              }
            }
          }
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = g + 8 * hf, col = 8 * nn + 2 * qd;
              float* dst = kind == 3 ? mm + (q * kSub + row) * kSub + col
                                     : (kind == 0 ? f1 : f2) +
                                           (q0 + row) * kLdF + x16 + col;
              *reinterpret_cast<float2*>(dst) =
                  make_float2(o[nn][2 * hf], o[nn][2 * hf + 1]);
            }
          }
        } else {
          // dv = (K * b) dS_E + A^T dO, columns [x16, x16 + 16)
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t ah[4], al[4], bh4[4], bl4[4];
            a_mk(kb_hi + q0 * kLd + 16 * kk, kLd, lane, ah);
            a_mk(kb_lo + q0 * kLd + 16 * kk, kLd, lane, al);
            b_kn(dh + 16 * kk * kLd + x16, kLd, lane, bh4);
            b_kn(dl + 16 * kk * kLd + x16, kLd, lane, bl4);
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              mma(o[nn], ah, bh4[2 * nn], bh4[2 * nn + 1]);
              mma(o[nn], ah, bl4[2 * nn], bl4[2 * nn + 1]);
              mma(o[nn], al, bh4[2 * nn], bh4[2 * nn + 1]);
            }
          }
          uint32_t ath[4], atl[4], bd[4];
          a_km(a_hi + q0 * kLdS, kLdS, lane, ath);
          a_km(a_lo + q0 * kLdS, kLdS, lane, atl);
          b_kn(dor + q0 * kLd + x16, kLd, lane, bd);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            mma(o[nn], ath, bd[2 * nn], bd[2 * nn + 1]);
            mma(o[nn], atl, bd[2 * nn], bd[2 * nn + 1]);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = t0 + q0 + g + 8 * hf;
              if (row < T_len) {
                *reinterpret_cast<__nv_bfloat162*>(
                    dv + base + static_cast<int64_t>(row) * D + x16 + 8 * nn +
                    2 * qd) = __floats2bfloat162_rn(o[nn][2 * hf],
                                                    o[nn][2 * hf + 1]);
              }
            }
          }
        }
      }
      if (q > 0) {
        ds.update(gs + q * D, rf_hi + q0 * kLd, rf_lo + q0 * kLd,
                  dor + q0 * kLd, kLd, 1, warp, lane);
      }
      __syncthreads();  // sub-chunk q's slots and products are read, written
    }

    // ---- per sub-chunk p and row i, on the CUDA cores: threads on r walk
    // forward (dr; (a), (b) and (d) of dw), threads on k backward (dk, (c)
    // of dw, du)
    float rv[kSub], kv[kSub], wv[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      rv[t] = __bfloat162float(rr[(r0 + t) * kLd + i]);
      kv[t] = __bfloat162float(kr[(r0 + t) * kLd + i]);
      wv[t] = __bfloat162float(wr[(r0 + t) * kLd + i]);
    }
    const float uu = uf[i];
    const float* mp = mm + p * kSub * kSub;  // M[t][s] at t * 16 + s
    const int64_t out0 = base + static_cast<int64_t>(t0 + r0) * D + i;
    const int valid = T_len - (t0 + r0);  // rows of the sub-chunk before T
    float* dwa = reinterpret_cast<float*>(rf_hi);  // (t, i), stride kLdF
    float fv[kSub], qs[kSub];  // f_t and Q_t of (c), on the threads on k
    if (on_r) {
      float bv[kSub];
      bv[kSub - 1] = 1.f;
#pragma unroll
      for (int t = kSub - 2; t >= 0; --t) bv[t] = bv[t + 1] * wv[t + 1];
      float rho_i = 0.f;
#pragma unroll
      for (int x = 0; x < D / 16; ++x) rho_i += rho[(p * (D / 16) + x) * D + i];
      float us[kSub];  // U_t[t'] for t' > t
#pragma unroll
      for (int t = 0; t < kSub; ++t) us[t] = 0.f;
      float f = 1.f, pb = 0.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const float drc = f1[(r0 + t) * kLdF + i];
        const float dkc = f2[(r0 + t) * kLdF + i];
        const float diag = mp[t * kSub + t];
        if (t < valid) {
          store(fmaf(f, drc, fmaf(uu * kv[t], diag, us[t])),
                dr + out0 + static_cast<int64_t>(t) * D);
        }
        float dd = 0.f, dec = 1.f;
#pragma unroll
        for (int t2 = t + 1; t2 < kSub; ++t2) {
          dd = fmaf(dec * rv[t2], us[t2], dd);
          dec *= wv[t2];
        }
        dwa[(r0 + t) * kLdF + i] = fmaf(f * bv[t], rho_i, fmaf(bv[t], pb, dd));
        pb = fmaf(wv[t], pb, kv[t] * dkc);
#pragma unroll
        for (int t2 = t + 1; t2 < kSub; ++t2) {
          us[t2] = fmaf(wv[t], us[t2], kv[t] * mp[t2 * kSub + t]);
        }
        f *= wv[t];
      }
    } else {
      fv[0] = 1.f;
#pragma unroll
      for (int t = 1; t < kSub; ++t) fv[t] = fv[t - 1] * wv[t - 1];
      float zs[kSub];  // Z_s[s'] for s' < s
#pragma unroll
      for (int t = 0; t < kSub; ++t) zs[t] = 0.f;
      float b = 1.f, qc = 0.f, du_acc = 0.f;
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t) {
        const float drc = f1[(r0 + t) * kLdF + i];
        const float dkc = f2[(r0 + t) * kLdF + i];
        const float diag = mp[t * kSub + t];
        if (t < valid) {
          store(fmaf(b, dkc, fmaf(uu * rv[t], diag, zs[t])),
                dk + out0 + static_cast<int64_t>(t) * D);
        }
        qs[t] = qc;
        du_acc = fmaf(rv[t] * kv[t], diag, du_acc);
        qc = fmaf(wv[t], qc, rv[t] * drc);
#pragma unroll
        for (int t2 = 0; t2 < t; ++t2) {
          zs[t2] = fmaf(wv[t], zs[t2], rv[t] * mp[t * kSub + t2]);
        }
        b *= wv[t];
      }
      dus[p * D + i] = du_acc;
    }
    __syncthreads();
    if (!on_r) {
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        if (t < valid) {
          store(fmaf(fv[t], qs[t], dwa[(r0 + t) * kLdF + i]),
                dw + out0 + static_cast<int64_t>(t) * D);
        }
      }
    }
    for (int e = tid; e < D; e += NT) {
      du_part[(static_cast<int64_t>(bh) * n + c) * D + e] =
          dus[e] + dus[D + e] + dus[2 * D + e] + dus[3 * D + e];
    }
    __syncthreads();  // the next item refills what this one read
  }
}

// ---------------------------------------------------------------------------
// du: the partials, (B, H, n, D), summed over b and then n, in order
// ---------------------------------------------------------------------------
// A warp per (h, i): its lanes load 32 partials at a time, which every lane
// adds in the order j = b n + c.
template <typename T>
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            T* __restrict__ du, int B, int H, int n, int D) {
  const int e = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= H * D) return;
  const int h = e / D, i = e % D;
  float sum = 0.f;
  for (int j0 = 0; j0 < B * n; j0 += 32) {
    const int j = j0 + lane;
    const float x =
        j < B * n
            ? du_part[((static_cast<int64_t>(j / n) * H + h) * n + j % n) * D +
                      i]
            : 0.f;
    const int m = min(32, B * n - j0);
    for (int l = 0; l < m; ++l) sum += __shfl_sync(0xffffffffu, x, l);
  }
  if (lane == 0) store(sum, du + e);
}

template <typename T>
int launch_du(const float* du_part, void* du, int B, int H, int n, int D,
              cudaStream_t stream) {
  wkv6_bwd_du<T><<<(H * D + 7) / 8, 256, 0, stream>>>(
      du_part, static_cast<T*>(du), B, H, n, D);
  return static_cast<int>(cudaGetLastError());
}

// The scan design: du_part (B, H, D), ckpt1 (B, H, ceil(T / 64), D, D),
// ckpt2 (B, H, 8, D, D).
template <typename T, int D>
int launch_scan(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* dout, void* dr, void* dk,
                void* dv, void* dw, void* du, float* du_part, float* ckpt1,
                float* ckpt2, int B, int H, int T_len, cudaStream_t stream) {
  if (static_cast<int64_t>(B) * H * Dv<D>::kGroups > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return launch_du<T>(du_part, du, B, H, 1, D, stream);
}

// The chunked design: du_part (B, H, n, D), states and dstates (B, H, n,
// D, D), n = ceil(T / 64).
template <int D>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* dout, void* dr,
                   void* dk, void* dv, void* dw, void* du, float* du_part,
                   float* states, float* dstates, int B, int H, int T_len,
                   cudaStream_t stream) {
  const int n = (T_len + kL - 1) / kL;
  if (static_cast<int64_t>(B) * H * n > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = opt_in_smem<wkv6_bwd_states<D>>(States<D>::kBytes);
  if (err == cudaSuccess) {
    err = opt_in_smem<wkv6_bwd_chunk<D>>(Chunk<D>::kBytes);
  }
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* tr = static_cast<const bf16*>(r);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tw = static_cast<const bf16*>(w);
  const bf16* tdo = static_cast<const bf16*>(dout);
  wkv6_bwd_states<D><<<2 * B * H, States<D>::kThreads, States<D>::kBytes,
                       stream>>>(tr, tk, tv, tw, tdo, states, dstates, B * H,
                                 T_len, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = B * H * n;
  wkv6_bwd_chunk<D><<<min(items, sms), Chunk<D>::kThreads, Chunk<D>::kBytes,
                      stream>>>(
      tr, tk, tv, tw, static_cast<const bf16*>(u), tdo, static_cast<bf16*>(dr),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<bf16*>(dw),
      du_part, states, dstates, H, T_len, n, items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_du<bf16>(du_part, du, B, H, n, D, stream);
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* dout, void* dr, void* dk, void* dv,
             void* dw, void* du, float* du_part, float* buf1, float* buf2,
             int B, int H, int T_len, int D, cudaStream_t s) {
  switch (D) {
    case 8: return launch_scan<T, 8>(r, k, v, w, u, dout, dr, dk, dv, dw, du,
                                     du_part, buf1, buf2, B, H, T_len, s);
    case 16: return launch_scan<T, 16>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                       du, du_part, buf1, buf2, B, H, T_len,
                                       s);
    case 32: return launch_scan<T, 32>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                       du, du_part, buf1, buf2, B, H, T_len,
                                       s);
    case 64: return launch_scan<T, 64>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                       du, du_part, buf1, buf2, B, H, T_len,
                                       s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <>
int dispatch<bf16>(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* dout, void* dr, void* dk,
                   void* dv, void* dw, void* du, float* du_part, float* buf1,
                   float* buf2, int B, int H, int T_len, int D,
                   cudaStream_t s) {
  switch (D) {
    case 8: return launch_scan<bf16, 8>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                        du, du_part, buf1, buf2, B, H, T_len,
                                        s);
    case 16: return launch_chunked<16>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                       du, du_part, buf1, buf2, B, H, T_len,
                                       s);
    case 32: return launch_chunked<32>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                       du, du_part, buf1, buf2, B, H, T_len,
                                       s);
    case 64: return launch_chunked<64>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                       du, du_part, buf1, buf2, B, H, T_len,
                                       s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Calls that succeeded, by design: 0 = the scan on the CUDA cores, 1 = the
// chunked form on the tensor cores.
unsigned long long g_launches[2] = {0, 0};

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw: (B, H, T, D); u, du: (H, D); all
// contiguous, one type (dtype 0 = float32, 1 = bfloat16).  Scratch, f32,
// by design (n = ceil(T / 64)): bf16 at D >= 16, the chunked form, takes
// du_part (B, H, n, D), buf1 = the states (B, H, n, D, D) and buf2 = their
// gradients (B, H, n, D, D); the scan takes du_part (B, H, D), buf1 (B, H,
// n, D, D) and buf2 (B, H, 8, D, D).  Three launches on `stream`; returns
// cudaGetLastError() after the last (0 on success), or the first error;
// refuses shapes it does not take with cudaErrorInvalidValue, before
// launching anything.
extern "C" int wkv6_backward_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* dout, void* dr, void* dk, void* dv, void* dw,
    void* du, float* du_part, float* buf1, float* buf2, int B, int H,
    int T_len, int D, int dtype, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 ||
      static_cast<int64_t>(B) * H > 1073741823) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case 0: rc = dispatch<float>(r, k, v, w, u, dout, dr, dk, dv, dw, du,
                                 du_part, buf1, buf2, B, H, T_len, D, s);
      break;
    case 1: rc = dispatch<bf16>(r, k, v, w, u, dout, dr, dk, dv, dw, du,
                                du_part, buf1, buf2, B, H, T_len, D, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc == 0) ++g_launches[dtype == 1 && D >= 16 ? 1 : 0];
  return rc;
}

// How many calls of design `variant` (0 = the scan on the CUDA cores, 1 =
// the chunked form on the tensor cores) succeeded in this process.
extern "C" unsigned long long wkv6_backward_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? g_launches[variant] : 0;
}
