// wkv6: the RWKV6 (Finch) WKV recurrence, written for Hopper (sm_90a).
//
//   r, k, v, w: (B, H, T, D), u: (H, D), out: (B, H, T, D)
//   per (b, h), from S_0 = 0 (a D x D f32 state):
//     o_t[j]       = sum_i r_t[i] (S_t[i][j] + u[i] k_t[i] v_t[j])
//     S_{t+1}[i][j] = w_t[i] S_t[i][j] + k_t[i] v_t[j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6/kernel.py (`wkv`,
// body `_wkv_kernel`).  That kernel walks 128-step chunks on the
// innermost, sequential grid axis with the state in VMEM scratch between
// grid steps (a VMEM artifact).  Here the state never leaves the SM, and
// two kernels share the work, chosen by type:
//
// * bfloat16, the type the models run in, at D >= 16: `wkv6_chunked`,
//   the chunk-parallel form on the tensor cores.  One block per (b, h)
//   walks T in 64-step chunks (cp.async double-buffered), each cut into
//   16-step sub-chunks.  A sub-chunk's output is the cross term
//   (r_t * fwd_t) . S, the intra-sub-chunk term A . V with
//   A[t][s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i] (s < t) and the
//   bonus sum_i r_t[i] u[i] k_t[i] on its diagonal; then
//   S <- diag(G) S + (k_s * bwd_s)^T v_s.  fwd_t (the decay from the
//   sub-chunk's start to t), bwd_s (from s to its end) and G (the whole
//   sub-chunk) are products of decays w in [0, 1], never quotients and
//   never exp of a positive number, so none overflows and a decay of 0
//   (or one that underflows) gives the exact 0: the factorisation
//   r.P_excl, k / P_incl of the reference's chunked form is wrong there.
//   A is built in 4 x 4 blocks of steps: off the diagonal blocks from r
//   and k times their decays within their 4-step block and the decays of
//   the blocks between (all <= 1), on them per channel.
//   Two kinds of warps, overlapped through double-buffered shared memory
//   and named barriers: D / 4 prep warps make chunk c + 1's factored
//   operands and A on the CUDA cores while D / 16 mma warps run chunk c's
//   three products as mma.sync m16n8k16 bf16 with f32 accumulation, warp
//   w owning state columns [16w, 16w + 16) as accumulators (S^T, so that
//   the accumulator fragment is the B operand of the output product
//   without a shuffle; the other operands by ldmatrix).  Each f32 operand
//   that is not a bf16 input (r * fwd, k * bwd, A and the state) is split
//   into a bf16 high and low part and multiplied as hi.hi + hi.lo +
//   lo.hi, which keeps ~16 bits of it: one bf16 rounding of those
//   operands would put errors of ~2**-9 of the state's size (not the
//   output's) on every output.
// * float32 (the check, and decode-vs-prefill, held to 1e-4, which TF32
//   would not meet), and bfloat16 at D = 8: `wkv6_scan`, the
//   step-by-step recurrence split by state column.  Column j evolves
//   alone and o_t[j] reads only column j, so the grid covers (b, h,
//   column group), and each column's D rows are split over 4 lanes and
//   reduced with shuffles: 8 warps an SM at rwkv6-1.6b's prefill instead
//   of the 2 of one block of D threads per (b, h), and a quarter of the
//   dependent chain a step.
//
// Bound at rwkv6-1.6b's prefill (B = 4, H = 32, T = 2048, D = 64): every
// input byte read once and every output byte written once, 168 MB in
// bf16 (~0.050 ms at 3.35 TB/s).  The chunked form's products, splits
// included, are 1.2e10 FLOP on the tensor cores (~0.012 ms at 989
// TFLOP/s), so bytes bound it; the recurrence's 4 D^2 f32 FLOP a step
// (4.3e9, ~0.064 ms at 67 TFLOP/s) bounds the scan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements of T at p as f32, in the widest aligned loads
// (16 bytes, or 8 or 4 where N elements are fewer bytes).
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      x[i] = v.x; x[i + 1] = v.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p,
                                          float (&x)[N]) {
  constexpr int kStep = N % 8 == 0 ? 8 : N % 4 == 0 ? 4 : 2;
#pragma unroll
  for (int i = 0; i < N; i += kStep) {
    uint32_t w[kStep / 2];
    if constexpr (kStep == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (kStep == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + i);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p + i);
    }
#pragma unroll
    for (int e = 0; e < kStep / 2; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      x[i + 2 * e] = f.x;
      x[i + 2 * e + 1] = f.y;
    }
  }
}

// The >48 KB shared-memory opt-in, once per device and kernel (one Tag
// type per kernel instance), so that later launches can be captured in a
// CUDA graph.
template <typename Tag, typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// ---------------------------------------------------------------------------
// wkv6_scan: the column-split recurrence (f32; bf16 at D = 8)
// ---------------------------------------------------------------------------
constexpr int kScanChunk = 32;  // steps staged in shared memory at once
constexpr int kLanes = 4;       // lanes that share one state column

template <typename T, int D>
struct Scan {
  static constexpr int kCols = D < 32 ? D : 32;  // state columns a block
  static constexpr int kThreads = kCols * kLanes;
  static constexpr int kGroups = D / kCols;  // blocks per (b, h)
  static constexpr int kRows = D / kLanes;   // state rows a lane
  // In shared memory each lane's kRows elements of a row are followed by
  // 16 bytes of padding where they fill 16 bytes or more, so that the 4
  // lanes of a column read 4 different banks: element i of row t lies at
  // t * kLd + (i / kRows) * (kRows + kPad) + i % kRows.
  static constexpr int kPad =
      kRows * static_cast<int>(sizeof(T)) >= 16 ? 16 / sizeof(T) : 0;
  static constexpr int kLd = kLanes * (kRows + kPad);
  // two buffers of a chunk's r, k, v, w rows
  static constexpr int kBytes = 2 * 4 * kScanChunk * kLd * sizeof(T);
  __device__ static int at(int i) { return (i / kRows) * (kRows + kPad) +
                                           i % kRows; }
};

template <typename T, int D>
__global__ void __launch_bounds__(Scan<T, D>::kThreads)
wkv6_scan(const T* __restrict__ r, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ w,
          const T* __restrict__ u, T* __restrict__ out, int H, int T_len) {
  using S = Scan<T, D>;
  constexpr int kRows = S::kRows;
  constexpr int kArr = kScanChunk * S::kLd;  // one array of a chunk
  constexpr int kVec = 16 / sizeof(T);       // elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  const int bh = blockIdx.x / S::kGroups;
  const int col0 = (blockIdx.x % S::kGroups) * S::kCols;
  const int lane4 = threadIdx.x % kLanes;
  const int j = col0 + threadIdx.x / kLanes;  // this lane's state column
  const int row0 = lane4 * kRows;             // and its first state row
  const int64_t base = static_cast<int64_t>(bh) * T_len * D;

  float s[kRows], uu[kRows];  // rows [row0, row0 + kRows) of column j
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    s[i] = 0.f;
    uu[i] = to_f32(u[(bh % H) * D + row0 + i]);
  }

  // chunk ch's rows [t0, t0 + kScanChunk) of r, k, v, w into buffer ch % 2,
  // in 16-byte asynchronous copies (each within one lane's padded group);
  // rows at or past T_len are zero-filled
  auto issue = [&](int ch) {
    const int t0 = ch * kScanChunk;
    T* dst = buf + (ch & 1) * 4 * kArr;
    constexpr int kSegs = kScanChunk * D / kVec;
    for (int idx = threadIdx.x; idx < 4 * kSegs; idx += S::kThreads) {
      const int a = idx / kSegs, rem = idx % kSegs;
      const int row = rem / (D / kVec), i = (rem % (D / kVec)) * kVec;
      const bool valid = t0 + row < T_len;
      const T* arr = a == 0 ? r : a == 1 ? k : a == 2 ? v : w;
      cp_async16(dst + a * kArr + row * S::kLd + S::at(i),
                 arr + base + static_cast<int64_t>(valid ? t0 + row : 0) * D
                     + i,
                 valid);
    }
    cp_async_commit();
  };

  const int n_chunks = (T_len + kScanChunk - 1) / kScanChunk;
  issue(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kScanChunk;
    if (ch + 1 < n_chunks) {
      issue(ch + 1);  // into the buffer chunk ch - 1 read
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* rb = buf + (ch & 1) * 4 * kArr + S::at(row0);
    const T* kb = rb + kArr;
    const T* wb = rb + 3 * kArr;
    const T* vb = buf + (ch & 1) * 4 * kArr + 2 * kArr + S::at(j);
    const int n = min(kScanChunk, T_len - t0);
    T* dst = out + base + static_cast<int64_t>(t0) * D + j;
    for (int t = 0; t < n; ++t) {
      const float vj = to_f32(vb[t * S::kLd]);
      float rr[kRows], kk[kRows], ww[kRows];
      load_rows(rb + t * S::kLd, rr);
      load_rows(kb + t * S::kLd, kk);
      load_rows(wb + t * S::kLd, ww);
      float o[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float kv = kk[i] * vj;
        o[i & 1] = fmaf(rr[i], fmaf(uu[i], kv, s[i]), o[i & 1]);
        s[i] = fmaf(ww[i], s[i], kv);
      }
      float sum = o[0] + o[1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (lane4 == 0) store(sum, dst + t * D);
    }
    __syncthreads();  // this buffer's readers are done before its refill
  }
}

template <typename T, int D>
int launch_scan(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* out, int B, int H, int T_len,
                cudaStream_t stream) {
  using S = Scan<T, D>;
  const int64_t blocks = static_cast<int64_t>(B) * H * S::kGroups;
  if (blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = opt_in_smem<S>(wkv6_scan<T, D>, S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_scan<T, D><<<static_cast<unsigned>(blocks), S::kThreads, S::kBytes,
                    stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<T*>(out), H, T_len);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wkv6_chunked: the chunk-parallel form on the tensor cores (bf16, D >= 16)
// ---------------------------------------------------------------------------
constexpr int kL = 64;             // steps a chunk (staged at once)
constexpr int kSub = 16;           // steps a sub-chunk (one mma tile deep)
constexpr int kNSub = kL / kSub;
constexpr int kPad = 8;            // bf16 padding a row: spreads the banks

using bf16 = __nv_bfloat16;

// Shared memory of one block, in bytes from the start.  The products of
// the prep warps for the mma warps are double-buffered by chunk parity.
template <int D>
struct Chunked {
  static constexpr int kMmaWarps = D / 16;  // one a 16 state columns
  static constexpr int kPrep = 8 * D;       // prep threads: D / 4 warps
  static constexpr int kThreads = kPrep + 32 * kMmaWarps;
  static constexpr int kLdR = D + kPad;   // row stride of bf16 (t, i) tiles
  static constexpr int kLdF = D + 8;      // row stride of f32 (t, i) tiles
  static constexpr int kLdS = kSub + kPad;
  static constexpr int kArr = kL * kLdR;  // elements of one (t, i) tile
  // 2 buffers x (r, k, v, w) x kL rows, as loaded
  static constexpr int kRaw = 0;
  // r and k times their decays in 4-step blocks (prep only)
  static constexpr int kRs = kRaw + 2 * 4 * kArr * 2;
  static constexpr int kKs = kRs + kL * kLdF * 4;
  static constexpr int kG4 = kKs + kL * kLdF * 4;  // each 4-step block's G
  // per buffer: r * fwd, k * bwd (hi and lo parts), v, A (hi and lo), G
  static constexpr int kBuf = kG4 + (kL / 4) * D * 4;
  static constexpr int kRh = 0, kRl = kArr * 2, kKh = 2 * kArr * 2;
  static constexpr int kKl = 3 * kArr * 2, kVb = 4 * kArr * 2;
  static constexpr int kAh = 5 * kArr * 2;
  static constexpr int kAl = kAh + kNSub * kSub * kLdS * 2;
  static constexpr int kG = kAl + kNSub * kSub * kLdS * 2;
  static constexpr int kBufBytes = kG + kNSub * D * 4;
  static constexpr int kU = kBuf + 2 * kBufBytes;
  static constexpr int kBytes = kU + D * 4;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

// Named barriers (0 is __syncthreads): the prep warps among themselves;
// buffer b full (prep warps arrive, mma warps wait) and free (the
// reverse).
constexpr int kBarPrep = 1, kBarFull = 2, kBarFree = 4;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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

// mma.sync m16n8k16 fragments (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), g = lane / 4, q = lane % 4:
//   A (16 x 16, row-major M x K): {(g, 2q..), (g + 8, 2q..), (g, 2q + 8..),
//                                  (g + 8, 2q + 8..)}
//   B (16 x 8, K x N):            {(2q.., g), (2q + 8.., g)}
//   C (16 x 8 f32):               {(g, 2q), (g, 2q + 1), (g + 8, 2q),
//                                  (g + 8, 2q + 1)}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
// tiles (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15):
// without .trans the A fragment of a row-major M x K tile; with .trans the
// B fragments of two 8-column tiles of a row-major K x N tile.
__device__ __forceinline__ const bf16* rows_a(const bf16* p, int ld,
                                              int lane) {
  return p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
// Tiles (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15): with .trans,
// the A fragment of the transpose of a row-major K x M tile.
__device__ __forceinline__ const bf16* rows_at(const bf16* p, int ld,
                                               int lane) {
  return p + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// 4 bf16 at p (8-byte aligned) as f32
__device__ __forceinline__ float4 bf4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

template <int D>
__global__ void __launch_bounds__(Chunked<D>::kThreads)
wkv6_chunked(const bf16* __restrict__ r, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ w,
             const bf16* __restrict__ u, bf16* __restrict__ out, int H,
             int T_len) {
  using C = Chunked<D>;
  constexpr int NT = C::kThreads, PT = C::kPrep;
  constexpr int kLdR = C::kLdR, kLdF = C::kLdF, kLdS = C::kLdS;
  constexpr int kArr = C::kArr;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem + C::kRaw);
  float* rs = reinterpret_cast<float*>(smem + C::kRs);
  float* ks = reinterpret_cast<float*>(smem + C::kKs);
  float* g4 = reinterpret_cast<float*>(smem + C::kG4);
  float* uf = reinterpret_cast<float*>(smem + C::kU);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int64_t base = static_cast<int64_t>(bh) * T_len * D;
  const int n_chunks = (T_len + kL - 1) / kL;
  for (int i = tid; i < D; i += NT) {
    uf[i] = __bfloat162float(u[(bh % H) * D + i]);
  }
  // A is lower triangular: what lies above the diagonal stays 0
  for (int x = 0; x < 2; ++x) {
    bf16* ab = reinterpret_cast<bf16*>(smem + C::kBuf + x * C::kBufBytes +
                                       C::kAh);
    for (int i = tid; i < 2 * kNSub * kSub * kLdS; i += NT) {
      ab[i] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  if (warp >= C::kMmaWarps) {
    // ---- prep warps: chunk c's decay products and A into buffer c % 2
    const int pt = tid - 32 * C::kMmaWarps;  // prep thread index
    // chunk c's rows of r, k, v, w (padded to kLdR) into raw buffer
    // c % 2, in 16-byte asynchronous copies; rows past T are zero-filled
    auto issue = [&](int c) {
      constexpr int kSegs = kL * D / 8;
      const int t0 = c * kL;
      bf16* dst = raw + (c & 1) * 4 * kArr;
      for (int idx = pt; idx < 4 * kSegs; idx += PT) {
        const int a = idx / kSegs, rem = idx % kSegs;
        const int row = rem / (D / 8), col = (rem % (D / 8)) * 8;
        const bool valid = t0 + row < T_len;
        const bf16* arr = a == 0 ? r : a == 1 ? k : a == 2 ? v : w;
        cp_async16(dst + a * kArr + row * kLdR + col,
                   arr + base +
                       static_cast<int64_t>(valid ? t0 + row : 0) * D + col,
                   valid);
      }
      cp_async_commit();
    };
    issue(0);
    if (n_chunks > 1) issue(1);
    for (int c = 0; c < n_chunks; ++c) {
      const int bsel = c & 1;
      unsigned char* buf = smem + C::kBuf + bsel * C::kBufBytes;
      bf16* rh = reinterpret_cast<bf16*>(buf + C::kRh);
      bf16* rl = reinterpret_cast<bf16*>(buf + C::kRl);
      bf16* kh = reinterpret_cast<bf16*>(buf + C::kKh);
      bf16* kl = reinterpret_cast<bf16*>(buf + C::kKl);
      bf16* vb = reinterpret_cast<bf16*>(buf + C::kVb);
      bf16* ah = reinterpret_cast<bf16*>(buf + C::kAh);
      bf16* al = reinterpret_cast<bf16*>(buf + C::kAl);
      float* gd = reinterpret_cast<float*>(buf + C::kG);
      if (c + 1 < n_chunks) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      bar_sync(kBarPrep, PT);
      const bf16* rr = raw + bsel * 4 * kArr;
      const bf16* kr = rr + kArr;
      const bf16* vr = rr + 2 * kArr;
      const bf16* wr = rr + 3 * kArr;
      // buffer c % 2 is free once the mma warps are done with chunk c - 2
      if (c >= 2) bar_sync(kBarFree + bsel, NT);
      // per sub-chunk and channel, walking its 16 steps: r times the decay
      // from the sub-chunk's start and k times the decay to its end, as hi
      // and lo parts, and the sub-chunk's decay G; on the way, the same
      // within each 4-step block (rs, ks, in f32) and each block's decay
      for (int task = pt; task < kNSub * D * 2; task += PT) {
        const int i = task % D, p = (task / D) % kNSub;
        const int t0 = p * kSub;
        float f4 = 1.f, f = 1.f;  // within the 4-step block, before it
        if (task / (D * kNSub) == 0) {
#pragma unroll
          for (int t = 0; t < kSub; ++t) {
            const int row = t0 + t;
            const float x = __bfloat162float(rr[row * kLdR + i]) * f4;
            rs[row * kLdF + i] = x;
            split(x * f, rh + row * kLdR + i, rl + row * kLdR + i);
            f4 *= __bfloat162float(wr[row * kLdR + i]);
            if (t % 4 == 3) {
              g4[(row / 4) * D + i] = f4;
              f *= f4;
              f4 = 1.f;
            }
          }
          gd[p * D + i] = f;
        } else {
#pragma unroll
          for (int t = kSub - 1; t >= 0; --t) {
            const int row = t0 + t;
            const float x = __bfloat162float(kr[row * kLdR + i]) * f4;
            ks[row * kLdF + i] = x;
            split(x * f, kh + row * kLdR + i, kl + row * kLdR + i);
            f4 *= __bfloat162float(wr[row * kLdR + i]);
            if (t % 4 == 0) {
              f *= f4;
              f4 = 1.f;
            }
          }
        }
      }
      for (int idx = pt; idx < kL * D / 8; idx += PT) {
        const int at = (idx / (D / 8)) * kLdR + (idx % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(vb + at) =
            *reinterpret_cast<const uint4*>(vr + at);
      }
      bar_sync(kBarPrep, PT);
      // A per sub-chunk, a 4 x 4 block (target block a, source block
      // b <= a) a warp: lane = (t, c8), each lane a row t and the channels
      // 4 c8 + 32 m.., its 4 sources s summed over the row's 8 lanes.  Off
      // the diagonal blocks, A[t][s] = sum_i rs_t[i] ks_s[i] M[i], M the
      // decay of the 4-step blocks strictly between; on them, the decay
      // prod_{s<tau<t} w_tau per channel, and the bonus u at s = t.
      {
        const int tl = lane >> 3, c8 = lane & 7;
        for (int wt = warp - C::kMmaWarps; wt < kNSub * 10; wt += PT / 32) {
          const int p = wt / 10, pr = wt % 10;
          // pr -> (a, b): (0,0) (1,0) (1,1) (2,0) (2,1) (2,2) (3,0) ...
          const int a = pr < 1 ? 0 : pr < 3 ? 1 : pr < 6 ? 2 : 3;
          const int bb = pr - (a * (a + 1)) / 2;
          const int t = p * kSub + 4 * a + tl;
          const int s0 = p * kSub + 4 * bb;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          if (bb < a) {
            const float* m1 = g4 + (p * 4 + a - 1) * D;
            const float* m2 = g4 + (p * 4 + a - 2) * D;
            for (int i = 4 * c8; i < D; i += 32) {
              float4 x = ld4(rs + t * kLdF + i);
              if (a - bb >= 2) x = mul4(x, ld4(m1 + i));
              if (a - bb == 3) x = mul4(x, ld4(m2 + i));
#pragma unroll
              for (int sl = 0; sl < 4; ++sl) {
                acc[sl] = dot4(x, ld4(ks + (s0 + sl) * kLdF + i), acc[sl]);
              }
            }
          } else {
            for (int i = 4 * c8; i < D; i += 32) {
              const float4 rt = bf4(rr + t * kLdR + i);
              const float4 w1 = bf4(wr + (s0 + 1) * kLdR + i);
              const float4 w2 = bf4(wr + (s0 + 2) * kLdR + i);
              const float4 uk = mul4(ld4(uf + i), bf4(kr + t * kLdR + i));
#pragma unroll
              for (int sl = 0; sl < 4; ++sl) {
                // sources past t give values that are not written
                const int gap = tl - sl;
                float4 x = gap == 0 ? uk : bf4(kr + (s0 + sl) * kLdR + i);
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
                const int at = (p * kSub + 4 * a + tl) * kLdS + 4 * bb + sl;
                split(acc[sl], ah + at, al + at);
              }
            }
          }
        }
      }
      // every prep warp is done with raw buffer c % 2, rs, ks and g4
      bar_sync(kBarPrep, PT);
      if (c + 2 < n_chunks) issue(c + 2);
      bar_arrive(kBarFull + bsel, NT);
    }
    return;
  }

  // ---- mma warps: warp w owns columns [16 w, 16 w + 16) of the state,
  // as S^T accumulator tiles of 16 j x 8 i over all D rows i
  const int g = lane / 4, q = lane % 4;
  const int j0 = warp * 16;
  float st[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st[nt][e] = 0.f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int bsel = c & 1;
    const unsigned char* buf = smem + C::kBuf + bsel * C::kBufBytes;
    const bf16* rh = reinterpret_cast<const bf16*>(buf + C::kRh);
    const bf16* rl = reinterpret_cast<const bf16*>(buf + C::kRl);
    const bf16* kh = reinterpret_cast<const bf16*>(buf + C::kKh);
    const bf16* kl = reinterpret_cast<const bf16*>(buf + C::kKl);
    const bf16* vb = reinterpret_cast<const bf16*>(buf + C::kVb);
    const bf16* ah = reinterpret_cast<const bf16*>(buf + C::kAh);
    const bf16* al = reinterpret_cast<const bf16*>(buf + C::kAl);
    const float* gd = reinterpret_cast<const float*>(buf + C::kG);
    bar_sync(kBarFull + bsel, NT);
#pragma unroll 1
    for (int p = 0; p < kNSub; ++p) {
      const int t0 = p * kSub;
      // cross term (r * fwd) . S, with S^T's accumulators as B, and the
      // intra-sub-chunk term and bonus A . V
      float o[2][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        ldsm4(rows_a(rh + t0 * kLdR + 16 * kk, kLdR, lane), a_hi);
        ldsm4(rows_a(rl + t0 * kLdR + 16 * kk, kLdR, lane), a_lo);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          uint32_t b_hi[2], b_lo[2];
          split2(st[2 * kk][2 * nn], st[2 * kk][2 * nn + 1], &b_hi[0],
                 &b_lo[0]);
          split2(st[2 * kk + 1][2 * nn], st[2 * kk + 1][2 * nn + 1],
                 &b_hi[1], &b_lo[1]);
          mma(o[nn][0], a_hi, b_hi);
          mma(o[nn][0], a_hi, b_lo);
          mma(o[nn][1], a_lo, b_hi);
        }
      }
      {
        uint32_t a_hi[4], a_lo[4], bv[4];
        ldsm4(rows_a(ah + t0 * kLdS, kLdS, lane), a_hi);
        ldsm4(rows_a(al + t0 * kLdS, kLdS, lane), a_lo);
        ldsm4_t(rows_a(vb + t0 * kLdR + j0, kLdR, lane), bv);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const uint32_t b[2] = {bv[2 * nn], bv[2 * nn + 1]};
          mma(o[nn][1], a_hi, b);
          mma(o[nn][1], a_lo, b);
        }
      }
      const int row = c * kL + t0 + g;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        bf16* dst = out + base + static_cast<int64_t>(row) * D + j0 + 8 * nn +
                    2 * q;
        if (row < T_len) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              o[nn][0][0] + o[nn][1][0], o[nn][0][1] + o[nn][1][1]);
        }
        if (row + 8 < T_len) {
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * D) =
              __floats2bfloat162_rn(o[nn][0][2] + o[nn][1][2],
                                    o[nn][0][3] + o[nn][1][3]);
        }
      }
      // S^T <- S^T diag(G) + v^T . (k * bwd)
      uint32_t a_v[4];
      ldsm4_t(rows_at(vb + t0 * kLdR + j0, kLdR, lane), a_v);
#pragma unroll
      for (int nt = 0; nt < D / 8; nt += 2) {
        uint32_t bk_hi[4], bk_lo[4];
        ldsm4_t(rows_a(kh + t0 * kLdR + 8 * nt, kLdR, lane), bk_hi);
        ldsm4_t(rows_a(kl + t0 * kLdR + 8 * nt, kLdR, lane), bk_lo);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int i = 8 * (nt + x) + 2 * q;
          const float g0 = gd[p * D + i], g1 = gd[p * D + i + 1];
          float (&sx)[4] = st[nt + x];
          sx[0] *= g0;
          sx[1] *= g1;
          sx[2] *= g0;
          sx[3] *= g1;
          const uint32_t b_hi[2] = {bk_hi[2 * x], bk_hi[2 * x + 1]};
          const uint32_t b_lo[2] = {bk_lo[2 * x], bk_lo[2 * x + 1]};
          mma(sx, a_v, b_hi);
          mma(sx, a_v, b_lo);
        }
      }
    }
    if (c + 2 < n_chunks) bar_arrive(kBarFree + bsel, NT);
  }
}

template <int D>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* out, int B, int H,
                   int T_len, cudaStream_t stream) {
  const cudaError_t err =
      opt_in_smem<Chunked<D>>(wkv6_chunked<D>, Chunked<D>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_chunked<D><<<B * H, Chunked<D>::kThreads, Chunked<D>::kBytes,
                    stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(w),
      static_cast<const bf16*>(u), static_cast<bf16*>(out), H, T_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* out, int B, int H, int T_len, int D,
             cudaStream_t s) {
  switch (D) {
    case 8: return launch_scan<T, 8>(r, k, v, w, u, out, B, H, T_len, s);
    case 16: return launch_scan<T, 16>(r, k, v, w, u, out, B, H, T_len, s);
    case 32: return launch_scan<T, 32>(r, k, v, w, u, out, B, H, T_len, s);
    case 64: return launch_scan<T, 64>(r, k, v, w, u, out, B, H, T_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <>
int dispatch<bf16>(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* out, int B, int H,
                   int T_len, int D, cudaStream_t s) {
  switch (D) {
    case 8: return launch_scan<bf16, 8>(r, k, v, w, u, out, B, H, T_len, s);
    case 16: return launch_chunked<16>(r, k, v, w, u, out, B, H, T_len, s);
    case 32: return launch_chunked<32>(r, k, v, w, u, out, B, H, T_len, s);
    case 64: return launch_chunked<64>(r, k, v, w, u, out, B, H, T_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (u in the same type as r, k, v, w).
// Returns cudaGetLastError() after the launch (0 on success); refuses
// shapes the kernels do not take with cudaErrorInvalidValue, before
// launching anything.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* out, int B,
                           int H, int T_len, int D, int dtype,
                           void* stream) {
  if (B < 1 || H < 1 || T_len < 1 ||
      static_cast<int64_t>(B) * H > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(r, k, v, w, u, out, B, H, T_len, D, s);
    case 1: return dispatch<bf16>(r, k, v, w, u, out, B, H, T_len, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
