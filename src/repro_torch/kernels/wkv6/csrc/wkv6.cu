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
// grid steps (a VMEM artifact).  Here one block of D threads owns one
// (b, h) for the whole sequence, and thread j keeps column j of the state
// in registers (D floats), so the state never leaves the SM.
//
// Bound: every input byte is read once and every output byte written
// once (r, k, v, w and o: 168 MB in bf16 at rwkv6-1.6b's prefill,
// B = 4, H = 32, T = 2048, D = 64, ~0.05 ms at 3.35 TB/s), and the
// arithmetic is ~4 D^2 f32 FLOP per step and head (the output's
// contraction with the state and the state's update; 4.3e9 FLOP, ~0.064
// ms at the card's 67 TFLOP/s f32 rate).  This first version is bound by
// neither: the recurrence is serial over T, and B * H = 128 blocks of
// D = 64 threads fill 128 of the 132 SMs with two warps each, so every
// step's latency (D dependent loads and FMAs per thread) is exposed.
// What the design does about it: r, k, v and w are staged a chunk of
// kChunk steps at a time into shared memory with coalesced 16-byte loads
// (each HBM byte read once) and converted to f32 there; within a step
// r, k, w and u are read as float4 broadcasts; the output's dot product
// keeps four partial sums to shorten its dependency chain.  Splitting
// the state's rows over more threads, or the parallel-over-chunks form,
// is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// 16 bytes of T as f32: 4 floats or 8 bf16.
__device__ __forceinline__ void load16(const float* src, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// n contiguous rows of D elements (n * D a multiple of the vector) into
// dst as f32, in 16-byte loads spread over the block's D threads.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int n) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = n * D / kVec;
  for (int i = threadIdx.x; i < vecs; i += D) {
    float v[8];
    load16(src + i * kVec, v);
#pragma unroll
    for (int x = 0; x < kVec; ++x) dst[i * kVec + x] = v[x];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const T* __restrict__ u, T* __restrict__ out, int H, int T_len) {
  __shared__ __align__(16) float rs[kChunk * D];
  __shared__ __align__(16) float ks[kChunk * D];
  __shared__ __align__(16) float vs[kChunk * D];
  __shared__ __align__(16) float ws[kChunk * D];
  __shared__ __align__(16) float us[D];
  const int bh = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t base = static_cast<int64_t>(bh) * T_len * D;
  us[j] = to_f32(u[(bh % H) * D + j]);

  float s[D];  // column j of the state
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int n = min(kChunk, T_len - t0);
    const int64_t off = base + static_cast<int64_t>(t0) * D;
    __syncthreads();  // the previous chunk's readers are done
    stage<T, D>(rs, r + off, n);
    stage<T, D>(ks, k + off, n);
    stage<T, D>(vs, v + off, n);
    stage<T, D>(ws, w + off, n);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t * D + j];
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[t * D + i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[t * D + i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[t * D + i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float kv = kk[x] * vj;
          o[x] = fmaf(rr[x], fmaf(uu[x], kv, s[i + x]), o[x]);
          s[i + x] = fmaf(ww[x], s[i + x], kv);
        }
      }
      store((o[0] + o[1]) + (o[2] + o[3]),
            out + off + static_cast<int64_t>(t) * D + j);
    }
  }
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, int B, int H, int T_len,
           cudaStream_t stream) {
  wkv6_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<T*>(out), H, T_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* out, int B, int H, int T_len, int D,
               cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(r, k, v, w, u, out, B, H, T_len, s);
    case 16: return launch<T, 16>(r, k, v, w, u, out, B, H, T_len, s);
    case 32: return launch<T, 32>(r, k, v, w, u, out, B, H, T_len, s);
    case 64: return launch<T, 64>(r, k, v, w, u, out, B, H, T_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (u in the same type as r, k, v, w).
// Returns cudaGetLastError() after the launch (0 on success); refuses
// shapes the kernel does not take with cudaErrorInvalidValue, before
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
    case 0:
      return dispatch_d<float>(r, k, v, w, u, out, B, H, T_len, D, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(r, k, v, w, u, out, B, H, T_len, D,
                                       s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
