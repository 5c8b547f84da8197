// fedavg_agg: the eq.-(13) weighted aggregate over stacked client models,
// written for Hopper (sm_90a).
//
//   out[p] = sum_c w[c] * x[c, p]     x: (C, P), w: (C,) f32, out: (P,)
//
// Accumulation is in f32; the result is cast back to the input type
// (f32 or bf16), as the reference does.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_agg/kernel.py
// (`weighted_aggregate`, body `_agg_kernel`).  That kernel walks the
// flattened parameter axis in 16,384-element tiles on a sequential grid,
// with the client axis resident in vector registers.  Here the parameter
// axis is split across all of the card's SMs instead: every thread owns
// kVec contiguous elements of P and loops over the C clients itself, so
// no reduction crosses threads or blocks and nothing carries over
// between blocks.
//
// Bound: the work is one FMA per input element, so it is bound by
// memory, (C + 1) * P * bytes at the card's bandwidth: C = 68 clients
// over the MNIST CNN's 421,642 parameters in f32 move about 116 MB
// (~35 us at 3.35 TB/s), VGG-11's 9,225,610 parameters about 2.55 GB
// (~0.76 ms).  The design therefore reads each input byte once, in
// 16-byte loads (f32) or 8-byte loads (bf16) where the rows are
// aligned, with neighbouring threads on neighbouring addresses, keeps
// the weights in shared memory and the sums in registers, and writes
// each output once.  A scalar path covers rows that are not aligned and
// the ragged tail of P.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // elements of P per thread
constexpr int kUnroll = 8;  // clients whose loads a thread keeps in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// kVec contiguous elements as one aligned load: 16 bytes of f32, 8 of bf16.
__device__ __forceinline__ void load_vec(const float* src, float v[kVec]) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float v[kVec]) {
  const uint2 q = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store_vec(float* dst, const float v[kVec]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst,
                                          const float v[kVec]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  T* __restrict__ out, int C, int64_t P, bool vec) {
  extern __shared__ float w_smem[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) w_smem[c] = w[c];
  __syncthreads();

  const int64_t p0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (p0 >= P) return;

  // The client loop is unrolled kUnroll deep so that that many loads per
  // thread are in flight at once: with few threads (a small leaf) the
  // loop is bound by load latency, not by bandwidth.
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
  if (vec && p0 + kVec <= P) {
    const T* src = x + p0;
#pragma unroll(kUnroll)
    for (int c = 0; c < C; ++c) {
      float v[kVec];
      load_vec(src + static_cast<int64_t>(c) * P, v);
      const float wc = w_smem[c];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(wc, v[i], acc[i]);
    }
    store_vec(out + p0, acc);
    return;
  }
  // Scalar path: rows not aligned, or the ragged tail of P.  The element
  // loop is unrolled and predicated so that acc stays in registers.
  const int64_t n = P - p0;
#pragma unroll(kUnroll)
  for (int c = 0; c < C; ++c) {
    const T* src = x + static_cast<int64_t>(c) * P + p0;
    const float wc = w_smem[c];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i < n) acc[i] = fmaf(wc, to_f32(src[i]), acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < n) from_f32(acc[i], out + p0 + i);
  }
}

template <typename T>
int launch(const void* x, const float* w, void* out, int C, int64_t P,
           cudaStream_t stream) {
  const int64_t align = kVec * static_cast<int64_t>(sizeof(T));
  const bool vec = P % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0;
  const int64_t threads_needed = (P + kVec - 1) / kVec;
  const int64_t blocks = (threads_needed + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  fedavg_agg_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(static_cast<const T*>(x), w,
                                   static_cast<T*>(out), C, P, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 on success); refuses shapes the kernel does not take
// with cudaErrorInvalidValue, before launching anything.
extern "C" int fedavg_agg_launch(const void* x, const float* w, void* out,
                                 int C, int64_t P, int dtype, void* stream) {
  // the weights sit in the default 48 KB of dynamic shared memory
  if (C < 1 || C > 12288 || P < 1 || (P + kVec - 1) / kVec / kThreads >=
                                          (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, w, out, C, P, s);
    case 1: return launch<__nv_bfloat16>(x, w, out, C, P, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
