// flash_attention in bfloat16 on Hopper's tensor cores (sm_90a): wgmma on
// bf16 tiles, TMA loads into a ring of shared-memory stages guarded by
// mbarriers, warp-specialised, the online softmax in registers.
//
// Computes what the Pallas TPU kernel computes
// (src/repro/kernels/flash_attention/kernel.py, `flash_attention`, body
// `_flash_kernel`): causal and sliding-window GQA attention with f32
// scores, an online softmax, f32 accumulation, a row with no key giving 0,
// output in bf16.  flash_attention.cu includes this file and sends every
// bfloat16 call here, at every head dim it takes (16, 32, 64, 128).
//
// Bound: at the main path's shape (llama3.2-3b prefill, B = 4, S = 2048,
// 24 q-heads of D = 128, causal) the work is ~1.03e11 FLOP against 134 MB
// of q, k, v and out, so the function is bound by the tensor cores' bf16
// rate (~0.10 ms at 989 TFLOP/s), not by memory.  What the design does
// about it:
//
// - Block: a persistent block of 384 threads on each SM walks a share of
//   the work items, each one (b, q-head, 128 query rows), longest first,
//   taken in snake order across the blocks so that their sums of work
//   even out.  Warpgroups 0 and 1 consume, 64 rows each; warpgroup 2
//   produces and gives its registers to them (setmaxnreg 24 / 240).  One
//   thread of the producer loads each item's Q into one of two buffers
//   and walks its KV tiles of 128 keys into a 2-stage ring that runs on
//   from item to item, every buffer with a "full" mbarrier (the TMA load
//   landed) and an "empty" one (the 8 consumer warps are done with it).
//   So the next item's Q and first K/V tiles load while the consumers
//   finish an item.  At D = 128 that is 2 x 32 KB of Q and 2 x 64 KB of K
//   and V, 193 KB.
// - Within a consumer warpgroup, tile n's S = Q K^T is issued beside tile
//   n - 1's P V, and tile n's softmax runs while that P V finishes, so
//   the tensor cores do not wait on the exponentials (FA3's intra-
//   warpgroup overlap).  K is released as soon as its scores are done.
//   The two consumer warpgroups take turns to issue their products (two
//   named barriers, FA3's ping-pong), so that one's softmax runs under
//   the other's products.
// - S = Q K^T: wgmma m64n128k16, A = Q and B = K both from shared memory,
//   K-major as stored, f32 accumulators.  The softmax scale and log2(e)
//   fold into one FMA before the exp2.
// - Softmax: the 4 lanes of a quad hold a row; row max by two shuffles,
//   row sums kept per thread and reduced once at the end; the rescale
//   alpha is applied to the O accumulator in registers.
// - O += P V: A = P from registers (the f32 accumulator fragment of S,
//   packed in pairs to bf16x2, is the A-register fragment of the second
//   product), B = V from shared memory through an MN-major (transposed)
//   descriptor.  P is rounded to bf16 before the product, as FA2/FA3 do.
//   O / l is rounded to bf16 once and stored from registers.
// - Masks only on tiles that cross the diagonal, the window's edge or S;
//   KV tiles that the mask empties are never loaded; the query tiles with
//   the most keys are scheduled first.
// - Ragged S: 3-D tensor maps (D, S, B*H), so that TMA zero-fills rows
//   past S and never reads the next head's rows (a garbage V times p = 0
//   could be NaN).  The maps are built on the host per call and passed by
//   value (__grid_constant__), so a CUDA graph replays the captured maps.
//   cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint: the
//   build needs no -lcuda.
// - Swizzle: a bf16 row of D = 128 is 256 B, wider than the 128-B swizzle
//   span, so each tile loads as two 64-column boxes (each rows x 128 B) and
//   the descriptors step between them.  D = 64 is one 128-B box, D = 32 one
//   64-B box (64-B swizzle), D = 16 one 32-B box (32-B swizzle).
// - For training, the kernel also writes each row's log-sum-exp (base 2,
//   of the scores times log2(e); -inf for a row with no key) into an f32
//   (B, Hq, S) buffer when it is given one, after the item's last tile:
//   the backward (flash_attention_bwd_wgmma.cuh) reads it instead of
//   recomputing it.  A null pointer skips the write (prefill).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa_wgmma {

constexpr int kBQ = 128;       // query rows per block: 2 warpgroups x 64
constexpr int kBK = 128;       // keys per KV tile
constexpr int kStages = 2;     // KV tiles in flight
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int kSwizzle = D >= 64 ? 128 : 2 * D;  // bytes a row
  static constexpr int kBoxCols = kSwizzle / 2;  // bf16 columns a box
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kKSteps = kSwizzle / 32;  // k16 steps a box
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  // wgmma descriptor layout type: 1 = 128-B, 2 = 64-B, 3 = 32-B swizzle
  static constexpr uint32_t kLayout =
      kSwizzle == 128 ? 1 : (kSwizzle == 64 ? 2 : 3);
  // 1 KB of slack to align the tiles to the swizzle pattern's period,
  // then two Q tiles, the K ring, the V ring and the mbarriers
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * (4 + 4 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box at (column c0, row c1, plane c2) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// named barriers 1 and 2 (0 is __syncthreads): `count` threads take
// part, some syncing and the others only arriving
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (exp2f adds fix-ups for them; a probability below 2^-126 is 0 here)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= A.B over k = 16: A (64 x 16) and B (16 x 128) from shared memory,
// both K-major; scale_d = 0 starts from zero
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A.B over k = 16: A (64 x 16) from registers (bf16 pairs in the
// accumulator's fragment layout), B (16 x N) from shared memory, MN-major
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// One tile of scores (this thread's rows `row` and `row + 8`, columns
// `col + 8 * (i / 4) + (i & 1)` of register i) to probabilities, in place:
// mask (kMask), update the running max m (of the unscaled scores) and sum
// l, and return each row's rescale of the accumulator in a0, a1.  The
// softmax scale and log2(e) fold into one FMA before the exp2.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& a0, float& a1,
                                             float scale_log2, int row,
                                             int col, int S, int causal,
                                             int window) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    if (kMask) {
      const int c = col + 8 * (i / 4) + (i & 1);
      const int r = row + 8 * ((i >> 1) & 1);
      const bool ok = c < S && (!causal || c <= r) &&
                      (window <= 0 || c > r - window);
      sc[i] = ok ? sc[i] : kNegInf;
    }
    if (i & 2) {
      mx1 = fmaxf(mx1, sc[i]);
    } else {
      mx0 = fmaxf(mx0, sc[i]);
    }
  }
  // the 4 lanes of a quad hold a row
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  a0 = exp2_ftz((m0 - mn0) * scale_log2);
  a1 = exp2_ftz((m1 - mn1) * scale_log2);
  m0 = mn0;
  m1 = mn1;
  const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    float p = exp2_ftz(fmaf(sc[i], scale_log2, (i & 2) ? -ms1 : -ms0));
    // a row with no key yet has m = kNegInf, where exp2(0) would be 1
    if (kMask) p = sc[i] == kNegInf ? 0.f : p;
    sc[i] = p;
    if (i & 2) {
      s1 += p;
    } else {
      s0 += p;
    }
  }
  l0 = a0 * l0 + s0;
  l1 = a1 * l1 + s1;
}

// P as bf16 pairs in the A-fragment order of the P.V product: k16 step j
// takes registers 8j .. 8j + 7, pairs (row, cols), (row + 8, cols),
// (row, cols + 8), (row + 8, cols + 8), the accumulator's own order.
__device__ __forceinline__ void pack_p(const float (&p)[kBK / 2],
                                       uint32_t (&pa)[kBK / 4]) {
#pragma unroll
  for (int i = 0; i < kBK / 4; ++i) pa[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
}

// Scores of the KV tile at kb for this warpgroup's rows of Q (qa): A and
// B K-major, 8-row groups 8 * kSwizzle bytes apart, k16 steps 32 bytes
// apart inside a box, boxes rows * kSwizzle bytes apart.  Issued, not
// waited for.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[kBK / 2],
                                             uint32_t qa, uint32_t kb) {
  using T = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t box = kk / T::kKSteps, step = kk % T::kKSteps;
    wgmma_ss_n128(sc,
                  make_desc(qa + box * kBQ * T::kSwizzle + step * 32, 16,
                            8 * T::kSwizzle, T::kLayout),
                  make_desc(kb + box * kBK * T::kSwizzle + step * 32, 16,
                            8 * T::kSwizzle, T::kLayout),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P V for the V tile at vb: V is MN-major, 8-key groups
// 8 * kSwizzle bytes apart, its column boxes kBK * kSwizzle bytes apart,
// k16 steps 16 rows apart.  Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBK / 4],
                                         uint32_t vb) {
  using T = Tile<D>;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    wgmma_rs<D>(o, pa[4 * j], pa[4 * j + 1], pa[4 * j + 2], pa[4 * j + 3],
                make_desc(vb + j * 16 * T::kSwizzle, kBK * T::kSwizzle,
                          8 * T::kSwizzle, T::kLayout));
  wgmma_commit();
}

// One work item: a 128-row query tile of one (b, q-head) and the KV tiles
// that hold at least one of its keys
struct Work {
  int q0, q_plane, kv_plane, t_lo, n_tiles;
};

// The k-th work item of this block, or -1 past the last.  Items run from
// the query tiles with the most keys to those with the fewest; the blocks
// take them in snake order (block c takes the c-th item of each even
// round of gridDim.x items and the c-th from the end of each odd one), so
// that long and short items even out across the blocks.
__device__ __forceinline__ int item_of(int k, int n_items) {
  const int g = gridDim.x, c = blockIdx.x;
  const int w = k * g + ((k & 1) ? g - 1 - c : c);
  return w < n_items ? w : -1;
}

__device__ __forceinline__ Work decode(int w, int n_q, int B, int Hq,
                                       int Hkv, int S, int causal,
                                       int window) {
  const int per_tile = B * Hq;  // heads of one KV head are neighbours
  const int qt = n_q - 1 - w / per_tile, rem = w % per_tile;
  const int h = rem % Hq, b = rem / Hq;
  Work r;
  r.q0 = qt * kBQ;
  r.q_plane = b * Hq + h;
  r.kv_plane = b * Hkv + h / (Hq / Hkv);
  const int k_hi = causal ? min(S, r.q0 + kBQ) : S;
  const int k_lo = window > 0 ? max(0, r.q0 - window + 1) : 0;
  r.t_lo = k_lo / kBK;
  r.n_tiles = (k_hi + kBK - 1) / kBK - r.t_lo;
  return r;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int B, int Hq, int Hkv,
                          int S, int causal, int window, float scale_log2) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // 2 Q tiles
  const uint32_t sk = sq + 2 * T::kQBytes;         // kStages K tiles
  const uint32_t sv = sk + kStages * T::kKVBytes;  // kStages V tiles
  // mbarriers, 8 bytes each, one per buffer and stage: "full" ones
  // complete when a TMA load lands, "empty" ones when the 8 consumer
  // warps are done with the buffer
  const uint32_t q_full = sv + kStages * T::kKVBytes;  // + 8 * buffer
  const uint32_t q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16;  // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int n_q = (S + kBQ - 1) / kBQ;
  const int n_items = n_q * B * Hq;

  if (threadIdx.x == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(q_full + 8 * x, 1);
      mbar_init(q_empty + 8 * x, 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load; the warpgroup keeps few
    // registers.  A fresh buffer passes its "empty" wait at once (parity
    // 1 of a barrier in phase 0).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int k = 0, n = 0;; ++k) {
        const int w = item_of(k, n_items);
        if (w < 0) break;
        const Work wk = decode(w, n_q, B, Hq, Hkv, S, causal, window);
        const int qb = k & 1;
        mbar_wait(q_empty + 8 * qb, ((k >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, T::kQBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load(sq + qb * T::kQBytes + x * kBQ * T::kSwizzle, &map_q,
                   q_full + 8 * qb, x * T::kBoxCols, wk.q0, wk.q_plane);
        for (int i = 0; i < wk.n_tiles; ++i, ++n) {
          const int s = n % kStages, row0 = (wk.t_lo + i) * kBK;
          const uint32_t parity = ((n / kStages) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, parity);
          mbar_expect_tx(k_full + 8 * s, T::kKVBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x)
            tma_load(sk + s * T::kKVBytes + x * kBK * T::kSwizzle, &map_k,
                     k_full + 8 * s, x * T::kBoxCols, row0, wk.kv_plane);
          mbar_wait(v_empty + 8 * s, parity);
          mbar_expect_tx(v_full + 8 * s, T::kKVBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x)
            tma_load(sv + s * T::kKVBytes + x * kBK * T::kSwizzle, &map_v,
                     v_full + 8 * s, x * T::kBoxCols, row0, wk.kv_plane);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qcol = 2 * (lane % 4);
    // The two consumer warpgroups take turns to issue their products
    // (FA3's ping-pong): warpgroup w waits on barrier 1 + w for its turn
    // and hands the turn over on the other's, so that one's softmax runs
    // while the other's products occupy the tensor cores.  Warpgroup 0
    // starts; warpgroup 1 hands over after every turn but its last, so
    // that every sync is met by one arrival.
    const int own_turn = 1 + wg, other_turn = 2 - wg;
    if (wg == 1) bar_arrive(1, 256);

    float o[D / 2];
    float sc[kBK / 2];
    uint32_t pa[kBK / 4];
    // n counts the KV tiles this block has consumed, as the producer does
    for (int k = 0, n = 0;; ++k) {
      const int w = item_of(k, n_items);
      if (w < 0) break;
      const Work wk = decode(w, n_q, B, Hq, Hkv, S, causal, window);
      const bool last_item = item_of(k + 1, n_items) < 0;
      const int qb = k & 1;
      const uint32_t qa = sq + qb * T::kQBytes + 64 * wg * T::kSwizzle;
      const int wg_row0 = wk.q0 + 64 * wg;  // this warpgroup's 64 rows
      const int row = wg_row0 + 16 * (tid / 32) + lane / 4;  // and row + 8
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, a0, a1;

      // scores to probabilities, masked only where the tile crosses S,
      // the diagonal or the window's edge
      auto softmax = [&](int i) {
        const int c0 = (wk.t_lo + i) * kBK;
        const bool mask = c0 + kBK > S ||
                          (causal && c0 + kBK - 1 > wg_row0) ||
                          (window > 0 && c0 <= wg_row0 + 63 - window);
        if (mask) {
          softmax_tile<true>(sc, m0, m1, l0, l1, a0, a1, scale_log2, row,
                             c0 + qcol, S, causal, window);
        } else {
          softmax_tile<false>(sc, m0, m1, l0, l1, a0, a1, scale_log2, row,
                              c0 + qcol, S, causal, window);
        }
      };
      auto hand_over = [&](int i) {
        if (wg == 0 || !last_item || i < wk.n_tiles - 1)
          bar_arrive(other_turn, 256);
      };
      // after the item's last scores, Q's buffer goes back to the producer
      auto release = [&](int i, int s) {
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * s);
          if (i == wk.n_tiles - 1) mbar_arrive(q_empty + 8 * qb);
        }
      };

      mbar_wait(q_full + 8 * qb, (k >> 1) & 1);
      // the first tile: its scores and probabilities
      {
        const int s = n % kStages;
        mbar_wait(k_full + 8 * s, (n / kStages) & 1);
        bar_sync(own_turn, 256);
        issue_scores<D>(sc, qa, sk + s * T::kKVBytes);
        hand_over(0);
        wgmma_wait<0>();
        fence_regs(sc);
        release(0, s);
        softmax(0);
        pack_p(sc, pa);
      }
      // tile i's scores run on the tensor cores beside tile i - 1's P.V;
      // tile i's softmax runs while that P.V finishes
      for (int i = 1; i < wk.n_tiles; ++i) {
        const int g = n + i, s = g % kStages, sp = (g - 1) % kStages;
        mbar_wait(k_full + 8 * s, (g / kStages) & 1);
        bar_sync(own_turn, 256);
        issue_scores<D>(sc, qa, sk + s * T::kKVBytes);
#pragma unroll
        for (int x = 0; x < D / 2; ++x) o[x] *= (x & 2) ? a1 : a0;
        mbar_wait(v_full + 8 * sp, ((g - 1) / kStages) & 1);
        issue_pv<D>(o, pa, sv + sp * T::kKVBytes);
        hand_over(i);
        wgmma_wait<1>();  // the scores; P.V may still run
        fence_regs(sc);
        release(i, s);
        softmax(i);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(v_empty + 8 * sp);
        pack_p(sc, pa);
      }
      // the last tile's P.V
      n += wk.n_tiles;
      const int sl = (n - 1) % kStages;
#pragma unroll
      for (int x = 0; x < D / 2; ++x) o[x] *= (x & 2) ? a1 : a0;
      mbar_wait(v_full + 8 * sl, ((n - 1) / kStages) & 1);
      issue_pv<D>(o, pa, sv + sl * T::kKVBytes);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty + 8 * sl);

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
      const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
      if (lse != nullptr && (lane & 3) == 0) {
        const float none = __int_as_float(0xff800000);  // -inf: no key
        float* dst_lse = lse + static_cast<int64_t>(wk.q_plane) * S + row;
        if (row < S)
          dst_lse[0] = l0 == 0.f ? none : fmaf(m0, scale_log2, log2f(l0));
        if (row + 8 < S)
          dst_lse[8] = l1 == 0.f ? none : fmaf(m1, scale_log2, log2f(l1));
      }
      __nv_bfloat16* dst =
          out + (static_cast<int64_t>(wk.q_plane) * S + row) * D + qcol;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        if (row < S)
          *reinterpret_cast<uint32_t*>(dst + 8 * c) =
              pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0);
        if (row + 8 < S)
          *reinterpret_cast<uint32_t*>(dst + 8 * D + 8 * c) =
              pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once (null if absent)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// (D, S, planes) bf16 tensor, boxes of kBoxCols x rows, swizzled to match
// the wgmma descriptors; rows past S read as zeros
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
              int planes, int S, int rows) {
  using T = Tile<D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::kBoxCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : (T::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Above 48 KB of dynamic shared memory only after opting in, which holds
// for the current device; made once per kernel and device, so that a later
// call may be captured into a CUDA graph.
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

// The current device's SM count, looked up once per device.
inline cudaError_t sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && counts[dev] > 0) {
    *sms = counts[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) counts[dev] = *sms;
  return err;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Hq, int Hkv, int S, int causal, int window,
           cudaStream_t stream) {
  using T = Tile<D>;
  // one persistent block an SM, each walking its share of the items
  const int64_t n_items = static_cast<int64_t>((S + kBQ - 1) / kBQ) * B * Hq;
  if (n_items > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_q, map_k, map_v;
  if (!make_map<D>(encode, &map_q, q, B * Hq, S, kBQ) ||
      !make_map<D>(encode, &map_k, k, B * Hkv, S, kBK) ||
      !make_map<D>(encode, &map_v, v, B * Hkv, S, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = opt_in_smem<flash_attention_wgmma<D>>(T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  flash_attention_wgmma<D><<<grid, kThreads, T::kSmem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), lse, B, Hq, Hkv,
      S, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// lse: null, or (B, Hq, S) f32 for each row's log-sum-exp
inline int dispatch(const void* q, const void* k, const void* v, void* out,
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

}  // namespace fa_wgmma
