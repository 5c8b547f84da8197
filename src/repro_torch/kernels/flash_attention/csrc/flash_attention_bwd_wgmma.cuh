// flash_attention backward in bfloat16 on Hopper's tensor cores (sm_90a):
// wgmma on bf16 tiles, TMA loads into rings of shared-memory stages guarded
// by mbarriers, warp-specialised, as the forward (flash_attention_wgmma.cuh,
// whose mbarrier, TMA, descriptor, wgmma and fence helpers this file uses).
//
// Computes what flash_attention_bwd.cu's CUDA-core kernels compute, for
// q, o, do, dq (B, Hq, S, D) and k, v, dk, dv (B, Hkv, S, D), bf16, with
// the row log-sum-exp `lse` (base 2, of the scores times log2(e)) that the
// forward wrote and delta[r] = sum_d do[r][d] o[r][d] (fa_bwd_prep):
//   P = exp2(z log2(e) - lse), dP = do v^T, dZ = P (dP - delta),
//   dq = dZ k / sqrt(D), dk = dZ^T q / sqrt(D), dv = P^T do,
// dk and dv summed over each KV head's query heads; a key a row may not
// see gives P = 0, so a row past S gives nothing.  flash_attention_bwd.cu
// includes this file and sends every bfloat16 call here, at every head
// dim the forward takes (16, 32, 64, 128).
//
// Bound: at llama3.2-3b's training shape (B = 4, 24 q heads over 8 kv
// heads, S = 2048, D = 128, causal) the function's work is five products
// over the causal half, 2.6e11 FLOP: 0.26 ms at the bf16 tensor-core rate,
// far above the 0.08 ms that its 268 MB take at 3.35 TB/s.  This design
// runs nine products (S and dP are computed in both kernels below, so
// that no gradient needs a float atomic, and dV's and dK's products run
// twice, on P's and dZ's bf16 high and low parts), 0.47 ms at that rate.
// What it does about the bound:
//
// - Every product is a wgmma on bf16 operands with f32 accumulators.  dQ
//   takes dZ rounded to bf16 as its A operand, as FA2/FA3 do (the forward
//   rounds P the same way).  dV and dK take P and dZ as two bf16 parts
//   each, hi = bf16(x) and lo = bf16(x - hi), ~2^-17 of x together: they
//   sum over every row of every query head of the GQA group (32,768
//   terms at qwen3-moe's 16 heads over 2048 rows), where one bf16 rounding
//   of each term put single elements past 2e-2 x (1 + |grad|) of the f32
//   gradient (as it does in SDPA's backward).  Every sum stays f32.
// - `dkdv_wgmma`, one block for each (b, kv head, 128 keys): K and V stay
//   in shared memory (TMA); warpgroup 2 produces (setmaxnreg 24) and one
//   of its threads streams the visible 64-row query tiles of every query
//   head of the group, in a fixed order, through a ring of kRing stages
//   of Q and dO (TMA), while its warp copies the tiles' lse and delta.
//   Warpgroups 0 and 1 (setmaxnreg 240) own 64 keys each.  For each query
//   tile: S^T = K Q^T and dP^T = V dO^T (SS, both operands K-major as
//   stored, as the forward's Q K^T), P^T and dZ^T in registers (the lse
//   and delta of each column from shared memory), then dV += P^T dO and
//   dK += dZ^T Q, each over the high part and then the low part (RS: the
//   f32 accumulator fragment packed to bf16 pairs is the A operand, as
//   the forward's P for P.V; dO and Q through MN-major descriptors, as
//   the forward reads V).  dK and dV stay in f32
//   registers over the whole group and are scaled and rounded once: no
//   atomics, a fixed order, a bit-identical result every call.
// - `dq_wgmma`, one block for each (b, q head, 128 query rows): Q and dO
//   stay in shared memory, the producer streams the visible 128-key tiles
//   of K and V through a ring; each consumer warpgroup owns 64 rows (lse
//   and delta in registers) and recomputes S = Q K^T and dP = dO V^T, then
//   dQ += dZ K (RS, K through an MN-major descriptor): the forward's
//   shapes (its issue_scores, issue_pv and pack_p), so its S and dP are
//   m64n128 products where the dK/dV kernel's are m64n64.
// - Masks follow the forward: tiles that see no allowed pair are skipped
//   (the producer never loads them; a warpgroup whose 64 rows or keys are
//   all masked in a loaded tile skips its products), the element mask
//   runs only on tiles that cross the diagonal, the window's edge or S,
//   and the blocks with the most work are launched first.
// - Ragged S: the 3-D tensor maps zero-fill rows past S, lse and delta
//   read as 0 there, and the element mask gives those rows P = 0.
#pragma once

#include "flash_attention_wgmma.cuh"

namespace fa_bwd_wgmma {

using namespace fa_wgmma;

// dkdv_wgmma: kBK keys a block, 64 a consumer warpgroup, and query tiles
// of kTile rows streamed; dq_wgmma: kBQ query rows a block, 64 a
// warpgroup, and key tiles of kBK streamed (the forward's constants)
constexpr int kTile = 64;
constexpr int kRing = 2;  // stages in flight

// d = A.B over k = 16: A (64 x 16) and B (16 x 64) from shared memory,
// both K-major; scale_d = 0 starts from zero
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = A B^T over D: A the 64 rows at `a` of a tile of a_rows rows, B the
// 64 rows at `b` of a tile of b_rows rows, both (rows, D) K-major as TMA
// stored them (boxes rows * kSwizzle bytes apart).  Issued and committed,
// not waited for.
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         int a_rows, uint32_t b, int b_rows) {
  using T = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t box = kk / T::kKSteps, step = kk % T::kKSteps;
    wgmma_ss_n64(d,
                 make_desc(a + box * a_rows * T::kSwizzle + step * 32, 16,
                           8 * T::kSwizzle, T::kLayout),
                 make_desc(b + box * b_rows * T::kSwizzle + step * 32, 16,
                           8 * T::kSwizzle, T::kLayout),
                 kk > 0);
  }
  wgmma_commit();
}

// d += A B: A (64 x 64) in registers, the accumulator fragment of a
// 64 x 64 product packed to bf16 pairs; B the (64, D) tile at `b` read
// MN-major (8-row groups 8 * kSwizzle bytes apart, column boxes
// 64 * kSwizzle bytes apart, k16 steps 16 rows apart).  Issued and
// committed, not waited for.
template <int D>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[16],
                                         uint32_t b) {
  using T = Tile<D>;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j)
    wgmma_rs<D>(d, a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3],
                make_desc(b + j * 16 * T::kSwizzle, kTile * T::kSwizzle,
                          8 * T::kSwizzle, T::kLayout));
  wgmma_commit();
}

// x (a 64 x 64 product's accumulator fragment) as two A fragments of
// bf16 pairs, the first element in each pair's low half: hi = bf16(x) and
// lo = bf16(x - hi); x - hi is exact in f32, and hi + lo is within
// ~2^-17 of x.  Pair by pair, so that x's registers free as they go.
__device__ __forceinline__ void split16(const float (&x)[32],
                                       uint32_t (&hi)[16],
                                       uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    hi[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
    lo[i] = pack_bf16(x[2 * i] - __uint_as_float(hi[i] << 16),
                      x[2 * i + 1] - __uint_as_float(hi[i] & 0xffff0000u));
  }
}

__device__ __forceinline__ bool allowed(int row, int col, int S, int causal,
                                        int window) {
  return row < S && col < S && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// Rows [r0, r0 + 64) against keys [c0, c0 + cols): no allowed pair at
// all, or some pair masked (the element mask is needed)
template <int cols>
__device__ __forceinline__ bool none_allowed(int r0, int c0, int S,
                                             int causal, int window) {
  return r0 >= S || c0 >= S || (causal && c0 > r0 + kTile - 1) ||
         (window > 0 && c0 + cols - 1 <= r0 - window);
}
template <int cols>
__device__ __forceinline__ bool needs_mask(int r0, int c0, int S,
                                           int causal, int window) {
  return r0 + kTile > S || c0 + cols > S || (causal && c0 + cols - 1 > r0) ||
         (window > 0 && c0 <= r0 + kTile - 1 - window);
}

// Shared memory of a kernel with two resident tiles of `resident` rows
// and a ring of two streamed tiles of `streamed` rows, plus `rows_bytes`
// of f32 row values a stage and the mbarriers, 1 KB of slack to align
// the tiles to the swizzle pattern's period.
template <int D>
constexpr size_t smem_bytes(int resident, int streamed, int rows_bytes) {
  return 1024 + 2 * static_cast<size_t>(resident) * D * 2 +
         kRing * (2 * static_cast<size_t>(streamed) * D * 2 + rows_bytes) +
         8 * (1 + 2 * kRing);
}

// ---------------------------------------------------------------------------
// dK, dV: one block for each (b, kv head, 128 keys)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap map_q,   // 64-row boxes
               const __grid_constant__ CUtensorMap map_do,  // 64-row boxes
               const __grid_constant__ CUtensorMap map_k,   // 128-row boxes
               const __grid_constant__ CUtensorMap map_v,   // 128-row boxes
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int B, int Hq, int Hkv,
               int S, int causal, int window, float scale_log2,
               float scale) {
  using T = Tile<D>;
  constexpr uint32_t kKV = kBK * D * 2;  // bytes of K (and of V)
  constexpr uint32_t kQ = kTile * D * 2;   // bytes of a Q (or dO) stage
  constexpr uint32_t kRowVals = 2 * kTile * 4;  // lse and delta a stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sk = (base + 1023) & ~1023u;
  const uint32_t sv = sk + kKV;
  const uint32_t sq = sv + kKV;              // + s * kQ
  const uint32_t sdo = sq + kRing * kQ;      // + s * kQ
  const uint32_t srow = sdo + kRing * kQ;    // + s * kRowVals
  const uint32_t kv_full = srow + kRing * kRowVals;
  const uint32_t full = kv_full + 8;          // + 8 * stage
  const uint32_t empty = full + 8 * kRing;    // + 8 * stage
  float* rows_f = reinterpret_cast<float*>(smem_raw + (srow - base));

  // the key tiles with the most visible query rows first (under a causal
  // mask the first)
  const int per_tile = B * Hkv;
  const int kt = blockIdx.x / per_tile, rem = blockIdx.x % per_tile;
  const int g = rem % Hkv, b = rem / Hkv;
  const int group = Hq / Hkv;
  const int c0 = kt * kBK;
  const int kv_plane = b * Hkv + g;
  // the 64-row query tiles that see a key of this block
  const int c_last = min(c0 + kBK, S) - 1;
  const int r_lo = causal ? c0 : 0;
  const int r_hi = window > 0 ? min(S - 1, c_last + window - 1) : S - 1;
  const int t_lo = r_lo / kTile;
  const int n_t = r_lo <= r_hi ? r_hi / kTile - t_lo + 1 : 0;
  const int n_items = group * n_t;  // query head hh = i / n_t, in order

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kRing; ++s) {
      // the TMA thread's arrival (with its bytes) and the producer
      // warp's 32 after their copies of lse and delta
      mbar_init(full + 8 * s, 33);
      mbar_init(empty + 8 * s, 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int lane = threadIdx.x - 256;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * kKV);
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x) {
        tma_load(sk + x * kBK * T::kSwizzle, &map_k, kv_full,
                 x * T::kBoxCols, c0, kv_plane);
        tma_load(sv + x * kBK * T::kSwizzle, &map_v, kv_full,
                 x * T::kBoxCols, c0, kv_plane);
      }
    }
    if (lane < 32) {
      for (int i = 0; i < n_items; ++i) {
        const int s = i % kRing;
        const int q_plane = b * Hq + g * group + i / n_t;
        const int q0 = (t_lo + i % n_t) * kTile;
        mbar_wait(empty + 8 * s, ((i / kRing) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * kQ);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x) {
            tma_load(sq + s * kQ + x * kTile * T::kSwizzle, &map_q,
                     full + 8 * s, x * T::kBoxCols, q0, q_plane);
            tma_load(sdo + s * kQ + x * kTile * T::kSwizzle, &map_do,
                     full + 8 * s, x * T::kBoxCols, q0, q_plane);
          }
        }
        // lse and delta of the tile's rows, 0 past S
        float* dst = rows_f + s * (kRowVals / 4);
        const int64_t at = static_cast<int64_t>(q_plane) * S;
        for (int r = lane; r < kTile; r += 32) {
          const bool in = q0 + r < S;
          dst[r] = in ? lse[at + q0 + r] : 0.f;
          dst[kTile + r] = in ? delta[at + q0 + r] : 0.f;
        }
        mbar_arrive(full + 8 * s);  // releases the copies
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qcol = 2 * (lane % 4);
    const int kw0 = c0 + 64 * wg;  // this warpgroup's 64 keys
    const int key = kw0 + 16 * (tid / 32) + lane / 4;  // and key + 8
    const uint32_t ka = sk + 64 * wg * T::kSwizzle;
    const uint32_t va = sv + 64 * wg * T::kSwizzle;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
    float st[32], dpt[32];
    uint32_t pa[16], za[16], pl[16], zl[16];

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_items; ++i) {
      const int s = i % kRing;
      const int q0 = (t_lo + i % n_t) * kTile;
      mbar_wait(full + 8 * s, (i / kRing) & 1);
      if (!none_allowed<kTile>(q0, kw0, S, causal, window)) {
        const uint32_t qs = sq + s * kQ, dos = sdo + s * kQ;
        issue_ss<D>(st, ka, kBK, qs, kTile);   // S^T = K Q^T
        issue_ss<D>(dpt, va, kBK, dos, kTile);  // dP^T = V dO^T
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        // column c of the tile is query q0 + c: its lse and delta
        const float* lse_s = rows_f + s * (kRowVals / 4);
        const float* delta_s = lse_s + kTile;
        const bool mask = needs_mask<kTile>(q0, kw0, S, causal, window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse_s + qcol + 8 * j);
          const float2 d2 =
              *reinterpret_cast<const float2*>(delta_s + qcol + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            const float lse = (e & 1) ? l2.y : l2.x;
            const float delta = (e & 1) ? d2.y : d2.x;
            float p = exp2_ftz(fmaf(st[x], scale_log2, -lse));
            if (mask) {
              const int r = key + 8 * ((e >> 1) & 1);
              const int c = q0 + qcol + 8 * j + (e & 1);
              p = allowed(c, r, S, causal, window) ? p : 0.f;
            }
            st[x] = p;
            dpt[x] = p * (dpt[x] - delta);
          }
        }
        split16(st, pa, pl);
        split16(dpt, za, zl);
        issue_rs<D>(dv_acc, pa, dos);  // dV += P_hi^T dO
        issue_rs<D>(dk_acc, za, qs);   // dK += dZ_hi^T Q
        issue_rs<D>(dv_acc, pl, dos);  // dV += P_lo^T dO
        issue_rs<D>(dk_acc, zl, qs);   // dK += dZ_lo^T Q
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    const int64_t at = static_cast<int64_t>(kv_plane) * S;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (key < S) {
        const int64_t o = (at + key) * D + 8 * c + qcol;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack_bf16(dk_acc[4 * c] * scale, dk_acc[4 * c + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) =
            pack_bf16(dv_acc[4 * c], dv_acc[4 * c + 1]);
      }
      if (key + 8 < S) {
        const int64_t o = (at + key + 8) * D + 8 * c + qcol;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack_bf16(dk_acc[4 * c + 2] * scale, dk_acc[4 * c + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) =
            pack_bf16(dv_acc[4 * c + 2], dv_acc[4 * c + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block for each (b, q head, 128 query rows), over tiles of 128
// keys: the forward's shapes, so its score, P.V and packing helpers serve
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap map_q,   // 128-row boxes
             const __grid_constant__ CUtensorMap map_do,  // 128-row boxes
             const __grid_constant__ CUtensorMap map_k,   // 128-row boxes
             const __grid_constant__ CUtensorMap map_v,   // 128-row boxes
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int B, int Hq, int Hkv, int S,
             int causal, int window, float scale_log2, float scale) {
  using T = Tile<D>;
  constexpr uint32_t kQ = kBQ * D * 2;   // bytes of Q (and of dO)
  constexpr uint32_t kKV = kBK * D * 2;    // bytes of a K (or V) stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + kQ;
  const uint32_t sk = sdo + kQ;             // + s * kKV
  const uint32_t sv = sk + kRing * kKV;     // + s * kKV
  const uint32_t q_full = sv + kRing * kKV;
  const uint32_t full = q_full + 8;          // + 8 * stage
  const uint32_t empty = full + 8 * kRing;   // + 8 * stage

  // the query tiles with the most keys first (under a causal mask the
  // last); the heads of one KV head are neighbours
  const int n_q = (S + kBQ - 1) / kBQ;
  const int per_tile = B * Hq;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rem = blockIdx.x % per_tile;
  const int h = rem % Hq, b = rem / Hq;
  const int q0 = qt * kBQ;
  const int q_plane = b * Hq + h;
  const int kv_plane = b * Hkv + h / (Hq / Hkv);
  const int k_hi = causal ? min(S, q0 + kBQ) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBK;
  const int n_t = (k_hi + kBK - 1) / kBK - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * kQ);
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x) {
        tma_load(sq + x * kBQ * T::kSwizzle, &map_q, q_full,
                 x * T::kBoxCols, q0, q_plane);
        tma_load(sdo + x * kBQ * T::kSwizzle, &map_do, q_full,
                 x * T::kBoxCols, q0, q_plane);
      }
      for (int i = 0; i < n_t; ++i) {
        const int s = i % kRing, row0 = (t_lo + i) * kBK;
        mbar_wait(empty + 8 * s, ((i / kRing) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * kKV);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load(sk + s * kKV + x * kBK * T::kSwizzle, &map_k,
                   full + 8 * s, x * T::kBoxCols, row0, kv_plane);
          tma_load(sv + s * kKV + x * kBK * T::kSwizzle, &map_v,
                   full + 8 * s, x * T::kBoxCols, row0, kv_plane);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qcol = 2 * (lane % 4);
    const int r0 = q0 + 64 * wg;  // this warpgroup's 64 rows
    const int row = r0 + 16 * (tid / 32) + lane / 4;  // and row + 8
    const uint32_t qa = sq + 64 * wg * T::kSwizzle;
    const uint32_t doa = sdo + 64 * wg * T::kSwizzle;
    const int64_t at = static_cast<int64_t>(q_plane) * S;
    const float lse0 = row < S ? lse[at + row] : 0.f;
    const float lse1 = row + 8 < S ? lse[at + row + 8] : 0.f;
    const float delta0 = row < S ? delta[at + row] : 0.f;
    const float delta1 = row + 8 < S ? delta[at + row + 8] : 0.f;

    float dq_acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dq_acc[x] = 0.f;
    float sc[kBK / 2], dp[kBK / 2];
    uint32_t za[kBK / 4];

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_t; ++i) {
      const int s = i % kRing, c0 = (t_lo + i) * kBK;
      mbar_wait(full + 8 * s, (i / kRing) & 1);
      if (!none_allowed<kBK>(r0, c0, S, causal, window)) {
        const uint32_t ks = sk + s * kKV, vs = sv + s * kKV;
        issue_scores<D>(sc, qa, ks);   // S = Q K^T
        issue_scores<D>(dp, doa, vs);  // dP = dO V^T
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        const bool mask = needs_mask<kBK>(r0, c0, S, causal, window);
#pragma unroll
        for (int x = 0; x < kBK / 2; ++x) {
          const bool lo = ((x >> 1) & 1) == 0;
          float p = exp2_ftz(fmaf(sc[x], scale_log2, lo ? -lse0 : -lse1));
          if (mask) {
            const int r = row + (lo ? 0 : 8);
            const int c = c0 + qcol + 8 * (x / 4) + (x & 1);
            p = allowed(r, c, S, causal, window) ? p : 0.f;
          }
          dp[x] = p * (dp[x] - (lo ? delta0 : delta1));
        }
        pack_p(dp, za);
        issue_pv<D>(dq_acc, za, ks);  // dQ += dZ K
        wgmma_wait<0>();
        fence_regs(dq_acc);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (row < S)
        *reinterpret_cast<uint32_t*>(dq + (at + row) * D + 8 * c + qcol) =
            pack_bf16(dq_acc[4 * c] * scale, dq_acc[4 * c + 1] * scale);
      if (row + 8 < S)
        *reinterpret_cast<uint32_t*>(dq + (at + row + 8) * D + 8 * c +
                                     qcol) =
            pack_bf16(dq_acc[4 * c + 2] * scale, dq_acc[4 * c + 3] * scale);
    }
  }
}

// The dK/dV and dQ kernels on `stream`, after delta is written; lse and
// delta (B, Hq, S) f32.  Returns the first error, or 0.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int B, int Hq, int Hkv, int S, int causal, int window,
           cudaStream_t stream) {
  const int64_t n_dkdv =
      static_cast<int64_t>((S + kBK - 1) / kBK) * B * Hkv;
  const int64_t n_dq = static_cast<int64_t>((S + kBQ - 1) / kBQ) * B * Hq;
  if (n_dq > (int64_t{1} << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q64, do64, k128, v128, q128, do128;
  if (!make_map<D>(encode, &q64, q, B * Hq, S, kTile) ||
      !make_map<D>(encode, &do64, dout, B * Hq, S, kTile) ||
      !make_map<D>(encode, &k128, k, B * Hkv, S, kBK) ||
      !make_map<D>(encode, &v128, v, B * Hkv, S, kBK) ||
      !make_map<D>(encode, &q128, q, B * Hq, S, kBQ) ||
      !make_map<D>(encode, &do128, dout, B * Hq, S, kBQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t kSmemDkdv = smem_bytes<D>(kBK, kTile, 2 * kTile * 4);
  constexpr size_t kSmemDq = smem_bytes<D>(kBQ, kBK, 0);
  cudaError_t err = opt_in_smem<dkdv_wgmma<D>>(kSmemDkdv);
  if (err == cudaSuccess) err = opt_in_smem<dq_wgmma<D>>(kSmemDq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale_log2 = 1.4426950408889634f * scale;
  dkdv_wgmma<D><<<static_cast<int>(n_dkdv), kThreads, kSmemDkdv, stream>>>(
      q64, do64, k128, v128, lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B,
      Hq, Hkv, S, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_wgmma<D><<<static_cast<int>(n_dq), kThreads, kSmemDq, stream>>>(
      q128, do128, k128, v128, lse, delta, static_cast<__nv_bfloat16*>(dq),
      B, Hq, Hkv, S, causal, window, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa_bwd_wgmma
