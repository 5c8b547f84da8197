// fedavg_agg: the eq.-(13) weighted aggregate over stacked client models,
// written for Hopper (sm_90a), every leaf of a model and every size
// bucket of the cohort in one launch.
//
//   out_l[p] = sum_b sum_c w[off_b + c] * x_{b,l}[c, p]
//     x_{b,l}: (C_b, P_l) the stack of leaf l in bucket b,
//     w: (sum_b C_b,) f32 in bucket order, out_l: (P_l,)
//
// Accumulation is in f32; the result is cast back to the input type
// (f32 or bf16), as the reference does.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_agg/kernel.py
// (`weighted_aggregate`, body `_agg_kernel`).  That kernel walks one
// leaf's flattened parameter axis in 16,384-element tiles on a
// sequential grid, with the client axis resident in vector registers,
// and the reference calls it once per leaf on the buckets' concatenated
// stacks.  Here one launch takes a table of every (leaf, bucket) stack,
// passed by value as a kernel parameter (no host-to-device copy, so the
// launch can be captured in a CUDA graph), and reads each bucket's rows
// where they lie: no copy of the stacks is made first.
//
// Bound: one FMA per input element, so memory: (C + 1) * P * bytes at
// the card's bandwidth.  The paper setup's MNIST CNN (8 leaves, 421,642
// parameters, 64 + 4 clients, f32) moves about 116 MB (~35 us at 3.35
// TB/s); VGG-11 (9,225,610 parameters) about 2.55 GB (~0.76 ms).  What
// the design does about it: one block for each work item, of two kinds
// (the card's block scheduler balances them; a grid of only as many
// blocks as the card holds at once, each walking items in turn, was
// slower at VGG-11's size).
// - A (leaf, tile) item: kTile contiguous elements of a large leaf.  Each
//   thread owns kVec of them and walks every client of every bucket in
//   turn (16-byte loads of f32, 8-byte of bf16 where the rows are
//   aligned, neighbouring threads on neighbouring addresses, kUnroll
//   loads in flight), the weights in shared memory.
// - A small leaf (fewer vectors than a block has threads), whole: such a
//   leaf's client loop is a chain of dependent-latency loads on a few
//   threads, so the block splits the client axis over groups of threads
//   instead, and sums the groups' partial sums through shared memory in
//   a fixed order (no atomics: the same bits on every run).
// Items are ordered by leaf size, smallest first, so the latency-bound
// items start first and the streaming tiles of the large leaves fill
// the card behind them.  A scalar path covers rows that are not aligned
// and the ragged tail of P.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;     // elements of P per thread
constexpr int kUnroll = 8;  // clients whose loads a thread keeps in flight
constexpr int kTile = kThreads * kVec;  // elements of P per tile item
constexpr int kMaxClients = 12288;      // weights in shared memory

struct Part {  // the stack of one leaf in one bucket
  const void* x;
  int clients;
  int w_offset;  // its first client's index in w
};

struct Leaf {
  void* out;
  int64_t P;
  int first_item;
  int16_t vec;    // every row and the output aligned for kVec-wide access
  int16_t small;  // one item, the client axis split over the block
};

// The kernel's parameters (the table and w) fill at most the 32,764
// bytes that CUDA 12.1 and later pass to a kernel on sm_70 and up.  The
// table's data holds n_leaves Leafs, then the n_buckets Parts of each
// leaf in turn: 24 + 16 * n_buckets bytes a leaf, so 584 leaves over 2
// buckets, or VGG-11's 18 over 112.
constexpr int kParamBytes = 32764;
constexpr int kTableBytes =
    (kParamBytes - static_cast<int>(sizeof(float*)) - 16) / 8 * 8;

struct Table {
  int n_items;
  int n_leaves;
  int n_buckets;
  int n_weights;
  alignas(8) unsigned char data[kTableBytes];

  Leaf* leaves() { return reinterpret_cast<Leaf*>(data); }  // host side
  Part* parts() {  // leaf l's in [l * n_buckets, (l + 1) * n_buckets)
    return reinterpret_cast<Part*>(data + n_leaves * sizeof(Leaf));
  }
  __device__ const Leaf& leaf(int l) const {
    return reinterpret_cast<const Leaf*>(data)[l];
  }
  __device__ const Part& part(int l, int b) const {
    return reinterpret_cast<const Part*>(
        data + n_leaves * sizeof(Leaf))[l * n_buckets + b];
  }
};
static_assert(sizeof(Leaf) == 24 && sizeof(Part) == 16,
              "kernel.py's TABLE_BYTES check counts these sizes");
static_assert(sizeof(Table) + sizeof(float*) <= kParamBytes,
              "the kernel's parameters exceed CUDA's limit");

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

// acc[i] += w[c] * x[c * P + i] over the clients c = c0, c0 + step, ...
// below C of one stack, for the elements this thread owns: kVec in one
// aligned load a client (vec), or the i < n of them one by one.  The branch
// is outside the client loop, which is unrolled kUnroll deep so that that
// many loads are in flight (with few threads, as for a small leaf, the
// loop is bound by load latency, not by bandwidth).
template <typename T>
__device__ __forceinline__ void accumulate(const T* x, const float* w,
                                           int c0, int step, int C,
                                           int64_t P, bool vec, int64_t n,
                                           float acc[kVec]) {
  if (vec) {
#pragma unroll(kUnroll)
    for (int c = c0; c < C; c += step) {
      float v[kVec];
      load_vec(x + static_cast<int64_t>(c) * P, v);
      const float wc = w[c];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(wc, v[i], acc[i]);
    }
    return;
  }
#pragma unroll(kUnroll)
  for (int c = c0; c < C; c += step) {
    const T* src = x + static_cast<int64_t>(c) * P;
    const float wc = w[c];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i < n) acc[i] = fmaf(wc, to_f32(src[i]), acc[i]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void write(T* dst, bool vec, int64_t n,
                                      const float acc[kVec]) {
  if (vec) {
    store_vec(dst, acc);
    return;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < n) from_f32(acc[i], dst + i);
  }
}

// One tile item of a large leaf: thread-owned kVec elements, every client
// of every bucket in order.
template <typename T>
__device__ void tile_item(const Leaf& leaf, const Part* parts, int n_parts,
                          int64_t tile, const float* w_smem) {
  const int64_t P = leaf.P;
  const int64_t p0 = tile * kTile + threadIdx.x * kVec;
  if (p0 >= P) return;
  const int64_t n = P - p0;
  const bool vec = leaf.vec && n >= kVec;
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
  for (int b = 0; b < n_parts; ++b) {
    const Part& part = parts[b];
    accumulate(static_cast<const T*>(part.x) + p0, w_smem + part.w_offset,
               0, 1, part.clients, P, vec, n, acc);
  }
  write(static_cast<T*>(leaf.out) + p0, vec, n, acc);
}

// A small leaf, whole: the block's threads form `splits` groups of
// `width` (a power of two at least the leaf's vector count); group g sums
// the leaf's clients g, g + splits, ... (numbered across the buckets in
// order), then every element's group sums are added in group order.
template <typename T>
__device__ void small_item(const Leaf& leaf, const Part* parts, int n_parts,
                           const float* w_smem, float* partial) {
  const int64_t P = leaf.P;
  const int nvec = static_cast<int>((P + kVec - 1) / kVec);
  int width = 1;
  while (width < nvec) width <<= 1;
  const int splits = kThreads / width;
  const int g = threadIdx.x / width;
  const int v = threadIdx.x % width;
  const int64_t p0 = static_cast<int64_t>(v) * kVec;
  const int64_t n = P - p0;
  const bool vec = leaf.vec && n >= kVec;
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
  if (v < nvec) {
    int first = 0;  // the index of this part's first client in the leaf
    for (int b = 0; b < n_parts; ++b) {
      const Part& part = parts[b];
      accumulate(static_cast<const T*>(part.x) + p0, w_smem + part.w_offset,
                 ((g - first) % splits + splits) % splits, splits,
                 part.clients, P, vec, n, acc);
      first += part.clients;
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) partial[threadIdx.x * kVec + i] = acc[i];
  __syncthreads();
  T* out = static_cast<T*>(leaf.out);
  for (int p = threadIdx.x; p < P; p += kThreads) {
    float s = 0.f;
    for (int gg = 0; gg < splits; ++gg) s += partial[gg * width * kVec + p];
    from_f32(s, out + p);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_kernel(const __grid_constant__ Table table,
                  const float* __restrict__ w) {
  extern __shared__ float smem[];
  float* w_smem = smem;                       // n_weights floats
  float* partial = smem + table.n_weights;    // kThreads * kVec floats
  for (int c = threadIdx.x; c < table.n_weights; c += kThreads) {
    w_smem[c] = w[c];
  }
  __syncthreads();
  const int item = blockIdx.x;
  int l = 0;
  while (l + 1 < table.n_leaves && table.leaf(l + 1).first_item <= item) {
    ++l;
  }
  const Leaf& leaf = table.leaf(l);
  const Part* parts = &table.part(l, 0);
  if (leaf.small) {
    small_item<T>(leaf, parts, table.n_buckets, w_smem, partial);
  } else {
    tile_item<T>(leaf, parts, table.n_buckets, item - leaf.first_item,
                 w_smem);
  }
}

// The shared-memory opt-in above the default 48 KB (the weights of up to
// kMaxClients clients and the partial sums), once per device, so that
// later launches can be captured in a CUDA graph.
template <typename T>
cudaError_t opt_in_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      fedavg_agg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>((kMaxClients + kThreads * kVec) * sizeof(float)));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T>
int launch(const Table& table, const float* w, cudaStream_t stream) {
  const cudaError_t err = opt_in_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      (static_cast<size_t>(table.n_weights) + kThreads * kVec) *
      sizeof(float);
  fedavg_agg_kernel<T><<<static_cast<unsigned>(table.n_items), kThreads,
                         smem, stream>>>(table, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Aggregates n_leaves leaves over n_buckets buckets in one launch.
//   x[b * n_leaves + l]: the (clients[b], P[l]) stack of leaf l in bucket b
//   out[l]: the (P[l],) output of leaf l;  w: sum(clients) f32 weights
// dtype: 0 = float32, 1 = bfloat16, for every stack and output.  Returns
// cudaGetLastError() after the launch (0 on success); refuses what the
// kernel does not take (a table past kTableBytes, more than 12,288
// clients, an empty leaf or bucket) with cudaErrorInvalidValue before
// launching anything.
extern "C" int fedavg_agg_launch(int n_buckets, int n_leaves,
                                 const void* const* x, const int* clients,
                                 void* const* out, const int64_t* P,
                                 const float* w, int dtype, void* stream) {
  constexpr int kMaxLeaves = kTableBytes / (sizeof(Leaf) + sizeof(Part));
  if (n_buckets < 1 || n_leaves < 1 ||
      n_leaves * (sizeof(Leaf) + n_buckets * int64_t{sizeof(Part)}) >
          kTableBytes ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t elem = dtype == 0 ? 4 : 2;
  Table table;  // only the bytes the leaves and parts use are written
  table.n_leaves = n_leaves;
  table.n_buckets = n_buckets;
  int n_weights = 0;
  for (int b = 0; b < n_buckets; ++b) {
    if (clients[b] < 1) return static_cast<int>(cudaErrorInvalidValue);
    n_weights += clients[b];
    if (n_weights > kMaxClients) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // leaves in the table by size, smallest first (a stable insertion sort)
  int order[kMaxLeaves];
  for (int l = 0; l < n_leaves; ++l) {
    if (P[l] < 1 || P[l] >= (int64_t{1} << 40)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int at = l;
    while (at > 0 && P[order[at - 1]] > P[l]) {
      order[at] = order[at - 1];
      --at;
    }
    order[at] = l;
  }
  int64_t items = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const int l = order[i];
    Leaf& leaf = table.leaves()[i];
    leaf.out = out[l];
    leaf.P = P[l];
    leaf.first_item = static_cast<int>(items);
    leaf.small = (P[l] + kVec - 1) / kVec < kThreads;
    items += leaf.small ? 1 : (P[l] + kTile - 1) / kTile;
    const uintptr_t align = static_cast<uintptr_t>(kVec * elem);
    bool vec = P[l] % kVec == 0 &&
               reinterpret_cast<uintptr_t>(out[l]) % align == 0;
    int offset = 0;
    for (int b = 0; b < n_buckets; ++b) {
      Part& part = table.parts()[i * n_buckets + b];
      part.x = x[b * n_leaves + l];
      part.clients = clients[b];
      part.w_offset = offset;
      offset += clients[b];
      vec = vec && reinterpret_cast<uintptr_t>(part.x) % align == 0;
    }
    leaf.vec = vec;
  }
  if (items >= (int64_t{1} << 31)) {  // one block an item
    return static_cast<int>(cudaErrorInvalidValue);
  }
  table.n_items = static_cast<int>(items);
  table.n_weights = n_weights;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(table, w, s)
                    : launch<__nv_bfloat16>(table, w, s);
}
