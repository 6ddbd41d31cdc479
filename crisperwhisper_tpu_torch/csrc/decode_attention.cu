// Single-query attention over a quantized (or float) decode cache: the
// three TPU kernels of experiments/ as one kernel template.
//
// Replaces the TPU kernels
//   experiments/decode_attention_v1.py (cross_attention_int8 -> _kernel),
//     one grid program per (batch, head) over an int8 cross cache;
//   experiments/decode_attention_v2.py (cross_attention_int8_v2 ->
//     _kernel), the same function with all heads in one program and q
//     rounded to bf16 first;
//   experiments/decode_gemv_v3.py (decode_gemv_attention -> _kernel), one
//     program per row against one layer of a stacked sequence-last cache
//     (s4/s8/bf16/f32), with optional scales, a causal position mask, a key
//     mask and the alignment selection inside the kernel.
// The TPU tilings (one program per head or per row, block-diagonal MXU
// dots) are not part of the function; here all three are one template
// instantiated over the cache's element type, with one C entry each that
// fixes the entry's rounding points:
//
//   entry   q before the product   P.V operand      output
//   v1      its own dtype          rounded to bf16  q's dtype, all probs
//   v2      rounded to bf16        rounded to bf16  q's dtype, all probs
//   v3      q's dtype              q's dtype        f32, aligned rows only
//
// K and V values go to the product in the operand dtype (exact for int8,
// int4 and bf16; an f32 cache under a bf16 q rounds, as the reference's
// astype does). Scores, softmax and both sums are f32.
//
// What bounds it on the H100: a (row, head) reads T x Dh cache values for
// K and for V once and does 4 x T x Dh operations on them, so the work is
// bound by bytes (int8 at B = 16, H = 20, T = 1500: about 62 MB, 0.019 ms
// at 3.35 TB/s). To stream those bytes the card needs many of them in
// flight on every SM, also when rows x heads is far below the SM count.
//
// Design: the keys of one (row, head) are split across a thread-block
// cluster of C blocks (C = 2, 4 or 8, picked by the wrapper from rows x
// heads and the SM count: ops/decode_attention.py `plan`; the entry takes
// any C that divides Dh), 128 threads a block, Dh = 64. Block r of the
// cluster owns keys [r P, (r + 1) P), P = ceil(T / C).
//  1. Loads: one thread issues bulk copies (cp.async.bulk, each completing
//     on its own mbarrier) of the block's K slice and V slice into shared
//     memory at the start, in kSlots pieces each, so the scores start on
//     the first K piece while the rest of K and all of V arrive. q, the
//     slice's bf16 scales and its key-mask bytes ride on K piece 0 (the
//     scales and mask as the 16-byte-aligned spans that hold them). The
//     layer is an argument: the copies index the stacked cache [L, B, H,
//     T, Dh] (packed int4: Dh / 2 bytes a row, the even index in the low
//     nibble) directly, so no layer is sliced. A slice of more than kSlots
//     pieces (caches at thousands of keys, where the wrapper's piece is
//     smaller than a quarter slice) streams through the same slots as a
//     ring: K pieces for the scores, then V pieces for P.V.
//  2. Scores: a key's row is read in 16-byte chunks (8-byte for int4) by
//     4 to 16 lanes against q in registers, widening int8 and int4 without
//     I2F (the value, sign bit flipped, in the low mantissa of 2^23, minus
//     2^23 + 128 or + 8: exact), and reduced with shuffles. Scale, position
//     mask (keys after `position` get -1e9; the position is an argument,
//     or an int32 the kernel reads on the device, so that one launch
//     captured in a CUDA graph serves every step of a decode: the grid
//     covers all T keys either way) and key mask follow; where every
//     key is masked the -1e9 scores tie and the row is uniform over T, as
//     in the reference.
//  3. One softmax for the cluster, in two passes: each block's max, then
//     each block's sum of exp(s - max), goes into every block's slots
//     through distributed shared memory (a store by map_shared_rank, then
//     cluster.sync()). Every block combines the C slots in rank order, so
//     all see the same max and sum whatever the schedule. Then p = e / sum
//     for its keys, the reference's division, and p * v_scale rounded
//     where the entry rounds. The rounding point comes after the global
//     sum, which is why this is a two-pass softmax and not an online one
//     (an online softmax rescales partial sums and would round p * v_scale
//     before the sum is known).
//  4. P.V from shared memory: lanes take chunks of a V row as in 2, the
//     warps strips of keys; the partial sums reduce across a warp's key
//     lanes by shuffles and across warps in shared memory in warp order;
//     each block stores its partial into its slot of rank 0's memory, and
//     rank 0 adds the slots in rank order and writes the output, so the
//     result does not depend on the schedule either.
//  5. Probabilities: v1/v2 write all of them. v3 writes the aligned rows:
//     the entry zeroes aligned [B, A, T] and each block adds sel[h, a] * p
//     into column a where sel[h, a] != 0 (the head's nonzero columns,
//     compacted once a block), so a one-hot column gets exactly its head's
//     row, a column no head selects stays zero, and a column of several
//     heads gets their weighted sum, as the reference's einsum does. A flag
//     that lets the lowest selecting head store first and the others add
//     after it would need clusters of other heads to wait on each other
//     (no forward-progress guarantee between clusters) and a flag reset
//     per launch (itself a memset), so the memset stays.
// Measured on the card (PERF.md): a bulk copy of the same slices alone
// runs near the bytes' bound; the kernel's time above it is the
// cluster's exchanges and P.V after each block's data has landed, which
// the other blocks of an SM hide only in part.

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 64;                  // head dim
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeys = 8192;
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxSmem = 232448;        // the H100's 227 KB a block
constexpr int kMaxDevices = 64;
constexpr int kSlots = 4;               // K (and V) pieces in flight
constexpr int kHeadBytes = 16 * kSlots + 256;  // the mbarriers, then q
constexpr float kMasked = -1e9f;        // the reference's mask fill

struct Int4Packed {};  // tag of the packed int4 cache (uint8 storage)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element e of a 32-bit word of a cache row, as f32 in the operand dtype:
// get(prep(w), e). int8 and int4 without I2F: prep flips each value's
// sign bit, get puts the value in the low mantissa of 2^23 (a byte
// permute, or a shift and a mask) and subtracts 2^23 + 128 (+ 8), exactly.
template <typename C>
struct Elem;
template <>
struct Elem<int8_t> {
  static constexpr int kPerWord = 4;
  __device__ static uint32_t prep(uint32_t w) { return w ^ 0x80808080u; }
  __device__ static float get(uint32_t w, int e, bool) {
    return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + e)) -
           8388736.f;
  }
};
template <>
struct Elem<Int4Packed> {
  static constexpr int kPerWord = 8;
  __device__ static uint32_t prep(uint32_t w) { return w ^ 0x88888888u; }
  __device__ static float get(uint32_t w, int e, bool) {
    return __uint_as_float(((w >> (4 * e)) & 0xFu) | 0x4B000000u) -
           8388616.f;
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static uint32_t prep(uint32_t w) { return w; }
  __device__ static float get(uint32_t w, int e, bool) {
    return __uint_as_float(e == 0 ? w << 16 : w & 0xFFFF0000u);
  }
};
template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static uint32_t prep(uint32_t w) { return w; }
  __device__ static float get(uint32_t w, int, bool op_bf16) {
    const float x = __uint_as_float(w);
    return op_bf16 ? round_bf16(x) : x;
  }
};

// Bytes of a cache row, by element type.
template <typename C>
__host__ __device__ constexpr int row_bytes() {
  return kD / Elem<C>::kPerWord * 4;
}

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Dynamic shared memory of a block, in this order: the mbarriers and q
// (kHeadBytes); kSlots K and kSlots V slots of `piece` rows of `row`
// bytes; for its `per` keys the scores (f32), the K and the V scales (bf16)
// and the key mask bytes, each copied as the 16-byte-aligned span that
// holds them; the warps' P.V partials; the head's nonzero sel columns and
// weights.
__host__ __device__ constexpr size_t smem_bytes(int per, int piece, int row,
                                                int n_align) {
  return kHeadBytes + 2 * (size_t)kSlots * piece * row + 4 * round16(per) +
         2 * round16(2 * (size_t)per + 15) + round16((size_t)per + 15) +
         4 * kWarps * kD + 8 * (((size_t)n_align + 3) & ~(size_t)3);
}

struct Args {
  const void* q;         // [B, H, Dh] f32 or bf16, pre-scaled
  const void* k;         // [L, B, H, T, Dh] (int4: Dh / 2 bytes a row)
  const void* v;
  const void* k_scale;   // [L, B, H, T] bf16, or null
  const void* v_scale;
  const void* key_mask;  // [B, T] one byte a key (0 = masked), or null
  const void* sel;       // [H, A] f32 head weights (one-hot in use), or null
  void* out;             // [B, H, Dh] f32 or bf16
  void* probs;           // [B, H, T] f32, or null
  void* aligned;         // [B, A, T] f32, or null
  const int* position_at;  // int32 on the device, read as `position`, or null
  int rows, heads, keys, layer, position, has_position, n_align;
  int q_bf16, op_bf16, pv_bf16, out_bf16;
  int cluster, piece;    // blocks a (row, head); K/V rows a slot holds
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// Arm the barrier's current phase (its one arrival) for `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from src
// into dst, completing on the barrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The 16-byte-aligned span around `bytes` bytes at src: (its start, its
// length). A 16-byte chunk that holds a byte of an allocation lies inside
// that allocation's pages, so the span is readable.
__device__ __forceinline__ uint32_t span_of(const void* src, size_t bytes,
                                            const unsigned char** start) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  *start = reinterpret_cast<const unsigned char*>(p & ~(uintptr_t)15);
  return (uint32_t)round16((p & 15) + bytes);
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The block's reduction of one value a thread: warp shuffles, then the
// warps in order through `red` (the result in every thread).
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red is free again
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) x = kMax ? fmaxf(x, red[i]) : x + red[i];
  return x;
}

// The cluster's combination of one value a block: each block stores its
// value into slot `rank` of `slots` in every block of the cluster (a
// distributed shared memory store), the cluster syncs, and each block
// combines its own C slots, max or sum in rank order, so every block and
// thread gets the same value whatever the schedule.
template <bool kMax>
__device__ float cluster_reduce(cg::cluster_group& cluster, float* slots,
                                float x, int rank, int n) {
  if (threadIdx.x < n) *cluster.map_shared_rank(slots + rank, threadIdx.x) = x;
  cluster.sync();
  x = slots[0];
  for (int r = 1; r < n; ++r) x = kMax ? fmaxf(x, slots[r]) : x + slots[r];
  return x;
}

// A lane's share of a cache row: kW 32-bit words from its 4 kW-byte
// chunk, each through prep.
template <typename E, int kW>
__device__ __forceinline__ void load_words(const unsigned char* row, int part,
                                           uint32_t* w) {
  if constexpr (kW == 4) {
    const uint4 x = reinterpret_cast<const uint4*>(row)[part];
    w[0] = E::prep(x.x), w[1] = E::prep(x.y), w[2] = E::prep(x.z),
    w[3] = E::prep(x.w);
  } else {
    const uint2 x = reinterpret_cast<const uint2*>(row)[part];
    w[0] = E::prep(x.x), w[1] = E::prep(x.y);
  }
}

template <typename C>
__global__ void __launch_bounds__(kThreads, 8)
    decode_attention_kernel(Args a) {
  using E = Elem<C>;
  constexpr int kRow = row_bytes<C>();           // bytes a cache row
  constexpr int kLaneBytes = kRow >= 64 ? 16 : 8;  // a lane's chunk
  constexpr int kW = kLaneBytes / 4;             // its 32-bit words
  constexpr int kLanes = kRow / kLaneBytes;      // lanes a key (4 to 16)
  constexpr int kKeysPass = 32 / kLanes;         // keys a warp a pass
  constexpr int kVals = kW * E::kPerWord;        // values a lane
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kWarps];
  // the cluster's slots: each block's max, its sum, and (read by rank 0)
  // its P.V partial, stored there by that block
  __shared__ float maxs[kMaxCluster], sums[kMaxCluster];
  __shared__ float parts[kMaxCluster * kD];
  __shared__ int n_sel;                          // the head's sel columns
  // the first half of a cluster barrier: no block stores into another
  // before that one has started (the second half waits before the first
  // store)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_rank = a.cluster;
  const int h = blockIdx.x / n_rank;
  const int b = blockIdx.y;
  const int t = a.keys;
  const int per = (t + n_rank - 1) / n_rank;
  const int k0 = min(rank * per, t);
  const int n = min(t - k0, per);                // this block's keys
  const int n_pieces = (n + a.piece - 1) / a.piece;

  // piece i of K and of V goes to slot i % kSlots, each slot with its own
  // barrier (K: bars + 8 s, V: bars + 8 (kSlots + s))
  const uint32_t bars = smem_u32(smem);
  unsigned char* qsm = smem + 16 * kSlots;
  unsigned char* kbuf = smem + kHeadBytes;
  unsigned char* vbuf = kbuf + (size_t)kSlots * a.piece * kRow;
  float* sc = reinterpret_cast<float*>(vbuf + (size_t)kSlots * a.piece * kRow);
  unsigned char* ksm = reinterpret_cast<unsigned char*>(sc) + 4 * round16(per);
  unsigned char* vsm = ksm + round16(2 * (size_t)per + 15);
  unsigned char* msm = vsm + round16(2 * (size_t)per + 15);
  float* part = reinterpret_cast<float*>(msm + round16((size_t)per + 15));  // [kWarps][kD]
  int* sel_col = reinterpret_cast<int*>(part + kWarps * kD);
  float* sel_w = reinterpret_cast<float*>(sel_col + ((a.n_align + 3) & ~3));

  const size_t bh = (size_t)b * a.heads + h;
  const size_t slab = ((size_t)a.layer * a.rows + b) * a.heads + h;
  const unsigned char* kg =
      static_cast<const unsigned char*>(a.k) + (slab * t + k0) * kRow;
  const unsigned char* vg =
      static_cast<const unsigned char*>(a.v) + (slab * t + k0) * kRow;
  const __nv_bfloat16* ks =
      a.k_scale ? static_cast<const __nv_bfloat16*>(a.k_scale) + slab * t + k0
                : nullptr;
  const __nv_bfloat16* vs =
      a.v_scale ? static_cast<const __nv_bfloat16*>(a.v_scale) + slab * t + k0
                : nullptr;
  const uint8_t* km =
      a.key_mask ? static_cast<const uint8_t*>(a.key_mask) + (size_t)b * t + k0
                 : nullptr;
  // where the scales and mask land: their spans keep the source's offset
  // within 16 bytes
  const __nv_bfloat16* kss = reinterpret_cast<const __nv_bfloat16*>(
      ksm + (reinterpret_cast<uintptr_t>(ks) & 15));
  const __nv_bfloat16* vss = reinterpret_cast<const __nv_bfloat16*>(
      vsm + (reinterpret_cast<uintptr_t>(vs) & 15));
  const uint8_t* kms = msm + (reinterpret_cast<uintptr_t>(km) & 15);

  auto load_piece = [&](int i, int v) {
    const int rows = min(n - i * a.piece, a.piece);
    const uint32_t bar = bars + 8 * (v * kSlots + i % kSlots);
    const size_t at = (size_t)(i % kSlots) * a.piece * kRow;
    mbar_expect(bar, rows * kRow);
    bulk_copy(smem_u32((v ? vbuf : kbuf) + at),
              (v ? vg : kg) + (size_t)i * a.piece * kRow, rows * kRow, bar);
  };
  if (threadIdx.x == 0) {
    n_sel = 0;
    for (int i = 0; i < 2 * kSlots; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) {
      // q, the scales and the mask ride on K piece 0's barrier
      const int qbytes = a.q_bf16 ? 2 * kD : 4 * kD;
      const unsigned char *s0, *s1, *s2;
      const uint32_t nk = ks ? span_of(ks, 2 * (size_t)n, &s0) : 0;
      const uint32_t nv = vs ? span_of(vs, 2 * (size_t)n, &s1) : 0;
      const uint32_t nm = km ? span_of(km, (size_t)n, &s2) : 0;
      const int rows = min(n, a.piece);
      mbar_expect(bars, rows * kRow + qbytes + nk + nv + nm);
      bulk_copy(smem_u32(kbuf), kg, rows * kRow, bars);
      bulk_copy(smem_u32(qsm),
                static_cast<const unsigned char*>(a.q) + bh * qbytes, qbytes,
                bars);
      if (nk) bulk_copy(smem_u32(ksm), s0, nk, bars);
      if (nv) bulk_copy(smem_u32(vsm), s1, nv, bars);
      if (nm) bulk_copy(smem_u32(msm), s2, nm, bars);
      load_piece(0, 1);
      for (int i = 1; i < min(n_pieces, kSlots); ++i) {
        load_piece(i, 0);
        load_piece(i, 1);
      }
    }
  }
  __syncthreads();
  // the head's nonzero sel columns, compacted (their order does not
  // matter: each column gets its own add)
  for (int c = threadIdx.x; c < a.n_align; c += kThreads) {
    const float w = static_cast<const float*>(a.sel)[h * a.n_align + c];
    if (w != 0.f) {
      const int i = atomicAdd(&n_sel, 1);
      sel_col[i] = c;
      sel_w[i] = w;
    }
  }

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int part_lane = lane % kLanes;           // the lane's chunk of a row
  const int key_lane = lane / kLanes;
  float qr[kVals];
  if (n > 0) mbar_wait(bars, 0);  // K piece 0, q and the spans are in
#pragma unroll
  for (int e = 0; e < kVals; ++e) {
    const int d = part_lane * kVals + e;
    const float x =
        a.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(qsm)[d])
                 : reinterpret_cast<const float*>(qsm)[d];
    qr[e] = a.op_bf16 ? round_bf16(x) : x;
  }

  // the causal position, read on the device where the launch points to it
  // and clamped to [-1, T] as the wrapper clamps the argument
  const int position =
      a.position_at ? max(min(*a.position_at, t), -1) : a.position;

  // scores, piece by piece as the K slots fill
  float mx = -INFINITY;
  for (int i = 0; i < n_pieces; ++i) {
    const int c0 = i * a.piece;
    const int rows = min(n - c0, a.piece);
    const unsigned char* kp = kbuf + (size_t)(i % kSlots) * a.piece * kRow;
    mbar_wait(bars + 8 * (i % kSlots), (i / kSlots) & 1);
    for (int j0 = warp * kKeysPass; j0 < rows; j0 += kWarps * kKeysPass) {
      const int j = j0 + key_lane;
      float s = 0.f;
      if (j < rows) {
        uint32_t w[kW];
        load_words<E, kW>(kp + (size_t)j * kRow, part_lane, w);
#pragma unroll
        for (int u = 0; u < kW; ++u)
#pragma unroll
          for (int e = 0; e < E::kPerWord; ++e)
            s = fmaf(qr[u * E::kPerWord + e], E::get(w[u], e, a.op_bf16), s);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (part_lane == 0 && j < rows) {
        const int jl = c0 + j;
        if (ks) s *= __bfloat162float(kss[jl]);
        if ((km && kms[jl] == 0) || (a.has_position && k0 + jl > position))
          s = kMasked;
        sc[jl] = s;
        mx = fmaxf(mx, s);
      }
    }
    if (i + kSlots < n_pieces) {  // a streamed slice: refill the slot
      __syncthreads();
      if (threadIdx.x == 0) load_piece(i + kSlots, 0);
    }
  }
  mx = block_reduce<true>(mx, red);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  mx = cluster_reduce<true>(cluster, maxs, mx, rank, n_rank);

  float sum = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float e = expf(sc[j] - mx);
    sc[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  sum = cluster_reduce<false>(cluster, sums, sum, rank, n_rank);

  float* probs = static_cast<float*>(a.probs);
  float* aligned = static_cast<float*>(a.aligned);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float p = sc[j] / sum;
    if (probs) probs[bh * t + k0 + j] = p;
    for (int c = 0; c < n_sel; ++c)  // aligned starts zeroed
      atomicAdd(aligned + ((size_t)b * a.n_align + sel_col[c]) * t + k0 + j,
                sel_w[c] * p);
    const float pv = vs ? p * __bfloat162float(vss[j]) : p;
    sc[j] = a.pv_bf16 ? round_bf16(pv) : pv;
  }

  // P.V, piece by piece from the V slots: lane (key_lane, part_lane) sums
  // its chunk's kVals dims over keys key_lane, + kKeysPass, ... of its
  // warp's strips
  float acc[kVals];
#pragma unroll
  for (int e = 0; e < kVals; ++e) acc[e] = 0.f;
  __syncthreads();  // the scaled p are in
  for (int i = 0; i < n_pieces; ++i) {
    const int c0 = i * a.piece;
    const int rows = min(n - c0, a.piece);
    const unsigned char* vp = vbuf + (size_t)(i % kSlots) * a.piece * kRow;
    mbar_wait(bars + 8 * (kSlots + i % kSlots), (i / kSlots) & 1);
    for (int j = warp * kKeysPass + key_lane; j < rows;
         j += kWarps * kKeysPass) {
      uint32_t w[kW];
      load_words<E, kW>(vp + (size_t)j * kRow, part_lane, w);
      const float pv = sc[c0 + j];
#pragma unroll
      for (int u = 0; u < kW; ++u)
#pragma unroll
        for (int e = 0; e < E::kPerWord; ++e)
          acc[u * E::kPerWord + e] =
              fmaf(pv, E::get(w[u], e, a.op_bf16), acc[u * E::kPerWord + e]);
    }
    if (i + kSlots < n_pieces) {  // a streamed slice: refill the slot
      __syncthreads();
      if (threadIdx.x == 0) load_piece(i + kSlots, 1);
    }
  }
#pragma unroll
  for (int e = 0; e < kVals; ++e)
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (key_lane == 0)
#pragma unroll
    for (int e = 0; e < kVals; ++e)
      part[warp * kD + part_lane * kVals + e] = acc[e];
  __syncthreads();
  // the block's partial, warps in order, into slot `rank` of rank 0's
  // parts; rank 0 adds the slots in rank order and writes the output
  if (threadIdx.x < kD) {
    float o = part[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += part[w * kD + threadIdx.x];
    cluster.map_shared_rank(parts, 0)[rank * kD + threadIdx.x] = o;
  }
  cluster.sync();  // no block reads another's memory after this
  if (rank == 0 && threadIdx.x < kD) {
    float o = parts[threadIdx.x];
    for (int r = 1; r < n_rank; ++r) o += parts[r * kD + threadIdx.x];
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[bh * kD + threadIdx.x] =
          __float2bfloat16_rn(o);
    else
      static_cast<float*>(a.out)[bh * kD + threadIdx.x] = o;
  }
}

template <typename C>
int launch(const Args& a, void* stream) {
  constexpr int kRow = row_bytes<C>();
  if (a.rows <= 0 || a.rows > 65535 || a.heads <= 0 || a.keys <= 0 ||
      a.keys > kMaxKeys || a.layer < 0 || a.n_align < 0 ||
      (a.n_align > 0 && (!a.sel || !a.aligned)) || a.cluster < 1 ||
      a.cluster > kMaxCluster || kD % a.cluster != 0 || a.piece < 1 ||
      (long long)a.heads * a.cluster > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int per = (a.keys + a.cluster - 1) / a.cluster;
  Args args = a;
  args.piece = min(a.piece, per);
  const size_t smem = smem_bytes(per, args.piece, kRow, a.n_align);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.n_align > 0) {
    const cudaError_t err = cudaMemsetAsync(
        a.aligned, 0, (size_t)a.rows * a.n_align * a.keys * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  // the attribute only grows, once per device and size
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if ((int)smem > allowed[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(decode_attention_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev].store((int)smem, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.heads * a.cluster, a.rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<C>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// v1: q [B, H, 1, 64] f32 or bf16 (q_bf16), int8 k/v [B, H, T, 64], bf16
// scales [B, H, T, 1]; out [B, H, 1, 64] in q's dtype, probs [B, H, T] f32;
// `cluster` blocks a (row, head), K/V slots of `piece` rows.
// Returns a cudaError_t (0 = launched).
extern "C" int cw_cross_attention_int8(const void* q, const void* k,
                                       const void* k_scale, const void* v,
                                       const void* v_scale, void* out,
                                       void* probs, int b, int h, int t,
                                       int q_bf16, int cluster, int piece,
                                       void* stream) {
  const Args a{q, k, v, k_scale, v_scale, nullptr, nullptr, out, probs,
               nullptr, nullptr, b, h, t, 0, 0, 0, 0, q_bf16, q_bf16,
               1, q_bf16, cluster, piece};
  return launch<int8_t>(a, stream);
}

// v2: as v1, with q rounded to bf16 before the product.
extern "C" int cw_cross_attention_int8_v2(const void* q, const void* k,
                                          const void* k_scale, const void* v,
                                          const void* v_scale, void* out,
                                          void* probs, int b, int h, int t,
                                          int q_bf16, int cluster, int piece,
                                          void* stream) {
  const Args a{q, k, v, k_scale, v_scale, nullptr, nullptr, out, probs,
               nullptr, nullptr, b, h, t, 0, 0, 0, 0, q_bf16, 1,
               1, q_bf16, cluster, piece};
  return launch<int8_t>(a, stream);
}

// v3: q [B, H, 64] f32 or bf16; k/v [L, B, H, T, 64] of cache_kind 0 int8,
// 1 packed int4 (uint8 [.., 32]), 2 bf16, 3 f32; scales [L, B, H, T] bf16
// or null; key_mask [B, T] bytes or null; sel [H, A] f32 or null (n_align
// = A); out [B, H, 64] f32, aligned [B, A, T] f32. Keys after `position`
// are masked when has_position; a non-null `position_at` (a 0-d int32 on
// the device) is read in the kernel in its place, and masks.
extern "C" int cw_decode_gemv_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* key_mask, const void* sel, void* out,
    void* aligned, const void* position_at, int cache_kind, int l, int b,
    int h, int t, int layer, int position, int has_position, int n_align,
    int q_bf16, int cluster, int piece, void* stream) {
  if (layer >= l) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, key_mask, sel, out, nullptr,
               aligned, static_cast<const int*>(position_at), b, h, t,
               layer, position, has_position || position_at != nullptr,
               n_align, q_bf16, q_bf16, q_bf16, 0, cluster, piece};
  switch (cache_kind) {
    case 0: return launch<int8_t>(a, stream);
    case 1: return launch<Int4Packed>(a, stream);
    case 2: return launch<__nv_bfloat16>(a, stream);
    case 3: return launch<float>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
