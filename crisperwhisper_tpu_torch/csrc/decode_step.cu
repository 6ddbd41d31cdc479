// One quantized decoder step over all layers in one cooperative launch.
//
// Replaces the TPU kernel crisperwhisper_tpu/ops/pallas_decode_b1.py
// (_kernel, reached from decode_step_b1, decode_step_b1_multi,
// decode_step_b1_beams and decode_step_rows through _run_kernel and
// _call_kernel). That kernel walked a (layer, phase) grid in order on one
// TPU core, streamed each int8 weight tile through VMEM and carried the
// residual stream in VMEM scratch.
//
// What bounds it on the H100: the weight stream. At large-v3 a step reads
// 32 x (3d + 3d + f + f) x d = 32 x 22.9 MB = 734 MB of int8 weights, plus
// the cross cache (61 MB packed int4 per stream) and the live ring prefix:
// 0.22 ms at 3.35 TB/s. The arithmetic is about one multiply-add per
// weight byte per row (M <= 8 rows). What keeps a step from that bound is
// the chain of dependent phases: each layer is eight phases apart by grid
// barriers, 256 a step, and every phase pays its memory round trips and
// block barriers in turn (PERF.md has the phase split).
//
// Design: a persistent cooperative grid (one 384-thread block an SM, the
// grid the SM count, checked once per device and M) runs eight
// phases a layer, each ended by a grid barrier:
//   A. LN1 + fused QKV GEMV         E. cross attention, split over keys
//   B. fresh K/V columns + self     F. combine the splits + cross-o GEMV
//      attention                       + residual, alignment rescale
//   C. o-proj + residual            G. LN3 + fc1 + GELU
//   D. LN2 + cross-q GEMV           H. fc2 + residual
// The phase functions are not inlined (each gets its own registers; 384
// threads leave 168 a thread, and no function spills at any M).
// * The grid barrier is one atomic word, as cooperative groups' grid sync
//   has it, but waited on by thread 0 alone: while it spins, warp 1 issues
//   bulk L2 prefetches (cp.async.bulk.prefetch.L2, one instruction a
//   range) of what the phases ahead read: the block's span of the next
//   GEMV phase after the coming one, the ring prefix of its self-attention
//   items, the cross keys of its cross items and the next layer's vector
//   row. A GEMV phase gives each block one contiguous span of output rows,
//   so its weights are one contiguous span too. An issuing thread is held
//   about a memory round trip, which is why the prefetches ride in the
//   barrier's wait. This is the L2 prefetch, not a shared-memory ring fed
//   by TMA copies: the phase split shows the GEMV phases held by their
//   chain of round trips and barriers, not by the stream of weight bytes
//   (PERF.md).
// * GEMV: a warp carries kRows weight rows at once for all M activation
//   rows; the block's rows are cut into groups of kRows, and when there are
//   fewer groups than warps the input dimension is split among warps too
//   (partial sums added in a fixed order). Weights come as 16-byte loads,
//   the first batch of them (and the epilogue's scale, bias and old
//   residual) issued before the input rows are made. Each activation
//   float4 read from shared memory feeds kRows rows. The M activation rows
//   sit in shared memory with the 16-byte slot q of chunk c stored at q ^
//   ((c >> 1) & 3), so the 8 lanes of an LDS.128 phase (chunks c .. c + 7)
//   touch 8 distinct bank groups. int8 and int4 values become f32 without
//   I2F: the byte (sign bit flipped) is put into the low mantissa of 2^23
//   by a byte permute, and 2^23 + 128 (2^23 + 8 for a nibble) subtracted,
//   exactly. The LayerNorm statistics of all M rows take one vector block
//   reduction a pass (mean, then the variance of the centred values).
// * Self attention (phase B): a warp per fresh (row, K or V) column and a
//   warp per (row, head) attention row, with shuffle reductions for the
//   column's amax and the scores' max and sum; a lane takes keys t = lane
//   mod 32 over the live prefix, and for P·V the head dims. In the multi
//   mode the block of a head writes its M fresh columns, then one block
//   barrier, then a warp per row. A row warp issues the loads of the slots
//   older than this step before that barrier.
// * Cross attention (phase E), flash-decoding: an item is (head, split of
//   kSplit keys) and takes all M rows, so at K = 1500 there are 20 x 12 =
//   240 items, two to a block (one a half), and in the multi and beams
//   modes (one shared cross cache) each (head, split) reads the cache once
//   a step, not M times. The split length depends on K alone, never on M,
//   the mode or the grid, so every row's arithmetic is the same in every
//   mode. Each item writes, per row, its split's max, its sum of exps and
//   its dh-wide P·V partial with the V scales folded in, and the alignment
//   heads' unnormalised exps. Phase F combines the splits in order as it
//   loads the cross-o input (every block needs all of it) and rescales the
//   alignment rows by exp(m_split - m) / sum; align_bf16 rounds after that.
//
// Modes: the M rows are M distinct streams at one position, each with its
// own ring and cross cache (M = 1: decode_step_b1, M = 2..8: rows), or, with
// `multi`, M consecutive tokens of ONE stream at positions pos .. pos+M-1
// (the speculative verify block, decode_step_b1_multi), sharing one ring
// and one cross cache; row i attends to slots [0, pos + i]. At M = 1 the
// multi mode runs exactly the b1 mode's arithmetic. With `cross_shared`
// (the beams mode, decode_step_b1_beams) the M rows are M beams of one
// item: the rows mode with every row reading the cross cache of stream 0.
// The rings stay per row. The multi mode shares the cross cache too.
//
// Numerics are the reference kernel's: f32 activations and sums, the
// dense epilogue acc * scale + bias with bf16 scales read as f32, the
// cross-q scale and bias times head_dim**-0.5, LayerNorm eps 1e-5, the
// fresh column quantized with the f32 scale by IEEE x / scale and rintf
// (half-to-even, as jnp.round) and its scale stored and used as bf16,
// exact erff GELU, IEEE expf/division (no fast-math). Buffers written
// inside the kernel are read with plain loads, never through the
// read-only cache. Every sum runs in a fixed order, so a launch is
// deterministic; the only atomic is the grid barrier's arrival.
//
// Phase stamps: given a device buffer of 8 L + 1 u64, thread 0 of block 0
// records %globaltimer at the start and after each grid barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;
constexpr int kMaxRows = 8;          // M
constexpr int kRows = 4;             // weight rows a warp carries at once
constexpr int kSplit = 128;          // cross keys an item takes
constexpr int kMaxSplits = 16;       // splits a (row, head) combines: K <= 2048
constexpr int kAttnWarps = 8;        // warps of a block that run a self row
// static shared memory (g_red, g_part), which the dynamic part shares the
// block's kMaxSmem with
constexpr int kStaticSmem = 4 * (kWarps * kMaxRows + kWarps * kRows * kMaxRows);
constexpr int kMaxDynSmem = kMaxSmem - kStaticSmem;

struct Step {
  const int8_t* const* w;  // [L * 6] weight pointers, [d_out, d_in] each
  const float* vec;        // [L, 20d + 2f] scales, biases, LayerNorms
  float* xr;               // [M, d] residual stream: x0 in, hid out
  float* qkv;              // [M, 3d]
  float* att;              // [M, d] self-attention output (o-proj input)
  float* qc;               // [M, d] cross queries
  float* hmid;             // [M, f] GELU(fc1)
  float* part;             // [M, H, n_split, Dh] cross P·V partials
  float* ml;               // [M, H, n_split, 2] cross split max and sum
  int8_t* ring_k;          // [L, R, H, T, Dh], R streams (1 in multi mode)
  int8_t* ring_v;
  __nv_bfloat16* ring_ks;  // [L, R, H, T]
  __nv_bfloat16* ring_vs;
  const uint8_t* cross_k;  // [L, C, H, K, Dh] int8 or [.., Dh/2] int4 pairs,
                           // C = 1 with cross_shared, else R
  const uint8_t* cross_v;
  const __nv_bfloat16* cross_ks;  // [L, C, H, K]
  const __nv_bfloat16* cross_vs;
  const int* align_lh;     // [A, 2] (layer, head) per alignment slot
  float* align;            // [M, A, K], zeroed by the caller
  unsigned long long* stamps;  // [8 L + 1] globaltimer, or null
  int n_layers, d, f, h, dh, t_ring, pos, k_enc, n_split, n_align,
      cross_int4, align_bf16;
  int multi;               // 1: the M rows are consecutive tokens of one
                           // stream (shared ring and cross cache)
  int cross_shared;        // 1: every row reads the cross cache of stream 0
  float qscale;            // head_dim**-0.5
};

enum Epilogue { kStore = 0, kResidual = 1, kGelu = 2 };

// Shared memory: the dynamic part (phase scratch, sized by smem_bytes),
// the block reductions' partials and the GEMV's split-input partials.
extern __shared__ float4 g_smem[];
__shared__ float g_red[kWarps * kMaxRows];
__shared__ float g_part[kWarps * kRows * kMaxRows];

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// int8 and int4 values to f32 without I2F: the value's bits, sign bit
// flipped, in the low mantissa of 2^23, minus 2^23 + 128 (or + 8).
// i8f takes a word already XORed with 0x80808080 and returns byte e;
// i4f one XORed with 0x88888888 and returns nibble e.
__device__ __forceinline__ float i8f(uint32_t flipped, int e) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 + e)) -
         8388736.f;
}
__device__ __forceinline__ float i4f(uint32_t flipped, int e) {
  return __uint_as_float(((flipped >> (4 * e)) & 0xFu) | 0x4B000000u) -
         8388616.f;
}
__device__ __forceinline__ float i8b(uint32_t byte) {
  return __uint_as_float(0x4B000000u | (byte ^ 0x80u)) - 8388736.f;
}
__device__ __forceinline__ float i4n(uint32_t nibble) {
  return __uint_as_float(0x4B000000u | (nibble ^ 0x8u)) - 8388616.f;
}

// One cache row of dh values (int8, or int4 pairs) as 8-byte words, all
// loaded at once; words past the row are zero.
__device__ __forceinline__ void load_row(const uint8_t* row, int dh,
                                         bool int4, uint2 (&w)[8]) {
  const int words = (int4 ? dh / 2 : dh) / 8;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = k < words ? reinterpret_cast<const uint2*>(row)[k]
                     : make_uint2(0u, 0u);
}

// q · row for a row loaded by load_row, summed in dim order.
__device__ __forceinline__ float dot_words(const uint2 (&w)[8],
                                           const float* q, int dh,
                                           bool int4) {
  const int words = (int4 ? dh / 2 : dh) / 8;
  float acc = 0.f;
  if (int4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= words) break;
      asm volatile("" ::: "memory");   // q loads a word at a time
      const uint32_t x = w[k].x ^ 0x88888888u, y = w[k].y ^ 0x88888888u;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += q[16 * k + e] * i4f(x, e);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += q[16 * k + 8 + e] * i4f(y, e);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k >= words) break;
      asm volatile("" ::: "memory");   // q loads a word at a time
      const uint32_t x = w[k].x ^ 0x80808080u, y = w[k].y ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc += q[8 * k + e] * i8f(x, e);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc += q[8 * k + 4 + e] * i8f(y, e);
    }
  }
  return acc;
}

__device__ __forceinline__ float dot_row(const uint8_t* row, const float* q,
                                         int dh, bool int4) {
  uint2 w[8];
  load_row(row, dh, int4, w);
  return dot_words(w, q, dh, int4);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Float index of element i of a GEMV input row in shared memory: the
// 16-byte slot q of 64-byte chunk c is stored at q ^ ((c >> 1) & 3).
__device__ __forceinline__ int swz(int i) {
  return (i & ~15) | ((((i >> 2) & 3) ^ ((i >> 5) & 3)) << 2) | (i & 3);
}

// ---------------------------------------------------------------------------
// Grid barrier
// ---------------------------------------------------------------------------

// The grid barrier's word: every block adds 1 but block 0, which adds
// 2^31 - (blocks - 1), so the arrivals of one barrier flip bit 31 and
// leave the low bits as they were (the scheme of cooperative groups' grid
// sync). Unlike that sync's word, which is the launch's own, this one is
// shared by every launch of every M on a device. That is sound because no
// two launches meet at a barrier: a block fills its SM's register file
// (one block an SM, which grid_for checks) and the grid is the SM count,
// so a block of a later launch, on any stream, becomes resident only on an
// SM a block of this one has left, after the last barrier; and arrivals
// at a barrier not yet complete never flip bit 31, which is all that a
// block still spinning on that last barrier reads.
__device__ unsigned int g_bar = 0;

// Thread 0 of a block: release the block's writes (fence), arrive with one
// atomic add, and spin with acquire loads until bit 31 flips. The block
// barriers on either side order the other threads. The launch is
// cooperative, so every block is resident.
__device__ __forceinline__ void grid_arrive_wait() {
  const unsigned int add =
      blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
  __threadfence();
  const unsigned int old = atomicAdd(&g_bar, add);
  unsigned int now;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(now) : "l"(&g_bar) : "memory");
  } while (((old ^ now) & 0x80000000u) == 0);
}

// ---------------------------------------------------------------------------
// L2 prefetch
// ---------------------------------------------------------------------------

// L2 prefetches by bulk copy (cp.async.bulk.prefetch.L2): the
// 16-byte-aligned part of each range in one instruction, the ranges dealt
// round-robin over `nt` threads (this one is `t`). An issuing thread is
// held for about a memory round trip, so the kernel issues them from warp
// 1 while thread 0 waits at the grid barrier.
struct Prefetcher {
  int t, nt, used;
  __device__ void range(const void* p, size_t bytes) {
    if (used++ % nt != t) return;
    const size_t a = __cvta_generic_to_global(p);
    const size_t lo = (a + 15) & ~(size_t)15, hi = (a + bytes) & ~(size_t)15;
    if (hi > lo)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(lo),
                   "r"((uint32_t)(hi - lo))
                   : "memory");
  }
};

// This block's output rows [r0, r1) of a GEMV phase with d_out rows: one
// contiguous span, the same in the phase and in its prefetch.
__device__ __forceinline__ void span(int d_out, int& r0, int& r1) {
  const int per = (d_out + gridDim.x - 1) / gridDim.x;
  r0 = min(d_out, (int)blockIdx.x * per);
  r1 = min(d_out, r0 + per);
}

__device__ __forceinline__ void gemv_shape(int p, int d, int f, int& d_out,
                                           int& d_in) {
  d_out = p == 0 ? 3 * d : p == 4 ? f : d;
  d_in = p == 5 ? f : d;
}

// GEMV phase g (= layer * 6 + index of qkv, o, cross q, cross o, fc1,
// fc2): this block's span of its weights.
__device__ void prefetch_gemv(const Step& s, int g, Prefetcher& pf) {
  if (g >= s.n_layers * 6) return;
  int d_out, d_in, r0, r1;
  gemv_shape(g % 6, s.d, s.f, d_out, d_in);
  span(d_out, r0, r1);
  if (r1 > r0)
    pf.range(s.w[g] + (size_t)r0 * d_in, (size_t)(r1 - r0) * d_in);
}

// This block's slice of a layer's vector row.
__device__ void prefetch_vec(const Step& s, int layer, Prefetcher& pf) {
  if (layer >= s.n_layers) return;
  const size_t row = (size_t)(20 * s.d + 2 * s.f) * sizeof(float);
  const size_t per = (row + gridDim.x - 1) / gridDim.x;
  const size_t lo = blockIdx.x * per;
  if (lo < row)
    pf.range(reinterpret_cast<const char*>(s.vec) + layer * row + lo,
                per < row - lo ? per : row - lo);
}

// ---------------------------------------------------------------------------
// Input rows
// ---------------------------------------------------------------------------

// v[m] summed over the block for each of the M rows; every thread gets the
// sums. `red` holds kWarps * kMaxRows floats; the leading barrier guards
// its reuse. The warps' partials are added in warp order.
template <int M>
__device__ void block_sum_rows(float (&v)[M], float* red) {
#pragma unroll
  for (int m = 0; m < M; ++m) v[m] = warp_sum(v[m]);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) red[(threadIdx.x >> 5) * M + m] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float r = red[m];
    for (int w = 1; w < kWarps; ++w) r += red[w * M + m];
    v[m] = r;
  }
}

// y[m, :] = LayerNorm(x[m, :]) for the M rows, into shared memory in the
// swizzled GEMV layout; two passes over the rows (mean, then the variance
// of the centred values), each one reduction for all M rows. The first
// pass also stages the gain and shift in shared memory after y (2 d
// floats), so every device load of the phase is issued at once.
template <int M>
__device__ void layer_norm_rows(const float* x, int d, const float* g,
                                const float* b, float* y, float* red) {
  float* gb = y + M * d;
  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const int si = swz(i);
    gb[i] = g[i];
    gb[d + i] = b[i];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float v = x[(size_t)m * d + i];
      y[m * d + si] = v;
      acc[m] += v;
    }
  }
  block_sum_rows<M>(acc, red);
  float mean[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mean[m] = acc[m] / (float)d;
    acc[m] = 0.f;
  }
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const int si = swz(i);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float z = y[m * d + si] - mean[m];
      acc[m] += z * z;
    }
  }
  block_sum_rows<M>(acc, red);
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 1.f / sqrtf(acc[m] / (float)d + 1e-5f);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const int si = swz(i);
    const float gi = gb[i], bi = gb[d + i];
#pragma unroll
    for (int m = 0; m < M; ++m)
      y[m * d + si] = (y[m * d + si] - mean[m]) * acc[m] * gi + bi;
  }
  __syncthreads();
}

// y = the M rows of src [M, n] from device memory, swizzled.
template <int M>
__device__ void load_rows(const float* src, int n, float* y) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int si = swz(i);
#pragma unroll
    for (int m = 0; m < M; ++m) y[m * n + si] = src[(size_t)m * n + i];
  }
  __syncthreads();
}

// Word q of a 16-byte weight load.
__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// Attention phases
// ---------------------------------------------------------------------------

// `bytes` (a multiple of `unit`, 8 or 16) from device to shared memory by
// cp.async, without registers; cp_async_wait makes them visible to the
// issuing thread (a barrier then to the others).
template <int unit>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const size_t g = __cvta_generic_to_global(src);
  for (int o = 0; o < bytes; o += unit)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d + o),
                 "l"(g + o), "n"(unit)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Phase B items: (stream, head), `per` warps each (the 2 n_new K and V
// columns dealt over them; warp i < n_new also runs row i), `ipb` of them
// in a block at once.
struct SelfItems {
  int streams, n_new, per, ipb, items;
  __device__ SelfItems(const Step& s, int M) {
    streams = s.multi ? 1 : M;
    n_new = s.multi ? M : 1;
    per = min(kWarps, 2 * n_new);
    ipb = kWarps / per;
    items = streams * s.h;
  }
};

// The ring prefix [0, pos) that this block's phase-B items of `layer` read.
template <int M>
__device__ void prefetch_ring(const Step& s, int layer, Prefetcher& pf) {
  const SelfItems si(s, M);
  const int T = s.t_ring, dh = s.dh;
  if (s.pos == 0) return;
  for (int base = blockIdx.x * si.ipb; base < si.items;
       base += gridDim.x * si.ipb)
    for (int it = base; it < min(si.items, base + si.ipb); ++it) {
      const size_t rb = (size_t)layer * si.streams * s.h + it;
      pf.range(s.ring_k + rb * T * dh, (size_t)s.pos * dh);
      pf.range(s.ring_v + rb * T * dh, (size_t)s.pos * dh);
      pf.range(s.ring_ks + rb * T, (size_t)s.pos * 2);
      pf.range(s.ring_vs + rb * T, (size_t)s.pos * 2);
    }
}

// Phase B: per (stream, head), the fresh K/V columns into the ring (M of
// them at [pos, pos + M) in the multi mode, else one at pos), a warp per
// column; one block barrier; then a warp per row i of the stream over
// ring slots [0, pos + i]. Before the barrier a row warp issues every load
// that does not depend on this step's columns: its query, and for keys
// lane and lane + 32 older than pos the K row (registers), the scales and
// the V row (cp.async into shared memory); after it, the same for the
// fresh slots. `smem` holds kAttnWarps * (1088 + T rounded up to 4)
// floats: per row warp its query, 64 V rows of up to 64 bytes and its
// scores.
template <int M>
__device__ __noinline__ void self_attention(const Step& s, int layer) {
  float* smem = reinterpret_cast<float*>(g_smem);
  const SelfItems si(s, M);
  const int H = s.h, dh = s.dh, T = s.t_ring, pos = s.pos, d = s.d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = warp / si.per, k = warp % si.per;
  // row warps (k < n_new) only; 16-byte aligned for the cp.async rows
  float* q = smem + (li * si.n_new + k) * (1088 + ((T + 3) & ~3));
  uint8_t* vst = reinterpret_cast<uint8_t*>(q + 64);
  float* sc = q + 1088;
  const int t0 = lane, t1 = lane + 32;
  for (int base = blockIdx.x * si.ipb; base < si.items;
       base += gridDim.x * si.ipb) {
    const int item = base + li;
    const bool live = li < si.ipb && item < si.items;
    const bool row = live && k < si.n_new;
    const int st = live ? item / H : 0, hh = live ? item % H : 0;
    const size_t rb = ((size_t)layer * si.streams + st) * H + hh;
    const uint8_t* rk = reinterpret_cast<const uint8_t*>(s.ring_k) +
                        rb * T * dh;
    const uint8_t* rv = reinterpret_cast<const uint8_t*>(s.ring_v) +
                        rb * T * dh;
    __nv_bfloat16* rks = s.ring_ks + rb * T;
    __nv_bfloat16* rvs = s.ring_vs + rb * T;
    const int m = st + k, last = pos + k;
    uint2 k0[8], k1[8];
    float ks0 = 0.f, ks1 = 0.f, vs0 = 0.f, vs1 = 0.f;
    if (row) {
      const float* qs = s.qkv + (size_t)m * 3 * d + hh * dh;
      if (lane < dh) q[lane] = qs[lane];
      if (lane + 32 < dh) q[lane + 32] = qs[lane + 32];
      if (t0 < pos) {
        load_row(rk + (size_t)t0 * dh, dh, false, k0);
        ks0 = __bfloat162float(rks[t0]);
        vs0 = __bfloat162float(rvs[t0]);
        cp_async<16>(vst + t0 * dh, rv + (size_t)t0 * dh, dh);
      }
      if (M < 4 && t1 < pos) {
        load_row(rk + (size_t)t1 * dh, dh, false, k1);
        ks1 = __bfloat162float(rks[t1]);
        vs1 = __bfloat162float(rvs[t1]);
        cp_async<16>(vst + t1 * dh, rv + (size_t)t1 * dh, dh);
      }
    }
    // the fresh columns: column c is row c / 2's K (c even) or V
    for (int c = k; live && c < 2 * si.n_new; c += si.per) {
      const int i = c >> 1, kv = c & 1;
      const float* src = s.qkv + (size_t)(st + i) * 3 * d + (1 + kv) * d +
                         hh * dh;
      const float x0 = lane < dh ? src[lane] : 0.f;
      const float x1 = lane + 32 < dh ? src[lane + 32] : 0.f;
      const float amax = warp_max(fmaxf(fabsf(x0), fabsf(x1)));
      const float scale = fmaxf(amax, 1e-8f) / 127.f;
      int8_t* dst = (kv ? s.ring_v : s.ring_k) + rb * T * dh +
                    (size_t)(pos + i) * dh;
      if (lane < dh)
        dst[lane] = (int8_t)fminf(fmaxf(rintf(x0 / scale), -127.f), 127.f);
      if (lane + 32 < dh)
        dst[lane + 32] =
            (int8_t)fminf(fmaxf(rintf(x1 / scale), -127.f), 127.f);
      if (lane == 0) (kv ? rvs : rks)[pos + i] = __float2bfloat16_rn(scale);
    }
    __syncthreads();
    if (!row) continue;
    // attention row m over slots [0, last]
    if (t0 >= pos && t0 <= last) {
      load_row(rk + (size_t)t0 * dh, dh, false, k0);
      ks0 = __bfloat162float(rks[t0]);
      vs0 = __bfloat162float(rvs[t0]);
      cp_async<16>(vst + t0 * dh, rv + (size_t)t0 * dh, dh);
    }
    if ((M >= 4 || t1 >= pos) && t1 <= last) {
      load_row(rk + (size_t)t1 * dh, dh, false, k1);
      ks1 = __bfloat162float(rks[t1]);
      vs1 = __bfloat162float(rvs[t1]);
      cp_async<16>(vst + t1 * dh, rv + (size_t)t1 * dh, dh);
    }
    float mx = -INFINITY;
    if (t0 <= last) {
      sc[t0] = dot_words(k0, q, dh, false) * ks0;
      mx = fmaxf(mx, sc[t0]);
    }
    if (t1 <= last) {
      sc[t1] = dot_words(k1, q, dh, false) * ks1;
      mx = fmaxf(mx, sc[t1]);
    }
#pragma unroll 1
    for (int t = lane + 64; t <= last; t += 32) {
      const float v = dot_row(rk + (size_t)t * dh, q, dh, false) *
                      __bfloat162float(rks[t]);
      sc[t] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t <= last; t += 32) {
      const float e = expf(sc[t] - mx);
      sc[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (t0 <= last) sc[t0] = sc[t0] / sum * vs0;
    if (t1 <= last) sc[t1] = sc[t1] / sum * vs1;
    for (int t = lane + 64; t <= last; t += 32)
      sc[t] = sc[t] / sum * __bfloat162float(rvs[t]);
    cp_async_wait();
    __syncwarp();
    // P·V, 64 keys at a time from the staged V rows; lanes own head dims
    // lane and lane + 32
    float a0 = 0.f, a1 = 0.f;
    for (int tb = 0; tb <= last; tb += 64) {
      if (tb > 0) {
        __syncwarp();
        if (tb + t0 <= last)
          cp_async<16>(vst + t0 * dh, rv + (size_t)(tb + t0) * dh, dh);
        if (tb + t1 <= last)
          cp_async<16>(vst + t1 * dh, rv + (size_t)(tb + t1) * dh, dh);
        cp_async_wait();
        __syncwarp();
      }
      const int n = min(64, last + 1 - tb);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float p = sc[tb + j];
        if (lane < dh) a0 += p * i8b(vst[j * dh + lane]);
        if (lane + 32 < dh) a1 += p * i8b(vst[j * dh + lane + 32]);
      }
    }
    float* out = s.att + (size_t)m * d + hh * dh;
    if (lane < dh) out[lane] = a0;
    if (lane + 32 < dh) out[lane + 32] = a1;
    __syncwarp();
  }
}

// The cross streams the M rows read: 1 when shared, else M.
template <int M>
__device__ __forceinline__ int cross_streams(const Step& s) {
  return s.cross_shared ? 1 : M;
}

// The cross-cache keys this block's phase-E items of `layer` read.
template <int M>
__device__ void prefetch_cross(const Step& s, int layer, Prefetcher& pf) {
  const int nc = cross_streams<M>(s), K = s.k_enc;
  const int rb = s.cross_int4 ? s.dh / 2 : s.dh;
  for (int it = blockIdx.x; it < s.h * s.n_split; it += gridDim.x) {
    const int hh = it / s.n_split, t0 = (it % s.n_split) * kSplit;
    const int n = min(kSplit, K - t0);
    for (int c = 0; c < nc; ++c) {
      const size_t cb = ((size_t)layer * nc + c) * s.h + hh;
      pf.range(s.cross_k + (cb * K + t0) * rb, (size_t)n * rb);
      pf.range(s.cross_v + (cb * K + t0) * rb, (size_t)n * rb);
      pf.range(s.cross_ks + cb * K + t0, (size_t)n * 2);
      pf.range(s.cross_vs + cb * K + t0, (size_t)n * 2);
    }
  }
}

// Phase E: per (head, split of kSplit keys), all M rows: the split's
// scores, its max and sum of exps per row (into ml), the alignment heads'
// unnormalised exps, and the P·V partial with the V scales folded in
// (into part). The two halves of a block (kHalf threads each) take an item
// each. The loads of an item are issued before its first barrier: the
// queries and V scales into shared memory, the V rows by cp.async and, at
// M = 1, each thread's key row into registers. `smem` holds, per half, cross_smem_floats(M) floats: M * (64 +
// 2 kSplit) + 4 kHalf floats and M * kSplit cache rows of up to Dh bytes.
constexpr int kHalf = kThreads / 2;

template <int M>
__device__ __forceinline__ int cross_smem_floats(int dh) {
  return M * (64 + 2 * kSplit) + kHalf * 4 + M * kSplit * dh / 4;
}

template <int M>
__device__ __noinline__ void cross_attention(const Step& s, int layer) {
  float* smem = reinterpret_cast<float*>(g_smem);
  // scoring tasks (row r, key): task x = tid + kHalf u is r = x / kSplit,
  // key = x % kSplit; at M = 1 a thread's one task loads its key row
  // before the item's first barrier (at M > 1 the registers are short)
  constexpr int kPre = M == 1 ? 1 : 0;
  const int H = s.h, dh = s.dh, K = s.k_enc, d = s.d, ns = s.n_split;
  const bool int4 = s.cross_int4 != 0, shared = s.cross_shared != 0;
  const int rb = int4 ? dh / 2 : dh;
  const int nc = cross_streams<M>(s);
  const int half = threadIdx.x / kHalf, tid = threadIdx.x % kHalf;
  const int lane = tid & 31, warp = tid >> 5;
  float* qs = smem + half * cross_smem_floats<M>(dh);   // [M, 64]
  float* sc = qs + M * 64;                // [M, kSplit]
  float* vsc = sc + M * kSplit;           // [nc, kSplit] V scales
  float* pp = vsc + M * kSplit;           // [kg, M, dh] P·V partials
  uint8_t* vb = reinterpret_cast<uint8_t*>(pp + kHalf * 4);
  for (int base = blockIdx.x; base < H * ns; base += 2 * gridDim.x) {
    const int it = base + half * gridDim.x;
    const bool live = it < H * ns;
    const int hh = it / ns, sp = it % ns;
    const int t0 = sp * kSplit, n = live ? min(kSplit, K - t0) : 0;
    const size_t cb0 = (size_t)layer * nc * H + hh;   // stream c: + c * H
    uint2 kw[kPre > 0 ? kPre : 1][8];
    float ks[kPre > 0 ? kPre : 1];
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int x = tid + kHalf * u, r = x / kSplit, key = x % kSplit;
      if (r < M && key < n) {
        const size_t at = (cb0 + (size_t)(shared ? 0 : r) * H) * K + t0 + key;
        load_row(s.cross_k + at * rb, dh, int4, kw[u]);
        ks[u] = __bfloat162float(s.cross_ks[at]);
      }
    }
    if (live) {
      for (int c = 0; c < nc; ++c)
        for (int o = tid * 8; o < n * rb; o += kHalf * 8)
          cp_async<8>(vb + c * kSplit * rb + o,
                      s.cross_v + ((cb0 + (size_t)c * H) * K + t0) * rb + o,
                      8);
      for (int x = tid; x < M * dh; x += kHalf)
        qs[(x / dh) * 64 + x % dh] =
            s.qc[(size_t)(x / dh) * d + hh * dh + x % dh];
      for (int x = tid; x < nc * n; x += kHalf) {
        const int c = x / n, t = x % n;
        vsc[c * kSplit + t] =
            __bfloat162float(s.cross_vs[(cb0 + (size_t)c * H) * K + t0 + t]);
      }
    }
    cp_async_wait();
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int x = tid + kHalf * u, r = x / kSplit, key = x % kSplit;
      if (r < M && key < n)
        sc[r * kSplit + key] = dot_words(kw[u], qs + r * 64, dh, int4) * ks[u];
    }
#pragma unroll 1
    for (int x = tid + kHalf * kPre; x < M * kSplit; x += kHalf) {
      const int r = x / kSplit, key = x % kSplit;
      if (key < n) {
        const size_t at = (cb0 + (size_t)(shared ? 0 : r) * H) * K + t0 + key;
        sc[r * kSplit + key] =
            dot_row(s.cross_k + at * rb, qs + r * 64, dh, int4) *
            __bfloat162float(s.cross_ks[at]);
      }
    }
    __syncthreads();
    for (int r = warp; live && r < M; r += kHalf / 32) {
      float* row = sc + r * kSplit;
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(row[t] - mx);
        row[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const size_t at = ((size_t)r * H + hh) * ns + sp;
      if (lane == 0) {
        s.ml[2 * at] = mx;
        s.ml[2 * at + 1] = sum;
      }
      for (int a = 0; a < s.n_align; ++a) {
        if (s.align_lh[2 * a] != layer || s.align_lh[2 * a + 1] != hh)
          continue;
        float* dst = s.align + ((size_t)r * s.n_align + a) * K + t0;
        for (int t = lane; t < n; t += 32) dst[t] = row[t];
      }
      const float* vs = vsc + (shared ? 0 : r) * kSplit;
      for (int t = lane; t < n; t += 32) row[t] *= vs[t];
    }
    __syncthreads();
    // P·V: a thread takes 4 consecutive head dims of one row over one of
    // kg groups of keys; the groups' partials are then added in order
    const int quads = M * dh / 4, kg = kHalf / quads;
    const int per = (n + kg - 1) / kg;
    if (live) {
      const int q4 = tid % quads, g = tid / quads;
      const int r = q4 / (dh / 4), e0 = (q4 % (dh / 4)) * 4;
      const float* pr = sc + r * kSplit;
      const uint8_t* v = vb + (shared ? 0 : r) * kSplit * rb;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (g < kg) {
        const int tb = g * per, te = min(n, tb + per);
        if (int4) {
          for (int t = tb; t < te; ++t) {
            const uint32_t w =
                *reinterpret_cast<const uint16_t*>(v + t * rb + e0 / 2) ^
                0x8888u;
            const float pt = pr[t];
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] += pt * i4f(w, e);
          }
        } else {
          for (int t = tb; t < te; ++t) {
            const uint32_t w =
                *reinterpret_cast<const uint32_t*>(v + t * rb + e0) ^
                0x80808080u;
            const float pt = pr[t];
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] += pt * i8f(w, e);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) pp[g * M * dh + r * dh + e0 + e] = a[e];
      }
    }
    __syncthreads();
    for (int x = tid; live && x < M * dh; x += kHalf) {
      const int r = x / dh, e = x % dh;
      float acc = pp[r * dh + e];
      for (int g = 1; g < kg; ++g) acc += pp[g * M * dh + r * dh + e];
      s.part[(((size_t)r * H + hh) * ns + sp) * dh + e] = acc;
    }
    __syncthreads();
  }
}

// Phase F, before the cross-o GEMV: y [M, d] (swizzled) = the cross
// attention output, each (row, head) combining its splits in order:
// m = max m_s, w_s = exp(m_s - m), out = sum w_s part_s / sum w_s l_s.
// Then the alignment heads of this layer, grid-strided: p = e * w_s / l,
// rounded to bf16 after that when asked. `stat` holds M * H * 2 floats.
template <int M>
__device__ void combine(const Step& s, int layer, float* y, float* stat) {
  const int H = s.h, dh = s.dh, ns = s.n_split, d = s.d, K = s.k_enc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = warp; it < M * H; it += kWarps) {
    const int r = it / H, hh = it % H;
    const float* ml = s.ml + (size_t)it * ns * 2;
    const float* pt = s.part + (size_t)it * ns * dh;
    // lane k holds split k's (max, sum); the partials of every split are
    // loaded before any is used
    const float mk = lane < ns ? ml[2 * lane] : -INFINITY;
    const float lk = lane < ns ? ml[2 * lane + 1] : 0.f;
    float p0[kMaxSplits], p1[kMaxSplits];
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) {
      const int sp = min(k, ns - 1);
      p0[k] = lane < dh ? pt[sp * dh + lane] : 0.f;
      p1[k] = lane + 32 < dh ? pt[sp * dh + lane + 32] : 0.f;
    }
    const float mx = warp_max(mk);
    const float wk = expf(mk - mx);
    float l = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) {
      if (k >= ns) break;
      const float w = __shfl_sync(0xffffffffu, wk, k);
      l += w * __shfl_sync(0xffffffffu, lk, k);
      o0 += w * p0[k];
      o1 += w * p1[k];
    }
    if (lane < dh) y[r * d + swz(hh * dh + lane)] = o0 / l;
    if (lane + 32 < dh) y[r * d + swz(hh * dh + lane + 32)] = o1 / l;
    if (lane == 0) {
      stat[2 * it] = mx;
      stat[2 * it + 1] = l;
    }
  }
  __syncthreads();
  for (int a = 0; a < s.n_align; ++a) {
    if (s.align_lh[2 * a] != layer) continue;
    const int hh = s.align_lh[2 * a + 1];
    for (int x = blockIdx.x * kThreads + threadIdx.x; x < M * K;
         x += gridDim.x * kThreads) {
      const int r = x / K, t = x % K, it = r * H + hh;
      float* p = s.align + ((size_t)r * s.n_align + a) * K + t;
      const float w = expf(s.ml[((size_t)it * ns + t / kSplit) * 2] -
                           stat[2 * it]);
      const float v = *p * w / stat[2 * it + 1];
      *p = s.align_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
    }
  }
}

// ---------------------------------------------------------------------------
// GEMV phases
// ---------------------------------------------------------------------------

enum Prep { kLayerNorm = 0, kRowsIn = 1, kCombine = 2 };

// One GEMV phase of a layer: out (=, +=, = GELU) of (y · Wᵀ) * s * extra +
// b * extra, with y made by `prep`: the LayerNorm of x [M, d] (gain g,
// shift b_ln), the rows x [M, n], or the cross attention's combine.
struct Phase {
  const int8_t* w;
  int d_out, d_in;
  const float* sc;
  const float* bias;
  float extra;
  float* out;
  int mode;
  int prep;
  const float* x;
  const float* g;
  const float* b_ln;
};

// This block's rows j of the phase. The first batch of weight loads and
// the epilogue's operands (scale, bias, the old residual) are issued
// before the prep fills y (the input rows, swizzled, ending with a block
// barrier): the loads need not wait for the input. A warp carries kRows
// weight rows for all M rows; with fewer row groups than warps the input
// dimension is split among warps too, the slices added in a fixed order
// in g_part. The phase functions are not inlined: each gets its own
// register allocation (the kernel's parameter is __grid_constant__, so `s`
// is read in place).
template <int M>
__device__ __noinline__ void gemv(const Step& s, int layer, const Phase p) {
  float* smem = reinterpret_cast<float*>(g_smem);
  float* part = g_part;
  constexpr int kUnroll = M == 1 ? 2 : 1;   // 16-byte steps in flight a row
  constexpr bool kPreload = M <= 4;         // first batch before the prep
  constexpr int RM = kRows * M;
  const int d_out = p.d_out, d_in = p.d_in;
  int r0, r1;
  span(d_out, r0, r1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = d_in >> 4;
  const int ng = max(1, (r1 - r0 + kRows - 1) / kRows);
  const int ks = max(1, min(kWarps / ng, (chunks + 31) >> 5));
  const int items = r1 > r0 ? ng * ks : 0;  // uniform over the block
  const int step = 32 * ks;
  const float4* y4 = reinterpret_cast<const float4*>(smem);
  const int row4 = d_in >> 2;

  // round 0: this thread's epilogue element and its first weight batch
  int ej = -1, em = 0;
  float es = 0.f, eb = 0.f, eo = 0.f;
  uint4 wv[kUnroll][kRows];
  if (items > 0) {
    if (ks == 1) {
      const int j0 = r0 + warp * kRows;
      const int nr = warp < items ? min(kRows, r1 - j0) : 0;
      if (lane < nr * M) {
        ej = j0 + lane / M;
        em = lane % M;
      }
    } else if ((int)threadIdx.x < ng * RM) {
      const int t = threadIdx.x;
      const int j = r0 + (t / RM) * kRows + (t % RM) / M;
      if (j < r1) {
        ej = j;
        em = t % M;
      }
    }
    if (ej >= 0) {
      es = p.sc[ej];
      eb = p.bias[ej];
      eo = p.mode == kResidual ? p.out[(size_t)em * d_out + ej] : 0.f;
    }
    if (kPreload && warp < items) {
      const int j0 = r0 + (warp / ks) * kRows;
      const int nr = min(kRows, r1 - j0);
      const uint4* rows = reinterpret_cast<const uint4*>(p.w + (size_t)j0 *
                                                         d_in);
      const int c0 = (warp % ks) * 32 + lane;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int c = c0 + step * u;
          wv[u][r] = c < chunks && r < nr
                         ? __ldg(rows + (size_t)r * chunks + c)
                         : make_uint4(0u, 0u, 0u, 0u);
        }
    }
  }
  if (p.prep == kLayerNorm)
    layer_norm_rows<M>(p.x, d_in, p.g, p.b_ln, smem, g_red);
  else if (p.prep == kRowsIn)
    load_rows<M>(p.x, d_in, smem);
  else
    combine<M>(s, layer, smem, smem + M * s.d);

  for (int base = 0; base < items; base += kWarps) {
    const int it = base + warp;
    const int j0 = r0 + (it / ks) * kRows;
    const int nr = it < items ? min(kRows, r1 - j0) : 0;
    const uint4* rows = reinterpret_cast<const uint4*>(p.w + (size_t)j0 *
                                                       d_in);
    float acc[kRows][M];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[r][m] = 0.f;
    for (int c0 = (it % ks) * 32 + lane; nr > 0 && c0 < chunks;
         c0 += step * kUnroll) {
      if (!kPreload || base > 0 || c0 >= (it % ks) * 32 + step * kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int c = c0 + step * u;
            wv[u][r] = c < chunks && r < nr
                           ? __ldg(rows + (size_t)r * chunks + c)
                           : make_uint4(0u, 0u, 0u, 0u);
          }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + step * u;
        if (c >= chunks) break;
        const int sw = (c >> 1) & 3;
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {
          float wf[kRows][4];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const uint32_t x = word(wv[u][r], q) ^ 0x80808080u;
#pragma unroll
            for (int e = 0; e < 4; ++e) wf[r][e] = i8f(x, e);
          }
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float4 t = y4[m * row4 + c * 4 + (q ^ sw)];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              acc[r][m] += wf[r][0] * t.x + wf[r][1] * t.y + wf[r][2] * t.z +
                           wf[r][3] * t.w;
          }
        }
      }
    }
    float mine = 0.f;     // lane r * M + m keeps the sum of (row r, row m)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float a = warp_sum(acc[r][m]);
        if (lane == r * M + m) mine = a;
      }
    float sum = mine;
    int j = j0 + lane / M, m = lane % M;
    bool mine_out = lane < nr * M;
    if (ks > 1) {            // one round (items <= kWarps): add the slices
      if (it < items && lane < RM) part[it * RM + lane] = mine;
      __syncthreads();
      mine_out = ej >= 0;
      if (mine_out) {
        const int t = threadIdx.x, gg = t / RM, rm = t % RM;
        sum = part[gg * ks * RM + rm];
        for (int s2 = 1; s2 < ks; ++s2) sum += part[(gg * ks + s2) * RM + rm];
        j = ej;
        m = em;
      }
    } else if (base > 0 && mine_out) {
      es = p.sc[j];
      eb = p.bias[j];
      eo = p.mode == kResidual ? p.out[(size_t)m * d_out + j] : 0.f;
    }
    if (mine_out) {
      const float v = sum * (es * p.extra) + eb * p.extra;
      float* o = p.out + (size_t)m * d_out + j;
      if (p.mode == kResidual) {
        *o = eo + v;
      } else if (p.mode == kGelu) {
        *o = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      } else {
        *o = v;
      }
    }
    if (ks > 1) __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Before phase `ph` of `layer` starts: the L2 prefetches of the first GEMV
// phase after it (its weights then have a whole phase to arrive), of the
// ring prefix before phase A, of the cross keys before phase D and of the
// next layer's vector row before phase E.
template <int M>
__device__ void prefetch_ahead(const Step& s, int layer, int ph,
                               Prefetcher& pf) {
  if (layer >= s.n_layers) return;
  switch (ph) {
    case 0: prefetch_gemv(s, layer * 6 + 1, pf);      // o
            prefetch_ring<M>(s, layer, pf); break;
    case 1: prefetch_gemv(s, layer * 6 + 2, pf); break;   // cross q
    case 3: prefetch_gemv(s, layer * 6 + 3, pf);      // cross o
            prefetch_cross<M>(s, layer, pf); break;
    case 4: prefetch_vec(s, layer + 1, pf); break;
    case 5: prefetch_gemv(s, layer * 6 + 4, pf); break;   // fc1
    case 6: prefetch_gemv(s, layer * 6 + 5, pf); break;   // fc2
    case 7: prefetch_gemv(s, layer * 6 + 6, pf); break;   // next qkv
    default: break;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
    decode_step_kernel(const __grid_constant__ Step s) {
  const bool stamping = s.stamps != nullptr && blockIdx.x == 0 &&
                        threadIdx.x == 0;
  int n_stamps = 0;
  if (stamping) s.stamps[0] = globaltimer();
  for (int layer = 0; layer < s.n_layers; ++layer) {
    for (int ph = 0; ph < 8; ++ph) {
      if (ph == 1) {                 // B: fresh columns + self attention
        self_attention<M>(s, layer);
      } else if (ph == 4) {          // E: cross attention, split over keys
        cross_attention<M>(s, layer);
      } else {
        // A: LN1 + QKV, C: o-proj, D: LN2 + cross q, F: combine + cross o,
        // G: LN3 + fc1 + GELU, H: fc2 (GEMV index of the layer's six)
        const int gi = ph == 0 ? 0 : ph < 4 ? ph - 1 : ph - 2;
        const int d = s.d, f = s.f;
        // the layer's row of `vec` (ops/decode_step.py _vec_row): the
        // scales and biases of qkv (3d each), o, cross q, cross o and fc2
        // (d each), LN1-3 gain and shift (d each), fc1's (f each)
        const float* v = s.vec + (size_t)layer * (20 * d + 2 * f);
        const int so = gi == 0 ? 0 : gi == 4 ? 20 * d : gi == 5 ? 12 * d
                                                                : (2 * gi + 4) * d;
        Phase p;
        p.w = s.w[layer * 6 + gi];
        gemv_shape(gi, d, f, p.d_out, p.d_in);
        p.sc = v + so;
        p.bias = v + so + (gi == 0 ? 3 * d : gi == 4 ? f : d);
        p.extra = gi == 2 ? s.qscale : 1.f;
        p.out = gi == 0 ? s.qkv : gi == 2 ? s.qc : gi == 4 ? s.hmid : s.xr;
        p.mode = gi == 4 ? kGelu : (gi == 0 || gi == 2) ? kStore : kResidual;
        p.prep = (gi & 1) == 0 ? kLayerNorm : gi == 3 ? kCombine : kRowsIn;
        p.x = gi == 1 ? s.att : gi == 5 ? s.hmid : s.xr;
        p.g = v + (14 + gi) * d;     // LN1-3 for gi 0, 2, 4
        p.b_ln = p.g + d;
        gemv<M>(s, layer, p);
      }
      // the grid barrier; while thread 0 waits, the other threads issue
      // the L2 prefetches of what the phases ahead read
      __syncthreads();
      if (threadIdx.x == 0) {
        grid_arrive_wait();
      } else if (threadIdx.x >> 5 == 1) {
        Prefetcher pf{(int)threadIdx.x & 31, 32, 0};
        prefetch_ahead<M>(s, ph == 7 ? layer + 1 : layer, (ph + 1) % 8, pf);
      }
      __syncthreads();
      if (stamping) s.stamps[++n_stamps] = globaltimer();
    }
  }
}

// Dynamic shared memory of one block (ops/decode_step.py _smem_bytes): the
// largest of the GEMV rows with, after them, phase F's (max, sum) per
// (row, head) or a LayerNorm's gain and shift, the
// self-attention rows' queries, 64 staged V rows and scores, and two cross
// items' queries, scores, V scales and V rows (bounded by M streams of
// Dh-byte rows).
size_t smem_bytes(int m, int d, int f, int h, int dh, int t_ring) {
  const size_t wide = d > f ? d : f;
  const size_t after = 2 * (size_t)m * h > 2 * (size_t)d ? 2 * (size_t)m * h
                                                        : 2 * (size_t)d;
  const size_t gemv = 4 * ((size_t)m * wide + after);
  const size_t self = 4 * (size_t)kAttnWarps * (1088 + ((t_ring + 3) & ~3));
  const size_t cross = 2 * (4 * ((size_t)m * (64 + 2 * kSplit) + 4 * kHalf) +
                            (size_t)m * kSplit * dh);
  const size_t a = gemv > self ? gemv : self;
  return a > cross ? a : cross;
}

// The grid of each (device, M), found once (the attribute, the SM count
// and the occupancy query are host calls that cost more than a small
// step): the dynamic shared-memory limit raised to kMaxDynSmem, which the
// caller's gate keeps every launch under, and one block an SM, so the
// grid is the SM count. The occupancy query without dynamic shared
// memory must give 1: the registers alone (168 a thread at
// __launch_bounds__(kThreads, 1)) fill an SM, which the grid barrier
// relies on.
constexpr int kMaxDevices = 64;
std::mutex g_grid_mu;
int g_grid[kMaxDevices][kMaxRows + 1];   // 0: not found yet

template <int M>
cudaError_t grid_for(int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_grid_mu);
  if (g_grid[dev][M] == 0) {
    const void* fn = reinterpret_cast<const void*>(&decode_step_kernel<M>);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynSmem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    if (per_sm > 1) return cudaErrorInvalidConfiguration;
    g_grid[dev][M] = sms;
  }
  *grid = g_grid[dev][M];
  return cudaSuccess;
}

template <int M>
cudaError_t launch(const Step& s, size_t smem, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = grid_for<M>(&grid);
  if (err != cudaSuccess) return err;
  Step arg = s;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&decode_step_kernel<M>), dim3(grid),
      dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One decoder step; see the note above. hid holds x0 on entry (M rows); the
// rings take the fresh columns in place; align [M, A, K] must be zeroed.
// scratch holds M (5 d + f) + M H n_split (Dh + 2) floats, n_split =
// ceil(k_enc / 128). multi = 1 takes the M rows as tokens pos .. pos+M-1
// of one stream, whose ring and cross cache have batch 1; cross_shared = 1
// (implied by multi) gives the cross cache batch 1 under M per-row rings
// (the beams mode). stamps: null, or 8 n_layers + 1 u64 for the phase
// stamps. Returns a cudaError_t (0 = launched).
extern "C" int cw_decode_step(
    const void* w_ptrs, const void* vec, void* hid, void* scratch,
    void* ring_k, void* ring_v, void* ring_ks, void* ring_vs,
    const void* cross_k, const void* cross_v, const void* cross_ks,
    const void* cross_vs, const void* align_lh, void* align, int m,
    int n_layers, int d, int f, int h, int dh, int t_ring, int pos,
    int k_enc, int n_align, int cross_int4, int align_bf16, int multi,
    int cross_shared, float qscale, void* stamps, void* stream) {
  if (m < 1 || m > kMaxRows || n_layers < 1 || h < 1 || d != h * dh ||
      (dh != 16 && dh != 32 && dh != 64) || d % 16 != 0 || f % 16 != 0 ||
      pos < 0 || pos + (multi ? m : 1) > t_ring || k_enc < 1 || n_align < 1)
    return (int)cudaErrorInvalidValue;
  const int n_split = (k_enc + kSplit - 1) / kSplit;
  if (n_split > kMaxSplits) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m, d, f, h, dh, t_ring);
  if (smem > (size_t)kMaxDynSmem) return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  Step s;
  s.w = static_cast<const int8_t* const*>(w_ptrs);
  s.vec = static_cast<const float*>(vec);
  s.xr = static_cast<float*>(hid);
  s.qkv = sc;
  s.att = s.qkv + (size_t)m * 3 * d;
  s.qc = s.att + (size_t)m * d;
  s.hmid = s.qc + (size_t)m * d;
  s.part = s.hmid + (size_t)m * f;
  s.ml = s.part + (size_t)m * h * n_split * dh;
  s.ring_k = static_cast<int8_t*>(ring_k);
  s.ring_v = static_cast<int8_t*>(ring_v);
  s.ring_ks = static_cast<__nv_bfloat16*>(ring_ks);
  s.ring_vs = static_cast<__nv_bfloat16*>(ring_vs);
  s.cross_k = static_cast<const uint8_t*>(cross_k);
  s.cross_v = static_cast<const uint8_t*>(cross_v);
  s.cross_ks = static_cast<const __nv_bfloat16*>(cross_ks);
  s.cross_vs = static_cast<const __nv_bfloat16*>(cross_vs);
  s.align_lh = static_cast<const int*>(align_lh);
  s.align = static_cast<float*>(align);
  s.stamps = static_cast<unsigned long long*>(stamps);
  s.n_layers = n_layers;
  s.d = d;
  s.f = f;
  s.h = h;
  s.dh = dh;
  s.t_ring = t_ring;
  s.pos = pos;
  s.k_enc = k_enc;
  s.n_split = n_split;
  s.n_align = n_align;
  s.cross_int4 = cross_int4;
  s.align_bf16 = align_bf16;
  s.multi = multi != 0;
  s.cross_shared = multi != 0 || cross_shared != 0;
  s.qscale = qscale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (m) {
    case 1: err = launch<1>(s, smem, st); break;
    case 2: err = launch<2>(s, smem, st); break;
    case 3: err = launch<3>(s, smem, st); break;
    case 4: err = launch<4>(s, smem, st); break;
    case 5: err = launch<5>(s, smem, st); break;
    case 6: err = launch<6>(s, smem, st); break;
    case 7: err = launch<7>(s, smem, st); break;
    default: err = launch<8>(s, smem, st); break;
  }
  return (int)err;
}
