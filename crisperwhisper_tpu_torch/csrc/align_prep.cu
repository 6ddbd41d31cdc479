// Alignment prep: [B, A, T, K] alignment-head probabilities -> [B, T, K] f32
// DTW cost = the negated head mean of the frame-axis median (odd width W)
// of the token-axis z-norm, with a per-row n_tokens and n_frames.
//
// Replaces the TPU kernel crisperwhisper_tpu/ops/pallas_align.py
// (fused_align_prep -> _kernel), which did the z-norm, the median and the
// head mean for one (item, head) block in VMEM, full-width rows only.
//
// What bounds it on the H100: memory. The input is [B, 15, T, 1500] f32
// (35 MB at B = 4, T = 96), the arithmetic a few dozen operations an
// element; every live input element has to cross from device memory once.
//
// Design: one launch; one block per (item, tile of kTile frames) of
// kThreads threads, each of which holds the head sums of two frames of the
// tile over a stride of token rows (ceil(T / 64) rows, at most
// kRowsPerThread / 2). The block loops over the heads in a fixed order:
//   - the head's strip, rows < n_tokens x frames [tile - W/2, tile + kTile +
//     W/2) (rounded out to 16 bytes, cut at n_frames), comes into a
//     double-buffered shared ring with cp.async (16-byte copies where rows
//     are 16-byte aligned, else 4-byte), the next head's copy in flight
//     while this head is computed;
//   - a half-warp a strip column: its lanes take the column's mean and
//     biased two-pass variance over the rows < n_tokens by shuffle trees
//     (a fixed order; no block barrier between the steps), floor the std
//     at 1e-10 and write the column back normalized (IEEE __fdiv_rn,
//     __fsqrt_rn);
//   - each thread takes the medians of two neighbouring frames' W
//     reflected taps (reflect at 0 and at n_frames - 1, per row, as the
//     plain chain; a block whose taps all lie inside [0, n_frames) reads
//     them as they are): the W - 1 taps the two windows share give their
//     middle two by a min/max network in registers, and each median is its
//     window's own tap clamped between them (W <= 7: the widths in use, 7
//     by default and 3 in the reference app; any wider odd W by
//     rank selection over shared memory); it adds them to its rows' head
//     sums in registers.
// The head sum is divided by A and negated once at the end; no atomics, so
// the result does not depend on scheduling. Frames >= n_frames are never
// read and their output is 0 (the plain chain's z of a zeroed column);
// token rows >= n_tokens are neither read nor normalized and are written
// as 0: the DTW reads only the live rectangle.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;           // output frames a block: two a thread,
                                    // 16 pairs a warp
constexpr int kThreads = 1024;      // 32 warps a block
constexpr int kRowsPerThread = 16;  // token rows a thread at most: T <= 512
constexpr int kMaxSmem = 232448;    // 227 KB of shared memory a block (H100)

// Floats of one strip row: the tile, W - 1 taps of halo, and up to 3
// columns each side to round the copy out to 16 bytes.
__host__ __device__ inline int strip_width(int width) {
  return (kTile + 2 * (width / 2) + 6 + 3) / 4 * 4;
}

size_t prep_smem(int t, int width) {
  const int sw = strip_width(width);
  return 2 * (size_t)t * sw * sizeof(float);
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The plain chain's tap index: reflect at 0, then at nf - 1, then clamp.
__device__ __forceinline__ int reflect(int idx, int nf, int k) {
  idx = idx < 0 ? -idx : idx;
  idx = idx >= nf ? 2 * nf - 2 - idx : idx;
  return min(max(idx, 0), k - 1);
}

__device__ __forceinline__ void sort2(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// The strip column of tap frame f in an edge block: the plain chain's
// reflection, kept inside the strip (only a frame >= n_frames, whose
// output is 0, can reflect out of it).
__device__ __forceinline__ int tap_col(int f, int nf, int k, int g0,
                                       int sw) {
  return min(max(reflect(f, nf, k) - g0, 0), sw - 1);
}

// Medians of two neighbouring windows, v[0 .. W - 1] and v[1 .. W]: the
// W - 1 values they share give their middle two, s_{H-1} <= s_H, and each
// median is its own extra value clamped between them (an input value, as
// the plain chain's sort gives it). H bubble passes from the top leave s_H
// at v[H]; the largest of v[1 .. H] is s_{H-1}. At W = 7 that is 12
// compare-swaps and 2 max for both medians, where one median-of-7 network
// takes 13 compare-swaps.
template <int W>
__device__ __forceinline__ void pair_median(float (&v)[W + 1], float& a,
                                            float& b) {
  constexpr int H = W / 2;
  if constexpr (W == 1) {
    a = v[0];
    b = v[1];
  } else {
#pragma unroll
    for (int p = 0; p < H; ++p) {
#pragma unroll
      for (int q = 1; q < W - 1 - p; ++q) sort2(v[q], v[q + 1]);
    }
    const float hi = v[W - H];  // s_H: v[1 .. W - 1] has 2H values
    float lo = v[1];            // s_{H-1}: the largest of the rest
#pragma unroll
    for (int q = 2; q < W - H; ++q) lo = fmaxf(lo, v[q]);
    a = fminf(fmaxf(v[0], lo), hi);
    b = fminf(fmaxf(v[W], lo), hi);
  }
}

// The sum over each half-warp (lanes 0-15, 16-31), a fixed tree.
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copies one head's strip (rows < nt, columns [lo, hi)) into `dst`: lane
// = a 16-byte chunk (or a column), warp = a stride of rows.
__device__ __forceinline__ void issue_strip(float* dst, const float* src,
                                            int nt, int g0, int lo, int hi,
                                            int sw, int k, bool vec) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  if (vec) {  // lo is a multiple of 4, rows are 16-byte aligned
    for (int c = lo + 4 * tx; c < hi; c += 128)
      for (int t = ty; t < nt; t += kThreads / 32)
        copy16(dst + t * sw + (c - g0), src + (size_t)t * k + c,
               4 * min(4, hi - c));
  } else {
    for (int c = lo + tx; c < hi; c += 32)
      for (int t = ty; t < nt; t += kThreads / 32)
        copy4(dst + t * sw + (c - g0), src + (size_t)t * k + c);
  }
  commit();
}

// W > 0: a network of that width; W == 0: any odd `width`, by rank.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    align_prep_kernel(const float* __restrict__ w,
                      const int* __restrict__ n_tokens,
                      const int* __restrict__ n_frames,
                      float* __restrict__ out, int heads, int t_len, int k,
                      int width) {
  extern __shared__ __align__(16) float smem[];
  if (W > 0) width = W;
  const int h = width / 2;
  const int sw = strip_width(width);
  const int b = blockIdx.y;
  const int s = blockIdx.x * kTile;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  constexpr int ny = kThreads / 32;
  float* stage0 = smem;
  float* stage1 = smem + (size_t)t_len * sw;

  const int nt = min(max(n_tokens[b], 0), t_len);  // rows in the statistics
  const int nfr = n_frames[b];                     // as given: reflection
  const int live = min(max(nfr, 0), k);            // frames < live are live
  // the median: frames ka = s + 2 (tx mod 16) and ka + 1, rows tx / 16 +
  // 2 ty + 64 r
  const int ka = s + 2 * (tx & 15);
  const int t0 = (tx >> 4) + 2 * ty;
  float* ob = out + (size_t)b * t_len * k;

  float acc[2][kRowsPerThread / 2];
#pragma unroll
  for (int r = 0; r < kRowsPerThread / 2; ++r) acc[0][r] = acc[1][r] = 0.f;

  if (nt > 0 && s < live) {  // block-uniform
    const int g0 = (s - h) & ~3;  // strip column 0, rounded down to 16 bytes
    const int lo = max(g0, 0);
    const int hi = min(g0 + sw, live);
    const bool vec = (k & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    const float count = (float)nt;
    const bool mine = ka < live;  // this thread's first frame is live
    // a block whose taps all fall inside [0, nf) reads frame f at strip
    // column f - g0; an edge block reflects each tap
    const bool interior = s - h >= 0 && s + kTile + h <= min(nfr, k);
    const float* wb = w + (size_t)b * heads * t_len * k;
    issue_strip(stage0, wb, nt, g0, lo, hi, sw, k, vec);
    for (int a = 0; a < heads; ++a) {
      float* x = (a & 1) ? stage1 : stage0;
      if (a + 1 < heads) {
        issue_strip((a & 1) ? stage0 : stage1, wb + (size_t)(a + 1) * t_len * k,
                    nt, g0, lo, hi, sw, k, vec);
        wait_groups<1>();
      } else {
        wait_groups<0>();
      }
      __syncthreads();  // head a's strip is in
      // a half-warp a column, lane l on rows l, l + 16, ...: the mean and
      // the biased variance by shuffle trees (a fixed order), then the
      // column normalized in place; no block barrier between the steps
      for (int cw = lo - g0 + 2 * ty; cw < hi - g0; cw += 2 * ny) {
        const int c = cw + (tx >> 4);  // the loop is warp-uniform
        const bool on = c < hi - g0;
        const int hl = tx & 15;
        float sum = 0.f;
        if (on)
          for (int t = hl; t < nt; t += 16) sum += x[t * sw + c];
        const float mu = __fdiv_rn(half_sum(sum), count);
        float sq = 0.f;
        if (on)
          for (int t = hl; t < nt; t += 16) {
            const float dv = x[t * sw + c] - mu;
            sq = fmaf(dv, dv, sq);
          }
        const float sd =
            fmaxf(__fsqrt_rn(__fdiv_rn(half_sum(sq), count)), 1e-10f);
        if (on)
          for (int t = hl; t < nt; t += 16)
            x[t * sw + c] = __fdiv_rn(x[t * sw + c] - mu, sd);
      }
      __syncthreads();  // the strip is z
      if (mine) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread / 2; ++r) {
          const int t = t0 + 64 * r;
          if (t < nt) {
            const float* row = x + t * sw;
            if constexpr (W > 0) {
              float v[W + 1];  // frames ka - h .. ka + 1 + h
#pragma unroll
              for (int q = 0; q <= W; ++q)
                v[q] = row[interior ? ka + q - h - g0
                                    : tap_col(ka + q - h, nfr, k, g0, sw)];
              float ma, mb;
              pair_median<W>(v, ma, mb);
              acc[0][r] += ma;
              acc[1][r] += mb;
            } else {
              // rank selection: the tap with h values below it (ties
              // counted as equal) is the median
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int f = ka + e;
                float med = 0.f;
                for (int q = 0; q < width; ++q) {
                  const float vq = row[tap_col(f + q - h, nfr, k, g0, sw)];
                  int below = 0, equal = 0;
                  for (int p = 0; p < width; ++p) {
                    const float vp = row[tap_col(f + p - h, nfr, k, g0, sw)];
                    below += vp < vq;
                    equal += vp == vq;
                  }
                  if (below <= h && h < below + equal) med = vq;
                }
                acc[e][r] += med;
              }
            }
          }
          // one row's taps at a time: the compiler must not hoist every
          // row's loads (they would not fit the registers)
          asm volatile("" ::: "memory");
        }
      }
      __syncthreads();  // done with this stage before it is refilled
    }
  }
  const float n_heads = (float)heads;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int f = ka + e;
    if (f < k) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread / 2; ++r) {
        const int t = t0 + 64 * r;
        if (t < t_len)
          ob[(size_t)t * k + f] =
              (t < nt && f < live) ? -__fdiv_rn(acc[e][r], n_heads) : 0.f;
      }
    }
  }
}

template <int W>
int launch(const float* w, const int* nt, const int* nf, float* out, int b,
           int a, int t, int k, int width, cudaStream_t stream) {
  const size_t smem = prep_smem(t, width);
  const cudaError_t attr =
      cudaFuncSetAttribute(align_prep_kernel<W>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((k + kTile - 1) / kTile, b);
  align_prep_kernel<W><<<grid, kThreads, smem, stream>>>(w, nt, nf, out, a, t,
                                                         k, width);
  return (int)cudaGetLastError();
}

}  // namespace

// w [B, A, T, K] f32, n_tokens/n_frames [B] i32, out [B, T, K] f32; width
// odd. Returns a cudaError_t (0 = launched).
extern "C" int cw_align_prep(const void* w, const void* n_tokens,
                             const void* n_frames, void* out, int b, int a,
                             int t, int k, int width, void* stream) {
  if (b <= 0 || a <= 0 || t <= 0 || k <= 0 || width <= 0 || width % 2 != 1 ||
      k <= width / 2 || t > kThreads / 32 * kRowsPerThread ||
      prep_smem(t, width) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(w);
  const int* nt = static_cast<const int*>(n_tokens);
  const int* nf = static_cast<const int*>(n_frames);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch<1>(x, nt, nf, o, b, a, t, k, width, st);
    case 3: return launch<3>(x, nt, nf, o, b, a, t, k, width, st);
    case 5: return launch<5>(x, nt, nf, o, b, a, t, k, width, st);
    case 7: return launch<7>(x, nt, nf, o, b, a, t, k, width, st);
  }
  return launch<0>(x, nt, nf, o, b, a, t, k, width, st);
}
