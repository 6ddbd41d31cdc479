// Fused log-mel frontend: framing, windowed real FFT, power, sparse mel
// sum and log10 in one launch; the window's max-8 clip and the affine step
// in a second.
//
// Replaces the TPU kernel crisperwhisper_tpu/audio/pallas_mel.py
// (pallas_log_mel -> _mel_kernel), which took frames gathered by XLA into
// device memory, padded to 512 lanes, and ran the DFT and the mel
// projection as two full-f32 (Precision.HIGHEST) MXU products; the clip
// and the affine step ran after it in XLA.
//
// What bounds it on the H100: the function moves 1.9 MB of samples and
// 1.5 MB of features per 30 s window at 128 mels and needs about 11k f32
// operations per frame with an FFT, so it is bound by bytes: 55 MB for 16
// windows, 0.017 ms at 3.35 TB/s (the clip pass adds one read and one
// write of the features). The spectrum feeds log10, so everything stays
// in IEEE f32 on the CUDA cores: no TF32 or bf16, no fast-math, no
// __sinf (the quiet bins of a TF32 DFT are wrong).
//
// Design: one block of 256 threads (8 warps) per (window, 32 frames).
//  1. Framing: the block reads the samples its 32 frames span straight
//     from the waveform into shared memory, reflect padding by index (no
//     frame tensor in device memory), and the host tables (below).
//  2. FFT: each warp takes frames w, w + 8, ... of the block, one at a
//     time. The 400-point real DFT of the Hann-windowed frame is a
//     200-point complex FFT of the even/odd-packed frame z[m] = x[2m] +
//     i x[2m+1], by Stockham stages of radix 5, 5 and 8 (200 = 5 x 5 x 8)
//     in a per-warp buffer of 200 complex values in shared memory: a lane
//     loads the inputs of its butterflies (one or two: 40, 40 and 25 a
//     stage), the warp syncs, and the lane writes its outputs in place.
//     Radix order: the radix-5 stages first, so the first stage's stores
//     (stride 5 complex values, 10 banks) fall on distinct banks without
//     padding, and the radix-8 stage with its seven twiddles a butterfly
//     has only 25 butterflies, one pass of a warp. The usual post-twiddle
//     X[k] = (Z[k] + conj Z[200-k]) / 2 - i W^k (Z[k] - conj Z[200-k]) / 2,
//     W = exp(-2 pi i / 400), gives the 201 bins, whose power goes to a
//     [32 frames x 201] strip (odd stride: a warp's rows hit distinct
//     banks). The window, the stage twiddles, W^k and the butterflies'
//     constants come from one table built once per device in float64 on
//     the host and stored f32 (fused_mel._fft_table_np).
//  3. Mel: lane = frame, warp w takes bands w, w + 8, ...; band m sums
//     power[k] * bank[k, m] over k ascending in [lo_m, hi_m), the range of
//     the bank's nonzeros (built once on the host). A zero weight adds
//     exactly 0 to an f32 sum of non-negative finite terms, so this is the
//     value the dense loop over all 201 bins gives for the same power.
//  4. log10(max(mel, 1e-10)), written [window, mel, frame] (a warp's 32
//     frames contiguous), and the window's maximum: a block reduction,
//     then one atomicMax on the order-preserving unsigned image of the
//     float into a [B] scratch that the entry zeroes first.
//  5. A second launch, clip_affine_kernel, applies max(x, max - 8) and
//     (x + 4) / 4 in place, 16 bytes a thread.
// Optional %globaltimer stamps (u64 [3]: the first FFT block's start, the
// last FFT block's end, the last clip block's end, by atomicMin/Max) split
// a call into its two launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNfft = 400;             // the only size the FFT plan takes
constexpr int kHalf = kNfft / 2;       // complex points
constexpr int kBins = kHalf + 1;       // 201
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = 32;            // frames a block (one a lane)
constexpr int kPStride = kBins;        // power strip row stride (odd)
// the host table, in floats (fused_mel._fft_table_np)
constexpr int kWin = 0;                // [200] (w[2m], w[2m+1])
constexpr int kTw2 = 400;              // [5 t][5 r] exp(-2 pi i t r / 25)
constexpr int kTw3 = 450;              // [25 t][8 r] exp(-2 pi i t r / 200)
constexpr int kPost = 850;             // [201 k] exp(-2 pi i k / 400)
constexpr int kConst = 1252;           // cos(2pi/5) cos(4pi/5) sin(..) sqrt(.5)
constexpr int kTable = 1260;           // floats (a multiple of 4)
constexpr int kMaxSmem = 232448;       // the H100's 227 KB a block

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Shared floats of one block: the table, the samples of 32 frames, one
// FFT buffer a warp, the power strip.
__host__ __device__ constexpr int smem_floats(int hop) {
  return kTable + round4((kFrames - 1) * hop + kNfft) + kWarps * 2 * kHalf +
         kFrames * kPStride;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a - i b and a + i b
__device__ __forceinline__ float2 sub_i(float2 a, float2 b) {
  return make_float2(a.x + b.y, a.y - b.x);
}
__device__ __forceinline__ float2 add_i(float2 a, float2 b) {
  return make_float2(a.x - b.y, a.y + b.x);
}

// In-place forward DFT of 5 points (c = cos 2pi/5, cos 4pi/5, sin 2pi/5,
// sin 4pi/5).
__device__ __forceinline__ void dft5(float2* a, const float* c) {
  const float2 t1 = cadd(a[1], a[4]), t2 = cadd(a[2], a[3]);
  const float2 t3 = csub(a[1], a[4]), t4 = csub(a[2], a[3]);
  const float2 b1 = make_float2(a[0].x + c[0] * t1.x + c[1] * t2.x,
                                a[0].y + c[0] * t1.y + c[1] * t2.y);
  const float2 b2 = make_float2(a[0].x + c[1] * t1.x + c[0] * t2.x,
                                a[0].y + c[1] * t1.y + c[0] * t2.y);
  const float2 d1 = make_float2(c[2] * t3.x + c[3] * t4.x,
                                c[2] * t3.y + c[3] * t4.y);
  const float2 d2 = make_float2(c[3] * t3.x - c[2] * t4.x,
                                c[3] * t3.y - c[2] * t4.y);
  a[0] = cadd(a[0], cadd(t1, t2));
  a[1] = sub_i(b1, d1);
  a[4] = add_i(b1, d1);
  a[2] = sub_i(b2, d2);
  a[3] = add_i(b2, d2);
}

// Forward DFT of 4 points x[0], x[s], x[2s], x[3s] into y[0..3].
__device__ __forceinline__ void dft4(const float2* x, int s, float2* y) {
  const float2 a = cadd(x[0], x[2 * s]), b = csub(x[0], x[2 * s]);
  const float2 c = cadd(x[s], x[3 * s]), d = csub(x[s], x[3 * s]);
  y[0] = cadd(a, c);
  y[1] = sub_i(b, d);
  y[2] = csub(a, c);
  y[3] = add_i(b, d);
}

// In-place forward DFT of 8 points, radix 2 over two 4-point DFTs
// (h = sqrt(1/2)).
__device__ __forceinline__ void dft8(float2* a, float h) {
  float2 e[4], o[4];
  dft4(a, 2, e);
  dft4(a + 1, 2, o);
  o[1] = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));
  o[2] = make_float2(o[2].y, -o[2].x);
  o[3] = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = cadd(e[k], o[k]);
    a[k + 4] = csub(e[k], o[k]);
  }
}

// The 200-point FFT of one windowed, packed frame (samples x, even
// offset) into buf, in natural order. Stockham stage (radix R, span Ns):
// butterfly j takes in[j + r N/R], multiplies input r by exp(-2 pi i
// (j mod Ns) r / (Ns R)), and writes out[(j / Ns) Ns R + j mod Ns + r Ns].
__device__ void fft200(const float* x, const float* tab, float2* buf,
                       int lane) {
  const float2* win = reinterpret_cast<const float2*>(tab + kWin);
  const float2* xs = reinterpret_cast<const float2*>(x);
  const float* c5 = tab + kConst;
  float2 a[2][5];
  // stage 1: radix 5, Ns = 1 (no twiddles), 40 butterflies, from samples
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = lane + 32 * u;
    if (j < 40) {
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const float2 s = xs[j + 40 * r], w = win[j + 40 * r];
        a[u][r] = make_float2(s.x * w.x, s.y * w.y);
      }
      dft5(a[u], c5);
#pragma unroll
      for (int r = 0; r < 5; ++r) buf[5 * j + r] = a[u][r];
    }
  }
  __syncwarp();
  // stage 2: radix 5, Ns = 5, 40 butterflies, in place
  const float2* tw2 = reinterpret_cast<const float2*>(tab + kTw2);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = lane + 32 * u;
    if (j < 40)
#pragma unroll
      for (int r = 0; r < 5; ++r) a[u][r] = buf[j + 40 * r];
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = lane + 32 * u;
    if (j < 40) {
      const int t = j % 5;
#pragma unroll
      for (int r = 1; r < 5; ++r) a[u][r] = cmul(a[u][r], tw2[5 * t + r]);
      dft5(a[u], c5);
      const int base = (j / 5) * 25 + t;
#pragma unroll
      for (int r = 0; r < 5; ++r) buf[base + 5 * r] = a[u][r];
    }
  }
  __syncwarp();
  // stage 3: radix 8, Ns = 25, 25 butterflies; out[j + 25 r] = in[...]
  if (lane < 25) {
    const float2* tw3 = reinterpret_cast<const float2*>(tab + kTw3);
    float2 b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) b[r] = buf[lane + 25 * r];
#pragma unroll
    for (int r = 1; r < 8; ++r) b[r] = cmul(b[r], tw3[8 * lane + r]);
    dft8(b, c5[4]);
#pragma unroll
    for (int r = 0; r < 8; ++r) buf[lane + 25 * r] = b[r];
  }
  __syncwarp();
}

// The 201 bins' power from the packed FFT Z in buf, each square rounded
// as the reference rounds it (no contraction into an FMA).
__device__ void power201(const float2* buf, const float* tab, float* prow,
                         int lane) {
  const float2* post = reinterpret_cast<const float2*>(tab + kPost);
  for (int k = lane; k < kBins; k += 32) {
    const float2 a = buf[k == kHalf ? 0 : k];
    const float2 c = buf[k == 0 ? 0 : kHalf - k];   // taken conjugated
    const float ex = 0.5f * (a.x + c.x), ey = 0.5f * (a.y - c.y);
    const float ox = 0.5f * (a.y + c.y), oy = -0.5f * (a.x - c.x);
    const float2 w = post[k];
    const float re = ex + (w.x * ox - w.y * oy);
    const float im = ey + (w.x * oy + w.y * ox);
    prow[k] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  }
}

// Order-preserving unsigned image of a float (larger float, larger
// image; 0 lies below every finite float's image).
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned v) {
  return __uint_as_float((v & 0x80000000u) ? (v & 0x7FFFFFFFu) : ~v);
}

__global__ void __launch_bounds__(kThreads)
    log_mel_kernel(const float* __restrict__ wave,
                   const float* __restrict__ table,
                   const int* __restrict__ bands,
                   const float* __restrict__ weights, float* __restrict__ out,
                   unsigned* __restrict__ peak,
                   unsigned long long* __restrict__ stamps, int n_samples,
                   int n_frames, int hop, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  const int span = (kFrames - 1) * hop + kNfft;   // samples of 32 frames
  float* tab = smem;
  float* xs = smem + kTable;
  float2* bufs = reinterpret_cast<float2*>(xs + round4(span));
  float* power = reinterpret_cast<float*>(bufs + kWarps * kHalf);
  __shared__ float red[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const float* wb = wave + (size_t)b * n_samples;
  if (stamps != nullptr && threadIdx.x == 0) atomicMin(stamps, globaltimer());

  for (int i = threadIdx.x; i < kTable / 4; i += kThreads)
    reinterpret_cast<float4*>(tab)[i] =
        __ldg(reinterpret_cast<const float4*>(table) + i);
  // padded index f * hop + t is waveform index f * hop + t - n_fft / 2,
  // reflected at both ends (numpy "reflect")
  for (int p = threadIdx.x; p < span; p += kThreads) {
    int i = f0 * hop + p - kHalf;
    if (i < 0) i = -i;
    if (i >= n_samples) i = 2 * (n_samples - 1) - i;
    i = min(max(i, 0), n_samples - 1);  // only frames past the end reach
    xs[p] = __ldg(wb + i);
  }
  __syncthreads();

  float2* buf = bufs + warp * kHalf;
  for (int i = warp; i < kFrames && f0 + i < n_frames; i += kWarps) {
    fft200(xs + i * hop, tab, buf, lane);
    power201(buf, tab, power + i * kPStride, lane);
    __syncwarp();  // the buffer is read; the next frame may overwrite it
  }
  __syncthreads();

  const int f = f0 + lane;
  const float* prow = power + lane * kPStride;
  float mx = -INFINITY;
  for (int m = warp; m < n_mels; m += kWarps) {
    const int lo = __ldg(bands + m), hi = __ldg(bands + n_mels + m);
    const int off = __ldg(bands + 2 * n_mels + m) - lo;
    float acc = 0.f;
    for (int k = lo; k < hi; ++k)
      acc = fmaf(prow[k], __ldg(weights + off + k), acc);
    const float v = log10f(fmaxf(acc, 1e-10f));
    if (f < n_frames) {
      out[((size_t)b * n_mels + m) * n_frames + f] = v;
      mx = fmaxf(mx, v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
    atomicMax(peak + b, ordered(mx));
    if (stamps != nullptr) atomicMax(stamps + 1, globaltimer());
  }
}

// x = (max(x, peak - 8) + 4) / 4 over each window's n features (n a
// multiple of 4, so every window starts on 16 bytes), in place.
__global__ void __launch_bounds__(kThreads)
    clip_affine_kernel(float* __restrict__ out,
                       const unsigned* __restrict__ peak,
                       unsigned long long* __restrict__ stamps, int n) {
  const float floor8 = unordered(peak[blockIdx.y]) - 8.0f;
  float* o = out + (size_t)blockIdx.y * n;
  const int stride = gridDim.x * kThreads;
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n / 4; i += stride) {
    float4 v = o4[i];
    v.x = (fmaxf(v.x, floor8) + 4.0f) * 0.25f;
    v.y = (fmaxf(v.y, floor8) + 4.0f) * 0.25f;
    v.z = (fmaxf(v.z, floor8) + 4.0f) * 0.25f;
    v.w = (fmaxf(v.w, floor8) + 4.0f) * 0.25f;
    o4[i] = v;
  }
  if (stamps != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) atomicMax(stamps + 2, globaltimer());
  }
}

}  // namespace

// wave [B, n_samples] f32; table [1260] f32 (fused_mel._fft_table_np);
// bands [3, n_mels] i32 (lo, hi, offset into weights); weights f32, the
// bank's nonzero ranges packed band after band; out [B, n_mels, n_frames]
// f32 features (clipped, affine); peak [B] u32 scratch; stamps u64 [3]
// (start {max, 0, 0}) or null. n_fft must be 400, hop even and n_mels x
// n_frames a multiple of 4. Returns a cudaError_t (0 = launched).
extern "C" int cw_log_mel(const void* wave, const void* table,
                          const void* bands, const void* weights, void* out,
                          void* peak, void* stamps, int b, int n_samples,
                          int n_frames, int n_fft, int hop, int n_mels,
                          void* stream) {
  if (b <= 0 || b > 65535 || n_frames <= 0 || n_fft != kNfft || hop <= 0 ||
      hop % 2 != 0 || n_mels <= 0 || n_samples <= kHalf ||
      (long long)(n_frames - 1) * hop >= n_samples ||
      (long long)n_mels * n_frames > (1ll << 30) || n_mels * n_frames % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_floats(hop) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(peak, 0, (size_t)b * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(log_mel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  log_mel_kernel<<<dim3((n_frames + kFrames - 1) / kFrames, b), kThreads,
                   smem, st>>>(
      static_cast<const float*>(wave), static_cast<const float*>(table),
      static_cast<const int*>(bands), static_cast<const float*>(weights),
      static_cast<float*>(out), static_cast<unsigned*>(peak),
      static_cast<unsigned long long*>(stamps), n_samples, n_frames, hop,
      n_mels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = n_mels * n_frames;
  const int blocks = min((n / 4 + kThreads - 1) / kThreads, 1024);
  clip_affine_kernel<<<dim3(blocks, b), kThreads, 0, st>>>(
      static_cast<float*>(out), static_cast<const unsigned*>(peak),
      static_cast<unsigned long long*>(stamps), n);
  return (int)cudaGetLastError();
}
