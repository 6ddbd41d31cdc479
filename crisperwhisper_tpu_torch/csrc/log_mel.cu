// Fused log-mel frontend: framing, windowed real DFT, power, mel
// projection and log10 in one pass.
//
// Replaces the TPU kernel crisperwhisper_tpu/audio/pallas_mel.py
// (pallas_log_mel -> _mel_kernel), which took frames gathered by XLA into
// device memory, padded to 512 lanes, and ran the DFT and the mel
// projection as two full-f32 (Precision.HIGHEST) MXU products.
//
// What bounds it on the H100: the function moves 1.9 MB of samples and
// 1.5 MB of features per 30 s window at 128 mels and needs about 11k f32
// operations per frame with an FFT, so it is bound by bytes: 55 MB for 16
// windows, 0.017 ms at 3.35 TB/s. This design does far more work than
// that: the DFT as a product, 3000 frames x (400 taps x 402 cos/sin
// columns + 201 bins x n_mels) multiply-adds a window, 17.9 GFLOP for 16
// windows, 0.27 ms at the 67 TFLOP/s of the f32 CUDA cores, the floor of
// this design and not of the function. The DFT feeds log10, so it stays
// in IEEE f32 on the CUDA cores: no TF32 or bf16 tensor-core path, no
// fast-math (the quiet bins of a TF32 DFT are wrong).
//
// Design: one block of 256 threads per (window, 32 frames). The block
// reads the samples its frames span straight from the waveform, reflect
// padding by index (no frame tensor in device memory), into shared
// memory. The DFT is a register-tiled product against the windowed
// cos/sin basis [n_fft][2][n_bins] (built once per device in float64 on
// the host): each thread owns 8 frames x 4 bins, keeps the cos and the
// sin sum of each (64 accumulators), and the basis goes through shared
// memory 8 taps at a time so the block's four frame groups share every
// load. The thread then squares its own sums into the power spectrum
// (shared memory, over the samples, which are done), and each warp
// projects 32 frames (one a lane) onto 16 mel bands, the bank read
// straight from device memory (one address a warp: a broadcast). The
// result is log10(max(mel, 1e-10)), written [window, mel, frame] with the
// frames of a warp contiguous. The max-8 clip and the affine step need the
// window's maximum and stay outside, as in the reference.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 32;                        // frames per block
constexpr int kTaps = 8;                           // basis taps per tile
constexpr int kBinLanes = 64;                      // threads across bins
constexpr int kBinsPer = 4;                        // bins per thread
constexpr int kMaxBins = kBinLanes * kBinsPer;     // 256
constexpr int kFrameRows = kThreads / kBinLanes;   // 4
constexpr int kFramesPer = kFrames / kFrameRows;   // 8 frames per thread
constexpr int kMelWarps = kThreads / 32;           // 8
constexpr int kMelsPer = 16;                       // mel bands per thread
constexpr int kMaxMels = kMelWarps * kMelsPer;     // 128
constexpr int kMaxSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
    log_mel_kernel(const float* __restrict__ wave,
                   const float* __restrict__ basis,
                   const float* __restrict__ fb, float* __restrict__ out,
                   int n_samples, int n_frames, int n_fft, int hop,
                   int n_bins, int n_mels) {
  extern __shared__ float smem[];
  const int span = (kFrames - 1) * hop + n_fft;   // samples of 32 frames
  float* xs = smem;                                // [span]
  float* tile = smem + span;                       // [kTaps][2][kMaxBins]
  float* power = smem;                             // [kFrames][pstride]
  const int pstride = n_bins | 1;  // odd: a warp's rows hit distinct banks
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const float* wb = wave + (size_t)b * n_samples;
  const int half = n_fft / 2;

  // the frames' samples; padded index f * hop + t is waveform index
  // f * hop + t - n_fft / 2, reflected at both ends (numpy "reflect")
  for (int p = threadIdx.x; p < span; p += kThreads) {
    int i = f0 * hop + p - half;
    if (i < 0) i = -i;
    if (i >= n_samples) i = 2 * (n_samples - 1) - i;
    i = min(max(i, 0), n_samples - 1);  // only frames past the end reach
    xs[p] = wb[i];
  }

  const int tx = threadIdx.x % kBinLanes;
  const int ty = threadIdx.x / kBinLanes;
  float re[kFramesPer][kBinsPer];
  float im[kFramesPer][kBinsPer];
#pragma unroll
  for (int i = 0; i < kFramesPer; ++i)
#pragma unroll
    for (int j = 0; j < kBinsPer; ++j) re[i][j] = im[i][j] = 0.f;

  for (int t0 = 0; t0 < n_fft; t0 += kTaps) {
    __syncthreads();  // the samples are in; the last tile is consumed
    for (int idx = threadIdx.x; idx < kTaps * 2 * kMaxBins;
         idx += kThreads) {
      const int tt = idx / (2 * kMaxBins);
      const int part = (idx / kMaxBins) % 2;       // 0 cos, 1 sin
      const int k = idx % kMaxBins;
      const int t = t0 + tt;
      tile[idx] = (t < n_fft && k < n_bins)
                      ? basis[((size_t)t * 2 + part) * n_bins + k]
                      : 0.f;
    }
    __syncthreads();
    const int taps = min(kTaps, n_fft - t0);
    for (int tt = 0; tt < taps; ++tt) {
      float x[kFramesPer];
#pragma unroll
      for (int i = 0; i < kFramesPer; ++i)
        x[i] = xs[(ty + kFrameRows * i) * hop + t0 + tt];
      const float* row = tile + tt * 2 * kMaxBins;
#pragma unroll
      for (int j = 0; j < kBinsPer; ++j) {
        const float c = row[tx + kBinLanes * j];
        const float s = row[kMaxBins + tx + kBinLanes * j];
#pragma unroll
        for (int i = 0; i < kFramesPer; ++i) {
          re[i][j] = fmaf(x[i], c, re[i][j]);
          im[i][j] = fmaf(x[i], s, im[i][j]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the samples and the tile

  // power = re^2 + im^2, each square rounded as the reference rounds it
#pragma unroll
  for (int i = 0; i < kFramesPer; ++i)
#pragma unroll
    for (int j = 0; j < kBinsPer; ++j) {
      const int k = tx + kBinLanes * j;
      if (k < n_bins)
        power[(ty + kFrameRows * i) * pstride + k] =
            __fadd_rn(__fmul_rn(re[i][j], re[i][j]),
                      __fmul_rn(im[i][j], im[i][j]));
    }
  __syncthreads();

  // mel projection: lane = frame, warp w takes bands w, w + 8, ...
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float acc[kMelsPer];
#pragma unroll
  for (int j = 0; j < kMelsPer; ++j) acc[j] = 0.f;
  const float* prow = power + lane * pstride;
  for (int k = 0; k < n_bins; ++k) {
    const float pk = prow[k];
    const float* fk = fb + (size_t)k * n_mels;
#pragma unroll
    for (int j = 0; j < kMelsPer; ++j) {
      const int m = warp + kMelWarps * j;
      if (m < n_mels) acc[j] = fmaf(pk, __ldg(fk + m), acc[j]);
    }
  }
  const int f = f0 + lane;
  if (f >= n_frames) return;
#pragma unroll
  for (int j = 0; j < kMelsPer; ++j) {
    const int m = warp + kMelWarps * j;
    if (m < n_mels)
      out[((size_t)b * n_mels + m) * n_frames + f] =
          log10f(fmaxf(acc[j], 1e-10f));
  }
}

}  // namespace

// wave [B, n_samples] f32; basis [n_fft, 2, n_bins] f32 (window * cos,
// window * -sin); fb [n_bins, n_mels] f32; out [B, n_mels, n_frames] f32
// log10(max(mel, 1e-10)). Returns a cudaError_t (0 = launched).
extern "C" int cw_log_mel(const void* wave, const void* basis,
                          const void* fb, void* out, int b, int n_samples,
                          int n_frames, int n_fft, int hop, int n_bins,
                          int n_mels, void* stream) {
  if (b <= 0 || n_frames <= 0 || n_fft < 2 || hop <= 0 || n_bins <= 0 ||
      n_bins > kMaxBins || n_mels <= 0 || n_mels > kMaxMels ||
      n_samples <= n_fft / 2 || (long long)(n_frames - 1) * hop >= n_samples)
    return (int)cudaErrorInvalidValue;
  const int span = (kFrames - 1) * hop + n_fft;
  const int floats = max(span + kTaps * 2 * kMaxBins, kFrames * (n_bins | 1));
  const size_t smem = (size_t)floats * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, b);
  log_mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(basis),
      static_cast<const float*>(fb), static_cast<float*>(out), n_samples,
      n_frames, n_fft, hop, n_bins, n_mels);
  return (int)cudaGetLastError();
}
