// Encoder self-attention for Hopper: out = softmax(q k^T) v, non-causal.
//
// Replaces the TPU kernel crisperwhisper_tpu/ops/fused_attention.py
// (fused_attention -> _attn_kernel), which kept the whole [Tq, Tk] score
// block of one (batch*head) in VMEM.
//
// What bounds it on the H100: at large-v3 (T = 1500, Dh = 64) one
// (batch*head) moves 4 x 1500 x 64 16-bit values (q, k, v, out) and does
// 4 x 1500^2 x 64 flops, about 750 flops a byte, above the card's 295: on
// tensor cores the bound is the 46 GFLOP of [4, 20, 1500, 64] over 989
// TFLOP/s. The exponentials (one a score) load the special-function
// units about as much as the products load the tensor cores.
//
// Two kernels; ops/fused_attention.py picks one by dtype and head dim
// (``route``) and counts launches by route:
//
//   * attention_tc_kernel, the tensor-core route: bf16 and f16 at head
//     dims 16, 32 and 64. One CTA per (batch*head, 192-query tile): three
//     consumer warpgroups of 64 query rows each and one producer warp.
//     The producer loads the CTA's Q tile once and streams 64-key K and V
//     tiles through a four-stage shared-memory ring with TMA (3-D tensor
//     maps [BH, T, Dh], so a tile never crosses into the next batch*head
//     and rows past T come back zero), full and empty mbarriers between
//     it and the consumers. Rows of 2*Dh bytes take the 128-, 64- or
//     32-byte swizzle, and the wgmma shared-memory descriptors match it.
//     Each consumer warpgroup runs S = Q K^T with wgmma (Q and K both in
//     shared memory, K-major), masks keys >= t_k to -inf, keeps the online
//     softmax on the S accumulator in registers (a row sits in a quad of
//     lanes: two shuffles for its max; exp2 of the score pre-multiplied
//     by log2 e), converts the unnormalised probabilities to the input's
//     16-bit type in registers, where the f32 accumulator's fragment is
//     already the A operand's, and runs O += P V with A from registers
//     and V from shared memory as a transposed (MN-major) B operand. The
//     row sums stay in f32 and 1/l multiplies O at the end, rows >= t_q
//     masked at the store: the algebra of _attn_kernel (f32 scores, P in
//     v's dtype for the second product, the denominator divided out last).
//     At Dh = 64 a tile's exp2s take the special-function units about as
//     long as its products take the tensor cores, so the warpgroups take
//     turns on the tensor cores (named barriers, in rotation): one issues
//     its PV of the previous tile and its S of this one while the others
//     run their softmax. No wgmma sits under a branch (ptxas would
//     serialize them all).
//
//   * encoder_attention_kernel, the CUDA-core route: f32 (tensor cores
//     would mean TF32, outside the reference's 2e-5 f32 band, and wgmma
//     transposes its B operand only for 16-bit types). One block per
//     (batch*head, 64-query tile), one thread per query; K/V tiles of 64
//     keys staged in shared memory widened to f32, read as shared-memory
//     broadcasts; online softmax with the precise expf.
//
// No SDPA, cuDNN, cuBLAS or CUTLASS kernel: the tensor maps are encoded
// with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
// that the library needs no -lcuda.
//
// Inputs q, k, v: [BH, T, D] row-major (the caller's [B, H, T, D]
// contiguous); the output has q's shape and dtype.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// CUDA-core route
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;  // queries per block, one thread each
constexpr int kBlockK = 64;  // keys staged in shared memory per tile
constexpr int kSub = 16;     // keys per online-softmax update

template <int D>
__global__ void __launch_bounds__(kBlockQ)
    encoder_attention_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o,
                             int t_q, int t_k) {
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const size_t bh = blockIdx.y;
  const int qi = blockIdx.x * kBlockQ + threadIdx.x;
  const bool live = qi < t_q;
  const float* qrow = q + (bh * t_q + (live ? qi : 0)) * D;
  const float* kb = k + bh * t_k * D;
  const float* vb = v + bh * t_k * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? qrow[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;  // running max of the scores
  float l = 0.f;        // running sum of exp(score - m)

  for (int k0 = 0; k0 < t_k; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kBlockQ) {
      const int r = idx / D;
      const int c = idx % D;
      const int key = k0 + r;
      const bool in = key < t_k;
      ks[r][c] = in ? kb[(size_t)key * D + c] : 0.f;
      vs[r][c] = in ? vb[(size_t)key * D + c] : 0.f;
    }
    __syncthreads();

    const int n_valid = min(kBlockK, t_k - k0);
    for (int s0 = 0; s0 < n_valid; s0 += kSub) {
      float s[kSub];
      float smax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(&ks[s0 + j][d]);
          dot = fmaf(qr[d], kv.x, dot);
          dot = fmaf(qr[d + 1], kv.y, dot);
          dot = fmaf(qr[d + 2], kv.z, dot);
          dot = fmaf(qr[d + 3], kv.w, dot);
        }
        s[j] = (s0 + j < n_valid) ? dot : -INFINITY;
        smax = fmaxf(smax, s[j]);
      }
      // s[0] is a real key, so m_new is finite; exp(-inf) == 0 on the
      // first update and for the masked keys
      const float m_new = fmaxf(m, smax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[s0 + j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (live) {
    float* orow = o + (bh * t_q + qi) * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
  }
}

cudaError_t launch_cuda_cores(const void* q, const void* k, const void* v,
                              void* o, int bh, int t_q, int t_k,
                              int head_dim, cudaStream_t stream) {
  const dim3 grid((t_q + kBlockQ - 1) / kBlockQ, bh);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  switch (head_dim) {
    case 16:
      encoder_attention_kernel<16>
          <<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, t_q, t_k);
      break;
    case 32:
      encoder_attention_kernel<32>
          <<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, t_q, t_k);
      break;
    case 64:
      encoder_attention_kernel<64>
          <<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, t_q, t_k);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route (wgmma + TMA)
// ---------------------------------------------------------------------------

// The tile configuration. Three consumer warpgroups, 64-key tiles and a
// four-stage ring were the fastest of the configurations timed on the
// card (PERF.md, Findings); 96- and 128-key tiles made ptxas serialize the
// wgmmas or ran slower.
constexpr int kConsumerWarpgroups = 3;
constexpr int kBlockM = 64 * kConsumerWarpgroups;  // queries per CTA
constexpr int kBlockN = 64;                        // keys per K/V tile
constexpr int kStages = 4;                         // K/V ring depth
constexpr int kConsumerWarps = 4 * kConsumerWarpgroups;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte-aligned base (the swizzle atoms' period):
// Q [kBlockM, D], kStages x K [kBlockN, D], kStages x V [kBlockN, D], then
// the mbarriers q_full, full[kStages], empty[kStages].
template <int D>
struct Smem {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kQBytes = kBlockM * kRowBytes;
  static constexpr int kTileBytes = kBlockN * kRowBytes;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kAlloc = kBars + 8 * (1 + 2 * kStages) + 1024;
  // wgmma's layout code: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t kLayout = D == 64 ? 1 : D == 32 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a tile whose rows are 2*D bytes,
// swizzled in atoms of 8 rows: start address >> 4 (bits 0-13), leading
// byte offset 1 (unused: each operand is one atom wide along its
// contiguous axis), stride byte offset = one atom of 8 rows (bits 32-45),
// the swizzle's layout code (bits 62-63). The same form serves the
// K-major Q and K tiles and the MN-major V tile.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kSbo = (8 * 2 * D) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (kSbo << 32) | (Smem<D>::kLayout << 62);
}

// The consumer warpgroups' turns on the tensor cores, in rotation:
// warpgroup w waits on named barrier 1 + w (its 128 threads and the
// passing warpgroup's 128), and passes the turn to warpgroup w + 1 by
// arriving on that one's barrier.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + wg) : "memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (probabilities below 2^-126 of the row's largest).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define CW_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CW_F8(d, i) CW_F4(d, i), CW_F4(d, i + 4)
#define CW_F16(d, i) CW_F8(d, i), CW_F8(d, i + 8)
#define CW_F32(d, i) CW_F16(d, i), CW_F16(d, i + 16)

// d[0:32] (+)= A(smem) B(smem), m64n64k16, both K-major
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31}, "
                 "%32, %33, p, 1, 1, 0, 0;\n"
                 "}\n"
                 : CW_F32(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31}, "
                 "%32, %33, p, 1, 1, 0, 0;\n"
                 "}\n"
                 : CW_F32(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d[0:8] += A(registers) B(smem), m64n16k16, B MN-major (transposed)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
                 "}\n"
                 : CW_F8(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
                 "}\n"
                 : CW_F8(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  }
}

// d[0:16] += A(registers) B(smem), m64n32k16, B MN-major (transposed)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
                 "}\n"
                 : CW_F16(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
                 "}\n"
                 : CW_F16(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  }
}

// d[0:32] += A(registers) B(smem), m64n64k16, B MN-major (transposed)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
                 "}\n"
                 : CW_F32(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
                 "}\n"
                 : CW_F32(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  }
}

template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t dv) {
  if constexpr (D == 64) {
    wgmma_rs_n64<T>(o, a, dv);
  } else if constexpr (D == 32) {
    wgmma_rs_n32<T>(o, a, dv);
  } else {
    wgmma_rs_n16<T>(o, a, dv);
  }
}

// Two f32 values as one 32-bit register of the 16-bit type, lo in the
// low half (the lower k index of an A fragment pair).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// S = Q K^T for one key tile: D/16 k-steps of 32 bytes within the
// swizzled rows of both K-major operands.
template <typename T, int D>
__device__ __forceinline__ void qk_tile(float* sc, uint64_t dq,
                                        uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss_n64<T>(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
  }
}

// O += P V for one key tile: V's rows are the keys (the k axis), its D
// columns contiguous (an MN-major B); k-step kk starts 16 rows further.
template <typename T, int D>
__device__ __forceinline__ void pv_tile(float* o, const uint32_t (*pa)[4],
                                        uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_pv<T, D>(o, pa[kk], dv + kk * ((16 * 2 * D) >> 4));
  }
}

// The online softmax of the score tile of keys k0 .. k0 + kBlockN - 1
// (keys >= t_k, the last tile's tail, to -inf before the max); rows i = 0,
// 1 of this thread. The first tile holds a real key, so the running max is
// finite from the first tile on and exp2(-inf) == 0 clears the empty start
// and the masked keys. Leaves P in the 16-bit type in pa, as the A
// fragments of the kBlockN/16 k-steps, and O rescaled to the new max.
template <typename T, int D>
__device__ __forceinline__ void softmax_tile(float* sc, float* o,
                                             float* m_run, float* l_run,
                                             uint32_t (*pa)[4], int k0,
                                             int t_k) {
  if (k0 + kBlockN > t_k) {
    const int col0 = k0 + 2 * (threadIdx.x % 4);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (col0 + 8 * j + c >= t_k) {
          sc[4 * j + c] = -INFINITY;
          sc[4 * j + 2 + c] = -INFINITY;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // four partial maxima and sums: short dependency chains
    float mp[4] = {m_run[i], -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mp[j % 4] = fmaxf(mp[j % 4], fmaxf(sc[4 * j + 2 * i],
                                         sc[4 * j + 2 * i + 1]));
    }
    float mx = fmaxf(fmaxf(mp[0], mp[1]), fmaxf(mp[2], mp[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = ex2((m_run[i] - mx) * kLog2e);
    m_run[i] = mx;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * i] *= corr;
      o[4 * j + 2 * i + 1] *= corr;
    }
    const float mb = mx * kLog2e;
    float lp[4] = {l_run[i] * corr, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = ex2(fmaf(sc[4 * j + 2 * i + c], kLog2e, -mb));
        sc[4 * j + 2 * i + c] = p;
        lp[j % 4] += p;
      }
    }
    l_run[i] = (lp[0] + lp[1]) + (lp[2] + lp[3]);
  }
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
  }
}

// Accumulator fragment of m64nNk16 (f32), thread (warp w of the
// warpgroup, lane l): element 4*j + 2*i + c holds row 16*w + l/4 + 8*i,
// column 8*j + 2*(l%4) + c. Converted pairwise to 16 bits, the columns
// 16*kk .. 16*kk+15 (j = 2kk, 2kk+1) are the A fragment of k-step kk.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        T* __restrict__ out, int t_q, int t_k) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int n_tiles = (t_k + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: one lane issues TMA
    if (lane == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      tma_load_3d(sq, &tm_q, q_full, 0, m0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) {
          mbar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);  // freed
        }
        mbar_expect_tx(full0 + 8 * s, 2 * L::kTileBytes);
        tma_load_3d(sk + s * L::kTileBytes, &tm_k, full0 + 8 * s, 0,
                    it * kBlockN, bh);
        tma_load_3d(sv + s * L::kTileBytes, &tm_v, full0 + 8 * s, 0,
                    it * kBlockN, bh);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows m0 + 64*wg .. m0 + 64*wg + 63.
  // The warpgroups take turns on the tensor cores, in rotation (named
  // barrier 1 + wg): turn j issues O += P_{j-1} V_{j-1} and S_j = Q K_j^T,
  // passes the turn on and waits for its own products, so one
  // warpgroup's softmax runs while the others' products do. The first and
  // last turns are peeled off the loop: a wgmma under a branch would make
  // ptxas serialize them all.
  const int wg = warp / 4;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of each row's sum
  float sc[kBlockN / 2];
  uint32_t pa[kBlockN / 16][4];
  const uint64_t dq = smem_desc<D>(sq + wg * 64 * L::kRowBytes);

  const int next = (wg + 1) % kConsumerWarpgroups;
  if (wg == kConsumerWarpgroups - 1) turn_pass(0);  // 0 takes the first turn
  mbar_wait(q_full, 0);
  mbar_wait(full0, 0);
  turn_wait(wg);  // turn 0: S_0 alone
  wgmma_fence();
  qk_tile<T, D>(sc, dq, smem_desc<D>(sk));
  wgmma_commit();
  turn_pass(next);
  wgmma_wait0();
  fence_regs<kBlockN / 2>(sc);
  softmax_tile<T, D>(sc, o, m_run, l_run, pa, 0, t_k);

  for (int j = 1; j < n_tiles; ++j) {
    const int sp = (j - 1) % kStages;  // stage of tile j - 1
    const int sn = j % kStages;        // stage of tile j
    mbar_wait(full0 + 8 * sn, (j / kStages) & 1);
    turn_wait(wg);
    fence_regs<D / 2>(o);
    wgmma_fence();
    pv_tile<T, D>(o, pa, smem_desc<D>(sv + sp * L::kTileBytes));
    qk_tile<T, D>(sc, dq, smem_desc<D>(sk + sn * L::kTileBytes));
    wgmma_commit();
    turn_pass(next);
    wgmma_wait0();
    fence_regs<D / 2>(o);
    fence_regs<kBlockN / 2>(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * sp);  // done with tile j - 1
    softmax_tile<T, D>(sc, o, m_run, l_run, pa, j * kBlockN, t_k);
  }

  turn_wait(wg);  // the last turn: PV of the last tile alone
  fence_regs<D / 2>(o);
  wgmma_fence();
  pv_tile<T, D>(o, pa,
                smem_desc<D>(sv + ((n_tiles - 1) % kStages) * L::kTileBytes));
  wgmma_commit();
  wgmma_wait0();
  fence_regs<D / 2>(o);
  if (wg != kConsumerWarpgroups - 1) turn_pass(next);  // its last turn

  // epilogue: O / l, rows < t_q, two 16-bit values per 32-bit store
  const int row0 = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = row0 + 8 * i;
    if (row < t_q) {
      T* orow =
          out + (static_cast<size_t>(bh) * t_q + row) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack2<T>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Error codes of the tensor-map step, beside cudaError_t's own range.
constexpr int kErrNoEncoder = 100000;
constexpr int kErrEncode = 100001;  // + the CUresult

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A 3-D map [BH, T, D] (innermost first) of a 16-bit tensor with boxes of
// [rows, D]; reads past T fill with zeros.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
             int bh, int t, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(2 * D),
                                 static_cast<cuuint64_t>(t) * 2 * D};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <typename T, int D>
int launch_tensor_cores(const void* q, const void* k, const void* v, void* o,
                        int bh, int t_q, int t_k, cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same_v<T, __nv_bfloat16>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mq, mk, mv;
  int err = make_map<D>(&mq, q, type, bh, t_q, kBlockM);
  if (err == 0) err = make_map<D>(&mk, k, type, bh, t_k, kBlockN);
  if (err == 0) err = make_map<D>(&mv, v, type, bh, t_k, kBlockN);
  if (err != 0) return err;
  constexpr int kSmem = Smem<D>::kAlloc;
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((t_q + kBlockM - 1) / kBlockM, bh);
  attention_tc_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      mq, mk, mv, static_cast<T*>(o), t_q, t_k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tensor_cores(const void* q, const void* k, const void* v, void* o,
                        int bh, int t_q, int t_k, int head_dim,
                        cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_tensor_cores<T, 16>(q, k, v, o, bh, t_q, t_k, stream);
    case 32:
      return launch_tensor_cores<T, 32>(q, k, v, o, bh, t_q, t_k, stream);
    case 64:
      return launch_tensor_cores<T, 64>(q, k, v, o, bh, t_q, t_k, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (ops/fused_attention.py's
// codes). Each entry returns a cudaError_t (0 = launched), or a tensor-map
// error code (>= 100000).

// The CUDA-core route: float32 (dtype 0), head dim 16, 32 or 64.
extern "C" int cw_encoder_attention(const void* q, const void* k,
                                    const void* v, void* o, int bh, int t_q,
                                    int t_k, int head_dim, int dtype,
                                    void* stream) {
  if (bh <= 0 || bh > 65535 || t_q <= 0 || t_k <= 0 || dtype != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_cuda_cores(
      q, k, v, o, bh, t_q, t_k, head_dim, static_cast<cudaStream_t>(stream)));
}

// The tensor-core route: bfloat16 or float16, head dim 16, 32 or 64; q, k
// and v 16-byte aligned (TMA).
extern "C" int cw_encoder_attention_tc(const void* q, const void* k,
                                       const void* v, void* o, int bh,
                                       int t_q, int t_k, int head_dim,
                                       int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || t_q <= 0 || t_k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch_tensor_cores<__nv_bfloat16>(q, k, v, o, bh, t_q, t_k,
                                              head_dim, s);
  }
  if (dtype == 2) {
    return launch_tensor_cores<__half>(q, k, v, o, bh, t_q, t_k, head_dim,
                                       s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one tensor-core CTA at this head dim (bytes).
extern "C" int cw_encoder_attention_tc_smem(int head_dim) {
  return head_dim == 64   ? Smem<64>::kAlloc
         : head_dim == 32 ? Smem<32>::kAlloc
         : head_dim == 16 ? Smem<16>::kAlloc
                          : 0;
}

extern "C" const char* cw_error_string(int err) {
  static thread_local char buf[96];
  if (err == kErrNoEncoder) {
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  }
  if (err >= kErrEncode) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - kErrEncode);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
