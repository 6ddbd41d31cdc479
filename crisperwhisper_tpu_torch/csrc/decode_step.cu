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
// the cross cache (61 MB packed int4 per stream) and the live ring prefix.
// The arithmetic is about one multiply-add per weight byte per row (M <= 8
// rows), far below the card's rate, so the step is a stream of bytes at
// 3.35 TB/s and one SM cannot pull it: every SM has to.
//
// Design: a persistent cooperative grid (every block resident, sized from
// the occupancy calculator) runs nine phases per layer with a grid barrier
// after each dependent one:
//   1. LN1 + fused QKV GEMV        5. LN2 + cross-q GEMV
//   2-3. fresh K/V column, quantized and written into the ring at `pos`,
//        then self attention over the ring slots [0, pos]
//   4. o-proj + residual           6. cross attention + alignment capture
//   7. cross-o + residual          8. LN3 + fc1 + GELU     9. fc2 + residual
// GEMV phases: each warp owns output channels and reads each weight row
// ([d_out, d_in], contiguous int8) once, in 16-byte loads with up to
// kUnroll in flight a lane, for all M rows, whose inputs every block holds
// in shared memory (a block recomputes the LayerNorm of the M residual rows
// itself instead of paying a barrier). Attention phases: one block per
// (row, head) item, a thread per key for the scores, then warps over the
// keys for P·V with the lanes of a warp reading one V row together; the
// self attention reads only the live prefix of the ring, the cross
// attention unpacks int4 nibbles in registers. The residual stream is an
// f32 [M, d] buffer in device memory (the output `hid`), other phase
// outputs an f32 scratch.
// The fresh column is written into the ring by the block that then reads
// it, after a block barrier, so no other block touches that slot.
//
// Modes: the M rows are M distinct streams at one position, each with its
// own ring and cross cache (M = 1: decode_step_b1, M = 2..8: rows), or, with
// `multi`, M consecutive tokens of ONE stream at positions pos .. pos+M-1
// (the speculative verify block, decode_step_b1_multi), sharing one ring
// and one cross cache. Row i then attends to slots [0, pos + i], so it needs
// the fresh columns of rows j < i of the same head: one block per head takes
// all M rows, writes their M columns at [pos, pos + M) and, after a block
// barrier, runs the M attention rows one after another. At M = 1 the multi
// mode runs exactly the b1 mode's arithmetic. With `cross_shared` (the
// beams mode, decode_step_b1_beams) the M rows are M beams of one item: the
// rows mode with every row reading the cross cache of stream 0, so the
// cross cache is held once per item, not once per beam. The rings stay per
// row. The multi mode shares the cross cache too.
//
// Numerics are the reference kernel's: f32 everywhere, the dense epilogue
// acc * scale + bias with bf16 scales read as f32, the cross-q scale and
// bias times head_dim**-0.5, LayerNorm eps 1e-5, the fresh column quantized
// with the f32 scale and rintf (half-to-even, as jnp.round) and its scale
// stored and used as bf16, exact erff GELU, IEEE expf/division (no
// fast-math). Buffers written inside the kernel are read with plain loads,
// never through the read-only cache.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;
constexpr int kPart = kWarps * 64;   // P·V partial sums: one dh row per warp
constexpr int kUnroll = 4;           // 16-byte weight loads in flight a lane

struct Step {
  const int8_t* const* w;  // [L * 6] weight pointers, [d_out, d_in] each
  const float* vec;        // [L, 20d + 2f] scales, biases, LayerNorms
  float* xr;               // [M, d] residual stream: x0 in, hid out
  float* qkv;              // [M, 3d]
  float* att;              // [M, d] attention output (o-proj input)
  float* qc;               // [M, d] cross queries
  float* hmid;             // [M, f] GELU(fc1)
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
  int n_layers, d, f, h, dh, t_ring, pos, k_enc, n_align, cross_int4,
      align_bf16;
  int multi;               // 1: the M rows are consecutive tokens of one
                           // stream (shared ring and cross cache)
  int cross_shared;        // 1: every row reads the cross cache of stream 0
  float qscale;            // head_dim**-0.5
};

// Offsets into one layer's row of `vec` (ops/decode_step.py _vec_row).
struct Vec {
  int qkv_s, qkv_b, o_s, o_b, cq_s, cq_b, co_s, co_b, fc2_s, fc2_b, ln1_g,
      ln1_b, ln2_g, ln2_b, ln3_g, ln3_b, fc1_s, fc1_b, stride;
  __device__ Vec(int d, int f)
      : qkv_s(0), qkv_b(3 * d), o_s(6 * d), o_b(7 * d), cq_s(8 * d),
        cq_b(9 * d), co_s(10 * d), co_b(11 * d), fc2_s(12 * d),
        fc2_b(13 * d), ln1_g(14 * d), ln1_b(15 * d), ln2_g(16 * d),
        ln2_b(17 * d), ln3_g(18 * d), ln3_b(19 * d), fc1_s(20 * d),
        fc1_b(20 * d + f), stride(20 * d + 2 * f) {}
};

enum Epilogue { kStore = 0, kResidual = 1, kGelu = 2 };

// Reduction over the block; every thread gets the result. `red` holds
// kWarps floats of shared memory; the leading barrier guards its reuse.
__device__ float block_reduce(float v, float* red, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, other) : v + other;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// Element e (0..7) of 8 int8 values, or nibble e (0..7) of 8 int4 values,
// packed in one 32-bit word; sign-extended by an arithmetic shift.
__device__ __forceinline__ float i8_at(uint32_t w, int e) {
  return (float)((int32_t)(w << (24 - 8 * e)) >> 24);
}
__device__ __forceinline__ float i4_at(uint32_t w, int e) {
  return (float)((int32_t)(w << (28 - 4 * e)) >> 28);
}

// q · row for one cache row of dh values (int8, or int4 pairs).
__device__ __forceinline__ float dot_row(const uint8_t* row, const float* q,
                                         int dh, bool int4) {
  float acc = 0.f;
  if (int4) {
    for (int i = 0; i < dh; i += 16) {
      const uint2 w = *reinterpret_cast<const uint2*>(row + i / 2);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += q[i + e] * i4_at(w.x, e);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += q[i + 8 + e] * i4_at(w.y, e);
    }
  } else {
    for (int i = 0; i < dh; i += 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(row + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc += q[i + e] * i8_at(w.x, e);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc += q[i + 4 + e] * i8_at(w.y, e);
    }
  }
  return acc;
}

// Value e of one cache row (int8, or int4 pairs).
__device__ __forceinline__ float value_at(const uint8_t* row, int e,
                                          bool int4) {
  if (!int4) return i8_at(row[e], 0);
  return i4_at(row[e >> 1], e & 1);
}

// y[m, :] = LayerNorm(x[m, :]) for the M rows, into shared memory.
template <int M>
__device__ void layer_norm_rows(const float* x, int d, const float* g,
                                const float* b, float* y, float* red) {
  for (int m = 0; m < M; ++m) {
    const float* xm = x + (size_t)m * d;
    float acc = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) acc += xm[i];
    const float mean = block_reduce(acc, red, false) / (float)d;
    acc = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float z = xm[i] - mean;
      acc += z * z;
    }
    const float var = block_reduce(acc, red, false) / (float)d;
    const float inv = 1.f / sqrtf(var + 1e-5f);
    for (int i = threadIdx.x; i < d; i += kThreads)
      y[m * d + i] = (xm[i] - mean) * inv * g[i] + b[i];
  }
  __syncthreads();
}

// y[0 : n) = src[0 : n) from device memory into shared memory.
__device__ void load_rows(const float* src, int n, float* y) {
  for (int i = threadIdx.x; i < n; i += kThreads) y[i] = src[i];
  __syncthreads();
}

// out[m, j] (=, +=, = GELU) (y[m, :] · W[j, :]) * s[j] * extra
//                          + b[j] * extra  for every output channel j.
template <int M>
__device__ void gemv(const int8_t* __restrict__ W, int d_out, int d_in,
                     const float* y, const float* sc, const float* bias,
                     float extra, float* out, int mode) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int chunks = d_in / 16;
  for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < d_out;
       j += n_warps) {
    const uint4* row = reinterpret_cast<const uint4*>(W + (size_t)j * d_in);
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0.f;
    for (int c0 = lane; c0 < chunks; c0 += 32 * kUnroll) {
      uint4 wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        wv[u] = c < chunks ? __ldg(row + c) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c >= chunks) break;
        float wf[16];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wf[e] = i8_at(wv[u].x, e);
          wf[4 + e] = i8_at(wv[u].y, e);
          wf[8 + e] = i8_at(wv[u].z, e);
          wf[12 + e] = i8_at(wv[u].w, e);
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4* ym = reinterpret_cast<const float4*>(
              y + (size_t)m * d_in + c * 16);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 t = ym[q];
            acc[m] += wf[4 * q] * t.x + wf[4 * q + 1] * t.y +
                      wf[4 * q + 2] * t.z + wf[4 * q + 3] * t.w;
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
    }
    if (lane < M) {
      float a = acc[0];
#pragma unroll
      for (int m = 1; m < M; ++m)
        if (lane == m) a = acc[m];
      const float v = a * (sc[j] * extra) + bias[j] * extra;
      float* o = out + (size_t)lane * d_out + j;
      if (mode == kResidual) {
        *o += v;
      } else if (mode == kGelu) {
        *o = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      } else {
        *o = v;
      }
    }
  }
}

// Softmax of sc[0 : n) in place (f32, max-subtracted, IEEE expf and
// division), each probability then times `scale_v[t]` when given.
__device__ void softmax_row(float* sc, int n, float* red) {
  float mx = -INFINITY;
  for (int t = threadIdx.x; t < n; t += kThreads) mx = fmaxf(mx, sc[t]);
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float e = expf(sc[t] - mx);
    sc[t] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);
  for (int t = threadIdx.x; t < n; t += kThreads) sc[t] = sc[t] / sum;
  __syncthreads();
}

// out[e] = sum_t pv[t] * V[t, e] over t < n; rows of `rb` bytes. Warps
// stride over the keys; the lanes of a warp read one key row together
// (consecutive bytes), each owning dh / 32 values (dh = 16: two keys per
// warp step), so the loads are coalesced and independent from key to key.
// `part` holds kPart floats.
__device__ void pv_product(const float* pv, const uint8_t* v, int n, int dh,
                           int rb, bool int4, float* part, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vpl = dh > 32 ? dh / 32 : 1;        // values per lane
  const int lpk = dh / vpl;                     // lanes per key row
  const int kpi = 32 / lpk;                     // key rows per warp step
  const int sub = lane / lpk;
  const int e0 = (lane % lpk) * vpl;
  float acc[2] = {0.f, 0.f};
#pragma unroll 4
  for (int t = warp * kpi + sub; t < n; t += kWarps * kpi) {
    const float p = pv[t];
    const uint8_t* row = v + (size_t)t * rb;
    acc[0] += p * value_at(row, e0, int4);
    if (vpl == 2) acc[1] += p * value_at(row, e0 + 1, int4);
  }
  float* mine = part + (warp * kpi + sub) * dh + e0;
  mine[0] = acc[0];
  if (vpl == 2) mine[1] = acc[1];
  __syncthreads();
  if (threadIdx.x < dh) {
    float o = 0.f;
    for (int i = 0; i < kWarps * kpi; ++i) o += part[i * dh + threadIdx.x];
    out[threadIdx.x] = o;
  }
  __syncthreads();
}

// Phases 2-3: per (stream, head), the fresh K/V columns into the ring (M
// of them at [pos, pos + M) in the multi mode, else one at pos), then, for
// each row i of the stream, attention over ring slots [0, pos + i].
template <int M>
__device__ void self_attention(const Step& s, int layer, float* smem,
                               float* red) {
  const int H = s.h, dh = s.dh, T = s.t_ring, pos = s.pos, d = s.d;
  const int streams = s.multi ? 1 : M;
  const int n_new = s.multi ? M : 1;   // rows (fresh columns) a stream
  float* q = smem;                  // dh
  float* sc = smem + 64;            // T scores
  float* part = sc + (T > s.k_enc ? T : s.k_enc);
  for (int item = blockIdx.x; item < streams * H; item += gridDim.x) {
    const int st = item / H, hh = item % H;
    const size_t base = ((size_t)layer * streams + st) * H + hh;
    int8_t* rk = s.ring_k + base * T * dh;
    int8_t* rv = s.ring_v + base * T * dh;
    __nv_bfloat16* rks = s.ring_ks + base * T;
    __nv_bfloat16* rvs = s.ring_vs + base * T;
    for (int i = 0; i < n_new; ++i) {
      const float* qkv = s.qkv + (size_t)(st + i) * 3 * d + hh * dh;
      const int slot = pos + i;
      for (int kv = 1; kv <= 2; ++kv) {
        const float x = threadIdx.x < dh ? qkv[kv * d + threadIdx.x] : 0.f;
        const float amax = block_reduce(fabsf(x), red, true);
        const float scale = fmaxf(amax, 1e-8f) / 127.f;
        if (threadIdx.x < dh) {
          const float qv = fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
          (kv == 1 ? rk : rv)[(size_t)slot * dh + threadIdx.x] = (int8_t)qv;
        }
        if (threadIdx.x == 0)
          (kv == 1 ? rks : rvs)[slot] = __float2bfloat16_rn(scale);
      }
    }
    for (int i = 0; i < n_new; ++i) {
      const int m = st + i, last = pos + i;
      if (threadIdx.x < dh)
        q[threadIdx.x] = s.qkv[(size_t)m * 3 * d + hh * dh + threadIdx.x];
      __syncthreads();
      for (int t = threadIdx.x; t <= last; t += kThreads)
        sc[t] = dot_row(reinterpret_cast<const uint8_t*>(rk) + (size_t)t * dh,
                        q, dh, false) *
                __bfloat162float(rks[t]);
      __syncthreads();
      softmax_row(sc, last + 1, red);
      for (int t = threadIdx.x; t <= last; t += kThreads)
        sc[t] *= __bfloat162float(rvs[t]);
      __syncthreads();
      pv_product(sc, reinterpret_cast<const uint8_t*>(rv), last + 1, dh, dh,
                 false, part, s.att + (size_t)m * d + hh * dh);
    }
  }
}

// Phase 6: per (row, head), attention over the quantized cross cache, with
// the alignment heads' probabilities captured.
template <int M>
__device__ void cross_attention(const Step& s, int layer, float* smem,
                                float* red) {
  const int H = s.h, dh = s.dh, K = s.k_enc, d = s.d;
  const bool int4 = s.cross_int4 != 0;
  const int rb = int4 ? dh / 2 : dh;
  float* q = smem;
  float* sc = smem + 64;
  float* part = sc + (s.t_ring > K ? s.t_ring : K);
  const int streams = s.cross_shared ? 1 : M;
  for (int item = blockIdx.x; item < M * H; item += gridDim.x) {
    const int m = item / H, hh = item % H;
    const size_t base =
        ((size_t)layer * streams + (s.cross_shared ? 0 : m)) * H + hh;
    const uint8_t* ck = s.cross_k + base * K * rb;
    const uint8_t* cv = s.cross_v + base * K * rb;
    const __nv_bfloat16* cks = s.cross_ks + base * K;
    const __nv_bfloat16* cvs = s.cross_vs + base * K;
    if (threadIdx.x < dh) q[threadIdx.x] = s.qc[(size_t)m * d + hh * dh +
                                                threadIdx.x];
    __syncthreads();
    for (int t = threadIdx.x; t < K; t += kThreads)
      sc[t] = dot_row(ck + (size_t)t * rb, q, dh, int4) *
              __bfloat162float(cks[t]);
    __syncthreads();
    softmax_row(sc, K, red);
    for (int a = 0; a < s.n_align; ++a) {
      if (s.align_lh[2 * a] != layer || s.align_lh[2 * a + 1] != hh) continue;
      float* dst = s.align + ((size_t)m * s.n_align + a) * K;
      for (int t = threadIdx.x; t < K; t += kThreads)
        dst[t] = s.align_bf16 ? __bfloat162float(__float2bfloat16_rn(sc[t]))
                              : sc[t];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < K; t += kThreads)
      sc[t] *= __bfloat162float(cvs[t]);
    __syncthreads();
    pv_product(sc, cv, K, dh, rb, int4, part, s.att + (size_t)m * d + hh * dh);
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
    decode_step_kernel(const Step s) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int d = s.d, f = s.f;
  const Vec o(d, f);
  for (int layer = 0; layer < s.n_layers; ++layer) {
    const float* v = s.vec + (size_t)layer * o.stride;
    const int8_t* const* w = s.w + layer * 6;
    layer_norm_rows<M>(s.xr, d, v + o.ln1_g, v + o.ln1_b, smem, red);
    gemv<M>(w[0], 3 * d, d, smem, v + o.qkv_s, v + o.qkv_b, 1.f, s.qkv,
            kStore);
    grid.sync();
    self_attention<M>(s, layer, smem, red);
    grid.sync();
    load_rows(s.att, M * d, smem);
    gemv<M>(w[1], d, d, smem, v + o.o_s, v + o.o_b, 1.f, s.xr, kResidual);
    grid.sync();
    layer_norm_rows<M>(s.xr, d, v + o.ln2_g, v + o.ln2_b, smem, red);
    gemv<M>(w[2], d, d, smem, v + o.cq_s, v + o.cq_b, s.qscale, s.qc,
            kStore);
    grid.sync();
    cross_attention<M>(s, layer, smem, red);
    grid.sync();
    load_rows(s.att, M * d, smem);
    gemv<M>(w[3], d, d, smem, v + o.co_s, v + o.co_b, 1.f, s.xr, kResidual);
    grid.sync();
    layer_norm_rows<M>(s.xr, d, v + o.ln3_g, v + o.ln3_b, smem, red);
    gemv<M>(w[4], f, d, smem, v + o.fc1_s, v + o.fc1_b, 1.f, s.hmid, kGelu);
    grid.sync();
    load_rows(s.hmid, M * f, smem);
    gemv<M>(w[5], d, f, smem, v + o.fc2_s, v + o.fc2_b, 1.f, s.xr,
            kResidual);
    grid.sync();
  }
}

template <int M>
cudaError_t launch(const Step& s, size_t smem, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&decode_step_kernel<M>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  Step arg = s;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(fn, dim3(per_sm * sms), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One decoder step; see the note above. hid holds x0 on entry (M rows); the
// rings take the fresh columns in place; align [M, A, K] must be zeroed.
// multi = 1 takes the M rows as tokens pos .. pos+M-1 of one stream, whose
// ring and cross cache have batch 1; cross_shared = 1 (implied by multi)
// gives the cross cache batch 1 under M per-row rings (the beams mode).
// Returns a cudaError_t (0 = launched).
extern "C" int cw_decode_step(
    const void* w_ptrs, const void* vec, void* hid, void* scratch,
    void* ring_k, void* ring_v, void* ring_ks, void* ring_vs,
    const void* cross_k, const void* cross_v, const void* cross_ks,
    const void* cross_vs, const void* align_lh, void* align, int m,
    int n_layers, int d, int f, int h, int dh, int t_ring, int pos,
    int k_enc, int n_align, int cross_int4, int align_bf16, int multi,
    int cross_shared, float qscale, void* stream) {
  if (m < 1 || m > 8 || n_layers < 1 || h < 1 || d != h * dh ||
      (dh != 16 && dh != 32 && dh != 64) || d % 16 != 0 || f % 16 != 0 ||
      pos < 0 || pos + (multi ? m : 1) > t_ring || k_enc < 1 || n_align < 1)
    return (int)cudaErrorInvalidValue;
  const int wide = d > f ? d : f;
  const int tk = t_ring > k_enc ? t_ring : k_enc;
  const size_t gemv_smem = (size_t)m * wide * sizeof(float);
  const size_t attn_smem = (size_t)(64 + tk + kPart) * sizeof(float);
  const size_t smem = gemv_smem > attn_smem ? gemv_smem : attn_smem;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  Step s;
  s.w = static_cast<const int8_t* const*>(w_ptrs);
  s.vec = static_cast<const float*>(vec);
  s.xr = static_cast<float*>(hid);
  s.qkv = sc;
  s.att = s.qkv + (size_t)m * 3 * d;
  s.qc = s.att + (size_t)m * d;
  s.hmid = s.qc + (size_t)m * d;
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
  s.n_layers = n_layers;
  s.d = d;
  s.f = f;
  s.h = h;
  s.dh = dh;
  s.t_ring = t_ring;
  s.pos = pos;
  s.k_enc = k_enc;
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
