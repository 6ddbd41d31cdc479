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
// at 3.35 TB/s). This first version is built to be right, not to reach
// that: one block per (row, head) leaves blocks of 256 threads with a
// short serial loop over keys each.
//
// Design: one block per (row, head), 256 threads, Dh = 64. The layer is an
// argument: the block indexes the stacked cache [L, B, H, T, Dh] (packed
// int4: [.., Dh / 2] bytes, the even index in the low nibble) directly, so
// no layer is sliced or copied. Scores: each thread takes keys j = tid,
// tid + 256, ... and reads key j's Dh-contiguous row in 16-byte loads,
// widening int8 and int4 by sign-extending shifts; q sits in registers.
// Scale, position mask (keys after `position` get -1e9) and key mask
// follow, then the block reduces the max and the sum (warp shuffles, then
// shared memory) and forms p = exp(s - max) / sum, the reference's
// division. Where every key is masked the -1e9 scores tie and the row is
// uniform over T, as in the reference. The probabilities go out (all of
// them, or for v3 the aligned rows: the entry zeroes aligned [B, A, T]
// and the block of head h adds sel[h, a] * p into column a where sel[h, a]
// != 0, so a one-hot column gets exactly its head's row, a column no head
// selects stays zero, and a column of several heads gets their weighted
// sum, as the reference's einsum does, in launch order). P.V: thread (d, g) sums p_j * scale_j *
// v_j[d] over keys j = g, g + 4, ... in f32, and the four partial sums of
// each d add in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                  // head dim
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / kD;  // key groups of the P.V sum
constexpr int kMaxKeys = 8192;          // scores live in shared memory
constexpr float kMasked = -1e9f;        // the reference's mask fill

struct Int4Packed {};  // tag of the packed int4 cache (uint8 storage)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element e of a 32-bit word of a cache row, as f32 in the operand dtype.
template <typename C>
struct Elem;
template <>
struct Elem<int8_t> {
  static constexpr int kPerWord = 4;
  __device__ static float get(uint32_t w, int e, bool) {
    return (float)((int)(w << (24 - 8 * e)) >> 24);  // sign-extend byte e
  }
};
template <>
struct Elem<Int4Packed> {
  static constexpr int kPerWord = 8;
  __device__ static float get(uint32_t w, int e, bool) {
    return (float)((int)(w << (28 - 4 * e)) >> 28);  // sign-extend nibble e
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static float get(uint32_t w, int e, bool) {
    return __uint_as_float(e == 0 ? w << 16 : w & 0xFFFF0000u);
  }
};
template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float get(uint32_t w, int, bool op_bf16) {
    const float x = __uint_as_float(w);
    return op_bf16 ? round_bf16(x) : x;
  }
};

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
  int rows, heads, keys, layer, position, has_position, n_align;
  int q_bf16, op_bf16, pv_bf16, out_bf16;
};

__device__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();  // red is free again
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) x = fmaxf(x, red[i]);
  return x;
}

__device__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) x += red[i];
  return x;
}

template <typename C>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args a) {
  using E = Elem<C>;
  constexpr int kRowWords = kD / E::kPerWord;   // 32-bit words a row
  extern __shared__ float sm[];                  // [T]: s, then e, then pv
  __shared__ float red[kWarps];
  __shared__ float part[kGroups][kD];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t = a.keys;
  const size_t bh = (size_t)b * a.heads + h;
  const size_t slab = ((size_t)a.layer * a.rows + b) * a.heads + h;
  const uint32_t* kb = static_cast<const uint32_t*>(a.k) + slab * t * kRowWords;
  const uint32_t* vb = static_cast<const uint32_t*>(a.v) + slab * t * kRowWords;
  const __nv_bfloat16* ks =
      a.k_scale ? static_cast<const __nv_bfloat16*>(a.k_scale) + slab * t
                : nullptr;
  const __nv_bfloat16* vs =
      a.v_scale ? static_cast<const __nv_bfloat16*>(a.v_scale) + slab * t
                : nullptr;
  const uint8_t* km =
      a.key_mask ? static_cast<const uint8_t*>(a.key_mask) + (size_t)b * t
                 : nullptr;

  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const float x =
        a.q_bf16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[bh * kD + d])
            : static_cast<const float*>(a.q)[bh * kD + d];
    qr[d] = a.op_bf16 ? round_bf16(x) : x;
  }

  // scores
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < t; j += kThreads) {
    const uint4* row = reinterpret_cast<const uint4*>(kb + (size_t)j * kRowWords);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kRowWords / 4; ++c) {
      const uint4 w4 = __ldg(row + c);
      const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < E::kPerWord; ++e)
          s = fmaf(qr[(c * 4 + i) * E::kPerWord + e],
                   E::get(w[i], e, a.op_bf16), s);
    }
    if (ks) s *= __bfloat162float(ks[j]);
    if (a.has_position && j > a.position) s = kMasked;
    if (km && km[j] == 0) s = kMasked;
    sm[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_max(mx, red);

  float sum = 0.f;
  for (int j = threadIdx.x; j < t; j += kThreads) {
    const float e = expf(sm[j] - mx);
    sm[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);

  const float* sel = static_cast<const float*>(a.sel);
  float* probs = static_cast<float*>(a.probs);
  float* aligned = static_cast<float*>(a.aligned);
  for (int j = threadIdx.x; j < t; j += kThreads) {
    const float p = sm[j] / sum;
    if (probs) probs[bh * t + j] = p;
    for (int c = 0; c < a.n_align; ++c) {  // aligned starts zeroed
      const float w = sel[h * a.n_align + c];
      if (w != 0.f)
        atomicAdd(aligned + ((size_t)b * a.n_align + c) * t + j, w * p);
    }
    const float pv = vs ? p * __bfloat162float(vs[j]) : p;
    sm[j] = a.pv_bf16 ? round_bf16(pv) : pv;
  }
  __syncthreads();

  // P.V: thread (d, g) over keys g, g + kGroups, ...
  const int d = threadIdx.x % kD;
  const int g = threadIdx.x / kD;
  const int word = d / E::kPerWord;  // the word of row j holding v_j[d]
  const int elem = d % E::kPerWord;
  float acc = 0.f;
#pragma unroll 4
  for (int j = g; j < t; j += kGroups)
    acc = fmaf(sm[j], E::get(__ldg(vb + (size_t)j * kRowWords + word), elem,
                             a.op_bf16),
               acc);
  part[g][d] = acc;
  __syncthreads();
  if (threadIdx.x < kD) {
    float o = part[0][d];
#pragma unroll
    for (int i = 1; i < kGroups; ++i) o += part[i][d];
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[bh * kD + d] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(a.out)[bh * kD + d] = o;
  }
}

template <typename C>
int launch(const Args& a, void* stream) {
  if (a.rows <= 0 || a.heads <= 0 || a.keys <= 0 || a.keys > kMaxKeys ||
      a.layer < 0 || a.n_align < 0 || (a.n_align > 0 && (!a.sel || !a.aligned)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.keys * sizeof(float);
  if (a.n_align > 0) {
    const cudaError_t err = cudaMemsetAsync(
        a.aligned, 0, (size_t)a.rows * a.n_align * a.keys * sizeof(float),
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  decode_attention_kernel<C><<<dim3(a.heads, a.rows), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// v1: q [B, H, 1, 64] f32 or bf16 (q_bf16), int8 k/v [B, H, T, 64], bf16
// scales [B, H, T, 1]; out [B, H, 1, 64] in q's dtype, probs [B, H, T] f32.
// Returns a cudaError_t (0 = launched).
extern "C" int cw_cross_attention_int8(const void* q, const void* k,
                                       const void* k_scale, const void* v,
                                       const void* v_scale, void* out,
                                       void* probs, int b, int h, int t,
                                       int q_bf16, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, nullptr, nullptr, out, probs,
               nullptr, b, h, t, 0, 0, 0, 0, q_bf16, q_bf16, 1, q_bf16};
  return launch<int8_t>(a, stream);
}

// v2: as v1, with q rounded to bf16 before the product.
extern "C" int cw_cross_attention_int8_v2(const void* q, const void* k,
                                          const void* k_scale, const void* v,
                                          const void* v_scale, void* out,
                                          void* probs, int b, int h, int t,
                                          int q_bf16, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, nullptr, nullptr, out, probs,
               nullptr, b, h, t, 0, 0, 0, 0, q_bf16, 1, 1, q_bf16};
  return launch<int8_t>(a, stream);
}

// v3: q [B, H, 64] f32 or bf16; k/v [L, B, H, T, 64] of cache_kind 0 int8,
// 1 packed int4 (uint8 [.., 32]), 2 bf16, 3 f32; scales [L, B, H, T] bf16
// or null; key_mask [B, T] bytes or null; sel [H, A] f32 or null (n_align
// = A); out [B, H, 64] f32, aligned [B, A, T] f32. Keys after `position`
// are masked when has_position.
extern "C" int cw_decode_gemv_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* key_mask, const void* sel, void* out,
    void* aligned, int cache_kind, int l, int b, int h, int t, int layer,
    int position, int has_position, int n_align, int q_bf16, void* stream) {
  if (layer >= l) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, key_mask, sel, out, nullptr,
               aligned, b, h, t, layer, position, has_position, n_align,
               q_bf16, q_bf16, q_bf16, 0};
  switch (cache_kind) {
    case 0: return launch<int8_t>(a, stream);
    case 1: return launch<Int4Packed>(a, stream);
    case 2: return launch<__nv_bfloat16>(a, stream);
    case 3: return launch<float>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
