// The grouped expert kernel of a mixture-of-experts MLP (ops/moe.py), on
// the tensor cores with mma.sync.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. Two
// launches a call, each over every routed expert at once:
//
// * moe_gate_up_kernel: for a tile of an expert's rows (token ids gathered
//   from `token`), the gate and up products over the model width into two
//   f32 accumulators, then silu(gate) * up in the epilogue, rounded to the
//   activation type and stored as h [pairs, f];
// * moe_down_kernel: h times the expert's down matrix, times each row's
//   routing weight, added with atomics into the f32 output row of its
//   token. A token has at most two routed rows and the output starts at
//   zero, so the sum is the same in either order.
//
// Rows come sorted by expert (ops/moe.expert_pairs): expert e's at
// [offsets[e], offsets[e + 1]); the null experts' and the unkept entries'
// slots lie past offsets[E] and no tile covers them. The grid is an upper
// bound of the row tiles (pairs over the tile rows, plus one an expert)
// times the column tiles; each block finds its expert and rows from the
// offsets on the device, and a block past the last tile returns at once.
// Row tiles are walked in groups of kGroup, each group over every column
// tile, so the blocks on the card at once share their inputs and weight
// tiles in L2.
//
// Each block runs a kStages-deep cp.async pipeline of k tiles (kBK values
// deep; shared-memory rows padded to 144 bytes, so ldmatrix reads eight
// rows without bank conflicts) and m16n8k16 mma.sync with f32
// accumulators. Two tile plans: moe_step_plan (64-row tiles) for decode
// steps, where an expert has tens of rows and each block streams its
// weight tiles once, bound by bytes; moe_block_plan (128-row tiles) for
// prefill blocks of thousands of rows, bound by operations. The plan is a
// template argument, so a device trace names it in the kernel's name.
//
// Contract (checked by ops/moe.py and again here): the width d and the
// expert width f multiples of 128; at most kMaxExperts routed experts;
// activations and weights bf16, weights [E, f, d] (gate, up) and [E, d,
// f] (down), contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;           // values of a k tile
constexpr int kLd = kBK + 8;      // a shared-memory row: 72 values, 144 bytes
constexpr int kStages = 3;
constexpr int kGroup = 8;         // row tiles a group of the grid walks
constexpr int kMaxExperts = 64;

// Tiles: rows BM x columns BN a block, warps WM x WN.
struct moe_step_plan {
  static constexpr int kGuBM = 64, kGuBN = 64, kGuWM = 2, kGuWN = 2;
  static constexpr int kDnBM = 64, kDnBN = 32, kDnWM = 4, kDnWN = 1;
};
struct moe_block_plan {
  static constexpr int kGuBM = 128, kGuBN = 64, kGuWM = 4, kGuWN = 2;
  static constexpr int kDnBM = 128, kDnBN = 128, kDnWM = 4, kDnWN = 2;
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !full.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <int BM, int BN, int WM, int WN, int kMats>
struct Shape {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kWTM = BM / WM, kWTN = BN / WN;
  static constexpr int kMT = kWTM / 16, kNT = kWTN / 8;
  static constexpr int kStageElems = (BM + kMats * BN) * kLd;
  static constexpr int kSmem = kStages * kStageElems * 2;
  static constexpr int kAChunks = BM * (kBK / 8) / kThreads;
  static_assert(kWTM % 16 == 0 && kWTN % 16 == 0, "warp tile");
  static_assert(BM * (kBK / 8) % kThreads == 0, "A chunks");
  static_assert(BN * (kBK / 8) % kThreads == 0, "B chunks");
};

// One block's tile: rows [row0, row_end) of expert e (e < 0: none) and
// the first of its BN columns. Row tiles are numbered over the experts in
// order; the block's linear index walks them kGroup at a time.
template <int BM, int BN>
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets,
                                          int n_exp, int n, int& e_sel,
                                          int& row0, int& row_end, int& n0) {
  const int col_tiles = n / BN;
  const int row_tiles = gridDim.x / col_tiles;
  const int pid = blockIdx.x;
  const int group = pid / (kGroup * col_tiles);
  const int first = group * kGroup;
  const int size = min(row_tiles - first, kGroup);
  const int in_group = pid - group * kGroup * col_tiles;
  const int tile = first + in_group % size;
  n0 = (in_group / size) * BN;
  e_sel = -1;
  row0 = row_end = 0;
  int acc = 0;
  for (int e = 0; e < n_exp; ++e) {
    const int s = offsets[e], t = offsets[e + 1];
    const int nt = (t - s + BM - 1) / BM;
    if (e_sel < 0 && tile < acc + nt) {
      e_sel = e;
      row0 = s + (tile - acc) * BM;
      row_end = t;
    }
    acc += nt;
  }
}

// The grouped product of a tile: A rows (x gathered by token when
// kGated, else h in pair order) times kMats weight matrices [E, n, k],
// then the epilogue: kGated stores silu(A W0^T) * (A W1^T) into h_out
// [pairs, n]; else adds weight[row] * (A W0^T) into out [tokens, n] at
// each row's token.
template <int BM, int BN, int WM, int WN, bool kGated>
__device__ __forceinline__ void grouped_tile(
    const bf16* __restrict__ a_src, const int* __restrict__ token,
    const float* __restrict__ weight, const int* __restrict__ offsets,
    int n_exp, const bf16* __restrict__ w0, const bf16* __restrict__ w1,
    bf16* __restrict__ h_out, float* __restrict__ out, int n, int k) {
  constexpr int kMats = kGated ? 2 : 1;
  using S = Shape<BM, BN, WM, WN, kMats>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  int e, row0, row_end, n0;
  find_tile<BM, BN>(offsets, n_exp, n, e, row0, row_end, n0);
  if (e < 0) return;

  const int tid = threadIdx.x;
  // this thread's A chunks: the same rows at every k tile
  const bf16* a_row[S::kAChunks];
  bool a_live[S::kAChunks];
#pragma unroll
  for (int i = 0; i < S::kAChunks; ++i) {
    const int c = tid + i * S::kThreads;
    const int pair = row0 + c / (kBK / 8);
    a_live[i] = pair < row_end;
    const int src = a_live[i] ? (kGated ? token[pair] : pair) : 0;
    a_row[i] = a_src + (size_t)src * k + (c % (kBK / 8)) * 8;
  }
  const size_t w_base = (size_t)e * n * k + (size_t)n0 * k;
  const bf16* wm[2] = {w0 + w_base, (kGated ? w1 : w0) + w_base};

  auto load = [&](int stage, int kt) {
    bf16* as = smem + stage * S::kStageElems;
#pragma unroll
    for (int i = 0; i < S::kAChunks; ++i) {
      const int c = tid + i * S::kThreads;
      cp16(as + (c / (kBK / 8)) * kLd + (c % (kBK / 8)) * 8,
           a_row[i] + kt * kBK, a_live[i]);
    }
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      bf16* bs = as + (BM + m * BN) * kLd;
#pragma unroll
      for (int c = tid; c < BN * (kBK / 8); c += S::kThreads) {
        const int r = c / (kBK / 8), q = c % (kBK / 8);
        cp16(bs + r * kLd + q * 8, wm[m] + (size_t)r * k + kt * kBK + q * 8,
             true);
      }
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wrow = (warp / WN) * S::kWTM, wcol = (warp % WN) * S::kWTN;
  float acc[kMats][S::kMT][S::kNT][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int i = 0; i < S::kMT; ++i)
#pragma unroll
      for (int j = 0; j < S::kNT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][i][j][v] = 0.f;

  const int n_kt = k / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < n_kt) load(next % kStages, next);
    cp_commit();
    const bf16* as = smem + (kt % kStages) * S::kStageElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[S::kMT][4];
#pragma unroll
      for (int i = 0; i < S::kMT; ++i) {
        ldsm_x4(af[i], as + (wrow + i * 16 + (lane & 15)) * kLd + kk +
                           (lane >> 4) * 8);
      }
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const bf16* bs = as + (BM + m * BN) * kLd;
        uint32_t bf[S::kNT][2];
#pragma unroll
        for (int j = 0; j < S::kNT; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, bs + (wcol + j * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                              kLd +
                          kk + ((lane >> 3) & 1) * 8);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < S::kMT; ++i)
#pragma unroll
          for (int j = 0; j < S::kNT; ++j) mma(acc[m][i][j], af[i], bf[j]);
      }
    }
  }

  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < S::kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pair = row0 + wrow + i * 16 + g + half * 8;
      if (pair >= row_end) continue;
      if (kGated) {
        bf16* dst = h_out + (size_t)pair * n + n0 + wcol + t2;
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
          const float g0 = acc[0][i][j][2 * half];
          const float g1 = acc[0][i][j][2 * half + 1];
          const float u0 = acc[kMats - 1][i][j][2 * half];
          const float u1 = acc[kMats - 1][i][j][2 * half + 1];
          *reinterpret_cast<uint32_t*>(dst + j * 8) =
              pack(g0 / (1.f + expf(-g0)) * u0, g1 / (1.f + expf(-g1)) * u1);
        }
      } else {
        const float wt = weight[pair];
        float* dst = out + (size_t)token[pair] * n + n0 + wcol + t2;
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
          atomicAdd(dst + j * 8, acc[0][i][j][2 * half] * wt);
          atomicAdd(dst + j * 8 + 1, acc[0][i][j][2 * half + 1] * wt);
        }
      }
    }
  }
}

template <typename Plan>
__global__ void __launch_bounds__(Plan::kGuWM* Plan::kGuWN * 32)
    moe_gate_up_kernel(const bf16* __restrict__ x,
                       const int* __restrict__ token,
                       const int* __restrict__ offsets, int n_exp,
                       const bf16* __restrict__ w_gate,
                       const bf16* __restrict__ w_up, bf16* __restrict__ h,
                       int d, int f) {
  grouped_tile<Plan::kGuBM, Plan::kGuBN, Plan::kGuWM, Plan::kGuWN, true>(
      x, token, nullptr, offsets, n_exp, w_gate, w_up, h, nullptr, f, d);
}

template <typename Plan>
__global__ void __launch_bounds__(Plan::kDnWM* Plan::kDnWN * 32)
    moe_down_kernel(const bf16* __restrict__ h, const int* __restrict__ token,
                    const float* __restrict__ weight,
                    const int* __restrict__ offsets, int n_exp,
                    const bf16* __restrict__ w_down, float* __restrict__ out,
                    int d, int f) {
  grouped_tile<Plan::kDnBM, Plan::kDnBN, Plan::kDnWM, Plan::kDnWN, false>(
      h, token, weight, offsets, n_exp, w_down, nullptr, nullptr, out, d, f);
}

// Opts a kernel in to `bytes` of dynamic shared memory, once per device.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

int row_tiles(int pairs, int bm, int n_exp) {
  return (pairs + bm - 1) / bm + n_exp;
}

template <typename Plan>
int launch_gate_up(const void* x, const void* token, const void* offsets,
                   const void* w_gate, const void* w_up, void* h, int pairs,
                   int d, int f, int n_exp, cudaStream_t stream) {
  using S = Shape<Plan::kGuBM, Plan::kGuBN, Plan::kGuWM, Plan::kGuWN, 2>;
  static bool done[64] = {};
  auto kernel = moe_gate_up_kernel<Plan>;
  cudaError_t err = allow_smem(kernel, S::kSmem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = row_tiles(pairs, Plan::kGuBM, n_exp) * (f /
                                                              Plan::kGuBN);
  kernel<<<blocks, S::kThreads, S::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(token),
      static_cast<const int*>(offsets), n_exp,
      static_cast<const bf16*>(w_gate), static_cast<const bf16*>(w_up),
      static_cast<bf16*>(h), d, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename Plan>
int launch_down(const void* h, const void* token, const void* weight,
                const void* offsets, const void* w_down, void* out, int pairs,
                int d, int f, int n_exp, cudaStream_t stream) {
  using S = Shape<Plan::kDnBM, Plan::kDnBN, Plan::kDnWM, Plan::kDnWN, 1>;
  static bool done[64] = {};
  auto kernel = moe_down_kernel<Plan>;
  cudaError_t err = allow_smem(kernel, S::kSmem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = row_tiles(pairs, Plan::kDnBM, n_exp) * (d /
                                                              Plan::kDnBN);
  kernel<<<blocks, S::kThreads, S::kSmem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const int*>(token),
      static_cast<const float*>(weight), static_cast<const int*>(offsets),
      n_exp, static_cast<const bf16*>(w_down), static_cast<float*>(out), d,
      f);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int pairs, int d, int f, int n_exp) {
  return pairs <= 0 || d <= 0 || f <= 0 || d % 128 != 0 || f % 128 != 0 ||
         n_exp <= 0 || n_exp > kMaxExperts;
}

}  // namespace

// plan: 0 = step tiles, 1 = block tiles. Each entry returns a cudaError_t
// (0 = launched).

// h [pairs, f] = silu(x[token] W_gate[e]^T) * (x[token] W_up[e]^T) over
// each expert e's rows; x [tokens, d] bf16, token [pairs] and offsets
// [E + 1] int32, w_gate / w_up [E, f, d] bf16.
extern "C" int cw_moe_gate_up(const void* x, const void* token,
                              const void* offsets, const void* w_gate,
                              const void* w_up, void* h, int pairs, int d,
                              int f, int n_exp, int plan, void* stream) {
  if (bad_shape(pairs, d, f, n_exp) || (plan != 0 && plan != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return plan ? launch_gate_up<moe_block_plan>(
                    x, token, offsets, w_gate, w_up, h, pairs, d, f, n_exp, s)
              : launch_gate_up<moe_step_plan>(
                    x, token, offsets, w_gate, w_up, h, pairs, d, f, n_exp,
                    s);
}

// out [tokens, d] f32 += weight[r] * (h[r] W_down[e]^T) at row token[r],
// over each expert e's rows r; w_down [E, d, f] bf16, weight [pairs] f32.
extern "C" int cw_moe_down(const void* h, const void* token,
                           const void* weight, const void* offsets,
                           const void* w_down, void* out, int pairs, int d,
                           int f, int n_exp, int plan, void* stream) {
  if (bad_shape(pairs, d, f, n_exp) || (plan != 0 && plan != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return plan ? launch_down<moe_block_plan>(
                    h, token, weight, offsets, w_down, out, pairs, d, f,
                    n_exp, s)
              : launch_down<moe_step_plan>(
                    h, token, weight, offsets, w_down, out, pairs, d, f,
                    n_exp, s);
}
