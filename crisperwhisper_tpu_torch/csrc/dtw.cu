// DTW over the alignment cost matrix: cost DP, 2-bit trace and backtrace.
//
// Replaces the TPU kernel crisperwhisper_tpu/ops/pallas_dtw.py
// (pallas_dtw_jump_times -> _dtw_kernel), which walked the batch items one
// after another on one TPU core over a pre-sheared, diagonal-major copy of
// the matrix.
//
// What bounds it on the H100: a chain. The DP walks nt + nf - 1 dependent
// anti-diagonals of the live rectangle (about 1,600-1,900 for a Whisper
// window), each a few cells' adds and three-way compares; the bytes
// (nt x nf f32 once) take well under a microsecond. So the time is what
// one diagonal costs on the critical path, times the diagonals, plus the
// backtrace's dependent steps. A diagonal needs one cell of every row:
// fetched a cell a row, a diagonal waits on a memory round trip, which is
// what held the one-block kernel this replaces to about 1,000 cycles a
// diagonal.
//
// Design: one block per batch item; warp w owns the band of token rows
// 32 w + 1 .. 32 w + 32, one row a lane, and the wrapper takes a warp per
// 32 rows (N <= 32 kMaxWarps = 512; Whisper's N is at most 448). Measured
// on the H100, more warps of one row a lane beat fewer warps of several
// rows: each warp issues its own cells on its own scheduler.
//   - Only the live rectangle [0, nt] x [0, nf] is walked: every cell there
//     depends only on cells above and to its left, and the backtrace starts
//     at (nt, nf), so no cell outside it is read and the caller need not
//     mask.
//   - No block barrier inside the diagonal loop. A lane's cell of one
//     diagonal needs the row above, the previous lane's, one
//     __shfl_up_sync a diagonal; the lane keeps its own row on the last
//     diagonal and the row above on the one before in registers. The walk
//     goes K diagonals a step (K = 16 where its ring fits in shared
//     memory, else 8; a template argument), unrolled, so the per-step work
//     below is paid once per K.
//   - Cost cells arrive ahead of the wavefront, in chunks: each row has a
//     ring of three K-column chunks in shared memory, and each step a
//     lane whose row has started copies the chunk after the next one
//     (cp.async, 16-byte copies where rows are 16-byte aligned, else
//     4-byte; one group a step, cp.async.wait_group 1), so a chunk lands
//     K + 1 to 2 K diagonals before its first column is used and the walk
//     reads shared memory only. Chunks 0 and 1 are copied before the walk;
//     a row that has not started, or is not live, copies nothing, so no
//     two copies in flight ever write one slot. A lane copies only its own
//     row: no warp barrier. The lanes' ring reads are kRing - 1 (odd)
//     floats apart, on 32 distinct banks.
//   - Between warps the last row of a band goes through a shared-memory
//     ring of kQueueSteps steps of values with two counters: the warp
//     above publishes `made` after each step (a release store), the warp
//     below waits once a step until the entries it needs are made (an
//     acquire load) and reports what it read (`used`), and the warp above
//     waits for `used` before it overwrites. Both waits are warp-uniform
//     spins; one that lasts kSpinLimit observations traps, so a hand-off
//     that never comes fails the launch instead of giving a wrong path.
//   - The trace stays on chip, 2 bits a cell (0 diagonal, 1 up, 2 left),
//     row-major in 32-bit words of 16 columns: n x ceil(m / 16) words of
//     dynamic shared memory (168 KB at 448 x 1500). A lane gathers its
//     row's codes in a register and stores a word when it fills.
//   - The backtrace is warp 0 over shared memory, every lane on the same
//     path (lane 0 stores). Moving left is the common step: the walk finds
//     a row's next "not left" code in a word with one __clz, so it loads
//     about nt + nf / 16 words, not nt + nf.
// The recurrence and tie-break are those of crisperwhisper_tpu/ops/
// alignment.py dtw_trace: take the diagonal only on strict < against both
// others, else "up" only on strict <, else "left"; each cell is one IEEE
// f32 add (__fadd_rn), so the result matches the plain version exactly.
// Rows >= nt of the output hold the last valid value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRingChunks = 3;      // chunks in a row's ring
constexpr int kQueueSteps = 4;      // hand-off ring a warp boundary, in steps
constexpr int kMaxWarps = 16;
constexpr int kMaxSmem = 232448;    // 227 KB of shared memory a block (H100)

// Observations of a hand-off counter before the wait traps (about a second
// at 1 << 26). A test build sets it to 0, so the first wait traps.
#ifndef CW_DTW_SPIN_LIMIT
#define CW_DTW_SPIN_LIMIT (1ll << 26)
#endif
constexpr long long kSpinLimit = CW_DTW_SPIN_LIMIT;

constexpr unsigned kFull = 0xffffffffu;

// k: diagonals a step and columns a chunk (8 or 16)
size_t dtw_smem(int n, int m, int warps, int k) {
  return (size_t)warps * 32 * kRingChunks * k * 4  // chunk rings
         + (size_t)n * ((m + 15) / 16) * 4       // 2-bit trace
         + (size_t)(warps - 1) * kQueueSteps * k * 4  // hand-off rings
         + (size_t)warps * 2 * 4;                     // made, used
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// 16- and 4-byte cp.async that read `bytes` of them (the rest of the
// destination is zero-filled; 0 reads nothing)
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// The hand-off counters: a release store after the entries it publishes
// (or the reads it reports), an acquire load before the reads (or stores)
// it allows, at block scope.
__device__ __forceinline__ void publish(int* counter, int v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(counter);
  asm volatile("st.release.cta.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ int observe(const int* counter) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(counter);
  int v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a)
               : "memory");
  return v;
}

// Waits until *counter >= target; traps after kSpinLimit observations
// (the launch then fails, and the next synchronization reports it).
__device__ __forceinline__ void wait_for(const int* counter, int target) {
  for (long long spin = 0; observe(counter) < target; ++spin)
    if (spin == kSpinLimit) __trap();
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies chunk q of row i (columns K q .. K q + K - 1, those < nf) into
// the row's ring slot q mod 3; a chunk past nf copies nothing.
template <int K>
__device__ __forceinline__ void copy_chunk(float* row_ring, const float* mb,
                                           int i, int q, int nf, int m,
                                           bool vec) {
  const int col = K * q;
  const int n = min(nf - col, K);
  if (n <= 0) return;
  float* dst = row_ring + K * (q % kRingChunks);
  const float* src = mb + ((i - 1) * m + col);
  if (vec) {
#pragma unroll
    for (int e = 0; e < K; e += 4)
      copy16(dst + e, n > e ? src + e : src, 4 * min(max(n - e, 0), 4));
  } else {
#pragma unroll
    for (int e = 0; e < K; ++e)
      copy4(dst + e, n > e ? src + e : src, n > e ? 4 : 0);
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
    dtw_kernel(const float* __restrict__ mat, const int* __restrict__ n_tokens,
               const int* __restrict__ n_frames, int* __restrict__ out,
               unsigned long long* __restrict__ stamps, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int tw = (m + 15) / 16;  // trace words a row
  constexpr int kRing = kRingChunks * K;  // ring columns a row
  float* ring = reinterpret_cast<float*>(smem);  // [warps * 32][kRing]
  unsigned* trace = reinterpret_cast<unsigned*>(ring + kRing * blockDim.x);
  // [warps - 1][kQueue]: the last row of band w for band w + 1, by
  // diagonal mod kQueue
  constexpr int kQueue = kQueueSteps * K;
  float* queue = reinterpret_cast<float*>(trace + (size_t)n * tw);
  // made[w]: the last diagonal band w has published; used[w]: the last
  // entry band w has read from band w - 1's queue
  int* made = reinterpret_cast<int*>(queue + (warps - 1) * kQueue);
  int* used = made + warps;

  if (stamps != nullptr && threadIdx.x == 0) stamps[3 * b] = globaltimer();
  const int nt = min(max(n_tokens[b], 0), n);
  const int nf = min(max(n_frames[b], 0), m);
  const float* mb = mat + (size_t)b * n * m;
  int* ob = out + (size_t)b * n;
  const bool vec =
      (m & 3) == 0 && (reinterpret_cast<uintptr_t>(mat) & 15) == 0;

  const int top = 1 + warp * 32;  // the band's first row (row 0 is the
  const int bottom = top + 31;    // boundary)
  const int i = top + lane;       // the lane's row
  float* mine = ring + threadIdx.x * kRing;
  if (lane == 0) {
    made[warp] = top - 1;
    used[warp] = top - 1;  // entries before the band's first are not read
  }
  __syncthreads();  // once, before the walk

  if (top <= nt) {  // the band holds live rows (warp-uniform)
    const float inf = INFINITY;
    const int lim = min(nt, bottom);  // the band's last live row
    const bool row_live = i <= lim;
    const int d_start = top + 1;
    const int d_end = lim + nf;
    const bool produce = warp + 1 < warps && bottom < nt;
    float* q_in = queue + (warp - 1) * kQueue;  // read when warp > 0
    float* q_out = queue + warp * kQueue;       // written when produce
    float p1 = inf;   // the lane's row on diagonal d - 1
    unsigned acc = 0;  // trace codes of the word being filled
    if (row_live) {    // chunks 0 and 1 before the walk
      copy_chunk<K>(mine, mb, i, 0, nf, m, vec);
      copy_chunk<K>(mine, mb, i, 1, nf, m, vec);
    }
    commit();
    wait_groups<0>();
    // the row above on diagonal d - 2 when diagonal d starts: cost[0][0] =
    // 0 for the first row, else a cell left of column 1, inf
    float up = (warp == 0 && lane == 0) ? 0.f : inf;

    for (int D = d_start; D <= d_end; D += K) {
      // the row is in chunk floor(c / K) at diagonal D; once it has
      // started it copies the chunk after the next
      const int c = D - i - 1;
      if (row_live && c >= 0) copy_chunk<K>(mine, mb, i, c / K + 2, nf, m, vec);
      commit();
      wait_groups<1>();  // the previous step's chunk landed
      const int slot0 = ((c % kRing) + kRing) % kRing;  // the step's first
      const int d_last = min(D + K - 1, d_end);
      // the entries d - 1 this step reads are made; the entries this step
      // overwrites were read
      if (warp > 0) wait_for(made + warp - 1, min(d_last - 1, top - 1 + nf));
      if (produce) wait_for(used + warp + 1, d_last - kQueue);
      // the step's inputs, read before any shared store of the step so
      // that no load waits behind one: the row's cells, and the band
      // above's last row (one broadcast read for the warp)
      float xs[K];
      float ab[K];
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int d = D + u;
        const int col = slot0 + u;
        xs[u] = mine[col < kRing ? col : col - kRing];
        const int j = d - top;
        ab[u] =
            warp > 0 && j >= 1 && j <= nf ? q_in[(d - 1) & (kQueue - 1)] : inf;
      }
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int d = D + u;
        if (d > d_end) break;
        // the row above on diagonal d - 1: the previous lane's row; for
        // lane 0 the boundary row (inf from column 1 on) or the band
        // above's last row
        float u1 = __shfl_up_sync(kFull, p1, 1);
        u1 = lane == 0 ? ab[u] : u1;
        const float c0 = up;  // cost[i-1][j-1]
        const float c1 = u1;  // cost[i-1][j]
        const float c2 = p1;  // cost[i][j-1]
        up = u1;
        const int col = d - i - 1;  // cell (i, col + 1) of the DP
        // diagonal only on c0 < c1 and c0 < c2, else up only on c1 < c0
        // and c1 < c2, else left; c0 < c2 is known before c1 arrives
        const bool pre = c0 < c2;
        const bool take1 = c1 < (pre ? c0 : c2);
        const bool take0 = pre && c0 < c1;
        const float cmin = take1 ? c1 : (take0 ? c0 : c2);
        const unsigned code = take1 ? 1u : (take0 ? 0u : 2u);
        const bool live = (unsigned)col < (unsigned)nf && i <= nt;
        const float cur = live ? __fadd_rn(xs[u], cmin) : inf;
        acc |= live ? code << (2 * (col & 15)) : 0u;
        const bool flush = live && ((col & 15) == 15 || col == nf - 1);
        if (flush) trace[(i - 1) * tw + (col >> 4)] = acc;
        acc = flush ? 0u : acc;
        if (produce && lane == 31) q_out[d & (kQueue - 1)] = cur;
        p1 = cur;
      }
      if (produce && lane == 31) publish(made + warp, d_last);
      if (warp > 0 && lane == 0)
        publish(used + warp, min(d_last - 1, top - 1 + nf));
    }
  }
  __syncthreads();  // once, after the walk: the trace is complete
  __syncwarp();     // the backtrace runs on a converged warp
  if (stamps != nullptr && threadIdx.x == 0) stamps[3 * b + 1] = globaltimer();

  if (warp != 0) return;
  // every lane walks the same path (broadcast reads, no divergence); lane
  // 0 stores
  int r = nt;
  int j = nf;
  int last = 0;  // rows >= nt: the value of row nt - 1 (0 when nt == 0)
  while (r > 0 && j > 0) {
    const int col = j - 1;
    const unsigned word = trace[(size_t)(r - 1) * tw + (col >> 4)];
    const int f = col & 15;
    // fields 0..f whose code is not "left" (2: its high bit set)
    const unsigned mask = f == 15 ? kFull : (1u << (2 * f + 2)) - 1u;
    const unsigned stop = ~word & 0xaaaaaaaau & mask;
    if (stop == 0) {  // left through the rest of the word
      j = col & ~15;
      continue;
    }
    const int g = (31 - __clz(stop)) >> 1;
    j = (col & ~15) + g + 1;
    // the walk leaves row r at (r, j): token r - 1's first arrival
    if (lane == 0) ob[r - 1] = j - 1;
    if (r == nt) last = j - 1;
    if (((word >> (2 * g)) & 3u) == 0) --j;  // diagonal, else up
    --r;
  }
  for (; r > 0; --r) {  // column 0 reached: straight up, frame 0
    if (lane == 0) ob[r - 1] = 0;
    if (r == nt) last = 0;
  }
  for (int t = nt + lane; t < n; t += 32) ob[t] = last;
  if (stamps != nullptr && lane == 0) stamps[3 * b + 2] = globaltimer();
}

template <int K>
int launch(const float* mat, const int* n_tokens, const int* n_frames,
           int* out, unsigned long long* stamps, int b, int n, int m,
           int warps, cudaStream_t stream) {
  const size_t smem = dtw_smem(n, m, warps, K);
  const cudaError_t attr = cudaFuncSetAttribute(
      dtw_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dtw_kernel<K><<<b, warps * 32, smem, stream>>>(mat, n_tokens, n_frames, out,
                                                 stamps, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

// mat [B, N, M] f32, n_tokens/n_frames [B] i32, out [B, N] i32, stamps
// [B, 3] u64 globaltimer (start, walk done, backtrace done) or null.
// `warps` warps a block, one token row a lane: warps * 32 >= N; `step`
// diagonals a step, 8 or 16.
// Returns a cudaError_t (0 = launched).
extern "C" int cw_dtw(const void* mat, const void* n_tokens,
                      const void* n_frames, void* out, void* stamps, int b,
                      int n, int m, int warps, int step, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || warps < 1 || warps > kMaxWarps ||
      warps * 32 < n || (step != 8 && step != 16) ||
      dtw_smem(n, m, warps, step) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(mat);
  const int* nt = static_cast<const int*>(n_tokens);
  const int* nf = static_cast<const int*>(n_frames);
  int* o = static_cast<int*>(out);
  unsigned long long* s = static_cast<unsigned long long*>(stamps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return step == 16 ? launch<16>(x, nt, nf, o, s, b, n, m, warps, st)
                    : launch<8>(x, nt, nf, o, s, b, n, m, warps, st);
}
