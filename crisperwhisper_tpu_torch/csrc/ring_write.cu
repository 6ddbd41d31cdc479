// Per-row block writes into the self-attention rings, in place.
//
// Replaces the TPU kernel crisperwhisper_tpu/ops/ring_scatter.py (_dma_call,
// reached from write_block_columns_group through _write_dma_group). That
// kernel issued one async DMA per (row, tensor) from VMEM into the rings
// left in HBM. Here one launch per layer covers up to four (ring, block)
// pairs (K, V and, for a quantized ring, both scale rings) for every row.
//
// Layouts (ops/ring_write.py): a ring is [L, B, H, T, tail], a block
// [B, H, S, tail], where a column of `col` bytes is a contiguous run (Dh
// values of the ring's dtype, Dh/2 bytes of packed int4, or one bf16
// scale). Row b's S columns of head h are therefore one contiguous run of
// S * col bytes in the block and in the ring at slot pos[b], so each
// (pair, row, head) is one memcpy of a few hundred bytes.
//
// What bounds it on the H100: the bytes, each block byte read once and
// written once; at large-v3, batch 16 and S = 5 that is about 0.8 MB per
// layer, well under a microsecond at 3.35 TB/s, so a launch costs more than
// the copy. The design keeps it to one launch per layer (all pairs, all
// rows), reads the positions from device memory (no host sync), and moves
// each run with the widest store that its column size and the base
// addresses allow (16 bytes for int8, bf16 and f32 K/V columns).
//
// The launch is the cost, so the host side is lean too: what is fixed for
// a set of rings (their addresses, column bytes, rows, heads, ring length)
// is packed once into a RingPlan that the wrapper keeps
// (ops/ring_write.py: ring_plan), a call passes a pointer to it, the
// block pointers, the positions, S, the layer and the store widths, and
// the kernel goes to cuLaunchKernel directly (launch.cuh).
//
// Grid: x over the B * H runs, y over the pairs; a block's threads stride
// over the run's vectors, each loading its first vector before it reads
// the row's slot, so the two loads are in flight together. Slots outside
// [0, T) are skipped: the caller checks the positions, and the guard keeps
// a bad one from writing outside the ring.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

constexpr int kMaxPairs = 4;

// What stays fixed for one set of rings; ops/ring_write.py's PlanStruct
// mirrors it field for field (a CPU test reads this declaration).
struct RingPlan {
  char* ring[kMaxPairs];  // ring j's base, [layers, rows, heads, t_ring, tail]
  int col[kMaxPairs];     // bytes per column of ring j
  int n_pairs;
  int layers;
  int rows;
  int heads;
  int t_ring;
};

namespace {

constexpr int kThreads = 128;

struct Pairs {
  char* ring[kMaxPairs];
  const char* blk[kMaxPairs];
  int col[kMaxPairs];    // bytes per column
  int width[kMaxPairs];  // bytes per store: 16, 8, 4, 2 or 1
};

// Copies one run of n_bytes from src to ring_row at slot pos[row] (in
// columns of col bytes), V at a time.
template <typename V>
__device__ void copy_run(char* ring_row, long long col, const char* src,
                         int n_bytes, const int* __restrict__ pos, int row,
                         int s, int t_ring) {
  const V* sv = reinterpret_cast<const V*>(src);
  const int n = n_bytes / (int)sizeof(V);
  int i = threadIdx.x;
  V first;
  if (i < n) first = sv[i];
  const int slot = pos[row];
  if (slot < 0 || slot + s > t_ring) return;
  V* d = reinterpret_cast<V*>(ring_row + slot * col);
  if (i < n) d[i] = first;
  for (i += blockDim.x; i < n; i += blockDim.x) d[i] = sv[i];
}

__global__ void __launch_bounds__(kThreads)
    ring_write_kernel(const Pairs p, const int* __restrict__ pos, int b_rows,
                      int heads, int t_ring, int s, int layer) {
  const int j = blockIdx.y;
  const int bh = blockIdx.x;              // row * heads + head
  const int row = bh / heads;
  const long long col = p.col[j];
  const long long run = col * s;
  char* ring_row =
      p.ring[j] + (((long long)layer * b_rows * heads + bh) * t_ring) * col;
  const char* src = p.blk[j] + (long long)bh * run;
  const int n = (int)run;
  switch (p.width[j]) {
    case 16: copy_run<uint4>(ring_row, col, src, n, pos, row, s, t_ring);
      break;
    case 8: copy_run<uint2>(ring_row, col, src, n, pos, row, s, t_ring);
      break;
    case 4: copy_run<uint32_t>(ring_row, col, src, n, pos, row, s, t_ring);
      break;
    case 2: copy_run<uint16_t>(ring_row, col, src, n, pos, row, s, t_ring);
      break;
    default: copy_run<uint8_t>(ring_row, col, src, n, pos, row, s, t_ring);
      break;
  }
}

}  // namespace

// Writes block j into ring j at [layer, b, :, pos[b] : pos[b] + s) for every
// pair j < plan->n_pairs and row b < plan->rows. Byte j of `widths` is pair
// j's store width for this call (16, 8, 4, 2 or 1; the plan's widest,
// lowered by the wrapper where a block is less aligned). Returns a
// cudaError_t or the CUresult of cuLaunchKernel (0 = launched).
extern "C" int cw_ring_write(const RingPlan* plan, const void* blk0,
                             const void* blk1, const void* blk2,
                             const void* blk3, const void* pos, int s,
                             int layer, int widths, void* stream) {
  if (plan == nullptr || pos == nullptr || plan->n_pairs < 1 ||
      plan->n_pairs > kMaxPairs || plan->rows < 1 || plan->heads < 1 ||
      s < 1 || s > plan->t_ring || layer < 0 || layer >= plan->layers ||
      plan->rows * (long long)plan->heads > 2147483647 / 2)
    return (int)cudaErrorInvalidValue;
  Pairs p;
  const void* blks[kMaxPairs] = {blk0, blk1, blk2, blk3};
  for (int j = 0; j < kMaxPairs; ++j) {
    const int w = (widths >> (8 * j)) & 0xFF;
    p.ring[j] = plan->ring[j];
    p.blk[j] = static_cast<const char*>(blks[j]);
    p.col[j] = plan->col[j];
    p.width[j] = w;
    if (j < plan->n_pairs &&
        (p.ring[j] == nullptr || p.blk[j] == nullptr || p.col[j] < 1 ||
         (w != 1 && w != 2 && w != 4 && w != 8 && w != 16) ||
         p.col[j] % w != 0 || (uintptr_t)p.ring[j] % w != 0 ||
         (uintptr_t)p.blk[j] % w != 0))
      return (int)cudaErrorInvalidValue;
  }
  static cw::Handles handles;
  const int* rows_pos = static_cast<const int*>(pos);
  int rows = plan->rows, heads = plan->heads, t_ring = plan->t_ring;
  void* args[] = {&p, &rows_pos, &rows, &heads, &t_ring, &s, &layer};
  return cw::launch((const void*)ring_write_kernel, handles,
                    dim3(rows * heads, plan->n_pairs), dim3(kThreads),
                    static_cast<cudaStream_t>(stream), args);
}
