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
// Grid: x over the B * H runs, y over the pairs; a block's threads stride
// over the run's vectors. Slots outside [0, T) are skipped: the caller
// checks the positions, and the guard keeps a bad one from writing outside
// the ring.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairs = 4;
constexpr int kThreads = 128;

struct Pairs {
  char* ring[kMaxPairs];
  const char* blk[kMaxPairs];
  int col[kMaxPairs];    // bytes per column
  int width[kMaxPairs];  // bytes per store: 16, 8, 4, 2 or 1
};

template <typename V>
__device__ void copy_run(char* dst, const char* src, int n_bytes) {
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  for (int i = threadIdx.x; i < n_bytes / (int)sizeof(V); i += blockDim.x)
    d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
    ring_write_kernel(const Pairs p, const int* __restrict__ pos, int b_rows,
                      int heads, int t_ring, int s, int layer) {
  const int j = blockIdx.y;
  const int bh = blockIdx.x;              // row * heads + head
  const int row = bh / heads;
  const int slot = pos[row];
  if (slot < 0 || slot + s > t_ring) return;
  const long long col = p.col[j];
  const long long run = col * s;
  char* dst = p.ring[j] +
              (((long long)layer * b_rows * heads + bh) * t_ring + slot) * col;
  const char* src = p.blk[j] + (long long)bh * run;
  switch (p.width[j]) {
    case 16: copy_run<uint4>(dst, src, (int)run); break;
    case 8: copy_run<uint2>(dst, src, (int)run); break;
    case 4: copy_run<uint32_t>(dst, src, (int)run); break;
    case 2: copy_run<uint16_t>(dst, src, (int)run); break;
    default: copy_run<uint8_t>(dst, src, (int)run); break;
  }
}

}  // namespace

// Writes block j into ring j at [layer, b, :, pos[b] : pos[b] + s) for every
// pair j < n_pairs and row b < b_rows. Returns a cudaError_t (0 = launched).
extern "C" int cw_ring_write(
    void* ring0, void* ring1, void* ring2, void* ring3, const void* blk0,
    const void* blk1, const void* blk2, const void* blk3, int col0, int col1,
    int col2, int col3, int width0, int width1, int width2, int width3,
    int n_pairs, const void* pos, int b_rows, int heads, int t_ring, int s,
    int layer, void* stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || b_rows < 1 || heads < 1 ||
      s < 1 || s > t_ring || layer < 0 || b_rows * heads > 2147483647 / 2)
    return (int)cudaErrorInvalidValue;
  Pairs p;
  void* rings[kMaxPairs] = {ring0, ring1, ring2, ring3};
  const void* blks[kMaxPairs] = {blk0, blk1, blk2, blk3};
  const int cols[kMaxPairs] = {col0, col1, col2, col3};
  const int widths[kMaxPairs] = {width0, width1, width2, width3};
  for (int j = 0; j < kMaxPairs; ++j) {
    p.ring[j] = static_cast<char*>(rings[j]);
    p.blk[j] = static_cast<const char*>(blks[j]);
    p.col[j] = cols[j];
    p.width[j] = widths[j];
    if (j < n_pairs && (rings[j] == nullptr || blks[j] == nullptr ||
                        cols[j] < 1 || cols[j] % widths[j] != 0))
      return (int)cudaErrorInvalidValue;
  }
  ring_write_kernel<<<dim3(b_rows * heads, n_pairs), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(pos), b_rows, heads, t_ring, s, layer);
  return (int)cudaGetLastError();
}
