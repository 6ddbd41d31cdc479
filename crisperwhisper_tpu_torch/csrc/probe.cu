// The compile probe's kernel: out = x * 2, elementwise, f32.
//
// Replaces the TPU kernel scripts/probe_pallas_compile.py (pallas_add,
// body `o_ref[...] = x_ref[...] * 2.0` on one (8, 128) f32 tile), which
// checked that the Mosaic backend compiles and runs a trivial kernel.
// Here it checks the same of nvcc, the ctypes binding and a launch on
// the card (crisperwhisper_tpu_torch/probe.py).
//
// What bounds it on the H100: an (8, 128) tile is 4 KB in and 4 KB out,
// so its time is the launch's latency, and a call's is the host's: the
// kernel goes to cuLaunchKernel directly (launch.cuh). One thread per
// element; doubling an f32 is exact, so the result equals the plain
// `x * 2.0` bit for bit.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void probe_add_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f;
}

}  // namespace

// x, out: n contiguous f32 values. Returns a cudaError_t or the
// CUresult of cuLaunchKernel (0 = launched).
extern "C" int cw_probe_add(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  static cw::Handles handles;
  const float* in = static_cast<const float*>(x);
  float* res = static_cast<float*>(out);
  void* args[] = {&in, &res, &n};
  return cw::launch((const void*)probe_add_kernel, handles,
                    dim3((n + threads - 1) / threads), dim3(threads),
                    static_cast<cudaStream_t>(stream), args);
}
