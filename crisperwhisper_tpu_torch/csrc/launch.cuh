// The lean launch of kernels whose own time on the card is a few
// microseconds (the ring writes, the probe): cuLaunchKernel, reached once
// through cudaGetDriverEntryPoint (so the library needs no -lcuda), on the
// kernel's CUfunction, looked up once per device. The runtime's <<<>>>
// does the same after pushing and popping the launch configuration and
// finding the kernel's handle for the current context, host work that
// weighs on a kernel this short.
//
// Usage, in the C entry of a kernel `k`:
//   static cw::Handles handles;
//   void* args[] = {&a, &b, ...};
//   return cw::launch((const void*)k, handles, grid, block, stream, args);

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>

namespace cw {

constexpr int kMaxDevices = 64;

typedef CUresult (*LaunchKernelFn)(CUfunction, unsigned, unsigned, unsigned,
                                   unsigned, unsigned, unsigned, unsigned,
                                   CUstream, void**, void**);

// cuLaunchKernel, or nullptr when it is not found.
inline LaunchKernelFn launch_kernel_fn() {
  static const LaunchKernelFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuLaunchKernel", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuLaunchKernel", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<LaunchKernelFn>(p)
               : nullptr;
  }();
  return fn;
}

// One kernel's CUfunction on each device, found at its first launch there.
struct Handles {
  std::atomic<void*> fn[kMaxDevices] = {};
};

// Launches `kernel` (a __global__ function's address) with no dynamic
// shared memory on the current device. Returns a cudaError_t or the
// CUresult of cuLaunchKernel (0 = launched).
inline int launch(const void* kernel, Handles& handles, dim3 grid,
                  dim3 block, cudaStream_t stream, void** args) {
  const LaunchKernelFn fn = launch_kernel_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  void* f = handles.fn[dev].load(std::memory_order_acquire);
  if (f == nullptr) {
    cudaFunction_t found;
    err = cudaGetFuncBySymbol(&found, kernel);
    if (err != cudaSuccess) return (int)err;
    f = reinterpret_cast<void*>(found);
    handles.fn[dev].store(f, std::memory_order_release);
  }
  return (int)fn(static_cast<CUfunction>(f), grid.x, grid.y, grid.z,
                 block.x, block.y, block.z, 0,
                 reinterpret_cast<CUstream>(stream), args, nullptr);
}

}  // namespace cw
