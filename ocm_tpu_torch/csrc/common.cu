// The kernel library's error-string function, its device query and its
// empty kernel: every C entry point returns a cudaError_t as an int, and
// the Python wrappers turn a non-zero code into a message through
// ocm_error_string.

#include <cuda_runtime.h>

namespace {

__global__ void ocm_noop_kernel() {}

}  // namespace

extern "C" const char* ocm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The SMs of `device` and the most shared memory one block may opt in to;
// the launch plans of ops/kernels.py size their grids and buffers by them.
extern "C" int ocm_device_limits(int device, int* sms, int* smem_optin) {
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  return (int)err;
}

// One launch of an empty kernel (one block of 32 threads) on `stream`: its
// device time, through the same ctypes path as every kernel's, is the
// card's launch floor, the least any launch of the port costs.
extern "C" int ocm_noop(void* stream) {
  ocm_noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
