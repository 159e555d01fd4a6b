// The kernel library's error-string function and its device query: every
// C entry point returns a cudaError_t as an int, and the Python wrappers
// turn a non-zero code into a message through ocm_error_string.

#include <cuda_runtime.h>

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
