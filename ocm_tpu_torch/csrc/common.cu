// The one error-string function of the kernel library: every C entry
// point returns a cudaError_t as an int, and the Python wrappers turn a
// non-zero code into a message through this.

#include <cuda_runtime.h>

extern "C" const char* ocm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
