// Error text for the codes the kernel entry points return (cudaError_t).

#include <cuda_runtime.h>

extern "C" const char* gs360x_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
