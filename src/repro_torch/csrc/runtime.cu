// Error text for the status codes the kernel launchers return.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
