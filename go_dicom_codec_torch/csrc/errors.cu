// Message for a CUDA error code returned by one of the launch entries.

#include <cuda_runtime.h>

extern "C" const char* gdct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
