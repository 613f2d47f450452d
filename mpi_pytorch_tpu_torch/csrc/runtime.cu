// Shared C entry point of the kernel library: readable CUDA error names for
// the Python wrappers (ops/_build.py check()).
#include <cuda_runtime.h>

extern "C" const char* mpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
