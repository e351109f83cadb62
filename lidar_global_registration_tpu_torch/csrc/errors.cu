// Error text for the codes the launch functions of this library return.
#include <cuda_runtime.h>

extern "C" const char* lgr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
