// Error text for the codes the kernel entry points return.
#include "common.cuh"

S2C2_API const char* s2c2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
