// Error text for the status codes the kernel entry points return.
#include "common.cuh"

ST_EXPORT const char* st_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
