// Error text for the status codes the kernel entry points return, so the
// Python wrappers can raise with the CUDA runtime's own message.
#include <cuda_runtime.h>

extern "C" const char* spig_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
