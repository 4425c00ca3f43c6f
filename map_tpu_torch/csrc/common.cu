// Shared C entry points of the map_tpu_torch kernel library.
#include <cuda_runtime.h>

extern "C" const char* map_tpu_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
