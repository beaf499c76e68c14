// Error reporting shared by the kernel library's C entry points.
//
// Every entry point returns cudaGetLastError() after its launches; the
// Python wrapper turns a non-zero code into an exception whose message comes
// from here.

#include <cuda_runtime.h>

extern "C" const char* tdorch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
