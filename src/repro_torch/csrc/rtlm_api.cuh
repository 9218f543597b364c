// The C interface every kernel library of the port exports beside its
// launcher: CUDA error code -> message.  Each library is one translation
// unit that includes this header once.  A launcher returns 0 or the
// cudaError_t of its launch; the Python side (kernels/_build.py) turns a
// non-zero code into an exception with this message.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* rtlm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
