// Host code shared by the port's attention kernels: every csrc/*.cu that
// includes this header.  _build.py hashes the shared headers into every
// library's name, so an edit here rebuilds all of them.
#pragma once

#include <cuda_runtime.h>

namespace rtlm {

// Let `kernel` take `bytes` of dynamic shared memory (above the 48 KB a
// kernel gets without asking).
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rtlm
