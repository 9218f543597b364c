// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py, rms_norm / _rms_kernel (Pallas,
//   TPU).
//
// What it computes, for every row of x (N, D):
//   out = x * rsqrt(mean(x^2) + eps) * (1 + w)
// with the reduction and the scaling in float32 and the result cast to
// x's dtype, in the order models.layers.rms_norm uses:
// (x * rsqrt(var + eps)) * (1 + w).  x and w are each bf16 or float32.
//
// What bounds it on the H100: memory.  Each element is read once and
// written once for ~4 float32 operations, two orders of magnitude below
// the card's operations-per-byte ridge.
//
// What the design does about it: one CTA per row, so a row is read from
// device memory once (the second pass over it, after the block-wide sum of
// squares, is served by L1/L2) and written once, with neighbouring threads
// on neighbouring elements.  The Pallas kernel's (block_rows, D) VMEM tile
// becomes one row per CTA: at D = 3072 a CTA of 256 threads takes 12
// elements per thread, and N rows give N CTAs to spread over 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rtlm_api.cuh"

namespace {

constexpr int kThreads = 256;

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ inline T from_f(float v);
template <>
__device__ inline float from_f<float>(float v) { return v; }
template <>
__device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TX, typename TW>
__global__ void rms_norm_kernel(const TX* __restrict__ x,
                                const TW* __restrict__ w,
                                TX* __restrict__ out, int D, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const TX* xr = x + (int64_t)blockIdx.x * D;
  TX* orow = out + (int64_t)blockIdx.x * D;

  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = to_f(xr[d]);
    ss = fmaf(v, v, ss);
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += warp_sums[i];
    inv_rms = rsqrtf(t / (float)D + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    orow[d] = from_f<TX>((to_f(xr[d]) * r) * (1.f + to_f(w[d])));
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int N, int D,
                   float eps, cudaStream_t stream) {
  rms_norm_kernel<TX, TW><<<N, kThreads, 0, stream>>>(
      (const TX*)x, (const TW*)w, (TX*)out, D, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_bf16 / w_bf16: 1 for bf16, 0 for float32.
int rtlm_rms_norm(const void* x, const void* w, void* out, int N, int D,
                  int x_bf16, int w_bf16, float eps, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (x_bf16 && w_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, N, D, eps, s);
  else if (x_bf16)
    err = launch<__nv_bfloat16, float>(x, w, out, N, D, eps, s);
  else if (w_bf16)
    err = launch<float, __nv_bfloat16>(x, w, out, N, D, eps, s);
  else
    err = launch<float, float>(x, w, out, N, D, eps, s);
  return (int)err;
}

}  // extern "C"
