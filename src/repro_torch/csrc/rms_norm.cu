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
// the card's operations-per-byte ridge; at 2048 x 3072 bf16 the bytes take
// 7.5 us at 3.35 TB/s.
//
// What the design does about it: every byte moves once, 16 bytes a
// thread.  A row belongs to a group of 1, 2, 4 or 8 warps, the fewest
// whose threads hold the row in at most MAXV 16-byte vectors each (MAXV
// 4, or 16 for rows past 8 warps x 4 vectors: 8192 bf16 or 4096 float32),
// and a CTA of 256 threads takes a block of 8 / warps-per-row rows: at
// 3072 bf16, four warps a row, three vectors a thread, two rows a block.
// Lane t of a group loads vectors t, t + 32 * warps, ... of its row
// (neighbouring lanes on neighbouring 16 bytes), keeps them in registers,
// sums their squares in float32, reduces across the warp with shuffles
// and, for a group of several warps, through one shared-memory slot per
// warp behind one barrier; then it scales the registers and stores them
// as 16-byte vectors.  The Pallas kernel's (block_rows, D) VMEM tile
// becomes these register-resident rows.  Where the row blocks fit in two
// waves of resident CTAs (2048 rows of 3072: 1024 blocks, 528 resident),
// one wave takes them all, each CTA loading its second block while it
// reduces and stores the first; more blocks get a CTA each.  A D or a
// view the 16-byte path does not fit (D * sizeof(x) not a multiple of 16;
// x, w or out off a 16-byte boundary; a row past 8 warps x 16 vectors)
// takes the scalar body of the same kernel: the same groups and
// reduction, one element a thread per step, the row read a second time
// for the scaling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rtlm_api.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T: E elements, as floats and back
template <typename T>
struct V16;
template <>
struct V16<bf16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void to_float(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  static __device__ __forceinline__ uint4 from_float(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return u;
  }
};
template <>
struct V16<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void to_float(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 from_float(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// E weights from w (aligned to E * sizeof(*w) bytes) as floats
template <int E>
__device__ __forceinline__ void load_w(const bf16* w, float* f) {
  if constexpr (E == 8) {
    V16<bf16>::to_float(__ldg(reinterpret_cast<const uint4*>(w)), f);
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(w));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
}
template <int E>
__device__ __forceinline__ void load_w(const float* w, float* f) {
#pragma unroll
  for (int k = 0; k < E; k += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(w + k));
    f[k] = t.x;
    f[k + 1] = t.y;
    f[k + 2] = t.z;
    f[k + 3] = t.w;
  }
}

// The sum of v over the threads of this thread's row group (wpr warps):
// shuffles within each warp, then, for several warps, one slot per warp
// in shared memory behind the kernel's one barrier.  Every thread of the
// group gets the same value (the same partials in the same order).
__device__ __forceinline__ float group_sum(float v, float* slots, int wpr) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (wpr == 1) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) slots[warp] = v;
  __syncthreads();
  const int first = warp - warp % wpr;
  float s = 0.f;
  for (int i = 0; i < wpr; ++i) s += slots[first + i];
  return s;
}

// Load row `row` (if it exists) of x into the thread's vectors: vector
// j = t + i * tpr of the row into v[i].
template <typename TX, int MAXV>
__device__ __forceinline__ void load_row(uint4 (&v)[MAXV], const TX* x,
                                         int64_t row, int N, int D, int t,
                                         int tpr, int nv) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int j = t + i * tpr;
    if (row < N && j < nv) v[i] = __ldg(xr + j);
  }
}

// MAXV: the most 16-byte vectors of x a thread holds.  CTA c takes row
// blocks c, c + gridDim.x, ... (each kThreads / tpr rows); with MAXV 4
// the next block's vectors are loaded before the current one is reduced
// and stored.  Every thread of a CTA walks the same blocks, so a group
// past the last row still meets the barrier.
template <typename TX, typename TW, int MAXV>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TX* __restrict__ out, int N, int D, int wpr, float eps) {
  constexpr int E = V16<TX>::E;
  constexpr bool kPrefetch = MAXV == 4;
  // one slot per warp and block, two blocks apart: a block's slots are
  // not written again before every thread has read them
  __shared__ float slots[2][kWarps];
  const int tpr = wpr * 32, groups = kThreads / tpr;  // threads, rows
  const int t = threadIdx.x % tpr, gi = threadIdx.x / tpr;
  const int n_blocks = (N + groups - 1) / groups;
  const int nv = D / E;
  const bool vec =
      D % E == 0 && nv <= tpr * MAXV &&
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15) == 0;

  if (vec) {
    uint4 v[MAXV], nx[kPrefetch ? MAXV : 1];
    int64_t row = (int64_t)blockIdx.x * groups + gi;
    load_row<TX, MAXV>(v, x, row, N, D, t, tpr, nv);
    for (int blk = blockIdx.x, it = 0; blk < n_blocks;
         blk += gridDim.x, ++it) {
      const int64_t next = row + (int64_t)gridDim.x * groups;
      if constexpr (kPrefetch) {
        if (blk + (int)gridDim.x < n_blocks)
          load_row<TX, MAXV>(nx, x, next, N, D, t, tpr, nv);
      }
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int j = t + i * tpr;
        if (row < N && j < nv) {
          float f[E];
          V16<TX>::to_float(v[i], f);
#pragma unroll
          for (int k = 0; k < E; ++k) ss = fmaf(f[k], f[k], ss);
        }
      }
      const float r =
          rsqrtf(group_sum(ss, slots[it & 1], wpr) / (float)D + eps);
      uint4* orow = reinterpret_cast<uint4*>(out + row * D);
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int j = t + i * tpr;
        if (row < N && j < nv) {
          float f[E], g[E];
          V16<TX>::to_float(v[i], f);
          load_w<E>(w + j * E, g);
#pragma unroll
          for (int k = 0; k < E; ++k) f[k] = (f[k] * r) * (1.f + g[k]);
          orow[j] = V16<TX>::from_float(f);
        }
      }
      if constexpr (kPrefetch) {
#pragma unroll
        for (int i = 0; i < MAXV; ++i) v[i] = nx[i];
      } else if (blk + (int)gridDim.x < n_blocks) {
        load_row<TX, MAXV>(v, x, next, N, D, t, tpr, nv);
      }
      row = next;
    }
  } else {
    for (int blk = blockIdx.x, it = 0; blk < n_blocks;
         blk += gridDim.x, ++it) {
      const int64_t row = (int64_t)blk * groups + gi;
      const TX* xr = x + row * D;
      TX* orow = out + row * D;
      float ss = 0.f;
      if (row < N)
        for (int d = t; d < D; d += tpr) {
          const float f = to_f(xr[d]);
          ss = fmaf(f, f, ss);
        }
      const float r =
          rsqrtf(group_sum(ss, slots[it & 1], wpr) / (float)D + eps);
      if (row < N)
        for (int d = t; d < D; d += tpr)
          orow[d] = from_f<TX>((to_f(xr[d]) * r) * (1.f + to_f(w[d])));
    }
  }
}

// The grid: one CTA per row block, unless the blocks fit in two waves of
// the CTAs the card holds at once; then one wave, each CTA taking two
// blocks with the second one's loads in flight under the first (a second
// wave would start its loads only as the first wave's CTAs retire).
template <typename TX, typename TW, int MAXV>
cudaError_t launch_rows(const void* x, const void* w, void* out, int N,
                        int D, int wpr, float eps, cudaStream_t stream) {
  static int resident = 0;  // CTAs the card holds at once
  if (resident == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rms_norm_kernel<TX, TW, MAXV>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
  }
  const int rows_per_cta = kWarps / wpr;
  const int n_blocks = (N + rows_per_cta - 1) / rows_per_cta;
  const int grid = n_blocks <= 2 * resident ? min(n_blocks, resident)
                                            : n_blocks;
  rms_norm_kernel<TX, TW, MAXV><<<grid, kThreads, 0, stream>>>(
      (const TX*)x, (const TW*)w, (TX*)out, N, D, wpr, eps);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int N, int D,
                   float eps, cudaStream_t stream) {
  // the fewest warps a row whose threads hold it in MAXV vectors each
  constexpr int E = V16<TX>::E;
  const int nv = (D + E - 1) / E;
  const int maxv = nv <= kThreads * 4 ? 4 : 16;
  int wpr = 1;
  while (wpr < kWarps && nv > wpr * 32 * maxv) wpr *= 2;
  return maxv == 4
             ? launch_rows<TX, TW, 4>(x, w, out, N, D, wpr, eps, stream)
             : launch_rows<TX, TW, 16>(x, w, out, N, D, wpr, eps, stream);
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
    err = launch<bf16, bf16>(x, w, out, N, D, eps, s);
  else if (x_bf16)
    err = launch<bf16, float>(x, w, out, N, D, eps, s);
  else if (w_bf16)
    err = launch<float, bf16>(x, w, out, N, D, eps, s);
  else
    err = launch<float, float>(x, w, out, N, D, eps, s);
  return (int)err;
}

}  // extern "C"
