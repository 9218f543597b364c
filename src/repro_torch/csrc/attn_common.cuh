// Shared device code of the port's two attention kernels
// (paged_decode_attention.cu, ragged_chunked_prefill.cu).
//
// Both kernels stream key/value tiles through shared memory and keep an
// online softmax (running max m, running sum l, float32 accumulator acc)
// for a block of R query rows, as the TPU kernels they replace do in VMEM
// scratch.  Everything is float32 after the bf16 loads.
//
// Shared-memory layout (floats), built by the caller with smem_floats():
//   q_s   R  x (D + 1)   query rows (row stride D + 1: conflict-free dots)
//   k_s   KT x (D + 1)   key tile
//   v_s   KT x D         value tile
//   s_s   R  x KT        scores, then probabilities
//   m_s, l_s, corr_s     R each
//   acc_s R  x D
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtlm {

constexpr float kNegInf = -1e30f;

struct Smem {
  float* q;
  float* k;
  float* v;
  float* s;
  float* m;
  float* l;
  float* corr;
  float* acc;
};

__host__ __device__ inline size_t smem_floats(int R, int KT, int D) {
  return (size_t)R * (D + 1) + (size_t)KT * (D + 1) + (size_t)KT * D +
         (size_t)R * KT + 3 * (size_t)R + (size_t)R * D;
}

__device__ inline Smem carve(float* base, int R, int KT, int D) {
  Smem sm;
  sm.q = base;
  sm.k = sm.q + (size_t)R * (D + 1);
  sm.v = sm.k + (size_t)KT * (D + 1);
  sm.s = sm.v + (size_t)KT * D;
  sm.m = sm.s + (size_t)R * KT;
  sm.l = sm.m + R;
  sm.corr = sm.l + R;
  sm.acc = sm.corr + R;
  return sm;
}

__device__ inline void init_state(const Smem& sm, int R, int D) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) sm.acc[e] = 0.f;
}

// Load nk rows of a bf16 tile (row t at src + t * row_stride, D contiguous
// elements) into k_s (stride D + 1) and v_s (stride D).
__device__ inline void load_kv_rows(const Smem& sm, const __nv_bfloat16* ksrc,
                                    const __nv_bfloat16* vsrc,
                                    int64_t row_stride, int nk, int D) {
  for (int e = threadIdx.x; e < nk * D; e += blockDim.x) {
    const int t = e / D, d = e - t * D;
    sm.k[t * (D + 1) + d] = __bfloat162float(ksrc[t * row_stride + d]);
    sm.v[t * D + d] = __bfloat162float(vsrc[t * row_stride + d]);
  }
}

// One key tile of the online softmax for R query rows against nk keys
// (nk <= KT).  valid(r, t) says whether query row r may see key t.
// Masked scores are NEG_INF and masked probabilities are exactly 0, so a
// row with nothing valid so far keeps l == 0 and acc == 0 (the re-mask of
// the TPU kernels: a seq_len == 0 row returns zeros).
template <typename Valid>
__device__ inline void attend_tile(const Smem& sm, int R, int KT, int nk,
                                   int D, float scale, Valid valid) {
  for (int e = threadIdx.x; e < R * nk; e += blockDim.x) {
    const int r = e / nk, t = e - r * nk;
    const float* qr = sm.q + r * (D + 1);
    const float* kt = sm.k + t * (D + 1);
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kt[d], dot);
    sm.s[r * KT + t] = valid(r, t) ? dot * scale : kNegInf;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float* sr = sm.s + r * KT;
    const float m_prev = sm.m[r];
    float mx = kNegInf;
    for (int t = 0; t < nk; ++t) mx = fmaxf(mx, sr[t]);
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = 0; t < nk; ++t) {
      const float p = valid(r, t) ? expf(sr[t] - m_new) : 0.f;
      sr[t] = p;
      sum += p;
    }
    const float corr = expf(m_prev - m_new);
    sm.corr[r] = corr;
    sm.l[r] = sm.l[r] * corr + sum;
    sm.m[r] = m_new;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const float* pr = sm.s + r * KT;
    float a = sm.acc[e] * sm.corr[r];
    for (int t = 0; t < nk; ++t) a = fmaf(pr[t], sm.v[t * D + d], a);
    sm.acc[e] = a;
  }
  __syncthreads();
}

inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rtlm
