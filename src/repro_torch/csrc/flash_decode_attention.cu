// Flash-decode attention over a contiguous cache for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py,
//   flash_decode_attention / _fd_kernel (Pallas, TPU).
//
// What it computes: one-token GQA attention for each of B rows over a
// contiguous cache (B, S, KV, D); slot s of row b is attended iff
// mask[b, s] (ring-buffer slots are resolved to that mask by the caller).
// Online softmax in float32.  A row whose mask is all false returns zeros
// (the port's empty-row rule).  The Pallas kernel does not re-mask the
// probabilities after the max shift, so there such a row averages the
// values of its masked slots, padding included; the probabilities here are
// exactly 0 wherever the mask is false.
//
// What bounds it on the H100: memory.  Each key/value byte serves
// G = H / KV query heads (2 * G operations per bf16 element), far below the
// ~295 operations per byte where the tensor cores would become the limit;
// the bytes that must move are the valid slots' keys and values, once.
//
// What the design does about it: one CTA per (KV head, row), so the G
// query heads of a group share every key/value tile loaded into shared
// memory, and the cache is read from device memory once per group rather
// than once per query head.  A tile of kTileKeys slots with no valid slot
// is skipped before its keys are loaded.  S need not be a multiple of the
// tile: the last tile is short.  At B = 16, KV = 2 that is 32 CTAs on 132
// SMs; a split over S (flash-decoding) is the known cure and later work.
#include "attn_common.cuh"
#include "rtlm_api.cuh"

namespace {

constexpr int kTileKeys = 64;
constexpr int kThreads = 128;

struct MaskValid {
  const uint8_t* row;  // mask[b, s0 ...]
  __device__ bool operator()(int, int t) const { return row[t] != 0; }
};

__global__ void flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, H, D)
    const __nv_bfloat16* __restrict__ k_cache,  // (B, S, KV, D)
    const __nv_bfloat16* __restrict__ v_cache,
    const uint8_t* __restrict__ mask,           // (B, S) bool
    __nv_bfloat16* __restrict__ out,            // (B, H, D)
    int S, int H, int KV, int D, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const rtlm::Smem sm = rtlm::carve(smem, G, kTileKeys, D);

  const __nv_bfloat16* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    sm.q[g * (D + 1) + d] = __bfloat162float(qb[e]);
  }
  rtlm::init_state(sm, G, D);

  const uint8_t* mrow = mask + (int64_t)b * S;
  const int64_t row_stride = (int64_t)KV * D;
  for (int s0 = 0; s0 < S; s0 += kTileKeys) {
    const int nk = min(kTileKeys, S - s0);
    int mine = 0;
    for (int t = threadIdx.x; t < nk; t += blockDim.x) mine |= mrow[s0 + t];
    // a barrier and a block-wide OR: every thread takes the same branch
    if (!__syncthreads_or(mine)) continue;
    const int64_t off = (((int64_t)b * S + s0) * KV + kvh) * D;
    rtlm::load_kv_rows(sm, k_cache + off, v_cache + off, row_stride, nk, D);
    __syncthreads();
    rtlm::attend_tile(sm, G, kTileKeys, nk, D, scale, MaskValid{mrow + s0});
  }
  __syncthreads();

  __nv_bfloat16* ob = out + ((int64_t)b * H + (int64_t)kvh * G) * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D;
    ob[e] = __float2bfloat16(sm.acc[e] / fmaxf(sm.l[g], 1e-30f));
  }
}

}  // namespace

extern "C" {

int rtlm_flash_decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* mask,
                                void* out, int B, int S, int H, int KV, int D,
                                float scale, void* stream) {
  if (B == 0) return 0;
  const int G = H / KV;
  const size_t bytes = rtlm::smem_floats(G, kTileKeys, D) * sizeof(float);
  cudaError_t err = rtlm::allow_smem((const void*)flash_decode_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  flash_decode_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache,
      (const __nv_bfloat16*)v_cache, (const uint8_t*)mask,
      (__nv_bfloat16*)out, S, H, KV, D, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
