// Split-K flash-decode attention over a contiguous cache, for Hopper
// (sm_90a).
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
// exactly 0 wherever the mask is false.  D is any multiple of 8 up to 256.
//
// What bounds it on the H100: memory.  Each key/value byte serves
// G = H / KV query heads (2 * G operations per bf16 element), far below the
// ~295 operations per byte where the tensor cores would become the limit;
// the bytes that must move are the valid slots' keys and values, once.
//
// What the design does about it: flash-decoding (split_decode.cuh, shared
// with the paged decode kernel).  One B x KV grid of groups fills a
// quarter of the card at serving batch sizes, so the cache rows are split
// over S as well: grid (KV x row blocks, B, n_splits), with n_splits
// chosen on the host (kernels/flash_decode_attention.py, split_plan) for
// about two CTAs per SM and never a split shorter than one 64-slot tile.
// A CTA first reads its split's mask once and marks the tiles with a valid
// slot, then streams only those through the two-stage cp.async ring of
// split_decode.cuh, Q K^T and P V on the tensor cores (mma.sync, P as
// bf16 hi + lo), and writes its float32 partial; a second kernel combines
// the partials of each (row, head), so an all-masked row comes out
// exactly zero.
#include "attn_common.cuh"
#include "rtlm_api.cuh"
#include "split_decode.cuh"

namespace {

namespace sp = rtlm::split;
using sp::bf16;

template <int DP>
__global__ void __launch_bounds__(sp::kThreads) flash_decode_split_kernel(
    const bf16* __restrict__ q,        // (B, H, D)
    const bf16* __restrict__ k_cache,  // (B, S, KV, D)
    const bf16* __restrict__ v_cache,
    const uint8_t* __restrict__ mask,  // (B, S) bool
    float* __restrict__ part,          // split_decode.cuh's partials
    int S, int H, int KV, int D, int tiles_per_split, float scale_log2) {
  constexpr int BN = sp::kTileKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* live = reinterpret_cast<int*>(smem_raw + sp::ring_bytes<DP>());
  const sp::Block blk(H, KV);
  const int t_begin = blk.split * tiles_per_split;
  const int t_end = min((S + BN - 1) / BN, t_begin + tiles_per_split);
  const int s_begin = t_begin * BN, s_end = min(S, t_end * BN);
  const uint8_t* mrow = mask + (int64_t)blk.b * S;

  sp::load_q<DP>(smem_raw, blk, q, H, D);
  // which of the split's tiles hold a valid slot
  for (int t = threadIdx.x; t < t_end - t_begin; t += blockDim.x) live[t] = 0;
  __syncthreads();
  for (int s = s_begin + threadIdx.x; s < s_end; s += blockDim.x)
    if (mrow[s]) live[(s - s_begin) / BN] = 1;
  __syncthreads();

  const int64_t kv_stride = (int64_t)KV * D;
  const int64_t row0 = ((int64_t)blk.b * S * KV + blk.kvh) * D;
  sp::attend<DP>(
      smem_raw, blk, H, D, k_cache + row0, v_cache + row0, t_begin, t_end,
      scale_log2, part,
      [&](int t) {
        while (t < t_end && !live[t - t_begin]) ++t;
        return t;
      },
      [&](int s) -> int64_t { return s < S ? s * kv_stride : -1; },
      [&](int s) { return s < S && mrow[s]; });
}

__global__ void flash_decode_combine_kernel(const float* __restrict__ part,
                                            bf16* __restrict__ out, int D,
                                            int n_splits, int64_t BH) {
  sp::combine(part, out, D, n_splits, BH);
}

template <int DP>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* mask, void* out, void* part, int B, int S, int H,
           int KV, int D, int n_splits, int tiles_per_split, float scale,
           cudaStream_t stream) {
  const int G = H / KV, n_rb = (G + sp::kRows - 1) / sp::kRows;
  const size_t bytes = sp::ring_bytes<DP>() + (size_t)tiles_per_split * 4;
  cudaError_t err =
      rtlm::allow_smem((const void*)flash_decode_split_kernel<DP>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV * n_rb, B, n_splits);
  flash_decode_split_kernel<DP><<<grid, sp::kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache,
      (const uint8_t*)mask, (float*)part, S, H, KV, D, tiles_per_split,
      scale * rtlm::mma::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t BH = (int64_t)B * H;
  flash_decode_combine_kernel<<<(unsigned)BH, sp::kThreads, 0, stream>>>(
      (const float*)part, (bf16*)out, D, n_splits, BH);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part: float32 workspace of B * H * n_splits * (D + 2) elements;
// n_splits * tiles_per_split * 64 >= S > (n_splits - 1) * tiles_per_split
// * 64 (kernels/flash_decode_attention.py, split_plan).  D must be a
// multiple of 8 up to 256, and q, the caches and out 16-byte aligned.
int rtlm_flash_decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* mask,
                                void* out, void* part, int B, int S, int H,
                                int KV, int D, int n_splits,
                                int tiles_per_split, float scale,
                                void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0)  // nothing to attend: zeros
    return (int)cudaMemsetAsync(out, 0, (size_t)B * H * D * sizeof(bf16), st);
  switch (rtlm::mma::padded_head_dim(D)) {
    case 32:
      return launch<32>(q, k_cache, v_cache, mask, out, part, B, S, H, KV, D,
                        n_splits, tiles_per_split, scale, st);
    case 64:
      return launch<64>(q, k_cache, v_cache, mask, out, part, B, S, H, KV, D,
                        n_splits, tiles_per_split, scale, st);
    case 128:
      return launch<128>(q, k_cache, v_cache, mask, out, part, B, S, H, KV,
                         D, n_splits, tiles_per_split, scale, st);
    case 256:
      return launch<256>(q, k_cache, v_cache, mask, out, part, B, S, H, KV,
                         D, n_splits, tiles_per_split, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
