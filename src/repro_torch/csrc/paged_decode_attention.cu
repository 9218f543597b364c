// Split-K paged flash-decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode_attention.py,
//   paged_flash_decode_attention / _paged_fd_kernel (Pallas, TPU).
//
// What it computes: one-token GQA attention for each of B sequences over
// a page pool (N, bs, KV, D) named by a (B, nb) block table; key position
// p of sequence b is row p % bs of page tables[b, p / bs], and only
// positions p < seq_lens[b] are attended.  Online softmax in float32; a
// seq_len == 0 row returns zeros.  D is any multiple of 8 up to 256; bs
// is any positive page size.
//
// What bounds it on the H100: memory.  Each key/value byte is used for
// G = H / KV query heads only (2 * G operations per bf16 element), far
// below the ~295 operations per byte where the tensor cores would become
// the limit.  The bytes that must move are the live positions of every
// sequence, once.
//
// What the design does about it: flash-decoding over the block table, the
// design of the contiguous decode kernel (split_decode.cuh).  One CTA per
// (KV head, sequence) would be 32 CTAs on 132 SMs at the serving shape, so
// each sequence's logical positions [0, nb * bs) are split as well: grid
// (KV x row blocks, B, n_splits), the plan made on the host from shapes
// alone (kernels/flash_decode_attention.py, split_plan: 4 splits of one
// 64-slot tile, 128 CTAs, at B 16, nb * bs 208).  A CTA reads seq_lens[b]
// itself and walks only its split's tiles that hold a position
// < seq_len; row r of a tile is position p, loaded by 16-byte cp.async
// from row p % bs of page tables[b, p / bs] (one tile spans 64 / bs pages,
// or straddles pages when bs does not divide 64).  Positions past seq_len
// are zero-filled without reading their table entries or pages, and score
// -inf.  A split wholly past seq_len writes the empty partial, so a
// seq_len == 0 row comes out exactly 0.  Q K^T and P V run on the tensor
// cores (mma.sync, P as bf16 hi + lo); a second kernel combines the
// splits.
#include "attn_common.cuh"
#include "rtlm_api.cuh"
#include "split_decode.cuh"

namespace {

namespace sp = rtlm::split;
using sp::bf16;

template <int DP>
__global__ void __launch_bounds__(sp::kThreads) paged_decode_split_kernel(
    const bf16* __restrict__ q,        // (B, H, D)
    const bf16* __restrict__ k_pages,  // (N, bs, KV, D)
    const bf16* __restrict__ v_pages,
    const int* __restrict__ tables,    // (B, nb)
    const int* __restrict__ seq_lens,  // (B,)
    float* __restrict__ part,          // split_decode.cuh's partials
    int H, int KV, int D, int bs, int nb, int tiles_per_split,
    float scale_log2) {
  constexpr int BN = sp::kTileKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const sp::Block blk(H, KV);
  const int len = min(max(seq_lens[blk.b], 0), nb * bs);
  const int t_begin = blk.split * tiles_per_split;
  const int t_end = min((len + BN - 1) / BN, t_begin + tiles_per_split);
  const int* trow = tables + (int64_t)blk.b * nb;
  const int64_t kv_stride = (int64_t)KV * D;

  sp::load_q<DP>(smem_raw, blk, q, H, D);
  sp::attend<DP>(
      smem_raw, blk, H, D, k_pages + (int64_t)blk.kvh * D,
      v_pages + (int64_t)blk.kvh * D, t_begin, t_end, scale_log2, part,
      [](int t) { return t; },  // every tile below seq_len holds a position
      [&](int p) -> int64_t {
        return p < len ? ((int64_t)trow[p / bs] * bs + p % bs) * kv_stride
                       : -1;
      },
      [&](int p) { return p < len; });
}

__global__ void paged_decode_combine_kernel(const float* __restrict__ part,
                                            bf16* __restrict__ out, int D,
                                            int n_splits, int64_t BH) {
  sp::combine(part, out, D, n_splits, BH);
}

template <int DP>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* seq_lens, void* out, void* part,
           int B, int H, int KV, int D, int bs, int nb, int n_splits,
           int tiles_per_split, float scale, cudaStream_t stream) {
  const int G = H / KV, n_rb = (G + sp::kRows - 1) / sp::kRows;
  const size_t bytes = sp::ring_bytes<DP>();
  cudaError_t err =
      rtlm::allow_smem((const void*)paged_decode_split_kernel<DP>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV * n_rb, B, n_splits);
  paged_decode_split_kernel<DP><<<grid, sp::kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k_pages, (const bf16*)v_pages,
      (const int*)tables, (const int*)seq_lens, (float*)part, H, KV, D, bs,
      nb, tiles_per_split, scale * rtlm::mma::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t BH = (int64_t)B * H;
  paged_decode_combine_kernel<<<(unsigned)BH, sp::kThreads, 0, stream>>>(
      (const float*)part, (bf16*)out, D, n_splits, BH);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part: float32 workspace of B * H * n_splits * (D + 2) elements;
// n_splits * tiles_per_split * 64 >= nb * bs > (n_splits - 1) *
// tiles_per_split * 64 (kernels/flash_decode_attention.py, split_plan).
// D must be a multiple of 8 up to 256, and q, the pages and out 16-byte
// aligned.  seq_lens is read on the device only.
int rtlm_paged_decode_attention(const void* q, const void* k_pages,
                                const void* v_pages, const void* tables,
                                const void* seq_lens, void* out, void* part,
                                int B, int H, int KV, int D, int bs, int nb,
                                int n_splits, int tiles_per_split,
                                float scale, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (nb == 0)  // nothing to attend: zeros
    return (int)cudaMemsetAsync(out, 0, (size_t)B * H * D * sizeof(bf16), st);
  switch (rtlm::mma::padded_head_dim(D)) {
    case 32:
      return launch<32>(q, k_pages, v_pages, tables, seq_lens, out, part, B,
                        H, KV, D, bs, nb, n_splits, tiles_per_split, scale,
                        st);
    case 64:
      return launch<64>(q, k_pages, v_pages, tables, seq_lens, out, part, B,
                        H, KV, D, bs, nb, n_splits, tiles_per_split, scale,
                        st);
    case 128:
      return launch<128>(q, k_pages, v_pages, tables, seq_lens, out, part, B,
                         H, KV, D, bs, nb, n_splits, tiles_per_split, scale,
                         st);
    case 256:
      return launch<256>(q, k_pages, v_pages, tables, seq_lens, out, part, B,
                         H, KV, D, bs, nb, n_splits, tiles_per_split, scale,
                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
