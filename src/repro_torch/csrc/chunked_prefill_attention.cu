// Chunked-prefill attention over a paged prefix for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/chunked_prefill_attention.py,
//   chunked_prefill_attention / _cp_kernel (Pallas, TPU).
//
// What it computes: for each of B sequences, one T-token chunk of queries
// (B, T, H, D) over the sequence's paged K/V (N, bs, KV, D) named by a
// (B, nb) block table.  The pages already hold the chunk's own K/V at
// logical positions ctx_len .. ctx_len + T - 1 (the caller's scatter_chunk
// wrote them), so the whole problem is one masked attention: query t of
// sequence b attends key position p iff p <= ctx_lens[b] + t — full over
// the prefix, causal within the chunk; a first chunk (ctx_len == 0) is
// purely causal and its query 0 sees exactly one key.  Online softmax in
// float32, divided by max(l, 1e-30).  Nothing is written to the pages.  D
// is any multiple of 8 up to 256.
//
// What bounds it on the H100: launch latency and the chain of dependent
// loads, at the single-chunk path's shapes (T = 32, H = 24, KV = 2,
// D = 128, prefixes of 0-96 tokens): the chunk's queries and outputs
// (2 x 196 KB) and its keys and values (at most 128 KB) take well under a
// microsecond at the card's memory rate, and the ~4 * H * D operations per
// query-key pair come to fewer than 100 per byte moved, below the ~295
// operations-per-byte ridge (chip_smoke's bound says "bytes").  Every
// key/value row loaded serves the tile's rows of all G heads of its
// group, so the pages are read once per KV head and row tile.
//
// What the design does about it (prefill_attn.cuh, shared with the fused
// ragged prefill): one CTA per (row tile of kCtaRows = 4 warps x 16
// t-major rows, KV head, sequence).  The CTA reads its block-table row
// itself (the TPU's scalar prefetch) and walks the positions in
// 64-position tiles, only as far as its last query sees, row p being row
// p % bs of page tables[b, p / bs]; table entries past that are never
// read.  Tiles go through a two-stage cp.async ring, and
// both products run on the tensor cores (mma.sync, P as bf16 hi + lo).
#include "attn_common.cuh"
#include "prefill_attn.cuh"
#include "rtlm_api.cuh"

namespace {

namespace pf = rtlm::prefill;
using pf::bf16;
using pf::kThreads;

template <int DP>
__global__ void __launch_bounds__(kThreads) chunked_prefill_kernel(
    const bf16* __restrict__ q,        // (B, T, H, D)
    const bf16* __restrict__ k_pages,  // (N, bs, KV, D)
    const bf16* __restrict__ v_pages,
    const int* __restrict__ tables,    // (B, nb)
    const int* __restrict__ ctx_lens,  // (B,)
    bf16* __restrict__ out,            // (B, T, H, D)
    int T, int H, int KV, int D, int bs, int nb, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int ctx = max(ctx_lens[b], 0);
  const int n_pos = nb * bs;
  const int* trow = tables + (int64_t)b * nb;
  const int64_t kv_stride = (int64_t)KV * D;
  const bf16* kp = k_pages + (int64_t)kvh * D;
  const bf16* vp = v_pages + (int64_t)kvh * D;
  const int64_t qo = (int64_t)b * T * H * D;
  pf::attend<DP>(
      smem_raw, q + qo, out + qo, T, H, H / KV, D, kvh, T, scale_log2,
      [&](int t) { return min(ctx + t, n_pos - 1); },
      [&](int p) -> pf::KVRow {
        const int64_t o = ((int64_t)trow[p / bs] * bs + p % bs) * kv_stride;
        return {kp + o, vp + o};
      });
}

template <int DP>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* ctx_lens, void* out, int B, int T,
           int H, int KV, int D, int bs, int nb, float scale,
           cudaStream_t stream) {
  const size_t bytes = pf::smem_bytes<DP>();
  cudaError_t err =
      rtlm::allow_smem((const void*)chunked_prefill_kernel<DP>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(pf::row_tiles(T * (H / KV)), KV, B);
  chunked_prefill_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k_pages, (const bf16*)v_pages,
      (const int*)tables, (const int*)ctx_lens, (bf16*)out, T, H, KV, D, bs,
      nb, scale * rtlm::mma::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the t-major query rows of one CTA, the grid's unit (prefill_attn.cuh)
int rtlm_prefill_cta_rows(void) { return pf::kCtaRows; }

// D must be a multiple of 8 up to 256, and q, the pages and out 16-byte
// aligned (the wrapper checks both).
int rtlm_chunked_prefill_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* ctx_lens, void* out, int B,
                                   int T, int H, int KV, int D, int bs, int nb,
                                   float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rtlm::mma::padded_head_dim(D)) {
    case 32:
      return launch<32>(q, k_pages, v_pages, tables, ctx_lens, out, B, T, H,
                        KV, D, bs, nb, scale, st);
    case 64:
      return launch<64>(q, k_pages, v_pages, tables, ctx_lens, out, B, T, H,
                        KV, D, bs, nb, scale, st);
    case 128:
      return launch<128>(q, k_pages, v_pages, tables, ctx_lens, out, B, T, H,
                         KV, D, bs, nb, scale, st);
    case 256:
      return launch<256>(q, k_pages, v_pages, tables, ctx_lens, out, B, T, H,
                         KV, D, bs, nb, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
