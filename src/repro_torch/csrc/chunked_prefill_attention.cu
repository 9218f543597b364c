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
// float32, divided by max(l, 1e-30).  Nothing is written to the pages.
//
// What bounds it on the H100: memory, at the single-chunk path's shapes
// (T = 32, H = 24, KV = 2, D = 128, prefixes of 0-96 tokens): the chunk's
// queries and outputs (2 x 196 KB) outweigh its keys and values (at most
// 128 KB), and the ~4 * H * D operations per query-key pair come to fewer
// than 100 per byte moved, below the ~295 operations-per-byte ridge.
// Every key/value row loaded serves T * G = 384 query rows, so the pages
// are read once per KV head, not once per query head.
//
// What the design does about it: one CTA per (query tile of kRowsPerTile
// rows of the (T * G)-row block, KV head, sequence).  Query row r of the
// block is (t, g) = divmod(r, G), the Pallas kernel's t-major layout, and
// head kvh * G + g uses KV head kvh, so every page loaded into shared memory
// serves the tile's rows of all G heads of the group.  The CTA reads its
// block-table row itself (the TPU's scalar prefetch) and walks only the
// ceil((ctx_len + T) / bs) entries that hold keys any query may see, never
// the padding entries past them.  Float32 on the CUDA cores; wgmma and TMA
// are later work.
#include "attn_common.cuh"
#include "rtlm_api.cuh"

namespace {

constexpr int kRowsPerTile = 64;
constexpr int kThreads = 256;

struct ChunkValid {
  int row0, G, base, ctx;
  __device__ bool operator()(int r, int t) const {
    return base + t <= ctx + (row0 + r) / G;
  }
};

__global__ void chunked_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, T, H, D)
    const __nv_bfloat16* __restrict__ k_pages,  // (N, bs, KV, D)
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ tables,             // (B, nb)
    const int* __restrict__ ctx_lens,           // (B,)
    __nv_bfloat16* __restrict__ out,            // (B, T, H, D)
    int T, int H, int KV, int D, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int row0 = tile * kRowsPerTile;
  const int R = min(kRowsPerTile, T * G - row0);
  const int ctx = ctx_lens[b];
  const int* table = tables + (int64_t)b * nb;
  const rtlm::Smem sm = rtlm::carve(smem, kRowsPerTile, bs, D);

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int t = (row0 + r) / G, g = (row0 + r) - t * G;
    sm.q[r * (D + 1) + d] = __bfloat162float(
        q[(((int64_t)b * T + t) * H + (int64_t)kvh * G + g) * D + d]);
  }
  rtlm::init_state(sm, R, D);
  __syncthreads();

  // the tile's last query row sits at position ctx + t_last
  const int last_pos = ctx + (row0 + R - 1) / G;
  int n_pages = last_pos / bs + 1;
  if (n_pages > nb) n_pages = nb;
  const int64_t row_stride = (int64_t)KV * D;
  for (int i = 0; i < n_pages; ++i) {
    const int64_t page = table[i];
    const int64_t off = (page * bs * KV + kvh) * D;
    rtlm::load_kv_rows(sm, k_pages + off, v_pages + off, row_stride, bs, D);
    __syncthreads();
    rtlm::attend_tile(sm, R, bs, bs, D, scale,
                      ChunkValid{row0, G, i * bs, ctx});
  }

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int t = (row0 + r) / G, g = (row0 + r) - t * G;
    out[(((int64_t)b * T + t) * H + (int64_t)kvh * G + g) * D + d] =
        __float2bfloat16(sm.acc[e] / fmaxf(sm.l[r], 1e-30f));
  }
}

}  // namespace

extern "C" {

int rtlm_chunked_prefill_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* ctx_lens, void* out, int B,
                                   int T, int H, int KV, int D, int bs, int nb,
                                   float scale, void* stream) {
  if (B == 0 || T == 0) return 0;
  const int G = H / KV;
  const int n_tiles = (T * G + kRowsPerTile - 1) / kRowsPerTile;
  const size_t bytes = rtlm::smem_floats(kRowsPerTile, bs, D) * sizeof(float);
  cudaError_t err =
      rtlm::allow_smem((const void*)chunked_prefill_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, KV, B);
  chunked_prefill_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)tables, (const int*)ctx_lens,
      (__nv_bfloat16*)out, T, H, KV, D, bs, nb, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
