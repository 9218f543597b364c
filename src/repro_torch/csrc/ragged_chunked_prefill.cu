// Fused ragged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ragged_chunked_prefill.py,
//   ragged_chunked_prefill / _rcp_kernel (Pallas, TPU).
//
// What it computes, for every chunk c of one engine iteration (meta row
// [slot, ctx_len, chunk_len, q_offset]): the chunk's fresh K/V rows
// t < chunk_len are written into its pages at logical positions
// ctx_len + t (row (ctx+t) % bs of page tables[c, min((ctx+t)/bs, nb-1)]),
// and each query row t attends over the prefix positions < ctx_len plus
// the chunk's own keys t_kv <= t, t_kv < chunk_len (float32 online
// softmax, divided by max(l, 1e-30)).  A chunk_len == 0 padding chunk
// writes nothing and returns zeros; so does every 16-row tile of the
// t-major rows wholly at t >= chunk_len.  D is any multiple of 8 up to 256;
// ctx_len + chunk_len <= nb * bs, as the engine's tables guarantee.
//
// What bounds it on the H100: launch latency and the chain of dependent
// loads, at the serve's shapes (1-4 chunks of 16-32 tokens over prefixes
// of at most 96, 24/2 heads, D 128).  The bytes (a few hundred KB) and the
// operations (~0.1 GFLOP) would take well under a microsecond at the
// card's rates; each page row serves the G * T_pad query rows of its
// group, so the operations per byte moved stay below the ~295 where the
// tensor cores would become the limit (chip_smoke's bound says "bytes").
//
// What the design does about it (prefill_attn.cuh): one CTA per (row tile
// of kCtaRows = 4 warps x 16 t-major rows, KV head, chunk), so every K/V
// tile loaded serves 64 query rows; dead tiles and padding chunks return
// at once.  The prefix and the chunk's own keys are one run of positions
// walked in 64-position tiles, only as far as the tile's last live query
// sees, through a two-stage cp.async ring: row p < ctx_len is
// row p % bs of page tables[c, p / bs], row p >= ctx_len is row p - ctx_len
// of k_new / v_new (read by stride, never from the pages being written, so
// no ordering between CTAs is needed).  Both products run on the tensor
// cores (mma.sync, P as bf16 hi + lo).  The TPU kernel's one-hot MXU
// scatter is a direct store: token t is stored by the one CTA whose rows
// hold row t * G, as 16-byte vectors before its attention (bit-equal to
// the plain version's scatter of the same page-dtype rows).
#include "attn_common.cuh"
#include "prefill_attn.cuh"
#include "rtlm_api.cuh"

namespace {

namespace pf = rtlm::prefill;
using pf::bf16;
using pf::kThreads;

template <int DP>
__global__ void __launch_bounds__(kThreads) ragged_prefill_kernel(
    const bf16* __restrict__ q,      // (C, T, H, D)
    const bf16* __restrict__ k_new,  // (C, T, KV, D), page dtype
    const bf16* __restrict__ v_new,
    bf16* __restrict__ k_pages,      // (N, bs, KV, D), in/out
    bf16* __restrict__ v_pages,
    const int* __restrict__ tables,  // (C, nb)
    const int* __restrict__ meta,    // (C, 4)
    bf16* __restrict__ out,          // (C, T, H, D)
    int T, int H, int KV, int D, int bs, int nb, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = pf::kCtaRows;
  const int kvh = blockIdx.y, c = blockIdx.z;
  const int G = H / KV;
  const int ctx = max(meta[c * 4 + 1], 0);
  const int clen = min(max(meta[c * 4 + 2], 0), T);
  const int* table = tables + (int64_t)c * nb;
  const int64_t kv_stride = (int64_t)KV * D;
  const bf16* kn = k_new + ((int64_t)c * T * KV + kvh) * D;
  const bf16* vn = v_new + ((int64_t)c * T * KV + kvh) * D;

  // ---- fused scatter: the tokens whose row t * G is one of this CTA's
  const int row0 = blockIdx.x * R;
  const int t_lo = (row0 + G - 1) / G;
  const int t_hi = min(clen, (row0 + R + G - 1) / G);
  const int vecs = D / 8;
  for (int e = threadIdx.x; e < (t_hi - t_lo) * vecs; e += kThreads) {
    const int t = t_lo + e / vecs, d = (e % vecs) * 8;
    const int pos = ctx + t;
    const int64_t page = table[min(pos / bs, nb - 1)];
    const int64_t dst = (page * bs + pos % bs) * kv_stride + kvh * D + d;
    const int64_t src = t * kv_stride + d;
    *reinterpret_cast<uint4*>(k_pages + dst) =
        *reinterpret_cast<const uint4*>(kn + src);
    *reinterpret_cast<uint4*>(v_pages + dst) =
        *reinterpret_cast<const uint4*>(vn + src);
  }

  // ---- attention: prefix positions < ctx from the pages, then the
  // chunk's own rows from k_new / v_new
  const int64_t qo = (int64_t)c * T * H * D;
  const bf16* kp = k_pages + (int64_t)kvh * D;
  const bf16* vp = v_pages + (int64_t)kvh * D;
  pf::attend<DP>(
      smem_raw, q + qo, out + qo, T, H, G, D, kvh, clen, scale_log2,
      [&](int t) { return ctx + min(t, clen - 1); },
      [&](int p) -> pf::KVRow {
        if (p < ctx) {
          const int64_t o =
              ((int64_t)table[min(p / bs, nb - 1)] * bs + p % bs) *
              kv_stride;
          return {kp + o, vp + o};
        }
        const int64_t o = (int64_t)(p - ctx) * kv_stride;
        return {kn + o, vn + o};
      });
}

template <int DP>
int launch(const void* q, const void* k_new, const void* v_new,
           void* k_pages, void* v_pages, const void* tables, const void* meta,
           void* out, int C, int T, int H, int KV, int D, int bs, int nb,
           float scale, cudaStream_t stream) {
  const size_t bytes = pf::smem_bytes<DP>();
  cudaError_t err =
      rtlm::allow_smem((const void*)ragged_prefill_kernel<DP>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(pf::row_tiles(T * (H / KV)), KV, C);
  ragged_prefill_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k_new, (const bf16*)v_new,
      (bf16*)k_pages, (bf16*)v_pages, (const int*)tables, (const int*)meta,
      (bf16*)out, T, H, KV, D, bs, nb, scale * rtlm::mma::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the t-major query rows of one CTA, the grid's unit (prefill_attn.cuh)
int rtlm_prefill_cta_rows(void) { return pf::kCtaRows; }

// D must be a multiple of 8 up to 256, and q, k_new, v_new, the pages and
// out 16-byte aligned (the wrapper checks both).
int rtlm_ragged_chunked_prefill(const void* q, const void* k_new,
                                const void* v_new, void* k_pages,
                                void* v_pages, const void* tables,
                                const void* meta, void* out, int C, int T,
                                int H, int KV, int D, int bs, int nb,
                                float scale, void* stream) {
  if (C == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rtlm::mma::padded_head_dim(D)) {
    case 32:
      return launch<32>(q, k_new, v_new, k_pages, v_pages, tables, meta, out,
                        C, T, H, KV, D, bs, nb, scale, st);
    case 64:
      return launch<64>(q, k_new, v_new, k_pages, v_pages, tables, meta, out,
                        C, T, H, KV, D, bs, nb, scale, st);
    case 128:
      return launch<128>(q, k_new, v_new, k_pages, v_pages, tables, meta,
                         out, C, T, H, KV, D, bs, nb, scale, st);
    case 256:
      return launch<256>(q, k_new, v_new, k_pages, v_pages, tables, meta,
                         out, C, T, H, KV, D, bs, nb, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
