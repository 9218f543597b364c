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
// writes nothing and returns zeros.
//
// What bounds it on the H100: at serving shapes (chunks of 32 tokens over
// prefixes of a few hundred) the work is ~G * T_pad = 384 query rows per
// page per KV head, around 2 * 384 flops per key byte — above the ~295
// flops/byte ridge, so the bound is the tensor-core rate and, at these
// small sizes, the number of CTAs in flight.
//
// What the design does about it: one CTA per (query tile of R rows of the
// T_pad * G row block, KV head, chunk), so every key/value tile loaded into
// shared memory serves R query rows at once.  The TPU kernel's one-hot MXU
// scatter is a direct store here: only the query-tile-0 CTA of each
// (chunk, KV head) writes the chunk's rows, so no row is written twice.
// The prefix phase reads only positions < ctx_len, which the scatter never
// writes, and the in-chunk phase reads the k_new / v_new inputs rather
// than the pages just written, so no ordering between CTAs is needed.
// This first version computes in float32 on the CUDA cores; wgmma, TMA
// and warp specialisation are later work.
#include "attn_common.cuh"

namespace {

constexpr int kRowsPerTile = 64;
constexpr int kThreads = 256;

struct PrefixValid {
  int base, ctx;
  __device__ bool operator()(int, int t) const { return base + t < ctx; }
};

struct InChunkValid {
  int row0, G, kv0, clen;
  __device__ bool operator()(int r, int t) const {
    const int t_q = (row0 + r) / G, t_kv = kv0 + t;
    return t_kv <= t_q && t_kv < clen;
  }
};

__global__ void ragged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,      // (C, T, H, D)
    const __nv_bfloat16* __restrict__ k_new,  // (C, T, KV, D), page dtype
    const __nv_bfloat16* __restrict__ v_new,
    __nv_bfloat16* __restrict__ k_pages,      // (N, bs, KV, D), in/out
    __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ tables,           // (C, nb)
    const int* __restrict__ meta,             // (C, 4)
    __nv_bfloat16* __restrict__ out,          // (C, T, H, D)
    int T, int H, int KV, int D, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, kvh = blockIdx.y, c = blockIdx.z;
  const int G = H / KV;
  const int rows = T * G;
  const int row0 = tile * kRowsPerTile;
  const int R = min(kRowsPerTile, rows - row0);
  const int ctx = meta[c * 4 + 1];
  const int clen = meta[c * 4 + 2];
  const int* table = tables + (int64_t)c * nb;
  const int64_t row_stride = (int64_t)KV * D;

  // ---- fused scatter (query tile 0 only): direct row stores, bit-equal
  // to a drop-mode scatter of the same page-dtype rows
  if (tile == 0) {
    for (int e = threadIdx.x; e < clen * D; e += blockDim.x) {
      const int t = e / D, d = e - t * D;
      const int pos = ctx + t;
      const int64_t page = table[min(pos / bs, nb - 1)];
      const int64_t dst = ((page * bs + pos % bs) * KV + kvh) * D + d;
      const int64_t src = (((int64_t)c * T + t) * KV + kvh) * D + d;
      k_pages[dst] = k_new[src];
      v_pages[dst] = v_new[src];
    }
  }

  const rtlm::Smem sm = rtlm::carve(smem, kRowsPerTile, bs, D);
  // query row r of this tile is (t_q, g) = divmod(row0 + r, G)
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int t_q = (row0 + r) / G, g = (row0 + r) - t_q * G;
    sm.q[r * (D + 1) + d] = __bfloat162float(
        q[(((int64_t)c * T + t_q) * H + (int64_t)kvh * G + g) * D + d]);
  }
  rtlm::init_state(sm, R, D);
  __syncthreads();

  // ---- prefix phase: pages holding positions < ctx
  int n_pages = (ctx + bs - 1) / bs;
  if (n_pages > nb) n_pages = nb;
  for (int i = 0; i < n_pages; ++i) {
    const int64_t page = table[i];
    const int64_t off = (page * bs * KV + kvh) * D;
    rtlm::load_kv_rows(sm, k_pages + off, v_pages + off, row_stride, bs, D);
    __syncthreads();
    rtlm::attend_tile(sm, R, bs, bs, D, scale, PrefixValid{i * bs, ctx});
  }

  // ---- in-chunk phase: causal against the chunk's own K/V inputs
  for (int kv0 = 0; kv0 < clen; kv0 += bs) {
    const int nk = min(bs, clen - kv0);
    const int64_t off = (((int64_t)c * T + kv0) * KV + kvh) * D;
    rtlm::load_kv_rows(sm, k_new + off, v_new + off, row_stride, nk, D);
    __syncthreads();
    rtlm::attend_tile(sm, R, bs, nk, D, scale,
                      InChunkValid{row0, G, kv0, clen});
  }

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int t_q = (row0 + r) / G, g = (row0 + r) - t_q * G;
    out[(((int64_t)c * T + t_q) * H + (int64_t)kvh * G + g) * D + d] =
        __float2bfloat16(sm.acc[e] / fmaxf(sm.l[r], 1e-30f));
  }
}

}  // namespace

extern "C" {

int rtlm_ragged_chunked_prefill(const void* q, const void* k_new,
                                const void* v_new, void* k_pages,
                                void* v_pages, const void* tables,
                                const void* meta, void* out, int C, int T,
                                int H, int KV, int D, int bs, int nb,
                                float scale, void* stream) {
  const int G = H / KV;
  const int n_tiles = (T * G + kRowsPerTile - 1) / kRowsPerTile;
  const size_t bytes = rtlm::smem_floats(kRowsPerTile, bs, D) * sizeof(float);
  cudaError_t err =
      rtlm::allow_smem((const void*)ragged_prefill_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, KV, C);
  ragged_prefill_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new,
      (const __nv_bfloat16*)v_new, (__nv_bfloat16*)k_pages,
      (__nv_bfloat16*)v_pages, (const int*)tables, (const int*)meta,
      (__nv_bfloat16*)out, T, H, KV, D, bs, nb, scale);
  return (int)cudaGetLastError();
}

const char* rtlm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
