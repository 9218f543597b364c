// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode_attention.py,
//   paged_flash_decode_attention / _paged_fd_kernel (Pallas, TPU).
//
// What it computes: one-token GQA attention for each of B sequences over
// a page pool (N, bs, KV, D) named by a (B, nb) block table; key position
// p of sequence b is row p % bs of page tables[b, p / bs], and only
// positions p < seq_lens[b] are attended.  Online softmax in float32; a
// seq_len == 0 row returns zeros.
//
// What bounds it on the H100: memory.  Each key/value byte is used for
// G = H / KV query heads only (2 * G flops per bf16 element), far below
// the ~295 flops per byte where the tensor cores would become the limit.
// The bytes that must move are the live pages of every sequence, once.
//
// What the design does about it: one CTA per (KV head, sequence), so the
// G query heads of a group share every page load — each page is read from
// device memory once per group instead of once per query head.  The CTA
// reads its block-table entries itself (the TPU kernel's scalar prefetch)
// and walks only the ceil(seq_len / bs) entries that hold live tokens, not
// all nb.  At the serving shapes (B = 16, KV = 2) that is 32 CTAs on 132
// SMs: the card is under-filled, which a split-K (flash-decoding) pass is
// the known cure for; this first version keeps one pass.
#include "attn_common.cuh"
#include "rtlm_api.cuh"

namespace {

struct PosBelow {
  int base, limit;
  __device__ bool operator()(int, int t) const { return base + t < limit; }
};

__global__ void paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, H, D)
    const __nv_bfloat16* __restrict__ k_pages,  // (N, bs, KV, D)
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ tables,             // (B, nb)
    const int* __restrict__ seq_lens,           // (B,)
    __nv_bfloat16* __restrict__ out,            // (B, H, D)
    int H, int KV, int D, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const rtlm::Smem sm = rtlm::carve(smem, G, bs, D);

  const __nv_bfloat16* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    sm.q[g * (D + 1) + d] = __bfloat162float(qb[e]);
  }
  rtlm::init_state(sm, G, D);
  __syncthreads();

  const int len = seq_lens[b];
  int n_pages = (len + bs - 1) / bs;
  if (n_pages > nb) n_pages = nb;
  if (n_pages < 0) n_pages = 0;
  const int64_t row_stride = (int64_t)KV * D;
  for (int i = 0; i < n_pages; ++i) {
    const int64_t page = tables[(int64_t)b * nb + i];
    const int64_t off = (page * bs * KV + kvh) * D;
    rtlm::load_kv_rows(sm, k_pages + off, v_pages + off, row_stride, bs, D);
    __syncthreads();
    rtlm::attend_tile(sm, G, bs, bs, D, scale, PosBelow{i * bs, len});
  }

  __nv_bfloat16* ob = out + ((int64_t)b * H + (int64_t)kvh * G) * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D;
    ob[e] = __float2bfloat16(sm.acc[e] / fmaxf(sm.l[g], 1e-30f));
  }
}

}  // namespace

extern "C" {

int rtlm_paged_decode_attention(const void* q, const void* k_pages,
                                const void* v_pages, const void* tables,
                                const void* seq_lens, void* out, int B, int H,
                                int KV, int D, int bs, int nb, float scale,
                                void* stream) {
  const int G = H / KV;
  const size_t bytes = rtlm::smem_floats(G, bs, D) * sizeof(float);
  cudaError_t err = rtlm::allow_smem((const void*)paged_decode_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  paged_decode_kernel<<<grid, 128, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)tables,
      (const int*)seq_lens, (__nv_bfloat16*)out, H, KV, D, bs, nb, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
