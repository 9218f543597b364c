// RoPE and the K/V page write of the paged engine path, for Hopper (sm_90a).
//
// Replaces the plain chains of models/transformer.py around the
// projections of a paged attention layer: layers.apply_rope on q and on k
// (each ~16 launches: the frequencies, the angles, cos, sin, a float32 copy,
// four products, a difference, a sum, a concatenation, a cast),
// kvcache.paged.scatter_token for k and for v, and q[:, 0].contiguous().
//
// What it computes.  Every head row x (D elements, bf16) of a token at
// position p is rotated by the two halves of the head dimension,
//   out[i]     = x[i] * cos(p f_i) - x[i + D/2] * sin(p f_i)
//   out[i+D/2] = x[i + D/2] * cos(p f_i) + x[i] * sin(p f_i)
// in float32 and rounded once to bf16, as apply_rope.  The cos and sin come
// from a float32 table (L, D) (layers.rope_table: row p holds cos(p f) in
// its first half and sin(p f) in its second), which torch computes with
// apply_rope's own operations, so the table holds apply_rope's values bit
// for bit.  Each product, difference and sum is one IEEE operation rounded
// to nearest (__fmul_rn, __fsub_rn, __fadd_rn): nothing is contracted into
// an FMA, so the rotation is the plain chain's, one torch kernel per
// operation, bit for bit.  A position past the table (a dead decode row
// whose stale position keeps growing) reads the table's last row; its
// output is never read.
//
//   rtlm_rope_kv_decode  one decode step: q (B, H, D) rotated by pos[b]
//                        into a contiguous q_out (B, H, D), the layout the
//                        paged decode kernel reads; k rotated and v as it
//                        is written into their page pools (N, bs, KV, D) at
//                        block tables[b, min(pos // bs, nb - 1)], row
//                        pos % bs (scatter_token's clamp of the block
//                        index to the table width).
//   rtlm_rope_packed     the packed prefill stream: output row r is packed
//                        row rows[r] (or r without rows) of q and k,
//                        rotated by positions[rows[r]], and of v, copied;
//                        the gather that builds the ragged kernel's padded
//                        per-chunk views, fused in.
//
// What bounds it on the H100: the launch.  A decode step at starcoder2-3b's
// shape (128 tokens, 24/2 heads of 128) moves ~1.8 MB, 0.5 us at 3.35 TB/s,
// under the ~2-3 us a launch costs; the plain chains it replaces take ~37
// launches and write float32 intermediates.  So the design is one launch
// and one pass: a CTA per token (per output row), its threads over the
// (head, pair) index, each pair read once from the projection and written
// once where the next kernel reads it.  Neighbouring threads take
// neighbouring pairs of a head, so each warp's loads and stores are
// contiguous 64-byte runs of the two halves.  Head dim is a runtime
// argument, any even value up to 256 (128 and 112 on the benchmark's
// configurations).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rtlm_api.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

// Pair i of one head row: x (D elements) rotated into out, by the table
// row cs (cos in [0, half), sin in [half, D)).
__device__ __forceinline__ void rotate_pair(const bf16* __restrict__ x,
                                            bf16* __restrict__ out,
                                            const float* __restrict__ cs,
                                            int i, int half) {
  const float c = __ldg(cs + i), s = __ldg(cs + half + i);
  const float x1 = __bfloat162float(x[i]);
  const float x2 = __bfloat162float(x[i + half]);
  out[i] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  out[i + half] =
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
}

// Every head of one token row: n heads of D at x, rotated into out.
__device__ __forceinline__ void rotate_heads(const bf16* __restrict__ x,
                                             bf16* __restrict__ out,
                                             const float* __restrict__ cs,
                                             int n, int D) {
  const int half = D / 2;
  for (int j = threadIdx.x; j < n * half; j += blockDim.x) {
    const int h = j / half, i = j - h * half;
    rotate_pair(x + (int64_t)h * D, out + (int64_t)h * D, cs, i, half);
  }
}

__device__ __forceinline__ const float* table_row(const float* table,
                                                  int p, int L, int D) {
  return table + (int64_t)min(max(p, 0), L - 1) * D;
}

__global__ void __launch_bounds__(kThreads)
    rope_kv_decode_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ pos,
                          const int* __restrict__ tables,
                          const float* __restrict__ table,
                          bf16* __restrict__ q_out, bf16* __restrict__ k_pages,
                          bf16* __restrict__ v_pages, int H, int KV, int D,
                          int bs, int nb, int L) {
  const int b = blockIdx.x;
  const int p = pos[b];
  const float* cs = table_row(table, p, L, D);
  rotate_heads(q + (int64_t)b * H * D, q_out + (int64_t)b * H * D, cs, H, D);
  const int blk = tables[(int64_t)b * nb + min(p / bs, nb - 1)];
  const int64_t dst = ((int64_t)blk * bs + p % bs) * KV * D;
  rotate_heads(k + (int64_t)b * KV * D, k_pages + dst, cs, KV, D);
  const bf16* vr = v + (int64_t)b * KV * D;
  for (int j = threadIdx.x; j < KV * D; j += blockDim.x)
    v_pages[dst + j] = vr[j];
}

__global__ void __launch_bounds__(kThreads)
    rope_kv_packed_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ positions,
                          const int64_t* __restrict__ rows,
                          const float* __restrict__ table,
                          bf16* __restrict__ q_out, bf16* __restrict__ k_out,
                          bf16* __restrict__ v_out, int H, int KV, int D,
                          int L) {
  const int r = blockIdx.x;
  const int64_t src = rows ? rows[r] : r;
  const float* cs = table_row(table, positions[src], L, D);
  rotate_heads(q + src * H * D, q_out + (int64_t)r * H * D, cs, H, D);
  rotate_heads(k + src * KV * D, k_out + (int64_t)r * KV * D, cs, KV, D);
  if (v) {
    const bf16* vr = v + src * KV * D;
    bf16* vo = v_out + (int64_t)r * KV * D;
    for (int j = threadIdx.x; j < KV * D; j += blockDim.x) vo[j] = vr[j];
  }
}

}  // namespace

extern "C" {

// q (B, H, D), k/v (B, KV, D) bf16; pos (B,) and tables (B, nb) i32;
// table (L, D) f32; q_out (B, H, D); pages (N, bs, KV, D) bf16, in place.
int rtlm_rope_kv_decode(const void* q, const void* k, const void* v,
                        const void* pos, const void* tables,
                        const void* table, void* q_out, void* k_pages,
                        void* v_pages, int B, int H, int KV, int D, int bs,
                        int nb, int L, void* stream) {
  if (B == 0) return 0;
  rope_kv_decode_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)pos,
      (const int*)tables, (const float*)table, (bf16*)q_out, (bf16*)k_pages,
      (bf16*)v_pages, H, KV, D, bs, nb, L);
  return (int)cudaGetLastError();
}

// q (T, H, D), k/v (T, KV, D) bf16; positions (T,) i32; rows (R,) i64 or
// null (R == T); table (L, D) f32; outputs (R, H, D), (R, KV, D), and
// v_out (R, KV, D) unless v is null.
int rtlm_rope_kv_packed(const void* q, const void* k, const void* v,
                        const void* positions, const void* rows,
                        const void* table, void* q_out, void* k_out,
                        void* v_out, int R, int H, int KV, int D, int L,
                        void* stream) {
  if (R == 0) return 0;
  rope_kv_packed_kernel<<<R, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)positions,
      (const int64_t*)rows, (const float*)table, (bf16*)q_out, (bf16*)k_out,
      (bf16*)v_out, H, KV, D, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
