// Split-K flash decoding on the tensor cores: the device code of the two
// decode kernels, flash_decode_attention.cu (a contiguous cache with a
// per-slot mask) and paged_decode_attention.cu (a page pool named by a
// block table).  _build.py hashes the shared headers into every library's
// name, so an edit here rebuilds both.
//
// Grid (KV x row blocks, B, n_splits).  A CTA holds the G = H / KV query
// heads of one KV group as one 16-row block (G padded to 16; G > 16 takes
// several blocks), so every key/value tile it loads serves all of them,
// and walks whole 64-slot tiles of split `split` of cache row b.  The
// kernel that includes this header says, as three functors, which tiles
// are live, where slot p of the row lies in memory and which slots are
// attended; the rest is here:
//   * a two-stage ring of bf16 K/V tiles filled by 16-byte cp.async, the
//     next live tile's copy in flight while the current one is computed;
//   * four warps of 16 slots a tile, each with its own online softmax in
//     base 2 (scores scaled by scale * log2(e)); S = Q K^T and O += P V are
//     mma.sync.m16n8k16 (mma_attn.cuh; P as bf16 hi + lo);
//   * the four warps' states merged in shared memory into the split's
//     float32 partial in a workspace the wrapper allocates: acc
//     (B, H, n_splits, D), then (m, l) pairs (B, H, n_splits).  A split
//     with no attended slot writes m = -1e30, l = 0, acc = 0, so the
//     combine never reads an unwritten partial;
//   * the combine (a second kernel on the same stream, one CTA per (b, h)):
//       M = max_s m_s,  L = sum_s l_s 2^(m_s - M),
//       out = sum_s acc_s 2^(m_s - M) / max(L, 1e-30),
//     so a row with no attended slot comes out exactly 0.
#pragma once

#include "mma_attn.cuh"

namespace rtlm {
namespace split {

using mma::bf16;

constexpr int kTileKeys = 64;  // 4 warps x 16 slots
constexpr int kThreads = 128;
constexpr int kRows = 16;      // query heads of one row block
constexpr float kEmptyMax = -1e30f;

// shared memory of the query block and the two-stage K/V ring
template <int DP>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)(kRows + 4 * kTileKeys) * (DP + 8) * sizeof(bf16);
}

// this CTA's place in the grid (KV x row blocks, B, n_splits)
struct Block {
  int kvh, b, split, h0, rows;
  __device__ Block(int H, int KV) {
    const int G = H / KV, n_rb = (G + kRows - 1) / kRows;
    kvh = blockIdx.x / n_rb;
    const int rb = blockIdx.x - kvh * n_rb;
    b = blockIdx.y;
    split = blockIdx.z;
    h0 = kvh * G + rb * kRows;
    rows = min(kRows, G - rb * kRows);
  }
};

// Start (not commit) the copy of the block's query rows of q (B, H, D)
// to the head of smem; attend() commits it with the first K/V tile.
template <int DP>
__device__ __forceinline__ void load_q(unsigned char* smem, const Block& blk,
                                       const bf16* q, int H, int D) {
  mma::load_rows<DP, kThreads>(
      reinterpret_cast<bf16*>(smem), q + ((int64_t)blk.b * H + blk.h0) * D,
      kRows, D,
      [&](int r) -> int64_t { return r < blk.rows ? (int64_t)r * D : -1; });
}

// The split's attention over the live tiles of [t_begin, t_end), then its
// partial into `part`.
//   next_live(t): the first live tile >= t, or t_end if there is none;
//   row_off(p):   offset in elements of slot p's key (and value) row from
//                 kg (vg); < 0 for a slot whose row must not be read (it
//                 is zero-filled);
//   valid(p):     whether slot p is attended.
template <int DP, typename NextLive, typename RowOff, typename Valid>
__device__ __forceinline__ void attend(unsigned char* smem, const Block& blk,
                                       int H, int D, const bf16* kg,
                                       const bf16* vg, int t_begin,
                                       int t_end, float scale_log2,
                                       float* part, NextLive next_live,
                                       RowOff row_off, Valid valid) {
  namespace mm = rtlm::mma;
  constexpr int BN = kTileKeys, LD = DP + 8, NO = DP / 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // kRows x LD
  bf16* k_s = q_s + kRows * LD;                // 2 x BN x LD
  bf16* v_s = k_s + 2 * BN * LD;               // 2 x BN x LD
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto load_kv = [&](int stage, int t) {
    const int p0 = t * BN;
    mm::load_kv_rows<DP, kThreads>(
        k_s + stage * BN * LD, v_s + stage * BN * LD, kg, BN, D,
        [&](int r) -> mm::KVRow {
          const int64_t o = row_off(p0 + r);
          if (o < 0) return {};
          return {kg + o, vg + o};
        });
  };
  int cur = next_live(t_begin);
  if (cur < t_end) load_kv(0, cur);
  mm::cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int stage = 0; cur < t_end; stage ^= 1) {
    const int nxt = next_live(cur + 1);
    if (nxt < t_end) load_kv(stage ^ 1, nxt);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();

    // this warp's 16 slots of the tile
    const int w0 = warp * 16;
    float s[2][4];
    mm::qk<DP, 2>(s, q_s, k_s + (stage * BN + w0) * LD);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sp = cur * BN + w0 + j * 8 + 2 * (lane & 3) + (e & 1);
        s[j][e] = valid(sp) ? s[j][e] * scale_log2 : -INFINITY;
      }
    mm::online_softmax<2, NO>(s, o, m, l);
    mm::pv<DP, 2>(o, s, v_s + (stage * BN + w0) * LD);
    __syncthreads();
    cur = nxt;
  }
  mm::cp_async_wait<0>();
  __syncthreads();

  // merge the four warps' states in the (now idle) ring
  float* o_s = reinterpret_cast<float*>(k_s);  // 4 x kRows x DP
  float* ml_s = o_s + 4 * kRows * DP;           // 4 x kRows x (m, l)
  const int g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = mm::quad_sum(l[r]);
    float* orow = o_s + (warp * kRows + g + 8 * r) * DP;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      orow[col] = o[n][2 * r];
      orow[col + 1] = o[n][2 * r + 1];
    }
    if ((lane & 3) == 0) {
      ml_s[(warp * kRows + g + 8 * r) * 2] = m[r];
      ml_s[(warp * kRows + g + 8 * r) * 2 + 1] = lr;
    }
  }
  __syncthreads();
  const int n_splits = gridDim.z;
  const int64_t bh0 = (int64_t)blk.b * H + blk.h0;
  float* acc_out = part + (bh0 * n_splits + blk.split) * D;
  float2* ml_out = reinterpret_cast<float2*>(
                       part + (int64_t)gridDim.y * H * n_splits * D) +
                   bh0 * n_splits + blk.split;
  for (int e = threadIdx.x; e < blk.rows * D; e += blockDim.x) {
    const int r = e / D, col = e - r * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, ml_s[(w * kRows + r) * 2]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = exp2f(ml_s[(w * kRows + r) * 2] - m_use);
      acc += o_s[(w * kRows + r) * DP + col] * f;
      lsum += ml_s[(w * kRows + r) * 2 + 1] * f;
    }
    acc_out[(int64_t)r * n_splits * D + col] = acc;
    if (col == 0)
      ml_out[(int64_t)r * n_splits] =
          make_float2(mx == -INFINITY ? kEmptyMax : mx, lsum);
  }
}

// out[b, h] (bf16) from the n_splits partials of (b, h), for the CTA
// blockIdx.x = b * H + h of a grid of BH CTAs
__device__ __forceinline__ void combine(const float* __restrict__ part,
                                        bf16* __restrict__ out, int D,
                                        int n_splits, int64_t BH) {
  const int64_t bh = blockIdx.x;
  const float* acc = part + bh * n_splits * D;
  const float2* ml =
      reinterpret_cast<const float2*>(part + BH * n_splits * D) +
      bh * n_splits;
  float M = kEmptyMax;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, ml[s].x);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float f = exp2f(ml[s].x - M);
      L += ml[s].y * f;
      a += acc[(int64_t)s * D + d] * f;
    }
    out[bh * D + d] = __float2bfloat16(a / fmaxf(L, 1e-30f));
  }
}

}  // namespace split
}  // namespace rtlm
