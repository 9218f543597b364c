// Chunked-prefill attention over a paged prefix on the tensor cores: the
// device code of the two prefill kernels, ragged_chunked_prefill.cu (every
// chunk of an engine iteration, with the fused scatter) and
// chunked_prefill_attention.cu (one chunk per sequence over pages already
// written).  _build.py hashes the shared headers into every library's
// name, so an edit here rebuilds both.
//
// Query rows.  The T x G query rows of one chunk and one KV group are
// taken in the TPU kernels' t-major order, row = t * G + g (query token t,
// head kvh * G + g), so a tile of rows is a run of tokens with all the
// group's heads.  One warp owns 16 consecutive rows; a CTA of kWarps warps
// owns kCtaRows of them, and the grid is (row tiles, KV head, chunk).
// Both kernels export kCtaRows (rtlm_prefill_cta_rows), so what reports
// their grid reads it from the library.  Rows of tokens t >= t_live are
// padding: a 16-row warp tile wholly made of them (or of rows past T * G)
// computes nothing and writes zeros, and a CTA made only of such tiles
// loads nothing.
//
// Keys.  The chunk's sequence is one run of logical positions; query t
// sees positions p <= last_key(t), a functor of the including kernel
// (the prefix and the chunk's own keys up to t).  Positions are walked in
// tiles of 64, up to the last one the CTA's last live row may see; row p
// of a tile is wherever row_at(p) says (row p % bs of page
// tables[c, p / bs], or the chunk's own K/V input), so a tile spans pages
// and a page size that does not divide 64 straddles tiles with no special
// case.  row_at returns the rows' addresses (mma::KVRow), not an offset
// from one base, because the fused prefill reads from two.  Positions
// past the CTA's last visible one are zero-filled without calling
// row_at: their table entries and pages are never read.
// The tiles go through a two-stage ring in shared memory, filled by 16-byte
// cp.async, the next tile's copy in flight while this one is computed.
//
// Products.  S = Q K^T and O += P V are mma.sync.m16n8k16 (mma_attn.cuh;
// P enters as bf16 hi + lo); the online softmax, in base 2, stays in
// registers, and a warp skips the part of a tile past its own last
// visible key.  mma.sync rather than wgmma (not probed): a warpgroup
// product takes 64 rows, which would make a 64-row tile the unit of the
// dead-row skip and of the per-row key limit, and at the serve's shapes
// these kernels' time is set by loads and launch latency, not by the
// products (PERF.md section 6: ~45x their byte bound, far from the tensor
// cores' rate).
//
// The output is staged through the warp's own (idle) query rows in shared
// memory and stored as 16-byte vectors.
#pragma once

#include "mma_attn.cuh"

namespace rtlm {
namespace prefill {

using mma::bf16;
using mma::KVRow;

constexpr int kTileKeys = 64;
constexpr int kWarpRows = 16;
// 4 warps a CTA: faster on the card than 1 or 2 at chip_smoke's and the
// serve's shapes (PERF.md section 6)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCtaRows = kWarps * kWarpRows;

// shared memory of the query rows and the two-stage K/V ring
template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(kCtaRows + 4 * kTileKeys) * (DP + 8) * sizeof(bf16);
}

// the CTAs of the grid's first dimension for T * G rows
__host__ __device__ constexpr int row_tiles(int rows) {
  return (rows + kCtaRows - 1) / kCtaRows;
}

// The CTA's rows of one chunk: q and out point at the chunk's (T, H, D)
// block.  Rows of tokens t < t_live are live.  last_key(t): the last key
// position query t sees (positions 0 .. last_key(t)), non-decreasing in t.
// row_at(p): the K and V rows of position p.
template <int DP, typename LastKey, typename RowAt>
__device__ __forceinline__ void attend(unsigned char* smem,
                                       const bf16* __restrict__ q,
                                       bf16* __restrict__ out, int T, int H,
                                       int G, int D, int kvh, int t_live,
                                       float scale_log2, LastKey last_key,
                                       RowAt row_at) {
  namespace mm = rtlm::mma;
  constexpr int THREADS = kThreads, R = kCtaRows;
  constexpr int BN = kTileKeys, LD = DP + 8, CH = DP / 8, NO = DP / 8;
  // keys of a softmax step: 8 * NT (at DP 256, 32 keys spilled registers
  // and 16 did not, PERF.md section 6)
  constexpr int NT = DP > 128 ? 2 : 8;
  constexpr int KS = 8 * NT;
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // R x LD
  bf16* k_s = q_s + R * LD;                    // 2 x BN x LD
  bf16* v_s = k_s + 2 * BN * LD;               // 2 x BN x LD
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = T * G;
  const int live_rows = min(rows, t_live * G);
  const int row0 = blockIdx.x * R, w0 = row0 + warp * kWarpRows;
  // the last live row of the CTA and of the warp, and what each may see
  const int cta_row = min(row0 + R, live_rows) - 1;
  const int warp_row = min(w0 + kWarpRows, live_rows) - 1;
  const int cta_last = cta_row >= row0 ? last_key(cta_row / G) : -1;
  const int warp_last = warp_row >= w0 ? last_key(warp_row / G) : -1;
  const int n_tiles = cta_last < 0 ? 0 : cta_last / BN + 1;

  auto load_tile = [&](int stage, int i) {
    mm::load_kv_rows<DP, THREADS>(
        k_s + stage * BN * LD, v_s + stage * BN * LD, q, BN, D,
        [&](int r) -> KVRow {
          const int p = i * BN + r;
          return p <= cta_last ? row_at(p) : KVRow{};
        });
  };
  if (n_tiles > 0) {
    mm::load_rows<DP, THREADS>(q_s, q, R, D, [&](int r) -> int64_t {
      const int row = row0 + r;
      if (row >= rows) return -1;
      const int t = row / G;
      return ((int64_t)t * H + (int64_t)kvh * G + (row - t * G)) * D;
    });
    load_tile(0, 0);
  }
  mm::cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // the last key position each of the thread's two rows sees
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + (lane >> 2) + 8 * r;
    lim[r] = row < rows ? last_key(row / G) : -1;
  }

  for (int i = 0, stage = 0; i < n_tiles; ++i, stage ^= 1) {
    if (i + 1 < n_tiles) load_tile(stage ^ 1, i + 1);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < BN / KS; ++kb) {
      const int p0 = i * BN + kb * KS;
      if (p0 > warp_last) break;  // warp-uniform; a dead warp's is -1
      float s[NT][4];
      mm::qk<DP, NT>(s, q_s + warp * kWarpRows * LD,
                     k_s + (stage * BN + kb * KS) * LD);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + j * 8 + 2 * (lane & 3) + (e & 1);
          s[j][e] = p <= lim[e >> 1] ? s[j][e] * scale_log2 : -INFINITY;
        }
      mm::online_softmax<NT, NO>(s, o, m, l);
      mm::pv<DP, NT>(o, s, v_s + (stage * BN + kb * KS) * LD);
    }
    __syncthreads();
  }
  mm::cp_async_wait<0>();

  // the warp's 16 rows (zeros for a dead tile) to bf16 in its own query
  // rows of shared memory, then out as 16-byte vectors
  bf16* o_s = q_s + warp * kWarpRows * LD;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(mm::quad_sum(l[r]), 1e-30f);
    bf16* orow = o_s + ((lane >> 2) + 8 * r) * LD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
  }
  __syncwarp();
  for (int e = lane; e < kWarpRows * CH; e += 32) {
    const int r = e / CH, c = e % CH, row = w0 + r;
    if (row < rows && c * 8 < D) {
      const int t = row / G;
      *reinterpret_cast<uint4*>(
          out + ((int64_t)t * H + (int64_t)kvh * G + (row - t * G)) * D +
          c * 8) = *reinterpret_cast<const uint4*>(o_s + r * LD + c * 8);
    }
  }
}

}  // namespace prefill
}  // namespace rtlm
