// Flash-attention prefill on the tensor cores (wgmma), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention /
//   _fa_kernel (Pallas, TPU).
//
// What it computes: q (B, Sq, H, D) against k/v (B, Sk, KV, D) with GQA
// (head h reads KV head h / G) and positions aligned (query i and key i
// sit at position i).  Key j is attended by query i iff j <= i when causal,
// and i - j < window when a window is given, as in _fa_kernel.  Online
// softmax in float32, divided by max(l, 1e-30); a row with no key to see
// returns zeros.  D is any multiple of 8 up to 256 (h2o-danube-3-4b uses
// 120, recurrentgemma-9b 256): the tiles are zero-padded to a
// compile-time 32, 64, 128 or 256 columns.
//
// What bounds it on the H100: at prefill lengths (S in the thousands) each
// key/value row serves the whole query tile, ~2 * S operations per key
// byte, far above the ~295 operations-per-byte ridge: the bound is the
// tensor-core rate over the causal (or windowed) part of the S x S
// products.
//
// What the design does about it (wgmma.cuh, mma_attn.cuh): one CTA of two
// warpgroups per (query tile of 128 positions, head, batch row); each
// warpgroup owns 64 query rows.  Q and a two-stage ring of K/V tiles of 64
// keys sit in shared memory as bf16 in wgmma's core-matrix layout, filled
// by 16-byte cp.async, the next tile's copy in flight while the current
// one is computed.  Both products are wgmma: S = Q K^T with Q and K read
// from shared memory (m64n64k16, K-major), O += P V with P from registers
// and V read from shared memory with the transpose bit (m64nDPk16).  P
// enters as bf16 hi + lo (two products into one float32 accumulator),
// never as bf16 alone.  The online softmax stays in registers.  Only the
// key tiles the query tile can see are walked (causal: up to its last row;
// windowed: from its first row - window + 1, rounded down to a tile); a
// warpgroup skips a tile none of its rows may see, and masks element by
// element only a tile that straddles one of its rows' mask edges or the
// end of the keys.  Query tiles are scheduled longest first (causal work
// grows with the tile index).
//
// Alternatives compared with it on the card (PERF.md, section 6): both
// products as mma.sync m16n8k16 with ldmatrix operands (FA2's design), and
// one CTA an SM, were slower; so were a third ring stage, one warpgroup a
// CTA, and issuing the next tile's Q K^T before this tile's softmax (FA3's
// intra-warpgroup overlap, whose registers fit only one CTA an SM).
#include "attn_common.cuh"
#include "mma_attn.cuh"
#include "rtlm_api.cuh"
#include "wgmma.cuh"

namespace {

using rtlm::mma::bf16;

constexpr int kGroups = 2;                 // warpgroups of a CTA
constexpr int kThreads = 128 * kGroups;
constexpr int kRowsPerTile = 64 * kGroups;  // 64 query rows a warpgroup
constexpr int kTileKeys = 64;
constexpr int kStages = 2;                 // K/V ring

template <int DP>
constexpr size_t smem_bytes() {
  // Q tile, then the K and V rings, all in core-matrix layout
  return (size_t)(kRowsPerTile + 2 * kStages * kTileKeys) * DP *
         sizeof(bf16);
}

// two CTAs an SM where their shared memory fits (D <= 128): registers
// capped at 128 a thread
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
    flash_attention_kernel(
    const bf16* __restrict__ q,  // (B, Sq, H, D)
    const bf16* __restrict__ k,  // (B, Sk, KV, D)
    const bf16* __restrict__ v,
    bf16* __restrict__ out,      // (B, Sq, H, D)
    int Sq, int Sk, int H, int KV, int D, int causal, int window,
    float scale_log2) {
  namespace mm = rtlm::mma;
  namespace wg = rtlm::wg;
  constexpr int BM = kRowsPerTile, BN = kTileKeys;
  constexpr int NT = BN / 8, NO = DP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BM x DP
  bf16* k_s = q_s + BM * DP;                       // kStages x BN x DP
  bf16* v_s = k_s + kStages * BN * DP;             // kStages x BN x DP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM, h = blockIdx.y,
            b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> 2;
  const int R = min(BM, Sq - q0);

  // the keys any row of this tile may see, from a tile boundary
  int lo = 0, hi = Sk;
  if (causal) hi = min(Sk, q0 + R);
  if (window > 0) lo = max(0, q0 - window + 1) / BN * BN;
  const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;

  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KV * D;
  const bf16* qg = q + (((int64_t)b * Sq + q0) * H + h) * D;
  wg::load_rows<DP>(q_s, qg, q_stride, BM, D, [&](int r) { return r < R; });
  const bf16* kg = k + ((int64_t)b * Sk * KV + kvh) * D;
  const bf16* vg = v + ((int64_t)b * Sk * KV + kvh) * D;
  auto load_kv = [&](int stage, int k0) {
    const int nk = min(BN, Sk - k0);
    auto ok = [&](int r) { return r < nk; };
    wg::load_rows<DP>(k_s + stage * BN * DP, kg + k0 * kv_stride, kv_stride,
                      BN, D, ok);
    wg::load_rows<DP>(v_s + stage * BN * DP, vg + k0 * kv_stride, kv_stride,
                      BN, D, ok);
  };
  // the first kStages - 1 tiles in flight, one commit group each
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t, lo + t * BN);
    mm::cp_async_commit();
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // the warpgroup's first and last query position, and the thread's first
  // row (its second is 8 below)
  const int w0 = q0 + group * 64, w1 = w0 + 63;
  const int qrow = q0 + warp * 16 + (lane >> 2);
  const bf16* q_wg = q_s + group * 64 * DP;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * BN, stage = it % kStages;
    const int ahead = it + kStages - 1;
    if (ahead < n_tiles) load_kv(ahead % kStages, lo + ahead * BN);
    mm::cp_async_commit();
    mm::cp_async_wait<kStages - 1>();
    wg::fence_async_smem();
    __syncthreads();

    // a tile none of the warpgroup's rows may see (past the diagonal, or
    // before the window) is skipped; one some may not see is masked
    // element by element: past the keys, across the diagonal, or across
    // the window's lower edge
    const bool none = (causal && k0 > w1) ||
                      (window > 0 && w0 - (k0 + BN - 1) >= window);
    if (!none) {
      const bf16* ks = k_s + stage * BN * DP;
      const bf16* vs = v_s + stage * BN * DP;
      float s[NT][4];
      wg::fence_operand(s);
      wg::fence();
#pragma unroll
      for (int j = 0; j < DP / 16; ++j)
        wg::mma_ss(s, wg::desc_k<DP>(q_wg, j), wg::desc_k<DP>(ks, j), j);
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(s);

      const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > w0) ||
                        (window > 0 && w1 - k0 >= window);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int kp = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
            const int qp = qrow + (e >> 1) * 8;
            const bool valid = kp < Sk && (!causal || kp <= qp) &&
                               (window <= 0 || qp - kp < window);
            if (!valid) x = -INFINITY;
          }
          s[j][e] = x;
        }
      mm::online_softmax<NT, NO>(s, o, m, l);
      // P as bf16 hi + lo, in the register A layout of each 16-key step
      uint32_t p_hi[NT / 2][4], p_lo[NT / 2][4];
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        mm::split_p(s[2 * kk], s[2 * kk + 1], p_hi[kk], p_lo[kk]);
      wg::fence_operand(o);
      wg::fence_operand(p_hi);
      wg::fence_operand(p_lo);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint64_t dv = wg::desc_mn<DP>(vs, kk);
        wg::mma_rs_tb(o, p_hi[kk], dv);
        wg::mma_rs_tb(o, p_lo[kk], dv);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(o);
    }
    __syncthreads();
  }
  mm::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(mm::quad_sum(l[r]), 1e-30f);
    const int qp = qrow + r * 8;
    if (qp < Sq) {
      bf16* og = out + (((int64_t)b * Sq + qp) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = n * 8 + 2 * (lane & 3);
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(og + col) =
              __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
      }
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DP>();
  cudaError_t err =
      rtlm::allow_smem((const void*)flash_attention_kernel<DP>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kRowsPerTile - 1) / kRowsPerTile, H, B);
  flash_attention_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Sq, Sk, H,
      KV, D, causal, window, scale * rtlm::mma::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// window <= 0 means no window.  D must be a multiple of 8 up to 256, and
// q, k, v, out 16-byte aligned (the wrapper checks both).
int rtlm_flash_attention(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int KV,
                         int D, int causal, int window, float scale,
                         void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rtlm::mma::padded_head_dim(D)) {
    case 32:
      return launch<32>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                        scale, st);
    case 64:
      return launch<64>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                        scale, st);
    case 128:
      return launch<128>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                         scale, st);
    case 256:
      return launch<256>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                         scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
