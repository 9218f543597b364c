// Split-K flash-decode attention over a contiguous cache, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py,
//   flash_decode_attention / _fd_kernel (Pallas, TPU).
//
// What it computes: one-token GQA attention for each of B rows over a
// contiguous cache (B, S, KV, D); slot s of row b is attended iff
// mask[b, s] (ring-buffer slots are resolved to that mask by the caller).
// Online softmax in float32.  A row whose mask is all false returns zeros
// (the port's empty-row rule).  The Pallas kernel does not re-mask the
// probabilities after the max shift, so there such a row averages the
// values of its masked slots, padding included; the probabilities here are
// exactly 0 wherever the mask is false.  D is any multiple of 8 up to 256.
//
// What bounds it on the H100: memory.  Each key/value byte serves
// G = H / KV query heads (2 * G operations per bf16 element), far below the
// ~295 operations per byte where the tensor cores would become the limit;
// the bytes that must move are the valid slots' keys and values, once.
//
// What the design does about it: flash-decoding.  One B x KV grid of
// groups fills a quarter of the card at serving batch sizes, so the cache
// rows are split over S as well: grid (KV x row blocks, B, n_splits), with
// n_splits chosen on the host (kernels/flash_decode_attention.py,
// split_plan) for about two CTAs per SM and never a split shorter than one
// 64-slot tile.  A CTA holds its group's G query heads as one 16-row block
// (G padded to 16; G > 16 takes several blocks), so every key/value tile
// it loads serves all of them.  It first reads its split's mask once and
// marks the tiles with a valid slot, then streams only those through a
// two-stage ring of bf16 tiles filled by 16-byte cp.async, the next tile's
// copy in flight while the current one is computed.  Each of its four warps
// takes 16 slots of a 64-slot tile and keeps its own online softmax:
// Q K^T and P V are mma.sync.m16n8k16 (mma_attn.cuh; P as bf16 hi + lo),
// so the arithmetic is a few instructions per tile and never holds up the
// copies.  The four warps' states merge in shared memory into the split's
// partial (m, l, acc), float32, in a workspace the wrapper allocates;
// a split with no valid slot writes m = -1e30, l = 0, acc = 0.  A second
// kernel on the same stream combines the partials of each (row, head):
//   M = max_s m_s,  L = sum_s l_s 2^(m_s - M),
//   out = sum_s acc_s 2^(m_s - M) / max(L, 1e-30)
// (base 2: the scores are scaled by scale * log2(e)), so an all-masked row
// comes out exactly zero.
#include "attn_common.cuh"
#include "mma_attn.cuh"
#include "rtlm_api.cuh"

namespace {

using rtlm::mma::bf16;

constexpr int kTileKeys = 64;  // 4 warps x 16 slots
constexpr int kThreads = 128;
constexpr int kRows = 16;      // query heads of one row block
constexpr float kEmptyMax = -1e30f;

template <int DP>
constexpr size_t ring_bytes() {
  return (size_t)(kRows + 4 * kTileKeys) * (DP + 8) * sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(
    const bf16* __restrict__ q,        // (B, H, D)
    const bf16* __restrict__ k_cache,  // (B, S, KV, D)
    const bf16* __restrict__ v_cache,
    const uint8_t* __restrict__ mask,  // (B, S) bool
    float* __restrict__ part,          // acc (B, H, n_splits, D), then
                                       // (m, l) (B, H, n_splits, 2)
    int S, int H, int KV, int D, int tiles_per_split, float scale_log2) {
  namespace mm = rtlm::mma;
  constexpr int BN = kTileKeys, LD = DP + 8, NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kRows x LD
  bf16* k_s = q_s + kRows * LD;                    // 2 x BN x LD
  bf16* v_s = k_s + 2 * BN * LD;                   // 2 x BN x LD
  int* live = reinterpret_cast<int*>(v_s + 2 * BN * LD);  // tiles_per_split

  const int G = H / KV, n_rb = (G + kRows - 1) / kRows;
  const int kvh = blockIdx.x / n_rb, rb = blockIdx.x - kvh * n_rb;
  const int b = blockIdx.y, split = blockIdx.z, n_splits = gridDim.z;
  const int h0 = kvh * G + rb * kRows, rows = min(kRows, G - rb * kRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t_begin = split * tiles_per_split;
  const int t_end = min((S + BN - 1) / BN, t_begin + tiles_per_split);
  const int s_begin = t_begin * BN, s_end = min(S, t_end * BN);
  const uint8_t* mrow = mask + (int64_t)b * S;

  mm::load_rows<DP>(q_s, q + ((int64_t)b * H + h0) * D, D, kRows, D,
                    [&](int r) { return r < rows; });
  // which of the split's tiles hold a valid slot
  for (int t = threadIdx.x; t < t_end - t_begin; t += blockDim.x) live[t] = 0;
  __syncthreads();
  for (int s = s_begin + threadIdx.x; s < s_end; s += blockDim.x)
    if (mrow[s]) live[(s - s_begin) / BN] = 1;
  __syncthreads();
  auto next_live = [&](int t) {
    while (t < t_end && !live[t - t_begin]) ++t;
    return t;
  };

  const int64_t kv_stride = (int64_t)KV * D;
  const bf16* kg = k_cache + ((int64_t)b * S * KV + kvh) * D;
  const bf16* vg = v_cache + ((int64_t)b * S * KV + kvh) * D;
  auto load_kv = [&](int stage, int t) {
    const int s0 = t * BN, nk = min(BN, S - s0);
    auto ok = [&](int r) { return r < nk; };
    mm::load_rows<DP>(k_s + stage * BN * LD, kg + s0 * kv_stride, kv_stride,
                      BN, D, ok);
    mm::load_rows<DP>(v_s + stage * BN * LD, vg + s0 * kv_stride, kv_stride,
                      BN, D, ok);
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
        s[j][e] = (sp < S && mrow[sp]) ? s[j][e] * scale_log2 : -INFINITY;
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
  const int64_t bh0 = (int64_t)b * H + h0;
  float* acc_out = part + (bh0 * n_splits + split) * D;
  float2* ml_out = reinterpret_cast<float2*>(
                       part + (int64_t)gridDim.y * H * n_splits * D) +
                   bh0 * n_splits + split;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
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

// out[b, h] from the n_splits partials of (b, h); one CTA per (b, h)
__global__ void flash_decode_combine_kernel(const float* __restrict__ part,
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

template <int DP>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* mask, void* out, void* part, int B, int S, int H,
           int KV, int D, int n_splits, int tiles_per_split, float scale,
           cudaStream_t stream) {
  const int G = H / KV, n_rb = (G + kRows - 1) / kRows;
  const size_t bytes = ring_bytes<DP>() + (size_t)tiles_per_split * 4;
  cudaError_t err =
      rtlm::allow_smem((const void*)flash_decode_split_kernel<DP>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV * n_rb, B, n_splits);
  flash_decode_split_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache,
      (const uint8_t*)mask, (float*)part, S, H, KV, D, tiles_per_split,
      scale * rtlm::mma::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t BH = (int64_t)B * H;
  flash_decode_combine_kernel<<<(unsigned)BH, kThreads, 0, stream>>>(
      (const float*)part, (bf16*)out, D, n_splits, BH);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part: float32 workspace of B * H * n_splits * (D + 2) elements;
// n_splits * tiles_per_split * 64 >= S > (n_splits - 1) * tiles_per_split
// * 64 (kernels/flash_decode_attention.py, split_plan).  D must be a
// multiple of 8 up to 256, and q, the caches and out 16-byte aligned.
int rtlm_flash_decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* mask,
                                void* out, void* part, int B, int S, int H,
                                int KV, int D, int n_splits,
                                int tiles_per_split, float scale,
                                void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0)  // nothing to attend: zeros
    return (int)cudaMemsetAsync(out, 0, (size_t)B * H * D * sizeof(bf16), st);
  switch (rtlm::mma::padded_head_dim(D)) {
    case 32:
      return launch<32>(q, k_cache, v_cache, mask, out, part, B, S, H, KV, D,
                        n_splits, tiles_per_split, scale, st);
    case 64:
      return launch<64>(q, k_cache, v_cache, mask, out, part, B, S, H, KV, D,
                        n_splits, tiles_per_split, scale, st);
    case 128:
      return launch<128>(q, k_cache, v_cache, mask, out, part, B, S, H, KV,
                         D, n_splits, tiles_per_split, scale, st);
    case 256:
      return launch<256>(q, k_cache, v_cache, mask, out, part, B, S, H, KV,
                         D, n_splits, tiles_per_split, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
