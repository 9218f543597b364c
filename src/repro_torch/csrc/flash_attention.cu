// FlashAttention-2-style prefill attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention /
//   _fa_kernel (Pallas, TPU).
//
// What it computes: q (B, Sq, H, D) against k/v (B, Sk, KV, D) with GQA
// (head h reads KV head h / G) and positions aligned (query i and key i
// sit at position i).  Key j is attended by query i iff j <= i when causal,
// and i - j < window when a window is given, as in _fa_kernel.  Online
// softmax in float32, divided by max(l, 1e-30); a row with no key to see
// returns zeros.  D is a runtime value (h2o-danube-3-4b uses 120).
//
// What bounds it on the H100: at prefill lengths (S in the thousands) each
// key/value row serves the whole query tile, ~2 * S operations per key
// byte, far above the ~295 operations-per-byte ridge: the bound is the
// tensor-core rate over the causal (or windowed) half of the S x S
// products.
//
// What the design does about it: one CTA per (query tile of kRowsPerTile
// positions, head, batch row), walking key tiles of kTileKeys with the
// online softmax kept in shared memory.  Only the key range the tile can
// see is walked: up to its last query row when causal, and from its first
// query row minus window + 1 when windowed, so fully masked tiles are never
// visited.  (The TPU kernel visits them and relies on corr = exp(m_prev -
// m_new) = 0 to wipe a first all-masked tile; here masked probabilities
// are exactly 0 and the accumulator starts at 0, so no tile can leave
// garbage behind.)  This first version computes in float32 on the CUDA
// cores; wgmma, TMA and keeping the group's heads in one CTA are later work.
#include "attn_common.cuh"
#include "rtlm_api.cuh"

namespace {

constexpr int kRowsPerTile = 64;
constexpr int kTileKeys = 32;
constexpr int kThreads = 256;

struct FaValid {
  int q0, k0, causal, window;  // window <= 0: none
  __device__ bool operator()(int r, int t) const {
    const int qp = q0 + r, kp = k0 + t;
    return (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
  }
};

__global__ void flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Sq, H, D)
    const __nv_bfloat16* __restrict__ k,  // (B, Sk, KV, D)
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ out,      // (B, Sq, H, D)
    int Sq, int Sk, int H, int KV, int D, int causal, int window,
    float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kRowsPerTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int R = min(kRowsPerTile, Sq - q0);
  const rtlm::Smem sm = rtlm::carve(smem, kRowsPerTile, kTileKeys, D);

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    sm.q[r * (D + 1) + d] = __bfloat162float(
        q[(((int64_t)b * Sq + q0 + r) * H + h) * D + d]);
  }
  rtlm::init_state(sm, R, D);
  __syncthreads();

  // the keys any row of this tile may see
  int lo = 0, hi = Sk;
  if (causal) hi = min(Sk, q0 + R);
  if (window > 0) lo = max(0, q0 - window + 1);
  const int64_t row_stride = (int64_t)KV * D;
  for (int k0 = lo; k0 < hi; k0 += kTileKeys) {
    const int nk = min(kTileKeys, hi - k0);
    const int64_t off = (((int64_t)b * Sk + k0) * KV + kvh) * D;
    rtlm::load_kv_rows(sm, k + off, v + off, row_stride, nk, D);
    __syncthreads();
    rtlm::attend_tile(sm, R, kTileKeys, nk, D, scale,
                      FaValid{q0, k0, causal, window});
  }

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    out[(((int64_t)b * Sq + q0 + r) * H + h) * D + d] =
        __float2bfloat16(sm.acc[e] / fmaxf(sm.l[r], 1e-30f));
  }
}

}  // namespace

extern "C" {

// window <= 0 means no window.
int rtlm_flash_attention(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int KV,
                         int D, int causal, int window, float scale,
                         void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const int n_tiles = (Sq + kRowsPerTile - 1) / kRowsPerTile;
  const size_t bytes =
      rtlm::smem_floats(kRowsPerTile, kTileKeys, D) * sizeof(float);
  cudaError_t err =
      rtlm::allow_smem((const void*)flash_attention_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, H, B);
  flash_attention_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Sq, Sk, H, KV, D, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
