// Shared device code of the port's tensor-core attention kernels
// (flash_attention.cu, the two split-K decode kernels through
// split_decode.cuh, and the two prefill kernels through
// prefill_attn.cuh).  _build.py hashes the shared headers into every
// library's name, so an edit here rebuilds all of them.
//
// Tiles live in shared memory as bf16, DP columns wide (the head dim D
// zero-padded up to a compile-time 32, 64, 128 or 256).  Copies into them
// are 16-byte cp.async (D must be a multiple of 8), which zero-fill the
// pad columns [D, DP).  For the mma.sync products (split-K decode,
// prefill) a tile
// is row-major with a row stride of DP + 8 elements: the 16 extra bytes
// shift each row by one 16-byte bank group, so the eight row addresses of
// an ldmatrix hit eight different groups.  (The wgmma products of flash
// attention take another layout: wgmma.cuh.)
//
// One warp owns 16 query rows.  Both products run on the tensor cores as
// mma.sync.m16n8k16 (bf16 operands, float32 accumulators):
//   * S = Q K^T: A = Q (ldmatrix), B = K rows (ldmatrix, no transpose);
//     the bf16 products are exact, so S differs from a float32 upcast
//     only in the order of summation;
//   * O += P V: A = P straight from the S accumulators (the m16n8 C
//     layout of two adjacent key tiles is the m16k16 A layout), B = V
//     rows (ldmatrix.trans).  P is split into hi = bf16(P) and
//     lo = bf16(P - hi), and both products go into the one float32
//     accumulator: P keeps ~16 bits of mantissa.  Rounding P to bf16
//     alone (8 bits) would use most of the kernel-vs-plain limit of
//     kernels/compare.py at S in the thousands.
// The online softmax (running max m, running sum l, the rescale of O)
// stays in registers, in base 2: scores are scaled by scale * log2(e).
// Each thread holds two rows (lane / 4 and lane / 4 + 8) of each
// accumulator; the four lanes of a quad share a row (wgmma's accumulators
// keep the same layout for each warp's 16 rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtlm {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// The compile-time width a head dim D is padded to; 0: not taken.
__host__ __device__ constexpr int padded_head_dim(int D) {
  return (D <= 0 || D % 8) ? 0
         : D <= 32         ? 32
         : D <= 64         ? 64
         : D <= 128        ? 128
         : D <= 256        ? 256
                           : 0;
}

// 16 bytes global -> shared, asynchronously; !valid fills zeros (the
// source is not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi); x0 in the low half
__device__ __forceinline__ void split_hi_lo(float x0, float x1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Copy `rows` rows of D bf16 into smem rows of stride DP + 8, 16 bytes a
// thread per step: row r from src + off(r) elements, or zeros where
// off(r) < 0 (a row that must not be read).  The pad columns [D, DP) are
// zero-filled.  off is the row-to-address rule: a stride over a
// contiguous cache, or a block-table lookup over a paged one.  All
// THREADS threads of the block take part.
template <int DP, int THREADS, typename Off>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int rows, int D, Off off) {
  constexpr int LD = DP + 8, CH = DP / 8;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const int64_t o = off(r);
    const bool v = o >= 0 && c * 8 < D;
    cp_async16(dst + r * LD + c * 8, src + (v ? o + c * 8 : 0), v);
  }
}

// Where the key and value rows of one position lie; k == nullptr (the
// default): a row that must not be read, zero-filled.
struct KVRow {
  const bf16* k = nullptr;
  const bf16* v = nullptr;
};

// The same for a key and a value tile: row r from row(r) (a KVRow), so a
// tile may gather its rows from more than one base (the fused prefill
// takes its prefix from the pages and its chunk's own rows from the new
// K/V).  any: a global address for the zero-filled copies, which read
// nothing from it (source size 0).
template <int DP, int THREADS, typename Row>
__device__ __forceinline__ void load_kv_rows(bf16* k_dst, bf16* v_dst,
                                             const bf16* any, int rows,
                                             int D, Row row) {
  constexpr int LD = DP + 8, CH = DP / 8;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const KVRow src = row(r);
    const bool v = src.k != nullptr && c * 8 < D;
    cp_async16(k_dst + r * LD + c * 8, v ? src.k + c * 8 : any, v);
    cp_async16(v_dst + r * LD + c * 8, v ? src.v + c * 8 : any, v);
  }
}

// s[j] = Q rows [0, 16) of q_s . K rows [8j, 8j + 8) of k_s over all DP
// columns (the pad is zeros).  q_s and k_s point at the warp's first row.
template <int DP, int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], const bf16* q_s,
                                   const bf16* k_s) {
  static_assert(NT % 2 == 0, "key tiles come in pairs");
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, q_s + a_row * LD + kk * 16 + a_col);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, k_s + (jp * 16 + b_row) * LD + kk * 16 + b_col);
      mma16816(s[2 * jp], a, b[0], b[1]);
      mma16816(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// P (16 x 16 keys, the accumulators of two key tiles of qk) as the m16k16
// A operand, bf16 hi + lo
__device__ __forceinline__ void split_p(const float (&p0)[4],
                                       const float (&p1)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_hi_lo(p0[0], p0[1], hi[0], lo[0]);
  split_hi_lo(p0[2], p0[3], hi[1], lo[1]);
  split_hi_lo(p1[0], p1[1], hi[2], lo[2]);
  split_hi_lo(p1[2], p1[3], hi[3], lo[3]);
}

// o += P . V: P = s (probabilities, the accumulators of qk), V rows
// [0, 8 * NT) of v_s, all DP columns; P enters as hi + lo bf16.
template <int DP, int NT>
__device__ __forceinline__ void pv(float (&o)[DP / 8][4],
                                   const float (&s)[NT][4], const bf16* v_s) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t hi[4], lo[4];
    split_p(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, v_s + (kk * 16 + v_row) * LD + np * 16 + v_col);
      mma16816(o[2 * np], hi, b[0], b[1]);
      mma16816(o[2 * np], lo, b[0], b[1]);
      mma16816(o[2 * np + 1], hi, b[2], b[3]);
      mma16816(o[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// One tile of the online softmax for the thread's two rows of one row
// tile.  s holds the tile's scores in base 2 with masked entries at
// -INFINITY; on return it holds the probabilities exp2(s - m), exactly 0
// where masked.  m is the running max (-INFINITY until a row has seen a
// valid key), l the thread's share of the running sum (the quad's four
// shares add up to the row's), and o is rescaled by exp2(m_old - m_new).
// A row with nothing valid so far keeps o == 0 and l == 0.
template <int NT, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&o)[NO][4],
                                               float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2f(m[r] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * r] = exp2f(s[j][2 * r] - m_use);
      s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_use);
      sum += s[j][2 * r] + s[j][2 * r + 1];
    }
    l[r] = l[r] * corr + sum;
    m[r] = m_new;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * r] *= corr;
      o[n][2 * r + 1] *= corr;
    }
  }
}

// the row's whole running sum from the quad's four shares
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma
}  // namespace rtlm
