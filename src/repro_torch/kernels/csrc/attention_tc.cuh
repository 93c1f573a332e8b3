// Shared building blocks of the two bf16 attention kernels on Hopper's
// tensor cores (flash_attention_tc.cu and serve_prefill.cu): one CTA
// attends one 64-row query tile to the key tiles a mask policy lists,
// FlashAttention-2 on mma.sync.m16n8k16 (bf16 in, float32 accumulate):
//
//   * each of the 4 warps owns 16 query rows, whose Q fragments stay in
//     registers for the whole key loop;
//   * key / value tiles of BK = 64 rows are double-buffered in shared
//     memory with cp.async (16 bytes a lane, zero-filled past the keys
//     and past d), rows padded by 16 bytes so that ldmatrix is
//     conflict-free;
//   * S = Q K^T stays in registers (ldmatrix for K); the online softmax
//     runs there too (quad shuffles for the row max, exp2f with the
//     scale folded into log2 e, each thread's share of the row sum kept
//     apart until the end);
//   * P goes to the A operand of P V in registers (ldmatrix.trans for V),
//     never through shared memory.  P is split into its bf16 rounding
//     and the bf16 rounding of the remainder, and both are multiplied:
//     P V then carries ~16 bits of P, where one bf16 P would cost up to
//     2^-8 of max|v| per element, more than the one-bf16-step check of
//     the output allows near 0.  The second product costs half the
//     P V work again;
//   * the policy says which key tiles the CTA visits (tiles it skips are
//     never loaded), which a warp can skip, on which the mask is all
//     true (no per-element mask: the interior of a band), and the mask
//     and score transform per element on the rest.
//
// The head dim is padded to 16, 32, 64 or 128; d % 8 != 0 (or a
// misaligned base) loads through plain zero-filling loads instead of
// cp.async.  A row that sees no key is written as exactly 0.
//
// A Policy provides (all warp-uniform except visible and score):
//   int ntiles() const;              key tiles the CTA visits
//   int tile_start(int t) const;     first key of the t-th of them
//   bool warp_sees(int j0, int warp, int i_lo, int i_hi) const;
//                                    may a key of the tile be visible to
//                                    one of the warp's rows i_lo..i_hi?
//   bool warp_full(int j0, int warp, int i_lo, int i_hi) const;
//                                    is every (row, key) pair visible?
//   bool visible(int i, int j) const;
//   float score(float qk) const;     q . k -> the score in log2 units

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_tc {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;        // keys per tile
constexpr int STAGES = 2;     // key / value tiles in flight
constexpr int WARPS = 4;      // 16 query rows each
constexpr int NT = WARPS * 32, BQ = WARPS * 16;   // threads, query rows
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the Q tile and the K / V stages, head dim padded to DP.
template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  return (BQ + 2 * STAGES * BK) * (DP + 8) * (int)sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; bytes past src_bytes (0 or 16) are zeroed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, float32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16,
// column-major).  Fragments (g = lane / 4, t = lane % 4): a[0] row g,
// cols 2t, 2t+1; a[1] row g+8; a[2] row g, cols 2t+8, 2t+9; a[3] row g+8
// of those; b0 rows 2t, 2t+1 of col g, b1 rows 2t+8, 2t+9; c[0..1] row g,
// cols 2t, 2t+1; c[2..3] row g+8.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring columns (lower one in the low half) as a bf16 pair, and
// the bf16 pair of what that rounding left.
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
  const bf16 l0 = __float2bfloat16_rn(p0 - __bfloat162float(h0));
  const bf16 l1 = __float2bfloat16_rn(p1 - __bfloat162float(h1));
  hi = (uint32_t)__bfloat16_as_ushort(h0) |
       ((uint32_t)__bfloat16_as_ushort(h1) << 16);
  lo = (uint32_t)__bfloat16_as_ushort(l0) |
       ((uint32_t)__bfloat16_as_ushort(l1) << 16);
}

// Stage a rows x DP tile of a matrix with row stride d (first `valid`
// rows and first d columns real, the rest zero) at row stride DP + 8.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int rows, int valid, int d,
                                          bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {        // d % 8 == 0 and src 16-byte aligned: cp.async
    constexpr int CPR = DP / 8;
    for (int idx = threadIdx.x; idx < rows * CPR; idx += NT) {
      const int r = idx / CPR, col = (idx % CPR) * 8;
      const bool ok = r < valid && col < d;
      cp_async16(smem_addr(dst + r * LD + col),
                 ok ? src + (size_t)r * d + col : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += NT) {
      const int r = idx / DP, col = idx % DP;
      dst[r * LD + col] = (r < valid && col < d) ? src[(size_t)r * d + col]
                                                 : __float2bfloat16(0.f);
    }
  }
}

// Stage the query tile (rows q0 .. q0 + BQ - 1 of n_q) at the front of
// smem, as attend's first cp.async group.
template <int DP>
__device__ __forceinline__ void load_q_tile(unsigned char* smem,
                                            const bf16* __restrict__ q,
                                            int q0, int n_q, int d,
                                            bool vec) {
  load_tile<DP>(reinterpret_cast<bf16*>(smem), q + (size_t)q0 * d, BQ,
                min(BQ, n_q - q0), d, vec);
}

// Attend query rows q0 .. q0 + BQ - 1 (of n_q, row stride d; q, o point
// at row 0 of the head) to the key tiles `pol` lists (of n_k keys; k, v
// point at key 0 of the kv head).  smem: smem_bytes<DP>() bytes.
// Q_ISSUED: the caller has issued load_q_tile (and committed it) already,
// so that the query tile's load overlaps the caller's own set-up.
template <int DP, class Policy, bool Q_ISSUED = false>
__device__ __forceinline__ void attend(const Policy& pol, unsigned char* smem,
                                       const bf16* __restrict__ q,
                                       const bf16* __restrict__ kb,
                                       const bf16* __restrict__ vb,
                                       bf16* __restrict__ o, int q0, int n_q,
                                       int n_k, int d, bool vec) {
  constexpr int LD = DP + 8;
  constexpr int KD = DP / 16;     // k-steps of Q K^T over the head dim
  constexpr int NS = BK / 8;      // score tiles of 8 keys
  constexpr int NO = DP / 8;      // output tiles of 8 dims
  bf16* sq = reinterpret_cast<bf16*>(smem);         // BQ x LD
  bf16* sk = sq + BQ * LD;                          // STAGES x BK x LD
  bf16* sv = sk + STAGES * BK * LD;                 // STAGES x BK x LD

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;      // mma fragment coordinates
  const int lr = lane & 7, lm = lane >> 3;     // ldmatrix row, matrix
  const int ntiles = pol.ntiles();

  if (!Q_ISSUED) load_q_tile<DP>(smem, q, q0, n_q, d, vec);
  if (ntiles > 0) {
    const int j0 = pol.tile_start(0);
    load_tile<DP>(sk, kb + (size_t)j0 * d, BK, min(BK, n_k - j0), d, vec);
    load_tile<DP>(sv, vb + (size_t)j0 * d, BK, min(BK, n_k - j0), d, vec);
  }
  cp_async_commit();

  const int i_lo = q0 + warp * 16, i_hi = i_lo + 15;   // the warp's rows
  uint32_t qf[KD][4];
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = pol.tile_start(t), st = t & 1;
    if (t + 1 < ntiles) {        // prefetch the next tile into the other stage
      const int j1 = pol.tile_start(t + 1);
      load_tile<DP>(sk + (st ^ 1) * BK * LD, kb + (size_t)j1 * d, BK,
                    min(BK, n_k - j1), d, vec);
      load_tile<DP>(sv + (st ^ 1) * BK * LD, vb + (size_t)j1 * d, BK,
                    min(BK, n_k - j1), d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldsm_x4(qf[kd], smem_addr(sq + (warp * 16 + lr + (lm & 1) * 8) * LD +
                                  kd * 16 + (lm >> 1) * 8));
    }
    const bf16* skt = sk + st * BK * LD;
    const bf16* svt = sv + st * BK * LD;
    if (pol.warp_sees(j0, warp, i_lo, i_hi)) {      // warp-uniform
      float sacc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, smem_addr(skt + (np * 16 + lr + (lm >> 1) * 8) * LD +
                                kd * 16 + (lm & 1) * 8));
          mma16816(sacc[2 * np], qf[kd], kf[0], kf[1]);
          mma16816(sacc[2 * np + 1], qf[kd], kf[2], kf[3]);
        }
      }

      const bool full = pol.warp_full(j0, warp, i_lo, i_hi);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = pol.score(sacc[n][e]);
          if (!full) {
            const int i = i_lo + g + (e >> 1) * 8;
            const int j = j0 + n * 8 + tq * 2 + (e & 1);
            if (!pol.visible(i, j)) x = -INFINITY;
          }
          sacc[n][e] = x;
        }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(sacc[n][2 * r], sacc[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[r] - m_use);   // 0 while m was -inf
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float p0 = exp2f(sacc[n][2 * r] - m_use);
          const float p1 = exp2f(sacc[n][2 * r + 1] - m_use);
          sacc[n][2 * r] = p0;
          sacc[n][2 * r + 1] = p1;
          rs += p0 + p1;
        }
        l[r] = l[r] * alpha + rs;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          oacc[n][2 * r] *= alpha;
          oacc[n][2 * r + 1] *= alpha;
        }
      }

#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split2(sacc[2 * kk][0], sacc[2 * kk][1], ph[0], pl[0]);
        split2(sacc[2 * kk][2], sacc[2 * kk][3], ph[1], pl[1]);
        split2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ph[2], pl[2]);
        split2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ph[3], pl[3]);
        // all P_hi products first, then all P_lo ones: the two products
        // into one accumulator are NO apart, not back to back
        uint32_t vf[NO / 2][4];
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          ldsm_x4_trans(vf[dp], smem_addr(svt + (kk * 16 + lr + (lm & 1) * 8) *
                                          LD + dp * 16 + (lm >> 1) * 8));
          mma16816(oacc[2 * dp], ph, vf[dp][0], vf[dp][1]);
          mma16816(oacc[2 * dp + 1], ph, vf[dp][2], vf[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          mma16816(oacc[2 * dp], pl, vf[dp][0], vf[dp][1]);
          mma16816(oacc[2 * dp + 1], pl, vf[dp][2], vf[dp][3]);
        }
      }
    }
    __syncthreads();             // stage st is consumed before it is refilled
  }
  if (ntiles == 0) cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = i_lo + g + r * 8;
    if (i >= n_q) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;   // 0: no visible key
    bf16* row = o + (size_t)i * d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + tq * 2;
      const float a = oacc[n][2 * r] * inv, c = oacc[n][2 * r + 1] * inv;
      if (col + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(a, c);
      } else {
        if (col < d) row[col] = __float2bfloat16_rn(a);
        if (col + 1 < d) row[col + 1] = __float2bfloat16_rn(c);
      }
    }
  }
}

}  // namespace attn_tc
