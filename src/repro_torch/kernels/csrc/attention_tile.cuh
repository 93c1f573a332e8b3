// Shared building blocks of the two attention kernels (flash_attention.cu
// and serve_prefill.cu): one query tile of a CTA, staged K/V tiles, and
// an online softmax per row in float32.
//
// Layout of a CTA: BQ = 64 query rows, 4 warps of 16 rows each.  Keys are
// staged BK = 32 at a time (one per lane) in shared memory as float32.
// Per staged tile each warp
//
//   1. scores: lane j holds key j's row 32 dims at a time in registers and
//      dots it with the warp's 16 query rows (read from shared memory as
//      float4 broadcasts), giving s[r] = q_r . k_j for its key;
//   2. masks, soft-caps and folds the 32 scores of each row into the
//      row's running max m and sum l (two warp reductions per row), and
//      writes p = exp(s - m) to a per-warp scratch row;
//   3. accumulates p . V: lane c owns dims c, c + 32, ... of the output
//      and reads four p values at a time as one float4 broadcast.
//
// Everything is float32 CUDA-core arithmetic (no tensor cores): the
// inputs may be float32, and the plain versions they are held against
// accumulate in float32.  Rows and dims beyond the tensor are zero-filled
// in shared memory, so any sequence length and any head dim up to 128
// (NC = ceil(d / 32) chunks of 32) run, and NC = 8 (head dims up to 256)
// for the flash kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int BQ = 64;              // query rows per CTA
constexpr int BK = 32;              // keys per staged tile, one per lane
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;    // query rows per warp
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one CTA for head dim chunks NC (DP = 32 NC floats).
template <int NC>
struct Smem {
  static constexpr int DP = NC * 32;
  static constexpr int KS = DP + 1;   // odd K row stride: lane j reads row j
  float q[BQ * DP];                   // query tile, pre-scaled
  float k[BK * KS];
  float v[BK * DP];
  float p[WARPS * ROWS * BK];         // per-warp probabilities of a tile
};

template <int NC>
constexpr size_t smem_bytes() { return sizeof(Smem<NC>); }

// Running softmax state of one warp's rows (uniform across the warp
// except acc, whose lane holds dims lane + 32 t).
template <int NC>
struct RowState {
  float m[ROWS];
  float l[ROWS];
  float acc[ROWS][NC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int t = 0; t < NC; ++t) acc[r][t] = 0.f;
    }
  }
};

// Load `rows` rows of d values (row stride d) into the query tile, times
// `scale`; the rest of the tile is zero.
template <typename T, int NC>
__device__ void load_q(Smem<NC>& sm, const T* __restrict__ src, int rows,
                       int d, float scale) {
  constexpr int DP = Smem<NC>::DP;
  for (int idx = threadIdx.x; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP, c = idx - r * DP;
    sm.q[idx] = (r < rows && c < d) ? to_f32(src[(size_t)r * d + c]) * scale
                                    : 0.f;
  }
}

// Stage `rows` keys and values (row stride d); the rest of the tile is 0.
template <typename T, int NC>
__device__ void load_kv(Smem<NC>& sm, const T* __restrict__ k,
                        const T* __restrict__ v, int rows, int d) {
  constexpr int DP = Smem<NC>::DP, KS = Smem<NC>::KS;
  for (int idx = threadIdx.x; idx < BK * DP; idx += THREADS) {
    const int r = idx / DP, c = idx - r * DP;
    const bool ok = r < rows && c < d;
    sm.k[r * KS + c] = ok ? to_f32(k[(size_t)r * d + c]) : 0.f;
    sm.v[idx] = ok ? to_f32(v[(size_t)r * d + c]) : 0.f;
  }
}

// Fold one staged key tile (absolute keys j0 .. j0 + BK - 1) into the
// warp's rows (absolute rows i0 .. i0 + ROWS - 1).  `visible(i, j)`
// decides the mask; `softcap` > 0 applies softcap * tanh(s / softcap)
// to the scaled scores first.  A masked score contributes exactly 0.
template <int NC, typename Visible>
__device__ __forceinline__ void fold_tile(Smem<NC>& sm,
                                          RowState<NC>& st, int warp,
                                          int lane, int i0, int j0,
                                          float softcap,
                                          const Visible& visible) {
  constexpr int DP = Smem<NC>::DP, KS = Smem<NC>::KS;
  float s[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
  const float* krow = sm.k + lane * KS;
  const float* qw = sm.q + warp * ROWS * DP;
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    float kr[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) kr[c] = krow[t * 32 + c];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4* qr = reinterpret_cast<const float4*>(qw + r * DP + t * 32);
      float a = s[r];
#pragma unroll
      for (int c4 = 0; c4 < 8; ++c4) {
        const float4 x = qr[c4];
        a = fmaf(x.x, kr[4 * c4 + 0], a);
        a = fmaf(x.y, kr[4 * c4 + 1], a);
        a = fmaf(x.z, kr[4 * c4 + 2], a);
        a = fmaf(x.w, kr[4 * c4 + 3], a);
      }
      s[r] = a;
    }
  }

  float* pw = sm.p + warp * ROWS * BK;
  const int j = j0 + lane;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool ok = visible(i0 + r, j);
    float x = s[r];
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    x = ok ? x : -INFINITY;
    const float mx = warp_max(x);
    if (mx == -INFINITY) {          // the row sees no key of this tile
      pw[r * BK + lane] = 0.f;
      continue;
    }
    const float m_new = fmaxf(st.m[r], mx);
    const float alpha = expf(st.m[r] - m_new);   // 0 while m was -inf
    const float p = ok ? expf(x - m_new) : 0.f;
    st.l[r] = st.l[r] * alpha + warp_sum(p);
    st.m[r] = m_new;
#pragma unroll
    for (int t = 0; t < NC; ++t) st.acc[r][t] *= alpha;
    pw[r * BK + lane] = p;
  }
  __syncwarp();

#pragma unroll 2
  for (int jj = 0; jj < BK; jj += 4) {
    float vv[4][NC];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int t = 0; t < NC; ++t) vv[u][t] = sm.v[(jj + u) * DP + t * 32 + lane];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(pw + r * BK + jj);
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        float a = st.acc[r][t];
        a = fmaf(p4.x, vv[0][t], a);
        a = fmaf(p4.y, vv[1][t], a);
        a = fmaf(p4.z, vv[2][t], a);
        a = fmaf(p4.w, vv[3][t], a);
        st.acc[r][t] = a;
      }
    }
  }
  __syncwarp();
}

// Write the warp's rows i0 + r < n_rows (row stride d): acc / l, or
// exactly 0 for a row that saw no key.
template <typename T, int NC>
__device__ void store_rows(const RowState<NC>& st, T* __restrict__ out,
                           int lane, int i0, int n_rows, int d) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = i0 + r;
    if (i >= n_rows) break;
    const float inv = st.l[r] > 0.f ? 1.f / st.l[r] : 0.f;
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const int c = t * 32 + lane;
      if (c < d) store_as(out + (size_t)i * d + c, st.acc[r][t] * inv);
    }
  }
}

}  // namespace attn
