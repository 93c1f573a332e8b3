// Segment-masked causal attention over one packed prefill buffer:
// q (hq, C, d), k / v (hkv, C, d), seg (C,) int32 request ids with -1 for
// pad -> o (hq, C, d) in q's type, float32 or bfloat16, accumulated in
// float32.  Key j is visible from query i iff j <= i and seg[i] == seg[j]
// >= 0; a row that sees no key (a pad row) is exactly 0.  An optional
// soft cap applies softcap * tanh(s / softcap) to the scaled scores,
// before the mask.
//
// Replaces the TPU kernel repro/kernels/serve_prefill.py::
// packed_attention_pallas (_packed_kernel).
//
// What bounds it: at the serving path's buffers, the bytes: the real
// tokens' q, k and v are read once and the whole buffer's o is written
// once (pad rows as zeros), against ~2 d sum_r s_r^2 multiply-adds per
// head over the per-request causal bands.  Full buffers of long requests
// come close to the operations' bound as well.
//
// bf16 runs on wgmma: the body of attention_wgmma.cuh (a TMA producer
// warp feeding a 4-stage K/V ring of 64-key tiles, one consumer
// warpgroup of 64 query rows on wgmma, online softmax in registers, P
// split into two bf16 halves for P V) under PackedPolicy, which gives
//
//   * the key tiles a query tile visits: each key tile's range of ids
//     (pads as -1) is computed once by the CTA in one parallel pass over
//     seg up to the tile's diagonal, and a tile is visited only if that
//     range meets the query tile's range of real ids.  The engine packs
//     requests in order, so the visited tiles are those of the tile's own
//     requests, and the key loop starts at the first of them; any other
//     layout stays correct (a range that meets is only a superset);
//   * the per-element mask only on tiles that straddle a request edge,
//     the diagonal or the ragged end: a tile wholly below a warp's
//     diagonal whose 64 keys carry the one id of the warp's 16 rows is
//     folded unmasked;
//   * the soft cap folded into the score: cap log2(e) tanh(q.k scale /
//     cap), so the exp2 of the softmax takes it as it takes the scaled
//     score.
//
// A query tile of pad rows only writes zeros with 16-byte stores and
// exits.  Any C runs: the ragged last tile is masked, and TMA zero-fills
// past C.  The query tile is 64 rows (one consumer warpgroup): the
// buffers hold short requests.
//
// Launch order: the heads of a query tile, then the next tile, from the
// buffer's start, so the real tiles (the engine packs from the start) run
// first and the pad tiles fill in last.  One CTA per (head, query tile),
// two an SM (the ring is 2 stages deep at head dim 128, 4 at 64): at the
// engine's buffers a CTA's latency, not the bytes it loads, sets the
// time, and on the card a second CTA an SM hid it better than a deeper
// ring.
//
// float32 inputs (the smoke-size card-against-CPU check) run the
// CUDA-core kernel on attention_tile.cuh: one CTA per (head, 64-row
// query tile), K/V tiles of 32 staged in shared memory as float32, a key
// tile staged only if one of its keys belongs to a request in the query
// tile's id range.

#include <climits>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "attention_tile.cuh"

namespace {

// --- float32: CUDA cores (attention_tile.cuh) --------------------------------

namespace f32 {

using namespace attn;

struct PackedVisible {
  const int* seg_q;   // shared: the query tile's ids
  const int* seg_k;   // shared: the staged key tile's ids
  int q0, j0;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    if (j > i) return false;
    const int si = seg_q[i - q0];
    return si >= 0 && si == seg_k[j - j0];
  }
};

template <int NC>
__global__ void __launch_bounds__(THREADS)
packed_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ seg,
              float* __restrict__ o, int hq, int hkv, int C, int d,
              float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NC>& sm = *reinterpret_cast<Smem<NC>*>(smem_raw);
  __shared__ int seg_q[BQ];
  __shared__ int seg_k[BK];
  __shared__ int q_range[2];       // smallest real id, largest id
  __shared__ int live[2];          // double-buffered tile flag
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = (size_t)h * C * d;
  const size_t koff = (size_t)hk * C * d;

  if (threadIdx.x < BQ)
    seg_q[threadIdx.x] = q0 + (int)threadIdx.x < C ? seg[q0 + threadIdx.x] : -1;
  __syncthreads();
  if (warp == 0) {
    const int a = seg_q[lane], b2 = seg_q[lane + 32];
    int lo = min(a >= 0 ? a : INT_MAX, b2 >= 0 ? b2 : INT_MAX);
    int hi = max(a, b2);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) { q_range[0] = lo; q_range[1] = hi; }
  }
  __syncthreads();
  const int q_lo = q_range[0], q_hi = q_range[1];

  RowState<NC> st;
  st.init();
  if (q_hi >= 0) {                 // else: pad rows only, written as 0
    load_q<float, NC>(sm, q + qoff + (size_t)q0 * d, min(BQ, C - q0), d,
                      scale);
    const int j_hi = min(C, q0 + BQ);
    for (int j0 = 0, it = 0; j0 < j_hi; j0 += BK, ++it) {
      if (warp == 0) {
        const int j = j0 + lane;
        const int sj = j < C ? seg[j] : -1;
        const bool mine = sj >= 0 && sj >= q_lo && sj <= q_hi;
        const unsigned any = __ballot_sync(0xffffffffu, mine);
        if (lane == 0) live[it & 1] = any != 0u;
      }
      __syncthreads();   // the previous tile is consumed; the flag is set
      if (!live[it & 1]) continue;
      if (threadIdx.x < BK)
        seg_k[threadIdx.x] = j0 + (int)threadIdx.x < C ? seg[j0 + threadIdx.x] : -1;
      load_kv<float, NC>(sm, k + koff + (size_t)j0 * d,
                         v + koff + (size_t)j0 * d, min(BK, C - j0), d);
      __syncthreads();
      fold_tile<NC>(sm, st, warp, lane, q0 + warp * ROWS, j0, softcap,
                    PackedVisible{seg_q, seg_k, q0, j0});
    }
  }
  store_rows<float, NC>(st, o + qoff, lane, q0 + warp * ROWS, C, d);
}

template <int NC>
int launch(const void* q, const void* k, const void* v, const int* seg,
           void* o, int hq, int hkv, int C, int d, float scale, float softcap,
           cudaStream_t stream) {
  auto kern = packed_kernel<NC>;
  const int bytes = (int)smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + BQ - 1) / BQ, hq);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg, static_cast<float*>(o), hq, hkv, C,
      d, scale, softcap);
  return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, const int* seg,
               void* o, int hq, int hkv, int C, int d, float scale,
               float softcap, cudaStream_t st) {
  switch ((d + 31) / 32) {
    case 1: return launch<1>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
    case 2: return launch<2>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
    case 3: return launch<3>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
    case 4: return launch<4>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace f32

// --- bf16: wgmma (attention_wgmma.cuh) -----------------------------------------

namespace wg {

using namespace attn_wg;

constexpr int BQ = 64;                 // query rows a CTA: one consumer group
constexpr int BK = 64;                 // keys a tile
constexpr int NT = threads<1>();       // the consumer group, the producer
// The ring: as many stages as leave room for two CTAs an SM (each under
// 116 KB of shared memory and 168 registers a thread): a buffer's
// requests are short, so a CTA visits few key tiles, and a second CTA's
// loads and set-up hide the first one's latency.
template <int DP>
using PackedRing = Ring<BK, DP == 64 ? 4 : 2>;
constexpr int SLABS = BQ / 16;

// The segment-causal mask of one query tile.  Shared arrays: the tile's
// query ids (-1 past C), per key tile the smallest and largest id over
// its 64 keys (pads and keys past C as -1), the visited key tiles in
// order, and per 16-row slab its rows' one id (-2 unless all 16 rows are
// real and of one request).
struct PackedPolicy {
  const int* __restrict__ seg;
  const int* seg_q;
  const int* tile_lo;
  const int* tile_hi;
  const int* live;
  const int* w_one;
  int n, C, q0;
  float scale_log2, cap_log2, scale_over_cap;   // cap_log2 0: no soft cap

  __device__ __forceinline__ int ntiles() const { return n; }
  __device__ __forceinline__ int tile_start(int t) const {
    return live[t] * BK;
  }
  __device__ __forceinline__ bool warp_full(int j0, int slab, int i_lo,
                                            int) const {
    const int t = j0 / BK;
    return j0 + BK - 1 <= i_lo && j0 + BK <= C && w_one[slab] >= 0 &&
           tile_lo[t] == w_one[slab] && tile_hi[t] == w_one[slab];
  }
  __device__ __forceinline__ bool visible(int i, int j) const {
    if (j > i || j >= C) return false;
    const int si = seg_q[i - q0];
    return si >= 0 && si == __ldg(seg + j);
  }
  __device__ __forceinline__ float score(float qk) const {
    return cap_log2 > 0.f ? cap_log2 * tanhf(qk * scale_over_cap)
                          : qk * scale_log2;
  }
};

// Zero `count` bf16 values from p: 16-byte stores between scalar ends.
__device__ __forceinline__ void zero_fill(bf16* p, size_t count) {
  const size_t lead = ((16 - ((uintptr_t)p & 15)) & 15) / 2;
  const size_t head = lead < count ? lead : count;
  const bf16 z = __float2bfloat16(0.f);
  for (size_t i = threadIdx.x; i < head; i += NT) p[i] = z;
  uint4* body = reinterpret_cast<uint4*>(p + head);
  const size_t nv = (count - head) / 8;
  for (size_t i = threadIdx.x; i < nv; i += NT) body[i] = make_uint4(0, 0, 0, 0);
  for (size_t i = head + nv * 8 + threadIdx.x; i < count; i += NT) p[i] = z;
}

// Dynamic shared memory: attend's, then three ints a key tile.
template <int DP>
__host__ __device__ constexpr size_t packed_smem(int C) {
  return smem_bytes<DP, 1, PackedRing<DP>>() +
         3 * sizeof(int) * (size_t)((C + BK - 1) / BK);
}

template <int DP>
__global__ void __maxnreg__(168)
packed_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const int* __restrict__ seg, bf16* __restrict__ o, int hq,
                    int hkv, int C, int d, float scale_log2, float cap_log2,
                    float scale_over_cap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int seg_q[BQ];
  __shared__ int w_lo[SLABS], w_hi[SLABS], w_one[SLABS];
  __shared__ int n_live;
  // all heads of a query tile, then the next tile, from the buffer's
  // start: the engine packs requests from the start, so the real tiles
  // run first and the pad tiles, which only store zeros, fill in last
  const int h = blockIdx.x, hk = h / (hq / hkv);
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = (size_t)h * C * d;
  const int ntl = (C + BK - 1) / BK;
  int* tile_lo =
      reinterpret_cast<int*>(smem_raw + smem_bytes<DP, 1, PackedRing<DP>>());
  int* tile_hi = tile_lo + ntl;
  int* live = tile_hi + ntl;

  // one round of loads: the query tile's ids, and the id range of every
  // key tile up to the diagonal (warp w takes tiles w, w + 8, ...; a lane
  // reads keys lane and lane + 32 of each, coalesced)
  if (threadIdx.x < BQ)
    seg_q[threadIdx.x] = q0 + (int)threadIdx.x < C ? seg[q0 + threadIdx.x] : -1;
  const int ntv = (min(C, q0 + BQ) + BK - 1) / BK;
#pragma unroll 4
  for (int t = warp; t < ntv; t += NT / 32) {
    const int j = t * BK + lane;
    const int a = j < C ? seg[j] : -1;
    const int b = j + 32 < C ? seg[j + 32] : -1;
    int lo = min(a, b), hi = max(a, b);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      tile_lo[t] = lo;
      tile_hi[t] = hi;
    }
  }
  __syncthreads();
  if (warp < SLABS) {     // each slab: its 16 rows' id range and one id
    const int si = seg_q[warp * 16 + (lane & 15)];
    int lo = si >= 0 ? si : INT_MAX, hi = si, mn = si;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    }
    if (lane == 0) {
      w_lo[warp] = lo;
      w_hi[warp] = hi;
      w_one[warp] = mn == hi && mn >= 0 ? mn : -2;
    }
  }
  __syncthreads();
  int q_lo = INT_MAX, q_hi = -1;
#pragma unroll
  for (int w = 0; w < SLABS; ++w) {
    q_lo = min(q_lo, w_lo[w]);
    q_hi = max(q_hi, w_hi[w]);
  }
  if (q_hi < 0) {                  // pad rows only: zeros, and done
    zero_fill(o + qoff + (size_t)q0 * d, (size_t)min(BQ, C - q0) * d);
    return;
  }
  if (warp == 0) {                 // the key tiles to visit, in order
    int count = 0;
    for (int t0 = 0; t0 < ntv; t0 += 32) {
      const int t = t0 + lane;
      const bool ok = t < ntv && tile_hi[t] >= q_lo && tile_lo[t] <= q_hi;
      const unsigned ball = __ballot_sync(0xffffffffu, ok);
      if (ok) live[count + __popc(ball & ((1u << lane) - 1u))] = t;
      count += __popc(ball);
    }
    if (lane == 0) n_live = count;
  }
  __syncthreads();

  const PackedPolicy pol{seg, seg_q, tile_lo, tile_hi, live, w_one, n_live,
                         C, q0, scale_log2, cap_log2, scale_over_cap};
  attend<DP, 1, PackedRing<DP>>(pol, smem_raw, &tq, &tk, &tv, h, hk, o + qoff, q0, C, d);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const int* seg,
           void* o, int hq, int hkv, int C, int d, float sl, float cl,
           float soc, cudaStream_t stream) {
  const size_t bytes = packed_smem<DP>(C);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, d, C, hq, BQ) || !encode_map(&tk, k, d, C, hkv, BK) ||
      !encode_map(&tv, v, d, C, hkv, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = packed_wgmma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, (C + BQ - 1) / BQ);
  kern<<<grid, NT, bytes, stream>>>(tq, tk, tv, seg, static_cast<bf16*>(o),
                                    hq, hkv, C, d, sl, cl, soc);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// q: (hq, C, d); k, v: (hkv, C, d); seg: (C,) int32; o: (hq, C, d); all
// contiguous float32 (CUDA cores).  hq % hkv == 0, 1 <= d <= 128, softcap
// <= 0 for none.  Returns cudaGetLastError() after the launch.
extern "C" int repro_packed_attention(const void* q, const void* k,
                                      const void* v, const int* seg, void* o,
                                      int hq, int hkv, int C, int d,
                                      float scale, float softcap,
                                      void* stream) {
  if (C <= 0 || hq <= 0) return 0;
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv) return (int)cudaErrorInvalidValue;
  return f32::dispatch_d(q, k, v, seg, o, hq, hkv, C, d, scale, softcap,
                         (cudaStream_t)stream);
}

// The same for bfloat16 on wgmma, at 16-byte aligned addresses with
// 8 <= d <= 128 and d % 8 == 0 (TMA's row stride: the wrapper pads other
// head dims).  rows: the query rows a CTA takes, the launch plan's (64).
// Returns cudaErrorInvalidValue for inputs outside these rules, a tensor
// map the driver refuses or a buffer whose key-tile table does not fit
// in shared memory, else the error of cudaFuncSetAttribute or
// cudaGetLastError() after the launch.
extern "C" int repro_packed_attention_wgmma(const void* q, const void* k,
                                            const void* v, const int* seg,
                                            void* o, int hq, int hkv, int C,
                                            int d, float scale, float softcap,
                                            int rows, void* stream) {
  if (C <= 0 || hq <= 0) return 0;
  if (d < 8 || d > 128 || d % 8 || hkv < 1 || hq % hkv || rows != wg::BQ)
    return (int)cudaErrorInvalidValue;
  const float sl = scale * attn_wg::LOG2E;
  const float cl = softcap > 0.f ? softcap * attn_wg::LOG2E : 0.f;
  const float soc = softcap > 0.f ? scale / softcap : 0.f;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 64)
    return wg::launch<64>(q, k, v, seg, o, hq, hkv, C, d, sl, cl, soc, st);
  return wg::launch<128>(q, k, v, seg, o, hq, hkv, C, d, sl, cl, soc, st);
}
