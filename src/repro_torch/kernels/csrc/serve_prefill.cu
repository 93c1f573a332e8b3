// Segment-masked causal attention over one packed prefill buffer:
// q (hq, C, d), k / v (hkv, C, d), seg (C,) int32 request ids with -1 for
// pad -> o (hq, C, d) in q's type, float32 or bfloat16, accumulated in
// float32.  Key j is visible from query i iff j <= i and seg[i] == seg[j]
// >= 0; a row that sees no key (a pad row) is exactly 0.  An optional
// soft cap applies softcap * tanh(s / softcap) to the scaled scores.
//
// Replaces the TPU kernel repro/kernels/serve_prefill.py::
// packed_attention_pallas (_packed_kernel).
//
// What bounds it: the operations over the per-request causal bands (about
// 2 d sum_r s_r^2 multiply-adds per head); the buffer is read and written
// once.  As in flash_attention.cu one CTA owns one (head, 64-row query
// tile) and walks the key tiles up to the diagonal with its online-softmax
// state in registers (attention_tile.cuh).  The TPU kernel's tile early-
// out is kept and tightened: before a key tile is staged, warp 0 checks
// whether any of its 32 keys belongs to a request whose id lies in the
// query tile's range of real ids; only then is the tile loaded and
// folded.  The engine packs requests in order, so the live tiles of a
// query tile are those of its own requests and the work approaches the
// sum of the per-request causal bands, not C^2.  A query tile of pad rows
// only writes zeros.  Any C runs: the ragged last tile is masked.

#include <climits>

#include "attention_tile.cuh"

namespace {

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

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
packed_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ seg,
              T* __restrict__ o, int hq, int hkv, int C, int d, float scale,
              float softcap) {
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
    load_q<T, NC>(sm, q + qoff + (size_t)q0 * d, min(BQ, C - q0), d, scale);
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
      load_kv<T, NC>(sm, k + koff + (size_t)j0 * d, v + koff + (size_t)j0 * d,
                     min(BK, C - j0), d);
      __syncthreads();
      fold_tile<NC>(sm, st, warp, lane, q0 + warp * ROWS, j0, softcap,
                    PackedVisible{seg_q, seg_k, q0, j0});
    }
  }
  store_rows<T, NC>(st, o + qoff, lane, q0 + warp * ROWS, C, d);
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const int* seg,
           void* o, int hq, int hkv, int C, int d, float scale, float softcap,
           cudaStream_t stream) {
  auto kern = packed_kernel<T, NC>;
  const int bytes = (int)smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + BQ - 1) / BQ, hq);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(o), hq, hkv, C, d,
      scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* seg,
               void* o, int hq, int hkv, int C, int d, float scale,
               float softcap, cudaStream_t st) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
    case 2: return launch<T, 2>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
    case 3: return launch<T, 3>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
    case 4: return launch<T, 4>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (hq, C, d); k, v: (hkv, C, d); seg: (C,) int32; o: (hq, C, d); all
// contiguous, q / k / v / o of one type: dtype 0 = float32, 1 = bfloat16.
// hq % hkv == 0, 1 <= d <= 128, softcap <= 0 for none.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_packed_attention(const void* q, const void* k,
                                      const void* v, const int* seg, void* o,
                                      int hq, int hkv, int C, int d,
                                      int dtype, float scale, float softcap,
                                      void* stream) {
  if (C <= 0 || hq <= 0) return 0;
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, seg, o, hq, hkv, C, d, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}
