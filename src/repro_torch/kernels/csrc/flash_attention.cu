// Blocked (flash) attention with causal and sliding-window masks and GQA
// for float32 inputs: q (b, hq, s_q, d), k / v (b, hkv, s_kv, d) -> o
// (b, hq, s_q, d) float32; s_kv differs from s_q only without a mask
// (cross-attention).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_kernel) for float32 inputs; bf16 inputs
// run the wgmma kernel of flash_attention_wgmma.cu.
//
// What bounds it: the operations.  Causal attention over s tokens does
// about 2 s^2 d multiply-adds per head against 4 s d values moved, so at
// s = 1024, d = 128 it is far above the card's byte-to-flop line.  The TPU
// kernel carries (acc, m, l) in VMEM across a sequential grid axis over
// key blocks; Hopper CTAs run in parallel and in no order, so here one CTA
// owns one (batch, head, 64-row query tile) and walks its key tiles in a
// loop, keeping that state in registers (attention_tile.cuh has the tile
// arithmetic).  Query head h reads kv head h / (hq / hkv): K/V are never
// repeated in memory.  Key tiles wholly above the causal diagonal or
// wholly outside the window are never loaded, since they contribute
// exactly 0.  The TPU kernel needs s % 128 == 0; here the ragged last tile
// is masked, so every s runs.  The arithmetic is float32 on CUDA cores:
// the tensor cores take bf16 (or TF32, which would cost float32 inputs
// their precision), and float32 attention runs only at smoke size.

#include "attention_tile.cuh"

namespace {

using namespace attn;

struct FlashVisible {
  int s_q, s_kv, causal, window;   // window <= 0: none
  __device__ __forceinline__ bool operator()(int i, int j) const {
    if (j >= s_kv || i >= s_q) return false;
    if (causal && j > i) return false;
    if (window > 0 && j <= i - window) return false;
    return true;
  }
};

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
             int s_q, int s_kv, int d, float scale, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NC>& sm = *reinterpret_cast<Smem<NC>*>(smem_raw);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = ((size_t)b * hq + h) * s_q * d;
  const size_t koff = ((size_t)b * hkv + hk) * s_kv * d;

  load_q<T, NC>(sm, q + qoff + (size_t)q0 * d, min(BQ, s_q - q0), d, scale);
  RowState<NC> st;
  st.init();

  int j_lo = 0, j_hi = s_kv;
  if (causal) j_hi = min(s_kv, q0 + BQ);
  if (window > 0) j_lo = max(0, q0 - window + 1) / BK * BK;
  const FlashVisible vis{s_q, s_kv, causal, window};
  for (int j0 = j_lo; j0 < j_hi; j0 += BK) {
    __syncthreads();   // the previous tile is consumed
    load_kv<T, NC>(sm, k + koff + (size_t)j0 * d, v + koff + (size_t)j0 * d,
                   min(BK, s_kv - j0), d);
    __syncthreads();
    fold_tile<NC>(sm, st, warp, lane, q0 + warp * ROWS, j0, 0.f, vis);
  }
  store_rows<T, NC>(st, o + qoff, lane, q0 + warp * ROWS, s_q, d);
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s_q, int s_kv, int d, float scale,
           int causal, int window, cudaStream_t stream) {
  auto kern = flash_kernel<T, NC>;
  const int bytes = (int)smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + BQ - 1) / BQ, hq, b);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s_q, s_kv, d,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, int d, float scale,
               int causal, int window, cudaStream_t st) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, b, hq, hkv, sq, skv, d, scale, causal, window, st);
    case 2: return launch<T, 2>(q, k, v, o, b, hq, hkv, sq, skv, d, scale, causal, window, st);
    case 3: return launch<T, 3>(q, k, v, o, b, hq, hkv, sq, skv, d, scale, causal, window, st);
    case 4: return launch<T, 4>(q, k, v, o, b, hq, hkv, sq, skv, d, scale, causal, window, st);
  }
  // 128 < d <= 256: one instantiation of 8 chunks (a thread keeps 16 rows
  // x 8 dims of the output; what ptxas spills is in the build log)
  if (d <= 256) return launch<T, 8>(q, k, v, o, b, hq, hkv, sq, skv, d, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (b, hq, s_q, d); k, v: (b, hkv, s_kv, d); o: (b, hq, s_q, d); all
// contiguous float32.  hq % hkv == 0, 1 <= d <= 256, window <= 0 for none;
// s_kv != s_q only with causal == 0 and no window.  Returns the error of
// cudaFuncSetAttribute or cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int hq,
                                     int hkv, int s_q, int s_kv, int d,
                                     float scale, int causal, int window,
                                     void* stream) {
  if (b <= 0 || s_q <= 0) return 0;
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv || s_kv < 0 ||
      (s_kv != s_q && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  return dispatch_d<float>(q, k, v, o, b, hq, hkv, s_q, s_kv, d, scale,
                           causal, window, (cudaStream_t)stream);
}
