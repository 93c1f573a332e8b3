// Blocked (flash) attention for bfloat16 on Hopper's tensor cores, with
// causal and sliding-window masks and GQA: q (b, hq, s_q, d), k / v
// (b, hkv, s_kv, d) -> o (b, hq, s_q, d) bf16, softmax and sums in float32.
// s_kv differs from s_q only without a mask (the encoder-decoder's
// cross-attention: queries over the text, keys over the encoder's frames).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_kernel) for bf16 inputs; float32 inputs
// run the CUDA-core kernel of flash_attention.cu.
//
// What bounds it: the operations.  Causal attention over s tokens does
// ~2 s^2 d multiply-adds per head against 4 s d values moved, so at
// s = 1024, d = 128 it is far above the card's byte-to-flop line, and
// only the tensor cores reach that rate.  The design is FlashAttention-2
// on mma.sync.m16n8k16 with P split into two bf16 halves for P V, shared
// with the packed-prefill kernel in attention_tc.cuh; this file is its
// causal / sliding-window instantiation (FlashPolicy): tiles wholly above
// the causal diagonal or wholly outside the window are never loaded, and
// masks are applied only on tiles that straddle an edge (and on the
// ragged last tile).  Head dims up to 256 run (attention_tc.cuh says how
// d = 256 keeps its registers).
//
// Grid fill: the query tile is 64 rows (4 warps).  At the serving path's
// s = 128 that is 2 x 32 heads = 64 CTAs on 132 SMs.  A 16-row tile
// (1 warp per CTA) gives 256 CTAs and fills the card, but each CTA then
// stages the whole K/V range for 16 rows and an SM holds at most 3 warps
// of it: it ran slower on the card at every length timed (PERF.md), s =
// 128 included, so the tile is 64 rows.  The query tiles with the most
// keys are scheduled first.

#include "attention_tc.cuh"

namespace {

using namespace attn_tc;

// The causal / sliding-window mask of one query tile: the key tiles from
// the window's first to the diagonal, in order; without a mask, all s_kv
// keys.  Keys past s_kv are never visible (the ragged last tile); query
// rows past s_q are computed but never stored.
struct FlashPolicy {
  int s_kv, causal, window, j_lo, n;
  float scale_log2;

  __device__ FlashPolicy(int s_kv_, int causal_, int window_, int q0,
                         float scale_log2_)
      : s_kv(s_kv_), causal(causal_), window(window_),
        scale_log2(scale_log2_) {
    const int j_hi = causal ? min(s_kv, q0 + BQ) : s_kv;
    j_lo = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
    n = (j_hi - j_lo + BK - 1) / BK;
  }
  __device__ __forceinline__ int ntiles() const { return n; }
  __device__ __forceinline__ int tile_start(int t) const {
    return j_lo + t * BK;
  }
  __device__ __forceinline__ bool warp_sees(int j0, int, int i_lo,
                                           int i_hi) const {
    return (!causal || j0 <= i_hi) &&
           (window <= 0 || j0 + BK - 1 > i_lo - window);
  }
  __device__ __forceinline__ bool warp_full(int j0, int, int i_lo,
                                            int i_hi) const {
    return j0 + BK <= s_kv && (!causal || j0 + BK - 1 <= i_lo) &&
           (window <= 0 || j0 > i_hi - window);
  }
  __device__ __forceinline__ bool visible(int i, int j) const {
    return j < s_kv && (!causal || j <= i) &&
           (window <= 0 || j > i - window);
  }
  __device__ __forceinline__ float score(float qk) const {
    return qk * scale_log2;
  }
};

template <int DP>
__global__ void __launch_bounds__(NT)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int hq,
                int hkv, int s_q, int s_kv, int d, float scale_log2,
                int causal, int window, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // most keys first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (hq / hkv);
  const size_t qoff = ((size_t)b * hq + h) * s_q * d;
  const size_t koff = ((size_t)b * hkv + hk) * s_kv * d;
  const FlashPolicy pol(s_kv, causal, window, q0, scale_log2);
  attend<DP>(pol, smem_raw, q + qoff, k + koff, v + koff, o + qoff, q0, s_q,
             s_kv, d, vec != 0);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s_q, int s_kv, int d, float scale_log2,
           int causal, int window, int vec, cudaStream_t stream) {
  auto kern = flash_tc_kernel<DP>;
  const int bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + BQ - 1) / BQ, hq, b);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), hq, hkv, s_q, s_kv,
      d, scale_log2, causal, window, vec);
  return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, int d, float sl, int causal,
               int window, int vec, cudaStream_t st) {
  if (d <= 16) return launch<16>(q, k, v, o, b, hq, hkv, sq, skv, d, sl, causal, window, vec, st);
  if (d <= 32) return launch<32>(q, k, v, o, b, hq, hkv, sq, skv, d, sl, causal, window, vec, st);
  if (d <= 64) return launch<64>(q, k, v, o, b, hq, hkv, sq, skv, d, sl, causal, window, vec, st);
  if (d <= 128) return launch<128>(q, k, v, o, b, hq, hkv, sq, skv, d, sl, causal, window, vec, st);
  return launch<256>(q, k, v, o, b, hq, hkv, sq, skv, d, sl, causal, window, vec, st);
}

}  // namespace

// q: (b, hq, s_q, d); k, v: (b, hkv, s_kv, d); o: (b, hq, s_q, d); all
// contiguous bfloat16.  hq % hkv == 0, 1 <= d <= 256, window <= 0 for none;
// s_kv != s_q only with causal == 0 and no window.  Returns the error of
// cudaFuncSetAttribute (the shared memory a head dim needs) or
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* o, int b, int hq,
                                        int hkv, int s_q, int s_kv, int d,
                                        float scale, int causal, int window,
                                        void* stream) {
  if (b <= 0 || s_q <= 0) return 0;
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv || s_kv < 0 ||
      (s_kv != s_q && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const float sl = scale * LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  return dispatch_d(q, k, v, o, b, hq, hkv, s_q, s_kv, d, sl, causal, window,
                    vec, st);
}
