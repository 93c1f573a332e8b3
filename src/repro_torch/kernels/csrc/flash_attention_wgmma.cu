// Blocked (flash) attention for bfloat16 on Hopper's wgmma, with causal
// and sliding-window masks and GQA: q (b, hq, s_q, d), k / v (b, hkv,
// s_kv, d) -> o (b, hq, s_q, d) bf16, softmax and sums in float32.  s_kv
// differs from s_q only without a mask (the encoder-decoder's
// cross-attention: queries over the text, keys over the encoder's frames).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_kernel) for bf16 inputs; float32 inputs
// run the CUDA-core kernel of flash_attention.cu.
//
// What bounds it: the operations.  Causal attention over s tokens does
// ~2 s^2 d multiply-adds per head against 4 s d values moved, so at
// s = 1024, d = 128 it is far above the card's byte-to-flop line, and
// only wgmma reaches the tensor cores' rate.  The body is
// attention_wgmma.cuh (a TMA producer warp feeding a K/V ring,
// consumer warpgroups on wgmma, P split in two bf16 halves for P V);
// this file is its causal / sliding-window instantiation (FlashPolicy):
// key tiles wholly above the causal diagonal or wholly outside the window
// are never loaded, and masks are applied only on tiles that straddle an
// edge (and on the ragged last tile).  The decode-shaped call (one query
// row against the encoder's 1,500 keys) is bound by the bytes of K and V
// instead; what the design does for it is the deeper ring.
//
// The rows a CTA takes are the launch plan's (kernels/flash_attention.py::
// attention_plan): 64 (one consumer warpgroup), or 128 (two sharing each
// K/V tile) at DP = 128 from 2,048 query rows on.  On the card the shared
// tiles beat the latency hiding of a second 64-row CTA an SM there
// (prefill_32k, danube3's 6,144 rows) and lost to it below (1,024 rows);
// short prompts keep their CTA count.  The query tiles with the most keys
// are scheduled first.

#include "attention_wgmma.cuh"

namespace {

using namespace attn_wg;

// The flash kernels' K/V ring: 64-key tiles (48 at DP = 256), as deep as
// leaves the SM room for more than one CTA where the one-group CTA at
// DP = 128 would otherwise be alone on it (2 stages: two CTAs an SM; 4
// at DP = 64: three), 3 stages beside DP = 256's 181 KB.  Two consumer
// groups (DP = 128 only: at DP = 256 their 168 registers a thread spill)
// share a 4-stage ring.
template <int DP, int NWG>
using FlashRing = Ring<DP == 256 ? 48 : 64,
                       DP == 64 ? 4 : DP == 256 ? 3 : NWG == 2 ? 4 : 2>;

// The causal / sliding-window mask of one query tile: the key tiles from
// the window's first to the diagonal, in order; without a mask, all s_kv
// keys.  Keys past s_kv are never visible (the ragged last tile); query
// rows past s_q are computed but never stored.
template <int BK>
struct FlashPolicy {
  int s_kv, causal, window, j_lo, n;
  float scale_log2;

  __device__ FlashPolicy(int s_kv_, int causal_, int window_, int q0, int bq,
                         float scale_log2_)
      : s_kv(s_kv_), causal(causal_), window(window_),
        scale_log2(scale_log2_) {
    const int j_hi = causal ? min(s_kv, q0 + bq) : s_kv;
    j_lo = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
    n = max(0, (j_hi - j_lo + BK - 1) / BK);
  }
  __device__ __forceinline__ int ntiles() const { return n; }
  __device__ __forceinline__ int tile_start(int t) const {
    return j_lo + t * BK;
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

template <int DP, int NWG>
__global__ void __launch_bounds__(threads<NWG>(), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ o, int hq, int hkv, int s_q, int s_kv,
                   int d, float scale_log2, int causal, int window) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int BQ = 64 * NWG;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // most keys first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (hq / hkv);
  using R = FlashRing<DP, NWG>;
  const FlashPolicy<R::BK> pol(s_kv, causal, window, q0, BQ, scale_log2);
  attend<DP, NWG, R>(pol, smem_raw, &tq, &tk, &tv, b * hq + h,
                                 b * hkv + hk,
                                 o + ((size_t)b * hq + h) * s_q * d, q0, s_q,
                                 d);
}

template <int DP, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s_q, int s_kv, int d, float scale_log2,
           int causal, int window, cudaStream_t stream) {
  constexpr int BQ = 64 * NWG;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, d, s_q, b * hq, BQ) ||
      !encode_map(&tk, k, d, s_kv, b * hkv, FlashRing<DP, NWG>::BK) ||
      !encode_map(&tv, v, d, s_kv, b * hkv, FlashRing<DP, NWG>::BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<DP, NWG>;
  const int bytes = smem_bytes<DP, NWG, FlashRing<DP, NWG>>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + BQ - 1) / BQ, hq, b);
  kern<<<grid, threads<NWG>(), bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), hq, hkv, s_q, s_kv, d, scale_log2,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (b, hq, s_q, d); k, v: (b, hkv, s_kv, d); o: (b, hq, s_q, d); all
// contiguous bfloat16 at 16-byte aligned addresses.  hq % hkv == 0,
// 8 <= d <= 256 with d % 8 == 0 (TMA's row stride: the wrapper pads other
// head dims), window <= 0 for none; s_kv != s_q only with causal == 0 and
// no window.  rows: the query rows a CTA takes (the launch plan's), 64,
// or 128 for 64 < d <= 128.  Returns cudaErrorInvalidValue for inputs
// outside these rules or a tensor map the driver refuses, else the error
// of cudaFuncSetAttribute or cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o, int b,
                                           int hq, int hkv, int s_q, int s_kv,
                                           int d, float scale, int causal,
                                           int window, int rows,
                                           void* stream) {
  if (b <= 0 || s_q <= 0 || hq <= 0) return 0;
  if (d < 8 || d > 256 || d % 8 || hkv < 1 || hq % hkv || s_kv < 0 ||
      (rows != 64 && (rows != 128 || d <= 64 || d > 128)) ||
      (s_kv != s_q && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (s_kv == 0)         // no key: every row sees none and is 0
    return (int)cudaMemsetAsync(o, 0, (size_t)b * hq * s_q * d * 2, st);
  const float sl = scale * LOG2E;
  if (rows == 128)
    return launch<128, 2>(q, k, v, o, b, hq, hkv, s_q, s_kv, d, sl, causal,
                          window, st);
  if (d <= 64)
    return launch<64, 1>(q, k, v, o, b, hq, hkv, s_q, s_kv, d, sl, causal,
                         window, st);
  if (d <= 128)
    return launch<128, 1>(q, k, v, o, b, hq, hkv, s_q, s_kv, d, sl, causal,
                          window, st);
  return launch<256, 1>(q, k, v, o, b, hq, hkv, s_q, s_kv, d, sl, causal,
                        window, st);
}

// The dynamic shared memory a CTA of the bf16 flash kernel asks for at
// padded head dim dp and `rows` query rows, or -1 for a pair not built.
extern "C" int repro_flash_attention_wgmma_smem(int dp, int rows) {
  if (rows == 64 && dp == 64) return smem_bytes<64, 1, FlashRing<64, 1>>();
  if (rows == 64 && dp == 128) return smem_bytes<128, 1, FlashRing<128, 1>>();
  if (rows == 64 && dp == 256) return smem_bytes<256, 1, FlashRing<256, 1>>();
  if (rows == 128 && dp == 128) return smem_bytes<128, 2, FlashRing<128, 2>>();
  return -1;
}
