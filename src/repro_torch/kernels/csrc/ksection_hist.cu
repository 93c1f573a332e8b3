// k-section candidate-cut histogram: for each of m cuts (any order), the
// total weight of items whose key is strictly below the cut.
//
// Replaces the TPU kernel repro/kernels/ksection_hist.py::
// ksection_histogram_pallas (_hist_kernel).
//
// What bounds it: the compares.  Streaming the items is 8 bytes each
// (float32 key + weight), but an item that lands in a "merge" tile is
// compared against every cut, so a round costs up to n * m compare-adds
// (n = 3M items, m = 63 * 8 = 504 cuts on the adaptive session's main
// path; 8M x 8184 in the standalone p = 1024 step).  The design:
//
//   * Items stream in tiles of 1024 through shared memory, read once per
//     cut chunk.  A block walks a fixed, strided set of tiles.
//   * The cuts are loaded once per block, a slice of up to 32 per thread
//     kept in registers (CPT = cuts per thread, a template parameter), so
//     the inner loop reads one shared-memory item (a broadcast: every
//     thread reads the same address) and does CPT predicated adds.
//   * The TPU kernel's tile early-out is kept: a block reduction gives
//     each tile's key min / max and weight total; a tile whose keys are
//     all below every cut of the chunk adds the tile total, a tile whose
//     keys are all at or above every cut adds nothing, and only the
//     remaining tiles run the compare loop.
//   * Blocks do not share accumulators.  Each writes its per-cut partial
//     sums to its own row of a scratch array and a second pass adds the
//     rows in a fixed order, so the result is the same from run to run
//     (no atomics).  On integer weights whose total stays below 2^24
//     every partial sum is exact, so it equals the searchsorted +
//     index_add_ + cumsum plain version bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 1024;       // items per tile (KS_TILE in ksection_hist.py)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItemsPerThread = kTile / kThreads;
constexpr int kMaxCpt = 32;       // cuts per thread in one launch

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide min / max / sum, broadcast to every thread.  Fixed order,
// so the sum is the same on every run.  Ends with a barrier.
__device__ __forceinline__ void block_reduce3(float& vmin, float& vmax,
                                              float& vsum,
                                              float (*scratch)[kWarps]) {
  vmin = warp_min(vmin);
  vmax = warp_max(vmax);
  vsum = warp_sum(vsum);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[0][warp] = vmin;
    scratch[1][warp] = vmax;
    scratch[2][warp] = vsum;
  }
  __syncthreads();
  vmin = scratch[0][0];
  vmax = scratch[1][0];
  vsum = scratch[2][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    vmin = fminf(vmin, scratch[0][w]);
    vmax = fmaxf(vmax, scratch[1][w]);
    vsum += scratch[2][w];
  }
  __syncthreads();
}

// One cut chunk [c0, c0 + kThreads * CPT): per-block partial sums into
// partials[blockIdx.x * m + j].
template <int CPT>
__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const float* __restrict__ keys,
                    const float* __restrict__ w, long long n,
                    const float* __restrict__ cuts, int m, int c0,
                    float* __restrict__ partials) {
  __shared__ float2 items[kTile];
  __shared__ float scratch[3][kWarps];
  const int tid = threadIdx.x;

  float cut[CPT], acc[CPT];
  float cmin = INFINITY, cmax = -INFINITY, unused = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = c0 + c * kThreads + tid;
    acc[c] = 0.f;
    if (j < m) {
      cut[c] = cuts[j];
      cmin = fminf(cmin, cut[c]);
      cmax = fmaxf(cmax, cut[c]);
    } else {
      cut[c] = -INFINITY;  // no key is below it: the slot stays idle
    }
  }
  block_reduce3(cmin, cmax, unused, scratch);

  const long long n_tiles = (n + kTile - 1) / kTile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long base = t * kTile;
    const int cnt = (int)min((long long)kTile, n - base);
    float kmin = INFINITY, kmax = -INFINITY, total = 0.f;
#pragma unroll
    for (int r = 0; r < kItemsPerThread; ++r) {
      const int i = r * kThreads + tid;
      if (i < cnt) {
        const float k = keys[base + i];
        const float wi = w[base + i];
        items[i] = make_float2(k, wi);
        kmin = fminf(kmin, k);
        kmax = fmaxf(kmax, k);
        total += wi;
      }
    }
    block_reduce3(kmin, kmax, total, scratch);  // also publishes items[]
    if (kmax < cmin) {
      // every key below every cut: the whole tile counts for each cut
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += total;
    } else if (kmin < cmax) {
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        const float2 it = items[i];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (it.x < cut[c]) acc[c] += it.y;
      }
    }
    // (otherwise every key is at or above every cut: adds nothing)
    __syncthreads();  // items[] is overwritten by the next tile
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = c0 + c * kThreads + tid;
    if (j < m) partials[(long long)blockIdx.x * m + j] = acc[c];
  }
}

// out[j] = sum over blocks b (in order) of partials[b * m + j].  A block
// is 32 cuts x 8 row-interleaved lanes; the 8 lane sums are added in a
// fixed order.
__global__ void hist_reduce_kernel(const float* __restrict__ partials,
                                   int n_parts, int m,
                                   float* __restrict__ out) {
  __shared__ float s[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  float v = 0.f;
  if (j < m) {
    for (int b = ty; b < n_parts; b += 8) v += partials[(long long)b * m + j];
  }
  s[ty][tx] = v;
  __syncthreads();
  if (ty == 0 && j < m) {
    float t = s[0][tx];
#pragma unroll
    for (int y = 1; y < 8; ++y) t += s[y][tx];
    out[j] = t;
  }
}

template <int CPT>
void launch_partial(const float* keys, const float* w, long long n,
                    const float* cuts, int m, int c0, float* partials,
                    int n_blocks, cudaStream_t s) {
  hist_partial_kernel<CPT><<<n_blocks, kThreads, 0, s>>>(keys, w, n, cuts, m,
                                                         c0, partials);
}

}  // namespace

// keys, w: (n,) float32; cuts: (m,) float32 in any order; partials:
// scratch of n_blocks * m float32 (no initialisation needed); out: (m,)
// float32.  Requires n > 0, 0 < m < 2^31, n_blocks >= 1.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int repro_ksection_hist(const float* keys, const float* w,
                                   long long n, const float* cuts,
                                   long long m, float* partials,
                                   int n_blocks, float* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int cpt = 1;
  while (cpt < kMaxCpt && (long long)cpt * kThreads < m) cpt <<= 1;
  const int mi = (int)m;
  for (long long c0 = 0; c0 < m; c0 += (long long)cpt * kThreads) {
    const int c = (int)c0;
    switch (cpt) {
      case 1: launch_partial<1>(keys, w, n, cuts, mi, c, partials, n_blocks, s); break;
      case 2: launch_partial<2>(keys, w, n, cuts, mi, c, partials, n_blocks, s); break;
      case 4: launch_partial<4>(keys, w, n, cuts, mi, c, partials, n_blocks, s); break;
      case 8: launch_partial<8>(keys, w, n, cuts, mi, c, partials, n_blocks, s); break;
      case 16: launch_partial<16>(keys, w, n, cuts, mi, c, partials, n_blocks, s); break;
      default: launch_partial<32>(keys, w, n, cuts, mi, c, partials, n_blocks, s); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  hist_reduce_kernel<<<(unsigned)((m + 31) / 32), dim3(32, 8), 0, s>>>(
      partials, n_blocks, mi, out);
  return (int)cudaGetLastError();
}
