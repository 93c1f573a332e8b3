// Exclusive prefix sum of float32 (n,): out[i] = x[0] + ... + x[i - 1],
// out[0] = 0.  Algorithm 1's S_i, the sum that places each item of the
// 1-D partition (sorted SFC order, or the refinement tree's DFS order).
//
// Replaces the TPU kernel repro/kernels/prefix_scan.py::
// exclusive_scan_pallas (_scan_kernel).
//
// What bounds it: memory.  The least work reads each input once and
// writes each output once, 8 bytes per element; the n additions are
// nothing beside that.  The TPU kernel walks 2048-wide blocks in grid
// order and carries the running total in a VMEM cell from one step to
// the next.  Hopper blocks run in no order, so the carry becomes three
// passes over tiles of 4096 items (256 threads x 16 items):
//
//   1. every block sums its tile and writes the total to a scratch row;
//   2. one block scans the tile totals in place (exclusive), looping over
//      chunks of 1024 with a carry, so any number of tiles works;
//   3. every block scans its tile again and writes offset + local prefix.
//
// Passes 1 and 3 read the input, so the kernel moves 12 bytes per
// element against the 8 of the bound; a single-pass decoupled look-back
// scan would reach 8 and is the design for a later optimisation.  A tile
// is staged through shared memory with coalesced loads, then each thread
// adds its 16 consecutive items in order (the shared-memory index is
// padded by one word every 32, so the 16-strided reads hit 32 banks), the
// thread totals are scanned with warp shuffles and the warp totals by
// warp 0.  Every sum is taken in an order fixed by n alone (no atomics),
// so the result is the same on every run; on integer weights whose total
// stays below 2^24 every partial sum is exact and the result equals
// torch.cumsum(x) - x bit for bit.  Any n runs: the ragged last tile
// reads zeros past the end and stores nothing there.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // consecutive items per thread
constexpr int kTile = kThreads * kItems;      // 4096 items per block
constexpr int kScanThreads = 1024;            // pass 2

__host__ __device__ constexpr int padded(int k) { return k + (k >> 5); }

// Exclusive warp scan of v; *total gets the warp's sum (every lane).
__device__ __forceinline__ float warp_exclusive(float v, float* total) {
  const int lane = threadIdx.x & 31;
  float inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += up;
  }
  *total = __shfl_sync(0xffffffffu, inc, 31);
  const float ex = __shfl_up_sync(0xffffffffu, inc, 1);
  return lane == 0 ? 0.0f : ex;
}

// Stage one tile in shared memory, add each thread's 16 items, and give
// each thread the exclusive prefix of its run inside the tile.  Returns
// the thread's offset; *tile_total gets the tile's sum (every thread).
__device__ __forceinline__ float tile_offsets(const float* __restrict__ x,
                                              long long n, long long base,
                                              float* smem, float* warp_tot,
                                              float* tile_total) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + t;
    const long long g = base + k;
    smem[padded(k)] = g < n ? x[g] : 0.0f;
  }
  __syncthreads();
  float run = 0.0f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) run += smem[padded(t * kItems + j)];
  float wsum;
  const float lane_off = warp_exclusive(run, &wsum);
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) warp_tot[warp] = wsum;
  __syncthreads();
  if (warp == 0) {
    const float v = lane < kWarps ? warp_tot[lane] : 0.0f;
    float all;
    const float ex = warp_exclusive(v, &all);
    __syncwarp();
    if (lane < kWarps) warp_tot[lane] = ex;
    if (lane == 0) warp_tot[kWarps] = all;
  }
  __syncthreads();
  *tile_total = warp_tot[kWarps];
  return warp_tot[warp] + lane_off;
}

__global__ void __launch_bounds__(kThreads)
tile_totals_kernel(const float* __restrict__ x, long long n,
                   float* __restrict__ totals) {
  __shared__ float smem[padded(kTile)];
  __shared__ float warp_tot[kWarps + 1];
  float total;
  tile_offsets(x, n, (long long)blockIdx.x * kTile, smem, warp_tot, &total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// One block: exclusive scan of the nb tile totals in place.
__global__ void __launch_bounds__(kScanThreads)
scan_totals_kernel(float* __restrict__ totals, long long nb) {
  __shared__ float warp_tot[kScanThreads / 32 + 1];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  float carry = 0.0f;
  for (long long start = 0; start < nb; start += kScanThreads) {
    const long long i = start + t;
    const float v = i < nb ? totals[i] : 0.0f;
    float wsum;
    const float ex = warp_exclusive(v, &wsum);
    if (lane == 0) warp_tot[warp] = wsum;
    __syncthreads();
    if (warp == 0) {
      float all;
      const float wex = warp_exclusive(warp_tot[lane], &all);
      __syncwarp();
      warp_tot[lane] = wex;
      if (lane == 0) warp_tot[32] = all;
    }
    __syncthreads();
    if (i < nb) totals[i] = carry + (warp_tot[warp] + ex);
    carry += warp_tot[32];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const float* __restrict__ x, long long n,
                 const float* __restrict__ offsets, float* __restrict__ out) {
  __shared__ float smem[padded(kTile)];
  __shared__ float warp_tot[kWarps + 1];
  const long long base = (long long)blockIdx.x * kTile;
  float total;
  const float off = offsets[blockIdx.x] +
                    tile_offsets(x, n, base, smem, warp_tot, &total);
  const int t = threadIdx.x;
  // exclusive prefix of each item, written back over the staged tile
  float run = 0.0f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = padded(t * kItems + j);
    const float v = smem[k];
    smem[k] = off + run;
    run += v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + t;
    const long long g = base + k;
    if (g < n) out[g] = smem[padded(k)];
  }
}

}  // namespace

// x, out: (n,) float32 on one device; scratch: (ceil(n / 4096),) float32.
// Launches the three passes on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int repro_prefix_scan(const float* x, long long n, float* out,
                                 float* scratch, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long nb = (n + kTile - 1) / kTile;
  tile_totals_kernel<<<(unsigned)nb, kThreads, 0, s>>>(x, n, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_totals_kernel<<<1, kScanThreads, 0, s>>>(scratch, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan_kernel<<<(unsigned)nb, kThreads, 0, s>>>(x, n, scratch, out);
  return (int)cudaGetLastError();
}
