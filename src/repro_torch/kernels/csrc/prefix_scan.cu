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
// the next.  Hopper blocks run in no order, so the carry becomes a
// single pass with a look-back over tile aggregates only:
//
//   1. a block draws its tile from an atomic ticket, so every tile with
//      a lower index has started (and none waits on a later one);
//   2. it loads its tile once (16 items a thread, staged through shared
//      memory with coalesced loads), scans it in the block and
//      publishes the tile's aggregate with a flag (one 64-bit store);
//   3. warp 0 waits for the aggregates of ALL lower tiles -- none of
//      them depends on another tile, so nothing is chained -- and adds
//      them in a fixed order: lane l takes tiles l, l + 32, ... in
//      order, then the lanes' sums meet in a fixed butterfly;
//   4. every thread writes its items once: tile prefix + in-tile prefix.
//
// So one launch moves the bound's 8 bytes per element.  A textbook
// decoupled look-back stops at the first predecessor whose inclusive
// prefix is ready, a point that depends on timing, so float sums would
// change from run to run; here the order of every addition is fixed by
// n alone, and the result is the same on every run.  On integer weights
// whose total stays below 2^24 every partial sum is exact and the result
// equals torch.cumsum(x) - x bit for bit.  Any n runs: the ragged last
// tile reads zeros past the end and stores nothing there.
//
// Tiles: 4096 items (256 threads) up to 2^19 items, 8192 (512 threads)
// above.  On the H100 the larger tile was faster from ~10^6 items on
// (fewer blocks, and fewer flags for each to read) and slower at 2^18,
// where 64 blocks of 4096 fill more of the card.  The tile depends on n
// alone, so the bits do too.
//
// Status memory: word 0 holds the ticket counter, word 1 + t holds
// (epoch << 32) | the aggregate's bits of tile t.  The wrapper keeps one
// status buffer per stream (calls on one stream run in order) and passes
// a new epoch with every call, so a flag left by an earlier call of any
// length never matches; the block that draws the last ticket resets the
// counter for the next call.  No memset, no allocation per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 16;                    // consecutive items per thread
constexpr int kLoads = 8;                     // look-back loads in flight
constexpr int kSmallThreads = 256;            // 4096-item tiles ...
constexpr long long kSmallUpTo = 1 << 19;     // ... up to 2^19 items
constexpr int kLargeThreads = 512;            // 8192-item tiles above

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

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The sum of the aggregates of tiles 0 .. tile - 1, by warp 0, waiting
// for each flag to carry this call's epoch.  Lane l adds tiles l, l + 32,
// l + 64, ... in that order; the lanes' sums meet in a fixed butterfly.
__device__ __forceinline__ float lookback(const unsigned long long* flags,
                                          unsigned tile, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (unsigned base = 0; base < tile; base += 32 * kLoads) {
    unsigned long long v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const unsigned j = base + u * 32 + lane;
      v[u] = j < tile ? load_acquire(flags + j) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const unsigned j = base + u * 32 + lane;
      if (j < tile) {
        while ((unsigned)(v[u] >> 32) != epoch)
          v[u] = load_acquire(flags + j);
        acc += __uint_as_float((unsigned)v[u]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ x, long long n, float* __restrict__ out,
            unsigned long long* __restrict__ status, unsigned tiles,
            unsigned epoch) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kTile = kThreads * kItems;
  __shared__ float smem[padded(kTile)];
  __shared__ float warp_tot[kWarps + 1];
  __shared__ unsigned tile_s;
  __shared__ float tile_off;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  unsigned* ticket = reinterpret_cast<unsigned*>(status);
  unsigned long long* flags = status + 1;
  if (t == 0) {
    const unsigned mine = atomicAdd(ticket, 1u);
    if (mine == tiles - 1) atomicExch(ticket, 0u);   // every ticket is out
    tile_s = mine;
  }
  __syncthreads();
  const unsigned tile = tile_s;
  const long long base = (long long)tile * kTile;

  // stage the tile with coalesced loads; each thread adds its 16
  // consecutive items (the index is padded by one word every 32, so the
  // 16-strided reads hit 32 banks)
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
  if (lane == 0) warp_tot[warp] = wsum;
  __syncthreads();
  if (warp == 0) {
    const float v = lane < kWarps ? warp_tot[lane] : 0.0f;
    float all;
    const float ex = warp_exclusive(v, &all);
    __syncwarp();
    if (lane < kWarps) warp_tot[lane] = ex;
    if (lane == 0) {
      store_release(flags + tile,
                    ((unsigned long long)epoch << 32) | __float_as_uint(all));
    }
    const float prior = lookback(flags, tile, epoch);
    if (lane == 0) tile_off = prior;
  }
  __syncthreads();
  const float off = tile_off + (warp_tot[warp] + lane_off);

  // exclusive prefix of each item, written back over the staged tile,
  // then stored with coalesced writes
  run = 0.0f;
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

template <int kThreads>
int launch(const float* x, long long n, float* out, void* status,
           unsigned epoch, cudaStream_t stream) {
  const long long tiles = (n + kThreads * kItems - 1) / (kThreads * kItems);
  scan_kernel<kThreads><<<(unsigned)tiles, kThreads, 0, stream>>>(
      x, n, out, static_cast<unsigned long long*>(status), (unsigned)tiles,
      epoch);
  return (int)cudaGetLastError();
}

}  // namespace

// The smallest tile: the wrapper sizes the status buffer by it.
extern "C" int repro_prefix_scan_tile() { return kSmallThreads * kItems; }

// x, out: (n,) float32 on one device; status: at least
// 1 + ceil(n / 4096) 64-bit words, reused across calls on `stream` with a
// new epoch (> 0) each call, zero before its first use.  Launches one
// kernel on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_prefix_scan(const float* x, long long n, float* out,
                                 void* status, unsigned epoch,
                                 void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= kSmallUpTo)
    return launch<kSmallThreads>(x, n, out, status, epoch, s);
  return launch<kLargeThreads>(x, n, out, status, epoch, s);
}
