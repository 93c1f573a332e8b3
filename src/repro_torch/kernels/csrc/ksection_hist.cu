// k-section candidate-cut histogram: for each of m cuts (any order), the
// total weight of items whose key is strictly below the cut.
//
// Replaces the TPU kernel repro/kernels/ksection_hist.py::
// ksection_histogram_pallas (_hist_kernel).
//
// What bounds it: the bytes, if each item costs O(log m) work.  The
// items stream once, 8 bytes each (float32 key + weight); the cuts are
// read and the sums written once.  The TPU kernel compares every item
// of a tile against every cut (n * m compare-adds, 6.9e10 at the
// standalone DLB's 8.4M items and 8,184 cuts), far slower on this card
// than the bytes.  This design does O(n log m + m^2) work in two
// launches:
//
//   1. prep_kernel, two kinds of block in one grid:
//      - rank blocks: rank_j = #{i: c_i < c_j} + #{i < j: c_i == c_j}
//        over the cuts' order-preserving bits, a permutation of [0, m)
//        that sorts them (ties by index), and sorted[rank_j] = c_j.  A
//        block ranks 64 cuts, two a lane; its 32 warps each compare them
//        with a 32nd of the cuts, read four at a time as broadcasts from
//        shared memory.  (One block sorting by bins instead, O(m) on
//        spread cuts, was slower at m = 8,184 and quadratic on equal
//        cuts.)  They also zero the global histogram.
//      - sum blocks: sum |w| over a slice of the items, in float64 and a
//        fixed order, for the fixed-point scale below.
//   2. bucket_kernel: a persistent grid of one 32-warp block per SM.
//      - A block copies the sorted cuts of its bucket range into shared
//        memory and cuts [first cut, last cut] into as many equal bins
//        as the range has buckets, with each bin's start
//        among the sorted cuts.  An item's bucket is #{cuts <= key}
//        (searchsorted(right=True)): its bin gives the range of cuts to
//        search, and a binary search of that range (about one cut, on
//        spread cuts) finishes it.  A binary search of all the cuts, in
//        Eytzinger order, took 13 dependent shared-memory loads a key at
//        m = 8,184, most of them bank conflicts, and was slower.
//      - Weights add into one histogram per block as 64-bit fixed-point
//        integers, w * 2^s with s = 61 - ceil(log2(sum |w|)): integer
//        additions give the same sum in every order, so shared-memory
//        atomics from all 32 warps give the same bits on every call for
//        any float weights, and no warp needs a private copy.  (Private
//        float histograms summed in lane order, the other way to fixed
//        sums, fit only 6 warps an SM at m = 8,184 and were slower.)
//        Shared-memory atomics are native for 32 bits only (a 64-bit add
//        compiles to a compare-and-swap loop, which stalled on keys in
//        order), so a bucket is two 32-bit words and an add carries from
//        the low word into the high one.
//      - A lane takes 4 consecutive items (one 16-byte load of keys, one
//        of weights) and keeps a run: consecutive items of one bucket add
//        into a register and only a change of bucket adds to shared
//        memory.  (Grouping a warp's lanes of one bucket first, by
//        __match_any_sync, cost more than it saved.)
//      - The block adds its histogram into the global one (native 64-bit
//        atomics, order free).  The last block to finish takes the
//        inclusive prefix S over the buckets in int64 and writes out[j] =
//        S[rank_j] * 2^-s, rounded once to float32.  Cuts with equal
//        values get equal sums: the buckets between duplicates are
//        empty.
//      - Above 8,191 cuts the buckets are split into chunks of 8,192 (a
//        second grid dimension; shared memory holds 16 bytes a bucket);
//        an item outside a chunk's key range is skipped by that chunk's
//        blocks, so every m runs.
//
// On integer weights whose total stays below 2^24 the scale keeps every
// weight and every partial sum exact, so the result equals the
// searchsorted + index_add_ + cumsum plain version bit for bit.  On
// other float weights it is the sum of the weights truncated to
// multiples of 2^-s, rounded once: within n * 2^-s of the exact sum.
// +inf keys (the padded tail) land in the last bucket, which no cut
// counts; a key equal to a cut lands above it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrepThreads = 1024;       // 32 warps
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kRankTile = 64;            // cuts per rank block, 2 per lane
constexpr int kRankStage = 4096;         // cuts staged in shared memory
constexpr int kSumBlocksPerSm = 1;
constexpr int kSumAcc = 4;               // sum accumulators per thread
constexpr int kBucketThreads = 1024;
constexpr int kItems = 4;                // items per lane per batch
constexpr int kBatch = 32 * kItems;      // items per warp batch
constexpr int kDepth = 2;                // batches in flight per lane
constexpr int kMaxLog2Buckets = 13;      // buckets per chunk: up to 8,192
constexpr int kScanPer = 8;              // buckets a thread scans per pass
constexpr int kGather = 8;               // cuts a thread gathers at once

struct Plan {
  int log2bk;       // buckets per chunk = 1 << log2bk
  int n_chunks;
  int rows;         // bucket blocks per chunk
  int rank_blocks;
  int sum_blocks;
};

Plan make_plan(long long n, long long m, int sms) {
  Plan p;
  int l = 1;
  while (l < kMaxLog2Buckets && (1LL << l) < m + 1) ++l;
  p.log2bk = l;
  const long long bk = 1LL << l;
  p.n_chunks = (int)((m + 1 + bk - 1) / bk);
  const long long batches = (n + kBatch - 1) / kBatch;
  long long g = (batches + kBucketThreads / 32 - 1) / (kBucketThreads / 32);
  long long cap = sms / p.n_chunks;
  if (cap < 1) cap = 1;
  if (g > cap) g = cap;
  if (g < 1) g = 1;
  p.rows = (int)g;
  p.rank_blocks = (int)((m + kRankTile - 1) / kRankTile);
  long long s = (n + 4 * kPrepThreads - 1) / (4 * kPrepThreads);
  if (s > (long long)kSumBlocksPerSm * sms) s = (long long)kSumBlocksPerSm * sms;
  if (s < 1) s = 1;
  p.sum_blocks = (int)s;
  return p;
}

__host__ __device__ __forceinline__ long long align256(long long b) {
  return (b + 255) & ~255LL;
}

// Order-preserving bits of a float: u(a) < u(b) iff a < b for non-NaN
// a != b (-0 below +0).
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The fixed-point shift s for weights whose |w| sums to the partials'
// total: 2^(61 - s) exceeds it.  Called by a whole warp: lane l adds
// partials l, l + 32, ... in float64, the lanes meet in a fixed tree, and
// lane 0's total decides (every kernel that calls this gets the same s).
__device__ __forceinline__ int fixed_shift(const double* wsum, int k,
                                           int lane) {
  double b = 0.0;
  for (int i = lane; i < k; i += 32) b += wsum[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) b += __shfl_down_sync(kFull, b, o);
  b = __shfl_sync(kFull, b, 0);
  int e = 0;
  frexp(b, &e);                    // b < 2^e
  return max(-100, min(62, 61 - e));
}

// Exclusive prefix sum of a[0, len) in place by one bucket block, in
// passes of kBucketThreads * kScanPer entries.  Integer adds: exact.
__device__ void block_exclusive_scan(int* a, int len, int* warp_tot,
                                     int* pass_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < len; base += kBucketThreads * kScanPer) {
    int v[kScanPer];
    int run = 0;
#pragma unroll
    for (int e = 0; e < kScanPer; ++e) {
      const int i = base + tid * kScanPer + e;
      v[e] = run;
      run += i < len ? a[i] : 0;
    }
    int inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += up;
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      int t = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFull, t, o);
        if (lane >= o) t += up;
      }
      const int prev = __shfl_up_sync(kFull, t, 1);
      __syncwarp();
      warp_tot[lane] = lane == 0 ? 0 : prev;
      if (lane == 31) *pass_tot = t;
    }
    __syncthreads();
    const int before = carry + warp_tot[warp] + (inc - run);
#pragma unroll
    for (int e = 0; e < kScanPer; ++e) {
      const int i = base + tid * kScanPer + e;
      if (i < len) a[i] = before + v[e];
    }
    carry += *pass_tot;
    __syncthreads();
  }
}

// Bin of key x among ``nbins`` equal slices of [cmin, cmin + nbins / inv]:
// a non-decreasing function of x (each step rounds monotonically), so a
// cut in a lower bin is below every key of a higher one.
__device__ __forceinline__ int bin_of(float x, float cmin, float inv,
                                      int nbins) {
  const float f = floorf((x - cmin) * inv);
  return (int)fminf(fmaxf(f, 0.0f), (float)(nbins - 1));
}

// Rank block: counts, for a lane's two cuts ja, jb (bits ua, ub), the
// cuts below them among the staged quads [qa, qb) (global index base +
// 4 q + e); ties count for cuts of lower index.  The block's own cuts
// fill whole quads, so a quad lies before them, among them or after.
__device__ __forceinline__ void rank_slice(const uint4* u, int qa, int qb,
                                           int base, int j0, int ja, int jb,
                                           uint32_t ua, uint32_t ub, int& ca,
                                           int& cb) {
  const int lo_end = min(qb, max(qa, (j0 - base) / 4));
  const int hi_beg = max(lo_end, min(qb, (j0 + kRankTile - base) / 4));
  int q = qa;
#pragma unroll 4
  for (; q < lo_end; ++q) {            // before the block's cuts: <=
    const uint4 x = u[q];
    ca += (x.x <= ua) + (x.y <= ua) + (x.z <= ua) + (x.w <= ua);
    cb += (x.x <= ub) + (x.y <= ub) + (x.z <= ub) + (x.w <= ub);
  }
  for (; q < hi_beg; ++q) {
    const uint32_t x[4] = {u[q].x, u[q].y, u[q].z, u[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int g = base + 4 * q + e;
      ca += (x[e] < ua) | ((x[e] == ua) & (g < ja));
      cb += (x[e] < ub) | ((x[e] == ub) & (g < jb));
    }
  }
#pragma unroll 4
  for (; q < qb; ++q) {                // after them: <
    const uint4 x = u[q];
    ca += (x.x < ua) + (x.y < ua) + (x.z < ua) + (x.w < ua);
    cb += (x.x < ub) + (x.y < ub) + (x.z < ub) + (x.w < ub);
  }
}

__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const float* __restrict__ cuts, int m,
            const float* __restrict__ wts, long long n, int rank_blocks,
            int* __restrict__ rank, float* __restrict__ sorted,
            u64* __restrict__ ghist, double* __restrict__ wsum,
            unsigned* __restrict__ ticket) {
  __shared__ __align__(16) uint32_t u[kRankStage];
  __shared__ int part[kPrepWarps][kRankTile + 1];
  __shared__ double warp_sum[kPrepWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == 0 && tid == 0) *ticket = 0u;
  if ((int)blockIdx.x < rank_blocks) {
    const int j0 = blockIdx.x * kRankTile;
    const int ja = j0 + lane, jb = j0 + 32 + lane;
    const uint32_t ua = ja < m ? ordered(cuts[ja]) : 0u;
    const uint32_t ub = jb < m ? ordered(cuts[jb]) : 0u;
    if (tid < kRankTile && j0 + tid < m) ghist[j0 + tid] = 0ull;
    int ca = 0, cb = 0;
    for (int base = 0; base < m; base += kRankStage) {
      const int cnt = min(kRankStage, m - base);
      const int quads = (cnt + 3) / 4;
      __syncthreads();
      // past the cuts: all ones, below none of them
      for (int i = tid; i < 4 * quads; i += kPrepThreads)
        u[i] = i < cnt ? ordered(cuts[base + i]) : 0xffffffffu;
      __syncthreads();
      const int per = (quads + kPrepWarps - 1) / kPrepWarps;
      const int qa = min(quads, warp * per), qb = min(quads, qa + per);
      rank_slice(reinterpret_cast<const uint4*>(u), qa, qb, base, j0, ja, jb,
                 ua, ub, ca, cb);
    }
    part[warp][lane] = ca;
    part[warp][32 + lane] = cb;
    __syncthreads();
    if (tid < kRankTile) {
      int r = 0;
#pragma unroll
      for (int w = 0; w < kPrepWarps; ++w) r += part[w][tid];
      if (j0 + tid < m) {
        rank[j0 + tid] = r;
        sorted[r] = cuts[j0 + tid];
      }
    }
    return;
  }
  // sum block s: groups of 4 items [s * chunk, (s + 1) * chunk), each
  // thread a fixed strided subset, then a fixed tree over the lanes and
  // the warps
  const int s = blockIdx.x - rank_blocks, nsum = gridDim.x - rank_blocks;
  const long long groups = (n + 3) / 4;
  const long long chunk = (groups + nsum - 1) / nsum;
  const long long lo = s * chunk, hi = min(groups, lo + chunk);
  // four groups a step, kSumAcc accumulators: loads stay in flight
  double acc[kSumAcc] = {0.0, 0.0, 0.0, 0.0};
  const long long full = min(hi, n / 4);       // groups of 4 real items
  long long g = lo + tid;
  for (; g + (kSumAcc - 1) * kPrepThreads < full; g += kSumAcc * kPrepThreads) {
    float4 w4[kSumAcc];
#pragma unroll
    for (int a = 0; a < kSumAcc; ++a)
      w4[a] = __ldcs(reinterpret_cast<const float4*>(wts) + g + a * kPrepThreads);
#pragma unroll
    for (int a = 0; a < kSumAcc; ++a)
      acc[a] += (fabs((double)w4[a].x) + fabs((double)w4[a].y)) +
                (fabs((double)w4[a].z) + fabs((double)w4[a].w));
  }
  for (; g < hi; g += kPrepThreads) {
    if (g < full) {
      const float4 w4 = __ldcs(reinterpret_cast<const float4*>(wts) + g);
      acc[0] += (fabs((double)w4.x) + fabs((double)w4.y)) +
                (fabs((double)w4.z) + fabs((double)w4.w));
    } else {
      for (long long i = 4 * g; i < n; ++i) acc[0] += fabs((double)wts[i]);
    }
  }
  double total = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_down_sync(kFull, total, o);
  if (lane == 0) warp_sum[warp] = total;
  __syncthreads();
  if (tid == 0) {
    double t = 0.0;
    for (int w = 0; w < kPrepWarps; ++w) t += warp_sum[w];
    wsum[s] = t;
  }
}

// Loads batch q (kBatch items: lane l takes items 4l .. 4l + 3) into
// (k, w); items past n read as (+inf, 0).
__device__ __forceinline__ void load_batch(const float* __restrict__ keys,
                                           const float* __restrict__ wts,
                                           long long n, long long q, int lane,
                                           float4& k, float4& w) {
  const long long i = q * kBatch + kItems * lane;
  if ((q + 1) * kBatch <= n) {
    k = __ldcs(reinterpret_cast<const float4*>(keys + i));
    w = __ldcs(reinterpret_cast<const float4*>(wts + i));
  } else {
    k.x = i < n ? keys[i] : INFINITY;
    k.y = i + 1 < n ? keys[i + 1] : INFINITY;
    k.z = i + 2 < n ? keys[i + 2] : INFINITY;
    k.w = i + 3 < n ? keys[i + 3] : INFINITY;
    w.x = i < n ? wts[i] : 0.f;
    w.y = i + 1 < n ? wts[i + 1] : 0.f;
    w.z = i + 2 < n ? wts[i + 2] : 0.f;
    w.w = i + 3 < n ? wts[i + 3] : 0.f;
  }
}

// hist[b] += v for a 64-bit bucket kept as two 32-bit words (lo, hi):
// the add that wraps the low word carries into the high one, so the pair
// holds the exact sum mod 2^64 whatever the order of the adds.
__device__ __forceinline__ void add64(unsigned* lo, unsigned* hi, u64 v) {
  const unsigned l = (unsigned)v;
  const unsigned old = atomicAdd(lo, l);
  const unsigned h = (unsigned)(v >> 32) + (old + l < old ? 1u : 0u);
  if (h) atomicAdd(hi, h);
}

// The last bucket block: S = inclusive prefix of ghist over [0, m) in
// int64, in passes of kBucketThreads * kScanPer buckets, into ``S``;
// then out[j] = S[rank_j] * 2^-shift, rounded once.
__device__ __forceinline__ void scan_gather(const u64* ghist, int m,
                                            const int* __restrict__ rank,
                                            int shift, long long* S,
                                            float* __restrict__ out,
                                            long long* warp_tot,
                                            long long* pass_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long carry = 0;
  for (long long base = 0; base < m; base += kBucketThreads * kScanPer) {
    long long v[kScanPer];
    long long run = 0;
#pragma unroll
    for (int e = 0; e < kScanPer; ++e) {
      const long long b = base + (long long)tid * kScanPer + e;
      run += b < m ? (long long)__ldcg(ghist + b) : 0;
      v[e] = run;
    }
    long long inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += up;
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      long long t = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long up = __shfl_up_sync(kFull, t, o);
        if (lane >= o) t += up;
      }
      const long long prev = __shfl_up_sync(kFull, t, 1);
      __syncwarp();
      warp_tot[lane] = lane == 0 ? 0 : prev;
      if (lane == 31) *pass_tot = t;
    }
    __syncthreads();
    const long long before = carry + warp_tot[warp] + (inc - run);
#pragma unroll
    for (int e = 0; e < kScanPer; ++e) {
      const long long b = base + (long long)tid * kScanPer + e;
      if (b < m) S[b] = before + v[e];
    }
    carry += *pass_tot;
    __syncthreads();
  }
  for (long long j0 = 0; j0 < m; j0 += kBucketThreads * kGather) {
    int r[kGather];
#pragma unroll
    for (int e = 0; e < kGather; ++e) {
      const long long j = j0 + e * kBucketThreads + tid;
      r[e] = j < m ? __ldg(rank + j) : 0;
    }
#pragma unroll
    for (int e = 0; e < kGather; ++e) {
      const long long j = j0 + e * kBucketThreads + tid;
      if (j < m) out[j] = ldexpf(__ll2float_rn(S[r[e]]), -shift);
    }
  }
}

// Grid (rows, n_chunks), kBucketThreads threads; dynamic shared memory
// 16 << log2bk bytes + 4: the chunk's histogram (low words, high words),
// its sorted cuts and the start of each bin among them.
__global__ void __launch_bounds__(kBucketThreads)
bucket_kernel(const float* __restrict__ keys, const float* __restrict__ wts,
              long long n, const float* __restrict__ sorted_cuts,
              const int* __restrict__ rank, int m, int log2bk,
              const double* __restrict__ wsum, int n_wsum, u64* ghist,
              unsigned* ticket, long long* S_global,
              float* __restrict__ out) {
  extern __shared__ unsigned hist_lo[];
  __shared__ float edge[2];
  __shared__ int edge_on[2];
  __shared__ int shift_s;
  __shared__ int warp_tot[kBucketThreads / 32];
  __shared__ int bins_tot;
  __shared__ long long scan_tot[kBucketThreads / 32];
  __shared__ long long pass_tot;
  __shared__ int is_last;
  const int bk = 1 << log2bk;
  unsigned* hist_hi = hist_lo + bk;
  float* sorted = reinterpret_cast<float*>(hist_hi + bk);
  int* bin_start = reinterpret_cast<int*>(sorted + bk);   // bk + 1 entries
  const int c = blockIdx.y, g = blockIdx.x, rows = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int warps = kBucketThreads / 32;
  const long long b0 = (long long)c << log2bk;
  const int count = (int)min((long long)bk - 1, m - b0);   // the chunk's cuts
  // the first batches' loads go out before the set-up below
  const long long nb = (n + kBatch - 1) / kBatch;
  const long long gw = (long long)rows * warps;
  const long long step = kDepth * gw;
  float4 kb[kDepth], wb[kDepth];
  const long long first = (long long)g * warps + warp;
#pragma unroll
  for (int s = 0; s < kDepth; ++s) {
    if (first + s * gw < nb) load_batch(keys, wts, n, first + s * gw, lane, kb[s], wb[s]);
  }
  for (int i = tid; i < bk; i += kBucketThreads) {
    hist_lo[i] = 0u;
    hist_hi[i] = 0u;
    bin_start[i] = 0;
  }
  if (tid == 0) bin_start[bk] = 0;
  for (int r = tid; r < count; r += kBucketThreads) sorted[r] = sorted_cuts[b0 + r];
  if (tid == 0) {
    edge_on[0] = b0 > 0;
    edge_on[1] = b0 + bk - 1 < m;
    edge[0] = b0 > 0 ? sorted_cuts[b0 - 1] : 0.0f;
    edge[1] = b0 + bk - 1 < m ? sorted_cuts[b0 + bk - 1] : 0.0f;
  }
  if (warp == 1) {
    const int sh = fixed_shift(wsum, n_wsum, lane);
    if (lane == 0) shift_s = sh;
  }
  __syncthreads();
  // bins: bk equal slices of [sorted[0], sorted[count - 1]]; the count of
  // each (integer atomics), then their starts by an exclusive scan
  const float cmin = count > 0 ? sorted[0] : 0.0f;
  const float width = count > 0 ? sorted[count - 1] - cmin : 0.0f;
  float inv = (float)bk / width;
  if (!(width > 0.0f) || !isfinite(inv) || !isfinite(cmin)) inv = 0.0f;
  for (int r = tid; r < count; r += kBucketThreads)
    atomicAdd(&bin_start[bin_of(sorted[r], cmin, inv, bk)], 1);
  __syncthreads();
  block_exclusive_scan(bin_start, bk + 1, warp_tot, &bins_tot);
  const int last = (int)min((long long)bk, m + 1 - b0) - 1;
  const bool lo_on = edge_on[0] != 0, hi_on = edge_on[1] != 0;
  const float lo = edge[0], hi = edge[1];
  const float scale = ldexpf(1.0f, shift_s);

  int run_b = -1;
  long long run_v = 0;
  for (long long q = first; q < nb; q += step) {
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      const long long qs = q + s * gw;
      if (qs < nb) {
        const float key[kItems] = {kb[s].x, kb[s].y, kb[s].z, kb[s].w};
        const float wt[kItems] = {wb[s].x, wb[s].y, wb[s].z, wb[s].w};
        if (qs + step < nb) load_batch(keys, wts, n, qs + step, lane, kb[s], wb[s]);
        int a[kItems], z[kItems];
#pragma unroll
        for (int t = 0; t < kItems; ++t) {
          const int k = bin_of(key[t], cmin, inv, bk);
          a[t] = bin_start[k];
          z[t] = bin_start[k + 1];
        }
#pragma unroll
        for (int t = 0; t < kItems; ++t) {
          // #{cuts <= key} among the bin's cuts: a binary search
          while (a[t] < z[t]) {
            const int mid = (a[t] + z[t]) >> 1;
            if (sorted[mid] <= key[t]) a[t] = mid + 1;
            else z[t] = mid;
          }
        }
#pragma unroll
        for (int t = 0; t < kItems; ++t) {
          const bool in = (!lo_on || !(key[t] < lo)) && (!hi_on || key[t] < hi);
          // NaN keys are below no cut: the last bucket
          const int b = key[t] == key[t] ? min(a[t], last) : last;
          const long long v = __float2ll_rz(wt[t] * scale);
          if (in) {
            if (b == run_b) {
              run_v += v;
            } else {
              if (run_b >= 0) add64(hist_lo + run_b, hist_hi + run_b, (u64)run_v);
              run_b = b;
              run_v = v;
            }
          }
        }
      }
    }
  }
  if (run_b >= 0) add64(hist_lo + run_b, hist_hi + run_b, (u64)run_v);
  __syncthreads();
  const int need = (int)min((long long)bk, m - b0);
  for (int b = tid; b < need; b += kBucketThreads) {
    const u64 v = ((u64)hist_hi[b] << 32) | hist_lo[b];
    if (v) atomicAdd(&ghist[b0 + b], v);
  }
  // the last block to finish takes the prefix and writes the sums
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  long long* S = 8LL * m <= (16LL << log2bk)
                     ? reinterpret_cast<long long*>(hist_lo)
                     : S_global;
  scan_gather(ghist, m, rank, shift_s, S, out, scan_tot, &pass_tot);
}

}  // namespace

// Scratch bytes the histogram of n items and m cuts needs on a card with
// ``sms`` SMs.
extern "C" long long repro_ksection_hist_workspace(long long n, long long m,
                                                   int sms) {
  const Plan p = make_plan(n, m, sms);
  return 2 * align256(4 * m) + 2 * align256(8 * m) +
         align256(8LL * p.sum_blocks) + 256;
}

// keys, w: (n,) float32, 16-byte aligned; cuts: (m,) float32 in any
// order; workspace: repro_ksection_hist_workspace's bytes, 256-byte aligned
// (no initialisation needed); out: (m,) float32.  Requires n > 0,
// 0 < m < 2^30, the same sms as the plan.  Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int repro_ksection_hist(const float* keys, const float* w,
                                   long long n, const float* cuts,
                                   long long m, void* workspace, int sms,
                                   float* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Plan p = make_plan(n, m, sms);
  const int mi = (int)m;
  char* ws = static_cast<char*>(workspace);
  int* rank = reinterpret_cast<int*>(ws);
  ws += align256(4 * m);
  u64* ghist = reinterpret_cast<u64*>(ws);
  ws += align256(8 * m);
  long long* S = reinterpret_cast<long long*>(ws);
  ws += align256(8 * m);
  double* wsum = reinterpret_cast<double*>(ws);
  ws += align256(8LL * p.sum_blocks);
  unsigned* ticket = reinterpret_cast<unsigned*>(ws);
  ws += 256;
  float* sorted = reinterpret_cast<float*>(ws);

  prep_kernel<<<p.rank_blocks + p.sum_blocks, kPrepThreads, 0, s>>>(
      cuts, mi, w, n, p.rank_blocks, rank, sorted, ghist, wsum, ticket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the attribute holds per device, so it is set on every call
  const int smem = (16 << p.log2bk) + 4;
  err = cudaFuncSetAttribute(bucket_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bucket_kernel<<<dim3(p.rows, p.n_chunks), kBucketThreads, smem, s>>>(
      keys, w, n, sorted, rank, mi, p.log2bk, wsum, p.sum_blocks, ghist,
      ticket, S, out);

  return (int)cudaGetLastError();
}
