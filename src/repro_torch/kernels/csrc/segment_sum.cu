// Segment sum: out[s] = the sum of w[i] over the items i with ids[i] == s,
// for s in [0, num_segments); an item whose id lies outside that range adds
// nothing.  float32 weights, int32 or int64 ids, the additions in any
// order.
//
// Replaces no TPU kernel: the JAX package leaves this sum to XLA's
// segment_sum (jax.ops.segment_sum).  It was added for the balancer's
// sums (part weights, migration volumes, the similarity matrix), which
// ran as index_add_: one global float atomic an item into p = 256 or
// 1,024 addresses, serialised at the few L2 slices that hold them (19-38
// ms over 2^27 items), behind two masked copies of the inputs.
//
// What bounds it: the bytes.  Each item is read once, a float32 weight
// and a 4- or 8-byte id: 12n bytes with int64 ids, 1.61 GB at n = 2^27,
// 0.48 ms at 3.35 TB/s.  The output, 4 bytes a bin, is small beside it.
//
// The design:
//   - A persistent grid, as many kThreads blocks as fit on the SMs, walks
//     the items in a grid-stride loop.  A thread takes groups of 4 items:
//     one 16-byte load of weights and one (int32) or two (int64) of ids,
//     streaming (__ldcs), kUnroll groups in flight.  The items before the
//     weights' first 16-byte boundary and those past the last whole group
//     go one at a time; where the ids do not meet 16 bytes where the
//     weights do (a slice of one of them), every item does.
//   - An id outside [0, num_segments) (negative, the balancer's pad part
//     p, past the end) and a zero weight add nothing: one unsigned compare
//     in registers, so the caller makes no masked copies.  Skipping a zero
//     changes no bit: a bin starts at +0 and x + 0 == x for every x that a
//     sum from +0 can reach.
//   - Shared route, where the bins fit in a block's shared memory: each
//     block adds into its own float32 histogram there, one copy a warp
//     where the wrapper's budget allows (fewer copies, shared by several
//     warps, above it), so warps do not contend for an address.  After a
//     barrier the block sums its copies and adds each non-zero bin into
//     the zeroed output with one global atomic: the global atomics fall
//     from one an item to at most one a bin a block.
//   - Global route, where they do not fit (the p x p similarity matrix):
//     the same loads and range test, then one global atomic an item.
//     Those bins are spread over the L2, so the atomics contend little.
//
// On integer weights whose bin totals stay below 2^24 every partial sum
// is exact, so the result is index_add_'s bit for bit, in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;               // groups of 4 items in flight

__device__ __forceinline__ void load4(const int* ids, long long g,
                                      long long (&k)[4]) {
  const int4 x = __ldcs(reinterpret_cast<const int4*>(ids) + g);
  k[0] = x.x;
  k[1] = x.y;
  k[2] = x.z;
  k[3] = x.w;
}

__device__ __forceinline__ void load4(const long long* ids, long long g,
                                      long long (&k)[4]) {
  const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(ids) + 2 * g);
  const longlong2 b =
      __ldcs(reinterpret_cast<const longlong2*>(ids) + 2 * g + 1);
  k[0] = a.x;
  k[1] = a.y;
  k[2] = b.x;
  k[3] = b.y;
}

// bins[id] += w for an id in [0, S) and a non-zero w (a NaN adds).
__device__ __forceinline__ void add(float* bins, long long id, float w,
                                    int S) {
  if ((unsigned long long)id < (unsigned long long)S && w != 0.0f)
    atomicAdd(bins + id, w);
}

// Items [head, head + 4 groups) in groups of 4 (the weights at w + head on
// 16 bytes, and the ids at ids + head), the rest one at a time.  Shared
// route: dynamic shared memory of copies * S floats, warp v adding into
// copy v % copies; global route: straight into out.
template <typename IdT, bool kShared>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ w, const IdT* __restrict__ ids,
                   long long n, long long head, long long groups, int S,
                   int copies, float* __restrict__ out) {
  extern __shared__ float hist[];
  float* bins = out;
  if (kShared) {
    for (int i = threadIdx.x; i < copies * S; i += kThreads) hist[i] = 0.0f;
    bins = hist + (threadIdx.x / 32 % copies) * S;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float4* w4 = reinterpret_cast<const float4*>(w + head);
  const IdT* id4 = ids + head;
  long long g = t;
  for (; g + (kUnroll - 1) * stride < groups; g += kUnroll * stride) {
    float4 x[kUnroll];
    long long k[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = __ldcs(w4 + g + u * stride);
      load4(id4, g + u * stride, k[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add(bins, k[u][0], x[u].x, S);
      add(bins, k[u][1], x[u].y, S);
      add(bins, k[u][2], x[u].z, S);
      add(bins, k[u][3], x[u].w, S);
    }
  }
  for (; g < groups; g += stride) {
    const float4 x = __ldcs(w4 + g);
    long long k[4];
    load4(id4, g, k);
    add(bins, k[0], x.x, S);
    add(bins, k[1], x.y, S);
    add(bins, k[2], x.z, S);
    add(bins, k[3], x.w, S);
  }
  // the items outside the groups: [0, head) and [head + 4 groups, n)
  const long long body = 4 * groups;
  for (long long i = t; i < n - body; i += stride) {
    const long long j = i < head ? i : i + body;
    add(bins, (long long)__ldcs(ids + j), __ldcs(w + j), S);
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < S; b += kThreads) {
      float s = 0.0f;
      for (int c = 0; c < copies; ++c) s += hist[c * S + b];
      if (s != 0.0f) atomicAdd(out + b, s);
    }
  }
}

template <typename IdT, bool kShared>
cudaError_t launch(const float* w, const IdT* ids, long long n, int S,
                   int copies, float* out, cudaStream_t stream) {
  auto kernel = segment_sum_kernel<IdT, kShared>;
  const int smem = kShared ? copies * S * (int)sizeof(float) : 0;
  cudaError_t err;
  if (kShared) {
    // the attribute holds per device, so it is set on every call
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  // groups of 4 from the weights' first 16-byte boundary, if the ids
  // meet 16 bytes there too
  long long head = (long long)(((16 - ((uintptr_t)w & 15)) & 15) / 4);
  if (head > n) head = n;
  long long groups = (n - head) / 4;
  if ((uintptr_t)(ids + head) & 15) head = groups = 0;
  const long long work = groups > n - 4 * groups ? groups : n - 4 * groups;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(w, ids, n, head,
                                                       groups, S, copies, out);
  return cudaGetLastError();
}

}  // namespace

// w: (n,) float32; ids: (n,) int32 (id_bytes 4) or int64 (id_bytes 8);
// out: (num_segments,) float32, zeroed by the caller.  copies = 0: the
// global route; 1..kWarps: the shared route with that many histogram
// copies a block (copies * num_segments * 4 bytes within sm_90a's
// 232,448 bytes of opt-in shared memory).  Returns cudaGetLastError()
// after the launch (0 on success), cudaErrorInvalidValue for arguments
// out of range.
extern "C" int repro_segment_sum(const float* w, const void* ids,
                                 int id_bytes, long long n, int num_segments,
                                 int copies, float* out, void* stream) {
  if (n < 0 || num_segments < 0 || copies < 0 || copies > kWarps ||
      (id_bytes != 4 && id_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || num_segments == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int S = num_segments;
  if (id_bytes == 4) {
    const int* i32 = static_cast<const int*>(ids);
    return (int)(copies ? launch<int, true>(w, i32, n, S, copies, out, s)
                        : launch<int, false>(w, i32, n, S, 0, out, s));
  }
  const long long* i64 = static_cast<const long long*>(ids);
  return (int)(copies ? launch<long long, true>(w, i64, n, S, copies, out, s)
                      : launch<long long, false>(w, i64, n, S, 0, out, s));
}
