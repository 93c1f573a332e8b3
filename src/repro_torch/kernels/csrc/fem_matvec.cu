// P1 element matvec: y[s] = sum_e sum_j K_e[i, j] * u[t_e[j]] for s = t_e[i]
// with precomputed 4x4 element matrices K_e = (g g^T + c M) |e|.
//
// Replaces the TPU kernel repro/kernels/fem_matvec.py::fem_matvec_pallas
// (_matvec_kernel).
//
// What bounds it: memory.  Each element's 4x4 matrix (64 bytes) is read
// once per call; the 16 multiply-adds per element are nothing beside
// that.  The TPU kernel expresses gather and scatter as one-hot matmuls
// against a VMEM-resident vertex vector.  A first port scattered with one
// float atomicAdd per (element, corner), ~19 to each address: it moved
// 30 % of the bytes the bandwidth allows and summed in a new order on
// every call.  This design sums without atomics, in an order fixed by the
// mesh, from a plan built once per connectivity (kernels/fem_matvec.py,
// build_element_plan):
//
//   pass 1, one CTA of CHUNK threads per chunk of CHUNK consecutive
//     elements: the chunk's K_e rows, local corners and incidence runs
//     are copied into shared memory with cp.async (coalesced, 16 and 8
//     bytes a lane) while the chunk's local vertices' u values are
//     gathered once; each row's sum (slot q = 4 e + i is row i of
//     element e) lands in shared memory at its slot; then one thread per
//     local vertex adds its slots in the plan's order (the chunk's
//     incidence runs, ``inc``) and writes one partial, at the index the
//     plan gives (partials are stored by (vertex, chunk)).  Staging in
//     shared memory rather than registers keeps a thread at <= 36
//     registers, so 7 CTAs share an SM and overlap one another's copies
//     with their arithmetic (a first version that staged K_e in registers
//     ran 4 CTAs an SM and took 1.27x as long in chip_smoke.py);
//   pass 2, one thread per vertex: the sum of its partials in chunk
//     order, or 0.
//
// Per element it reads 64 bytes of K_e and 16 of plan (4 local corners,
// 4 incidence entries), and per local vertex (~0.4 per element) 10 bytes
// of plan and one u value; each partial is written once and read once.
// Slots >= n_out (the pad slot n_out) have no partial: they are dropped.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 256;          // elements per chunk = threads per CTA
constexpr int SLOTS = 4 * CHUNK;    // (element, corner) slots per chunk

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async8(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               ::"r"(dst), "l"(src));
}

// 7 CTAs per SM (28 KB of shared memory each, <= 36 registers a thread):
// the memory system is kept busy by other CTAs while one computes.
__global__ void __launch_bounds__(CHUNK, 7)
element_pass(const float4* __restrict__ kel, const short4* __restrict__ local,
             const short* __restrict__ inc, const int* __restrict__ chunk_off,
             const int* __restrict__ gid, const short* __restrict__ seg_end,
             const int* __restrict__ pos, long long C,
             const float* __restrict__ u, long long V,
             float* __restrict__ partial) {
  __shared__ __align__(16) float4 ks[SLOTS];   // the chunk's K_e rows
  __shared__ __align__(16) short4 lcs[CHUNK];  // its local corners
  __shared__ __align__(16) short incs[SLOTS];  // its incidence runs
  __shared__ float us[SLOTS];                  // u at its local vertices
  __shared__ float rs[SLOTS];                  // row sums by slot
  const long long e0 = (long long)blockIdx.x * CHUNK;
  const int ne = (int)min((long long)CHUNK, C - e0);
  const int nslots = 4 * ne;
  const int l0 = chunk_off[blockIdx.x];
  const int nloc = chunk_off[blockIdx.x + 1] - l0;
  const int tid = threadIdx.x;

  // the chunk's K_e (a warp copies 512 consecutive bytes), corners and
  // incidence runs stream in while the u values are gathered
  for (int q = tid; q < nslots; q += CHUNK)
    cp_async16(smem_addr(ks + q), kel + 4 * e0 + q);
  for (int e = tid; e < ne; e += CHUNK) {
    cp_async8(smem_addr(lcs + e), local + e0 + e);
    cp_async8(smem_addr(incs + 4 * e), inc + 4 * (e0 + e));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int l = tid; l < nloc; l += CHUNK) {
    const long long g = gid[l0 + l];
    us[l] = u[g < V - 1 ? g : V - 1];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int q = tid; q < nslots; q += CHUNK) {    // slot q: row q % 4 of
    const float4 r = ks[q];                      // element q / 4
    const short4 c = lcs[q / 4];
    rs[q] = r.x * us[c.x] + r.y * us[c.y] + r.z * us[c.z] + r.w * us[c.w];
  }
  __syncthreads();

  for (int l = tid; l < nloc; l += CHUNK) {
    const int p = pos[l0 + l];
    if (p < 0) continue;                      // the dropped pad slot
    const int end = seg_end[l0 + l];
    float s = 0.f;
    for (int q = l ? seg_end[l0 + l - 1] : 0; q < end; ++q) s += rs[incs[q]];
    partial[p] = s;
  }
}

__global__ void vertex_pass(const int* __restrict__ vert_off,
                            const float* __restrict__ partial,
                            float* __restrict__ y, long long n_out) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_out) return;
  const int end = vert_off[v + 1];
  float s = 0.f;
  for (int q = vert_off[v]; q < end; ++q) s += partial[q];
  y[v] = s;
}

}  // namespace

// kel: (C, 4, 4) float32 row-major, 16-byte aligned; the plan's arrays as
// kernels/fem_matvec.py::ElementPlan describes them (local (C, 4) int16,
// inc (4C,) int16, chunk_off (ceil(C / CHUNK) + 1,) int32, gid / seg_end /
// pos per local vertex, vert_off (n_out + 1,) int32); u: (V,) float32,
// V >= 1; partial: one float32 per partial; y: (n_out,) float32, every
// entry written.  C >= 1 and n_out >= 1.  Returns cudaGetLastError()
// after the launches (0 on success).
// Elements per chunk of the plan's layout: the wrapper checks that its
// plan builder cuts the elements the same way.
extern "C" int repro_fem_matvec_chunk() { return CHUNK; }

extern "C" int repro_fem_matvec(const float* kel, const short* local,
                                const short* inc, const int* chunk_off,
                                const int* gid, const short* seg_end,
                                const int* pos, long long C, const float* u,
                                long long V, float* partial,
                                const int* vert_off, float* y,
                                long long n_out, void* stream) {
  if (C <= 0 || n_out <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long chunks = (C + CHUNK - 1) / CHUNK;
  element_pass<<<(unsigned)chunks, CHUNK, 0, s>>>(
      reinterpret_cast<const float4*>(kel),
      reinterpret_cast<const short4*>(local), inc, chunk_off, gid, seg_end,
      pos, C, u, V, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  vertex_pass<<<(unsigned)((n_out + threads - 1) / threads), threads, 0, s>>>(
      vert_off, partial, y, n_out);
  return (int)cudaGetLastError();
}
