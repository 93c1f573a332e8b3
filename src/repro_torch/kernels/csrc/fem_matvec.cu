// P1 element matvec: y[s] = sum_e sum_j K_e[i, j] * u[t_e[j]] for s = t_e[i]
// with precomputed 4x4 element matrices K_e = (g g^T + c M) |e|.
//
// Replaces the TPU kernel repro/kernels/fem_matvec.py::fem_matvec_pallas
// (_matvec_kernel).
//
// What bounds it: memory.  Each element reads its 4 slot ids (16 bytes)
// and its 4x4 matrix (64 bytes) once; the vertex vector is read and the
// output written once per vertex (4 + 4 bytes).  The 16 multiply-adds per
// element are nothing beside that.  The TPU kernel expresses gather and
// scatter as one-hot matmuls against a VMEM-resident vertex vector,
// which suits its matrix unit but caps the vertex count.  Here there is
// no cap: one thread per element gathers u[min(t, V - 1)] directly
// (neighbouring elements share vertices, so the gathers mostly hit L2),
// applies K_e with four float4 row loads, and scatters the four results
// with atomicAdd into y[t] for t < n_out; slot n_out is the dropped pad
// slot.  The atomics make the order of each sum change from run to run,
// so the result equals the plain version within float32 tolerance, not
// bit for bit.

#include <cuda_runtime.h>

namespace {

__global__ void fem_matvec_kernel(const int4* __restrict__ tets,
                                  const float4* __restrict__ kel, long long C,
                                  const float* __restrict__ u, long long V,
                                  float* __restrict__ y, long long n_out) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= C) return;
  const int4 t4 = tets[e];
  const long long t[4] = {t4.x, t4.y, t4.z, t4.w};
  float ue[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) ue[a] = u[t[a] < V - 1 ? t[a] : V - 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 r = kel[4 * e + i];
    const float s = r.x * ue[0] + r.y * ue[1] + r.z * ue[2] + r.w * ue[3];
    if (t[i] < n_out) atomicAdd(y + t[i], s);
  }
}

}  // namespace

// tets: (C, 4) int32 slot ids in [0, n_out], 16-byte aligned; kel:
// (C, 4, 4) float32 row-major, 16-byte aligned; u: (V,) float32 with
// V >= 1; y: (n_out,) float32, zeroed here before the scatter.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int repro_fem_matvec(const int* tets, const float* kel,
                                long long C, const float* u, long long V,
                                float* y, long long n_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_out > 0) {
    const cudaError_t err =
        cudaMemsetAsync(y, 0, (size_t)n_out * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (C <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (C + threads - 1) / threads;
  fem_matvec_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      reinterpret_cast<const int4*>(tets), reinterpret_cast<const float4*>(kel),
      C, u, V, y, n_out);
  return (int)cudaGetLastError();
}
