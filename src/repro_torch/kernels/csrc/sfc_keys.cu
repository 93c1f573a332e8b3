// SFC key generation (Morton and Hilbert), one thread per element.
//
// Replaces the TPU kernel repro/kernels/sfc_keys.py::sfc_keys_pallas
// (_sfc_kernel -> _morton_body / _hilbert_body).
//
// What bounds it: memory.  Each element reads 12 bytes of int32 grid
// coordinates and writes one 4-byte key; the bit manipulation (at most
// ~10 rounds of a few integer ops for Hilbert) is far below the card's
// integer rate, so the least time is 16 bytes per element over the memory
// rate.  The design does nothing clever: one thread per element, the
// (n, 3) row-major grid read in place (a warp's three loads cover one
// contiguous 384-byte span, served from the same cache lines), and the key
// written once.  The TPU kernel's planar SoA layout and (8, 128) tiling
// exist for its vector unit and are dropped.
//
// Bit-identical to repro_torch.core.sfc.morton_encode / hilbert_encode
// for bits <= 10 (30-bit keys).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t part1by2(uint32_t v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__device__ __forceinline__ uint32_t morton_key(uint32_t x, uint32_t y,
                                               uint32_t z) {
  return part1by2(x) | (part1by2(y) << 1) | (part1by2(z) << 2);
}

// Skilling AxesToTranspose, Gray encode, then interleave the transpose
// form: key bit (3b + 2 - axis) <- bit b of axis.
__device__ __forceinline__ uint32_t hilbert_key(uint32_t x0, uint32_t x1,
                                                uint32_t x2, int bits) {
  for (uint32_t q = 1u << (bits - 1); q > 1u; q >>= 1) {
    const uint32_t p = q - 1u;
    if (x0 & q) x0 ^= p;
    if (x1 & q) {
      x0 ^= p;
    } else {
      const uint32_t t = (x0 ^ x1) & p;
      x0 ^= t;
      x1 ^= t;
    }
    if (x2 & q) {
      x0 ^= p;
    } else {
      const uint32_t t = (x0 ^ x2) & p;
      x0 ^= t;
      x2 ^= t;
    }
  }
  x1 ^= x0;
  x2 ^= x1;
  uint32_t t = 0u;
  for (uint32_t q = 1u << (bits - 1); q > 1u; q >>= 1) {
    if (x2 & q) t ^= q - 1u;
  }
  x0 ^= t;
  x1 ^= t;
  x2 ^= t;
  uint32_t key = 0u;
  for (int b = 0; b < bits; ++b) {
    key |= ((x0 >> b) & 1u) << (3 * b + 2);
    key |= ((x1 >> b) & 1u) << (3 * b + 1);
    key |= ((x2 >> b) & 1u) << (3 * b);
  }
  return key;
}

__global__ void sfc_keys_kernel(const int* __restrict__ grid,
                                int* __restrict__ out, long long n,
                                int curve, int bits) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = (uint32_t)grid[3 * i];
  const uint32_t y = (uint32_t)grid[3 * i + 1];
  const uint32_t z = (uint32_t)grid[3 * i + 2];
  out[i] = (int)(curve == 0 ? morton_key(x, y, z) : hilbert_key(x, y, z, bits));
}

}  // namespace

// grid: (n, 3) int32 row-major, values in [0, 2^bits); out: (n,) int32.
// curve: 0 = Morton, 1 = Hilbert.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int repro_sfc_keys(const int* grid, int* out, long long n,
                              int curve, int bits, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sfc_keys_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      grid, out, n, curve, bits);
  return (int)cudaGetLastError();
}

// Text of a CUDA error code returned by any entry of this library.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
