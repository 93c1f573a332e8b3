// SFC key generation (Morton and Hilbert), four elements per thread.
//
// Replaces the TPU kernel repro/kernels/sfc_keys.py::sfc_keys_pallas
// (_sfc_kernel -> _morton_body / _hilbert_body).
//
// What bounds it: memory, if a key costs few enough integer operations.
// Each element reads 12 bytes of int32 grid coordinates and writes one
// 4-byte key, so the least time is 16 bytes per element over the memory
// rate: 3.35 TB/s / 16 B = 2.1e11 keys a second.  The card runs about
// 1.6e13 integer operations a second (64 a clock on each of 132 SMs), so
// a key may cost about 75 of them before they, and not the bytes, set
// the time.  Skilling's Hilbert loop as the TPU kernel writes it (9
// levels of selects, a 9-step Gray loop and a 30-step bit interleave)
// compiles to 227 integer instructions a key at bits = 10; the table
// walk below to 51 and 6 loads.  The design:
//
//   * Hilbert as a table walk.  Each level of Skilling's loop maps the
//     lower bits of (x0, x1, x2) by an axis permutation and an inversion
//     mask, and the Gray step carries one bit of parity down, so the
//     encoder is a finite-state transducer over the 3-bit digits of the
//     coordinates, read from the top: 48 states (24 orientations x 2
//     parities).  kernels/sfc_keys.py::hilbert_table steps Skilling's
//     loop one level at a time to build it for two levels at a time: a
//     row of 64 entries per state, indexed by the six coordinate bits of
//     two levels, each entry the next state's row base (next * 64) plus
//     the six key bits of the two levels.  One more row starts an odd
//     number of levels (a virtual top level of zeros).  The 6,272-byte
//     table sits in shared memory; a 10-bit key is 5 dependent lookups.
//   * The six bits of a step are cut from one word: each axis spread by
//     the first three steps of the Morton spread (two-bit groups to
//     every sixth bit), so a step is a shift, one LOP3 with the entry
//     (row base | bits) and the load.  Morton is the same spread's
//     fourth step.
//   * Wider memory operations: a thread takes 4 elements, 48 bytes of
//     grid as three 16-byte loads and 4 keys as one 16-byte store.  A
//     grid whose base is not 16-byte aligned (a contiguous slice of a
//     larger tensor) and a ragged tail of n % 4 elements take 4-byte
//     loads and stores instead.
//
// The TPU kernel's planar SoA layout and (8, 128) tiling exist for its
// vector unit and are dropped.  Bit-identical to repro_torch.core.sfc.
// morton_encode / hilbert_encode for bits <= 10 (30-bit keys).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                 // elements per thread
constexpr int kTableRows = 49;          // 48 states + the odd-start row
constexpr int kTableEntries = kTableRows * 64;
constexpr int kBlocksPerSm = 4;         // grid cap; threads stride over groups

// Two-bit groups of the low 10 bits to every sixth bit (pair k -> 6k):
// the first three steps of the Morton spread.
__device__ __forceinline__ uint32_t spread_pairs(uint32_t v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  return v;
}

// Bits of the low 10 to every third bit (the Morton part1by2).
__device__ __forceinline__ uint32_t spread_bits(uint32_t v) {
  return (spread_pairs(v) | (spread_pairs(v) << 2)) & 0x09249249u;
}

__device__ __forceinline__ uint32_t morton_key(uint32_t x, uint32_t y,
                                               uint32_t z) {
  return spread_bits(x) | (spread_bits(y) << 1) | (spread_bits(z) << 2);
}

// STEPS two-level steps of the table walk, from the top.  The six index
// bits of a step are (x0 pair << 4) | (x1 pair << 2) | x2 pair.
template <int STEPS>
__device__ __forceinline__ uint32_t hilbert_key(uint32_t x0, uint32_t x1,
                                                uint32_t x2,
                                                const uint16_t* tab,
                                                uint32_t row) {
  const uint32_t p =
      (spread_pairs(x0) << 4) | (spread_pairs(x1) << 2) | spread_pairs(x2);
  uint32_t key = 0u;
#pragma unroll
  for (int s = STEPS - 1; s >= 0; --s) {
    const uint32_t e = tab[row | ((p >> (6 * s)) & 63u)];
    key = (key << 6) | (e & 63u);
    row = e & ~63u;
  }
  return key;
}

template <int CURVE, int STEPS>
__device__ __forceinline__ uint32_t key_of(uint32_t x, uint32_t y, uint32_t z,
                                           const uint16_t* tab,
                                           uint32_t row) {
  if (CURVE == 0) return morton_key(x, y, z);
  return hilbert_key<STEPS>(x, y, z, tab, row);
}

// CURVE: 0 Morton, 1 Hilbert.  STEPS: ceil(bits / 2) (Hilbert only).
// ALIGNED: the grid's base is 16-byte aligned, so full groups of 4
// elements load as three int4.  row0: the first table row's base, 0 for
// an even number of levels, 48 * 64 for an odd one.
template <int CURVE, int STEPS, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
sfc_keys_kernel(const int* __restrict__ grid, int* __restrict__ out,
                long long n, const uint16_t* __restrict__ table,
                uint32_t row0) {
  __shared__ __align__(16) uint16_t tab[CURVE == 0 ? 2 : kTableEntries];
  if (CURVE == 1) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(table);
    uint32_t* dst = reinterpret_cast<uint32_t*>(tab);
    for (int i = threadIdx.x; i < kTableEntries / 2; i += kThreads)
      dst[i] = __ldg(src + i);
    __syncthreads();
  }
  const long long groups = (n + kPer - 1) / kPer;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = blockIdx.x * (long long)kThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long i0 = g * kPer;
    if (ALIGNED && i0 + kPer <= n) {
      const int4* src = reinterpret_cast<const int4*>(grid) + 3 * g;
      const int4 a = __ldg(src), b = __ldg(src + 1), c = __ldg(src + 2);
      int4 k;
      k.x = (int)key_of<CURVE, STEPS>(a.x, a.y, a.z, tab, row0);
      k.y = (int)key_of<CURVE, STEPS>(a.w, b.x, b.y, tab, row0);
      k.z = (int)key_of<CURVE, STEPS>(b.z, b.w, c.x, tab, row0);
      k.w = (int)key_of<CURVE, STEPS>(c.y, c.z, c.w, tab, row0);
      reinterpret_cast<int4*>(out)[g] = k;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const long long i = i0 + e;
        if (i < n) {
          out[i] = (int)key_of<CURVE, STEPS>(
              (uint32_t)__ldg(grid + 3 * i), (uint32_t)__ldg(grid + 3 * i + 1),
              (uint32_t)__ldg(grid + 3 * i + 2), tab, row0);
        }
      }
    }
  }
}

template <int CURVE, int STEPS>
void launch(const int* grid, int* out, long long n, const uint16_t* table,
            uint32_t row0, int blocks, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(grid) & 15u) == 0) {
    sfc_keys_kernel<CURVE, STEPS, true><<<blocks, kThreads, 0, s>>>(
        grid, out, n, table, row0);
  } else {
    sfc_keys_kernel<CURVE, STEPS, false><<<blocks, kThreads, 0, s>>>(
        grid, out, n, table, row0);
  }
}

}  // namespace

// grid: (n, 3) int32 row-major, values in [0, 2^bits); out: (n,) int32,
// 16-byte aligned.  curve: 0 = Morton, 1 = Hilbert; table: the Hilbert
// table (kernels/sfc_keys.py::hilbert_table, 49 x 64 uint16; not read
// for Morton); sms: the card's SM count.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int repro_sfc_keys(const int* grid, int* out, long long n,
                              int curve, int bits, const uint16_t* table,
                              int sms, void* stream) {
  if (n <= 0) return 0;
  if (bits < 1 || bits > 10) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long groups = (n + kPer - 1) / kPer;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > (long long)kBlocksPerSm * sms) blocks = (long long)kBlocksPerSm * sms;
  const int nb = (int)blocks;
  const uint32_t row0 = (bits & 1) ? 48u * 64u : 0u;
  if (curve == 0) {
    launch<0, 1>(grid, out, n, table, 0u, nb, s);
  } else {
    switch ((bits + 1) / 2) {
      case 1: launch<1, 1>(grid, out, n, table, row0, nb, s); break;
      case 2: launch<1, 2>(grid, out, n, table, row0, nb, s); break;
      case 3: launch<1, 3>(grid, out, n, table, row0, nb, s); break;
      case 4: launch<1, 4>(grid, out, n, table, row0, nb, s); break;
      default: launch<1, 5>(grid, out, n, table, row0, nb, s); break;
    }
  }
  return (int)cudaGetLastError();
}

// Text of a CUDA error code returned by any entry of this library.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
