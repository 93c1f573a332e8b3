// Shared body of the two bf16 attention kernels on Hopper
// (flash_attention_wgmma.cu and serve_prefill.cu): one CTA attends a
// query tile of 64 or 128 rows to the key tiles a mask policy lists, in
// FlashAttention-3's shape on wgmma, TMA and mbarriers (bf16 in, float32
// accumulate):
//
//   * warp specialisation: one producer warp (a whole warpgroup beside
//     two consumer groups, setmaxnreg down) issues every TMA load from one
//     thread; each consumer warpgroup (setmaxnreg up with two) owns 64
//     query rows;
//   * the producer loads the query tile once, then K and V tiles of BK
//     keys into a ring of STAGES stages with a full and an empty mbarrier
//     each, 128-byte swizzled in panels of 64 head dims: the layout wgmma
//     reads, with no thread touching the bytes.  The tensor maps are 3-D
//     (head dim, rows, heads), so TMA zero-fills keys past the sequence,
//     query rows past it and head dims past d (d = 80 and 120 ride on
//     DP = 128 that way);
//   * S = Q K^T is wgmma m64nBKk16 with both operands in shared memory
//     (K-major); the online softmax runs on its accumulator registers
//     (quad shuffles for the row max, exp2 with the scale folded into
//     log2 e, each thread's share of the row sum kept apart until the
//     end), masking only tiles that straddle an edge of the mask;
//   * P V is wgmma with A = P from registers (the S accumulator's layout
//     is the A fragment's) and B = the V tile in shared memory, MN-major
//     through the descriptor's transpose bit.  P is split in two bf16
//     halves, its top 16 bits and the remainder rounded, and both are
//     multiplied into one accumulator: P V then carries ~16 bits of P,
//     where one bf16 P would cost up to 2^-8 of max|v| per element, more
//     than the one-bf16-step check of the output allows near 0.  The
//     second product costs half the P V work again;
//   * each consumer issues Q K^T of a tile with P V of the tile before
//     and runs the tile's softmax while that P V runs.  The pipeline has
//     no branch around a wgmma or its wait: where it had one (a warpgroup
//     skipping a tile it cannot see, two named barriers passing the
//     tensor cores between the groups), ptxas serialised every wgmma
//     (C7514 / C7518) and the ping-pong was slower on the card as well.
//
// Head dims are padded to DP = 64, 128 or 256; the kernels pick the ring
// (BK, STAGES).  ptxas sizes a thread of a two-group CTA at 168 registers
// whatever setmaxnreg asks, so those consumers stay within it: 64-key
// tiles, and DP = 256 (a 64 x 256 float32 output accumulator is 128
// registers alone) only in one-group CTAs.  Shared memory (smem_bytes)
// stays within the 232,448 bytes a block may use; the launch plan in
// kernels/flash_attention.py computes the same numbers.  A row that sees
// no key is written as exactly 0.
//
// A Policy provides (warp_full warp-uniform; visible and score per
// element):
//   int ntiles() const;              key tiles the CTA visits (tiles it
//                                    skips are never loaded)
//   int tile_start(int t) const;     first key of the t-th of them
//   bool warp_full(int j0, int slab, int i_lo, int i_hi) const;
//                                    is every (row, key) pair of the
//                                    16-row slab's rows i_lo..i_hi and
//                                    the tile visible (no mask needed)?
//   bool visible(int i, int j) const;
//   float score(float qk) const;     q . k -> the score in log2 units

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_wg {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;

// The K/V ring of a kernel: BK keys a tile (a multiple of 16, whole
// 1,024-byte swizzle atoms), STAGES tiles in flight.
template <int BK_, int STAGES_>
struct Ring {
  static constexpr int BK = BK_;
  static constexpr int STAGES = STAGES_;
};

// Dynamic shared memory of a CTA of NWG consumer warpgroups at padded
// head dim DP on ring R: 1,024 bytes of slack to align the tiles, the
// query tile, the K and V stages and the mbarriers (full and empty per
// stage, one for the query tile).
template <int DP, int NWG, class R>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + 64 * NWG * DP * 2 + 2 * R::STAGES * R::BK * DP * 2 +
         8 * (2 * R::STAGES + 1);
}

// Threads of a CTA: NWG consumer warpgroups and the producer, one warp
// with one consumer group, a whole warpgroup with two (so that each of the
// SM's four register files holds one producer warp, whose registers
// setmaxnreg hands to the two consumer warps beside it).
template <int NWG>
__host__ __device__ constexpr int threads() {
  return NWG == 2 ? 384 : 160;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers, named barriers and TMA ---------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait until the phase of the given parity has completed.  A wait that
// lasts ~2^34 cycles (several seconds) can only be a fault of the kernel:
// it traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on the mbarrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// --- wgmma ---------------------------------------------------------------------

// A shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).  K-major tiles (Q, K)
// take lbo 16 (unused) and sbo 1,024 (the next 8 rows); the MN-major V
// tile takes lbo = the next 64-dim panel and sbo 1,024 (the next 8 keys).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                        uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an asynchronous wgmma writes: keep the compiler from moving
// their reads and writes across the issue or the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, float32) = (scale_d ? d : 0) + A B, A (64 x 16) and B
// (16 x 64) bf16 in shared memory, both K-major (descriptors).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 48, float32) = (scale_d ? d : 0) + A B, as wgmma_ss_n64 with
// B 16 x 48.
__device__ __forceinline__ void wgmma_ss_n48(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, float32) += A B, A (64 x 16 bf16) in registers (each warp's
// 16 rows as the m16n8k16 A fragment), B (16 x 64 bf16) in shared
// memory, MN-major (transposed through the descriptor).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, float32) += A B, as wgmma_rs_n64 with B 16 x 128.
__device__ __forceinline__ void wgmma_rs_n128(float* d,
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One k-step of S (64 x BK) = Q K^T: BK = 64 or 48.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(BK == 64 || BK == 48, "key tile");
  if constexpr (BK == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n48(d, da, db, scale_d);
}

// Two neighbouring columns of P (the lower one in the low half) as a bf16
// pair, and the bf16 pair of what that left.  The first is P's top 16
// bits (truncation: one byte permute for the pair, no conversion), the
// second the remainder rounded (one packed conversion): P_hi + P_lo
// carries P to 2^-16 of itself.  Conversions share the special-function
// unit's quarter rate with exp2, which bounds the softmax.
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(p0), b1 = __float_as_uint(p1);
  hi = __byte_perm(b0, b1, 0x7632);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(p0 - __uint_as_float(b0 & 0xffff0000u),
                            p1 - __uint_as_float(b1 & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x on the special-function unit (flushing results below 2^-126 to 0,
// far under the float32 sums they join).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// O (64 x DP) += P_hi V + P_lo V over one key tile: V's stage at vb, in
// panels of BK keys x 64 dims; k-step kk takes keys 16 kk .. 16 kk + 15
// (2,048 bytes on).  Per k-step all P_hi products first, then the P_lo
// ones, so the two products into one accumulator are not back to back.
template <int DP, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&ph)[BK / 16][4],
                                         const uint32_t (&pl)[BK / 16][4],
                                         uint32_t vb) {
  constexpr uint32_t PANEL = BK * 128;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (DP == 64) {
      const uint64_t db = desc(vb + kk * 2048, PANEL, 1024);
      wgmma_rs_n64(o, ph[kk], db);
      wgmma_rs_n64(o, pl[kk], db);
    } else {      // 128 dims (two panels) an instruction
#pragma unroll
      for (int h = 0; h < DP / 128; ++h)
        wgmma_rs_n128(o + 64 * h, ph[kk],
                      desc(vb + 2 * h * PANEL + kk * 2048, PANEL, 1024));
#pragma unroll
      for (int h = 0; h < DP / 128; ++h)
        wgmma_rs_n128(o + 64 * h, pl[kk],
                      desc(vb + 2 * h * PANEL + kk * 2048, PANEL, 1024));
    }
  }
}

// Attend query rows q0 .. q0 + 64 NWG - 1 (of n_q; o points at row 0 of
// the head, row stride d) to the key tiles `pol` lists.  tq / tk / tv: 3-D
// tensor maps (head dim, rows, heads) of q, k and v with boxes of 64 dims
// by 64 NWG query rows or R::BK keys; qh / kh: the head coordinate.
// smem: smem_bytes<DP, NWG, R>() bytes of dynamic shared memory; the
// block has threads<NWG>() threads.  Called by every thread of the block, once, as
// the last thing the kernel does: the roles split here and never meet
// again.
template <int DP, int NWG, class R, class Policy>
__device__ __forceinline__ void attend(const Policy& pol, unsigned char* smem,
                                       const CUtensorMap* tq,
                                       const CUtensorMap* tk,
                                       const CUtensorMap* tv, int qh, int kh,
                                       bf16* __restrict__ o, int q0, int n_q,
                                       int d) {
  static_assert(DP == 64 || DP == 128 || DP == 256, "DP is 64, 128 or 256");
  constexpr int BK = R::BK, ST = R::STAGES;
  constexpr int PANELS = DP / 64;   // 128-byte column panels
  constexpr int BQ = 64 * NWG;
  constexpr int Q_PANEL = BQ * 128, KV_PANEL = BK * 128;   // bytes
  constexpr int KV_STAGE = PANELS * KV_PANEL;
  constexpr int NS = BK / 8;        // score column groups of 8 keys
  constexpr int KS = BK / 16;       // k-steps of P V
  constexpr int NO = DP / 2;        // output accumulator registers

  // tiles 1,024-aligned (the swizzle's atom), then the mbarriers
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + BQ * DP * 2;
  const uint32_t sv = sk + ST * KV_STAGE;
  const uint32_t bars = sv + ST * KV_STAGE;
  const uint32_t qbar = bars + 16 * ST;
  const uint32_t full = bars, empty = bars + 8 * ST;   // + 8 s: stage s
  const int n = pol.ntiles();

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * NWG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup (the producer warp is one of its own), warp-uniform as
  // the compiler sees it
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == NWG) {
    // ---- producer: one thread issues every load ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(qbar, BQ * DP * 2);
      for (int p = 0; p < PANELS; ++p)
        tma_load(sq + p * Q_PANEL, tq, p * 64, q0, qh, qbar);
      for (int t = 0; t < n; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(empty + 8 * s, ((t / ST) - 1) & 1);
        const int j0 = pol.tile_start(t);
        mbar_expect_tx(full + 8 * s, 2 * KV_STAGE);
        for (int p = 0; p < PANELS; ++p) {
          tma_load(sk + s * KV_STAGE + p * KV_PANEL, tk, p * 64, j0, kh,
                   full + 8 * s);
          tma_load(sv + s * KV_STAGE + p * KV_PANEL, tv, p * 64, j0, kh,
                   full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = role, tid = threadIdx.x % 128;
    const int w4 = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq4 = lane & 3;     // accumulator coordinates
    const int i_lo = q0 + wg * 64 + w4 * 16, i_hi = i_lo + 15;  // the warp's
    const int slab = wg * 4 + w4;

    float o_acc[NO], sacc[NS * 4];
    uint32_t ph[KS][4], pl[KS][4];
#pragma unroll
    for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) sacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // the warpgroup's Q rows: panel p at sq + p Q_PANEL + wg 8,192 bytes
    const uint32_t qa = sq + wg * 64 * 128;
    // S = Q K^T of the key tile in stage s (one commit group)
    auto issue_qk = [&](int s) {
      const uint32_t kb = sk + s * KV_STAGE;
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        // k-step kd: panel kd / 4, 32 bytes a step inside it
        const uint32_t off = (kd % 4) * 32;
        wgmma_qk<BK>(sacc, desc(qa + (kd / 4) * Q_PANEL + off, 16, 1024),
                     desc(kb + (kd / 4) * KV_PANEL + off, 16, 1024),
                     kd > 0);
      }
      wgmma_commit();
    };
    // the tile's scores to P (in sacc), alpha and the row sums' shares
    float alpha[2], rs[2];
    auto softmax = [&](int j0) {
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) sacc[i] = pol.score(sacc[i]);
      if (!pol.warp_full(j0, slab, i_lo, i_hi)) {    // warp-uniform
#pragma unroll
        for (int c = 0; c < NS; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i_lo + g + (e >> 1) * 8;
            const int j = j0 + c * 8 + tq4 * 2 + (e & 1);
            if (!pol.visible(i, j)) sacc[4 * c + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < NS; ++c)
          mx = fmaxf(mx, fmaxf(sacc[4 * c + 2 * r], sacc[4 * c + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2_ftz(m[r] - m_use);         // 0 while m was -inf
        m[r] = m_new;
        rs[r] = 0.f;
#pragma unroll
        for (int c = 0; c < NS; ++c) {
          const float p0 = exp2_ftz(sacc[4 * c + 2 * r] - m_use);
          const float p1 = exp2_ftz(sacc[4 * c + 2 * r + 1] - m_use);
          sacc[4 * c + 2 * r] = p0;
          sacc[4 * c + 2 * r + 1] = p1;
          rs[r] += p0 + p1;
        }
      }
    };
    // once P V of the tile before has landed: the row sums, O rescaled
    // (skipped once the row maxima settle and alpha is 1), P split
    auto fold = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < NO / 4; ++c) {
            o_acc[4 * c + 2 * r] *= alpha[r];
            o_acc[4 * c + 2 * r + 1] *= alpha[r];
          }
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        split2(sacc[8 * kk + 0], sacc[8 * kk + 1], ph[kk][0], pl[kk][0]);
        split2(sacc[8 * kk + 2], sacc[8 * kk + 3], ph[kk][1], pl[kk][1]);
        split2(sacc[8 * kk + 4], sacc[8 * kk + 5], ph[kk][2], pl[kk][2]);
        split2(sacc[8 * kk + 6], sacc[8 * kk + 7], ph[kk][3], pl[kk][3]);
      }
    };

    // Every tile the CTA visits goes through one straight pipeline with no
    // branch around a wgmma or its wait (ptxas serialises the wgmma of a
    // pipeline that branches): a tile none of the warpgroup's rows sees
    // is masked whole and adds exactly nothing.
    mbar_wait(qbar, 0);
    if (n > 0) {
      mbar_wait(full, 0);
      fence_regs(sacc);
      wgmma_fence();
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sacc);
      softmax(pol.tile_start(0));
      fold();
      for (int t = 1; t < n; ++t) {  // Q K^T of tile t beside P V of t - 1
        const int s = t % ST, s_prev = (t - 1) % ST;
        mbar_wait(full + 8 * s, (t / ST) & 1);
        fence_regs(sacc);
        fence_regs(o_acc);
        wgmma_fence();
        issue_qk(s);
        issue_pv<DP, BK>(o_acc, ph, pl, sv + s_prev * KV_STAGE);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sacc);
        softmax(pol.tile_start(t));
        wgmma_wait<0>();
        fence_regs(o_acc);
        mbar_arrive(empty + 8 * s_prev);
        fold();
      }
      const int s_last = (n - 1) % ST;
      fence_regs(o_acc);
      wgmma_fence();
      issue_pv<DP, BK>(o_acc, ph, pl, sv + s_last * KV_STAGE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      mbar_arrive(empty + 8 * s_last);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int i = i_lo + g + r * 8;
      if (i >= n_q) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;   // 0: no visible key
      bf16* row = o + (size_t)i * d;
#pragma unroll
      for (int c = 0; c < NO / 4; ++c) {
        const int col = c * 8 + tq4 * 2;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(o_acc[4 * c + 2 * r] * inv,
                                    o_acc[4 * c + 2 * r + 1] * inv);
      }
    }
  }
}

// --- host: tensor maps ----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda; null if the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return (EncodeTiled) nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return (EncodeTiled) nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiled)p
                                            : (EncodeTiled) nullptr;
  }();
  return fn;
}

// The 3-D map (d, rows, heads) of a contiguous bf16 tensor of `heads`
// matrices of rows x d, boxes of 64 dims x box_rows rows, 128-byte
// swizzle, out-of-bounds elements read as 0.  d % 8 == 0 and a 16-byte
// aligned base (TMA's stride and address rules).  False on failure.
inline bool encode_map(CUtensorMap* map, const void* base, int d, int rows,
                       int heads, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn || d % 8 || (uintptr_t)base % 16 || rows < 1 || heads < 1)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace attn_wg
