// Banded SpMM W = A U, and its fused k x k Gram, for Hopper (sm_90a), on
// both band layouts of the package: the full-window band and the rolling
// band. The kernels read and multiply only the occupied 16 x 16
// sub-blocks of the band.
//
// Replaces the Pallas TPU kernels
//   band_spmm_kernel<..., kRolling = false, kGram = false>, and
//   band_staged_kernel<kGram = false> given starts
//       <-  eigenpinns_tpu/sparse/banded.py::banded_spmm_pallas (K4)
//   band_spmm_kernel<..., kRolling = false, kGram = true>, and
//   band_staged_kernel<kGram = true> given starts
//       <-  eigenpinns_tpu/sparse/banded.py::banded_spmm_gram_pallas (K5)
//   band_spmm_kernel<..., kRolling = true, kGram = false or true>, and
//   band_staged_kernel without starts
//       <-  eigenpinns_tpu/sparse/rolling.py::_rolling_kernel_call (K1,
//           public there as rolling_spmm_pallas / rolling_spmm_gram_pallas)
// The two kernels are two routes to the same sums (below); the wrapper
// picks one by shape (sparse/occupancy.py::band_grid).
//
// Layouts (built on the host, unchanged). Both bands are (n_pad, B)
// row-major, B a multiple of 128, with one 64-bit occupancy word per
// 128 x 128 piece of a 128-row tile's B columns: bit 8 i + j is set when
// the piece's 16 x 16 sub-block (i, j) holds a nonzero.
//   * Full window (BandedELL.from_scipy, the core of SplitBanded): row i
//     of tile t = i / 128 multiplies the window U[starts[t] : starts[t] +
//     B], so piece p of the tile multiplies U rows starts[t] + 128 p
//     onward. starts is clamped to n_pad - B, so a window may reach past n.
//   * Rolling (RollingBanded.from_scipy; starts == nullptr): B is the
//     window plus one tile, and row i's entry for column c sits at band
//     column (c + pre) mod B. B, pre and every tile's origin 128 t are
//     multiples of 128, so the rotation moves whole pieces: piece p of
//     tile t multiplies U rows 128 t + ((128 p - 128 t) mod B) - pre
//     onward, and a 16 x 16 sub-block of the rotated band is still 16
//     consecutive rows of U. A window may start before row 0 and end past
//     row n - 1. A rolling band is a full-window band whose starts are
//     implicit and whose pieces wrap; that is all K1 adds to K4, so it is
//     a third instantiation here and not a source of its own.
// W has n rows and U n_u: a full-window band may be a rectangular block
// (a shard's rows against its halo window, or that block's transpose),
// and U rows outside [0, n_u) read as zero (no padded copy of U is made).
// The Gram takes the tile's own U rows, so K5 is square only (n_u == n).
//
// The Pallas kernels walked the tiles in order on a sequential grid: the
// full-window ones double-buffered each tile's whole U window into VMEM,
// the rolling one kept a ring buffer of U there from one grid step to the
// next and loaded only the 128 new rows; all multiplied the dense (128,
// B) slice on the MXU and carried the Gram in a VMEM-resident output
// across the grid. None of that has a counterpart here: CUDA blocks run
// in no order, so every output is written once by the warp that owns its
// 16-row stripe, which walks the set bits of its byte of the tile's
// words in piece order, and no atomics: W is the same bit for bit from
// run to run, between grids and between the routes. The column-block
// walk (band_spmm_kernel; occupancy_spmm.cuh: the entry list, the
// per-warp stages, the register prefetch of the next sub-block and its
// U rows, no block-wide barrier) gives each block one (128-row tile,
// column block of 32 or 64) pair; it takes a bf16 band and any k, in
// masked column blocks. The staged route (band_staged_kernel, below)
// takes an fp32 band whose product fits one column block (k <= 64): it
// stages each piece's U groups once for all the stripes of a block, in
// shared memory, by asynchronous copies, and is what the ring did.
// Offsets into the band are 64-bit: the rolling band of a 300k-point
// cloud holds 1.15e9 elements, the full-window band of 1M rows at B =
// 1024 1.0e9.
//
// The Gram: each block writes the partial U[tile]^T W[tile, cols] of its
// tile into partial[t] (n_tiles, k, k) (occ::tile_gram: W and the tile's
// own, unrounded U rows staged in shared memory, each warp a block of
// Gram rows in registers); a second kernel sums the partials in a fixed
// order, so G is the same bit for bit from run to run (no fp32 atomics).
// With or without the Gram a block's W is the same bits. The epilogue is
// 2 n k^2 FLOP of exact FFMA and is bound by instruction slots (one
// shared-memory load for every two or three FFMA): on a 300k-point
// cloud it adds between a third (k = 20) and two thirds (k = 84) of the
// product's own time.
//
// What bounds it. On a 300k-point cloud the cluster-ordered core
// (B = 1024, fp32, 2.16M nonzeros) has 15.3% of its sub-blocks occupied
// (184k sub-blocks, 12 nonzeros each), the Hilbert core (B = 512) 21.6%,
// the RCM-ordered rolling band (B = 3840) 4.3% (192k sub-blocks: the
// dense band is 4.6 GB in fp32, the occupied sub-blocks 0.2 GB). Both
// routes read the occupied sub-blocks, 1 KB each in fp32 for ~12
// nonzeros (0.63 GB at 1M rows, 0.19 ms at 3.35 TB/s), and a sub-block
// holds so few nonzeros that the warp votes on its 64 groups of 1 x 4
// values and skips the zero ones (about five in six), loads and FFMA
// alike: a nonzero group costs one broadcast load for 4 FFMA at 32
// columns per block and for 8 at 64, which is why k = 60 runs as one
// block of 64 columns. The walk fetches 16 U rows for every occupied
// sub-block and stripe (2.36 GB at 1M rows and k = 60, from L2); the
// staged route fetches each group once a block (0.94 GB; 2.52 sub-blocks
// a group), but that traffic was never the bound. Its first form, one
// block a tile, took about the walk's time; what bound it was the
// stripes' instructions (64 unrolled zero-group tests an entry, now a
// test a row first) and each block's start (table, list, first copies),
// which a grid of the blocks the card holds, each walking many units,
// overlaps with the previous unit's work. On the card (NVIDIA H100 80GB
// HBM3, 700 W, chip_smoke.py): the 1M cluster core at k = 60 0.5341 ms
// (the walk 0.7493, torch.sparse.mm 0.6562), 300k 0.1643 (0.2347,
// 0.2270). What is left is the sub-block reads and the barriers:
// band_stage_variants.py takes the U copies out (0.4629 of 0.5350 ms at
// 1M, k = 60), the FFMA out (0.5073), both (0.3799), or the resident
// grid (one block a unit, 0.5726). A bf16 band is multiplied by
// mma.sync.m16n8k16 on the walk, one per sub-block and 8 columns, with
// both fragments loaded straight from global memory; there instruction
// slots and latency bound it, not bytes. The rolling band of the
// multigrid path's fused block-diagonal operator is tiny (4352 x 512:
// 34 tiles at k = 10), so the staged route runs it on 136 blocks of 2
// stripes and keeps up to 16 sub-blocks of a stripe in flight (a stripe
// lists at most 12 there): 0.0133 ms, where the walk's one stripe chain
// of ~8 dependent fetches takes 0.0182 and torch.sparse.mm 0.0163.
// chip_smoke.py measures every case against torch.sparse.mm of the same
// operator and prints each launch's route, grid and U bytes.
//
// Left open: a compact copy of the occupied sub-blocks (each read of 1
// KB serves ~48 B of nonzeros, and those reads now bound the staged
// route), the masked columns at k = 20 in fp32 (12 of a warp's 32
// lanes), the staged route past 64 columns (k = 84 and 128 take the
// walk), and K5's epilogue, which now sets its pace (K5 takes about
// twice K4 on the cluster cores at k = 60). TMA descriptors and wgmma do
// not fit this work: the sub-blocks are tiny, irregularly placed, and
// wgmma wants 64-row tiles. On the walk, blocks of 32 columns run three
// to an SM, except with the Gram on an fp32 band (80 registers a thread
// spill there and it is slower); blocks of 64 columns run two. The
// staged route aims at two blocks an SM (112 KB of shared memory each,
// about 112 registers a thread).
//
// Precision: an fp32 band is exact fp32 FFMA (the TPU's
// Precision.HIGHEST; the rolling band's 'high' mode, bf16 x 3 on the MXU,
// is the same exact product here). A bf16 band rounds U to bf16 before
// the product (tensor cores, fp32 accumulation), as the Pallas kernels
// do; the Gram is taken from the fp32 W and the unrounded U.

#include <cstdint>
#include <type_traits>

#include "occupancy_spmm.cuh"

namespace {

using occ::kSub;
using occ::kT;
using occ::kThreads;

template <typename BandT, bool kRoundU, bool kRolling, bool kGram, int kCols>
__global__ void __launch_bounds__(
    kThreads, kCols == 1 && (!kGram || kRoundU) ? 3 : 2)
band_spmm_kernel(const BandT* __restrict__ band,
                 const int* __restrict__ starts, int pre,
                 const unsigned char* __restrict__ occupancy,
                 const float* __restrict__ U, float* __restrict__ W,
                 float* __restrict__ partial, int n, int n_u, int B, int k,
                 int n_cb) {
  // The warps' scratch; the Gram's stages follow the product in the same
  // memory.
  constexpr size_t kScratch = sizeof(occ::WarpScratch) * (kThreads / 32);
  constexpr size_t kStages = sizeof(float) * occ::kGramFloats<kCols>;
  __shared__ __align__(16) unsigned char
      smem[kGram && kStages > kScratch ? kStages : kScratch];
  occ::WarpScratch* scratch = reinterpret_cast<occ::WarpScratch*>(smem);

  const int stripe = threadIdx.x >> 5;
  const int t = blockIdx.x / n_cb;   // row tile; its column blocks are
  const int cb = blockIdx.x % n_cb;  // neighbours and share it through L2
  const int col0 = cb * 32 * kCols;
  const int row0 = t * kT;
  const int P = B / kT;              // pieces (table words) per tile
  // The U row above band column 0 of the tile, and (rolling) the column
  // at which the window wraps to it.
  const int start = kRolling ? row0 - pre : starts[t];
  const int shift = kRolling ? row0 % B : 0;

  float acc[kSub * kCols];
#pragma unroll
  for (int i = 0; i < kSub * kCols; ++i) acc[i] = 0.f;

  // Piece q = t * P + i: columns [128 i, 128 i + 128) of the tile's band.
  auto piece = [&](int q, int& ub, long long& off) {
    const int c = (q - t * P) * kT;
    ub = start + (c >= shift ? c - shift : c - shift + B);
    off = (long long)(row0 + stripe * kSub) * B + c;
  };
  occ::stripe_product<kRoundU, kCols>(
      band, (size_t)B, occupancy, t * P, (t + 1) * P, piece, U, n_u, k, col0,
      scratch[stripe], acc);
  occ::store_stripe<BandT, kCols>(W, row0 + stripe * kSub, n, k, col0, acc);

  if constexpr (kGram) {
    occ::tile_gram<BandT, kCols>(acc, U, row0, n, k, col0,
                                 reinterpret_cast<float*>(smem),
                                 partial + (size_t)t * k * k);
  }
}

// ---- the staged route (fp32 band, one column block: k <= 32 kCols) ----
//
// A block owns every output column of kWarps of a tile's 8 stripes (8,
// or 4 and 2 on a small operator) at a time, plus one copy warp, and
// walks such units in turn (blockIdx.x, blockIdx.x + gridDim.x, ...: the
// grid is the blocks the card holds at once, one a unit with the Gram).
// For each 128-column piece of a unit's window whose union byte (the OR
// of its stripe bytes) is not 0 the copy warp stages the union's 16-row
// U groups, each 16 k contiguous floats of the row-major U, in a ring of
// `depth` piece slots in shared memory: a whole group whose start is
// 16-byte aligned by one cp.async.bulk of 64 k bytes issued by lane 0,
// any other (odd k, an unaligned window start, rows outside [0, n_u),
// which read as zero) by the 32 lanes' 4-byte cp.async with a source
// size of 0 for the dead rows. Both complete on the slot's "full"
// mbarrier (lane 0's expect_tx arrival and the lanes' cp.async
// arrivals). The stripe warps take the staged pieces in the same order,
// wait for "full", read their groups from the slot and arrive on its
// "empty" mbarrier, which the copy warp waits on before it fills the
// slot again; it runs ahead into the next unit as far as the ring
// allows. A stripe warp's own sub-blocks go through a per-warp ring of
// kSubDepth stages by 16-byte cp.async, that many entries ahead of the
// one multiplied. The sums are the walk's: entries in piece order, then
// sub-block column, then the zero groups skipped by ballot (a row's four
// groups tested at once first), so W has the walk's bits.

constexpr int kMaxDepth = 8;        // piece slots of the U ring, at most
constexpr int kBarBytes = 2 * kMaxDepth * 8;  // full and empty mbarriers
// Shared memory a block aims at: two blocks fill an SM's 228 KB.
constexpr int kBlockSmem = 112 * 1024;

// Sub-block stages of a stripe warp: on 8-warp blocks 4 at 32 columns
// and 2 at 64 (where the shared memory buys a third U slot instead); 8
// and 16 on the small grid's 4- and 2-warp blocks, enough for every
// entry of a multigrid stripe.
template <int kWarps, int kCols>
constexpr int kSubDepth = kWarps == 8 ? (kCols == 1 ? 4 : 2) : 32 / kWarps;

// Piece slots of the U ring for width k and P pieces a tile: as many as
// fit in kBlockSmem beside the barriers and `scratch` bytes, at least two
// (one copied while one is multiplied) and no more than a tile's pieces.
inline int stage_depth(int k, int P, int scratch) {
  int depth = (kBlockSmem - kBarBytes - scratch) / (8 * kSub * k * 4);
  depth = depth < P ? depth : P;
  depth = depth < kMaxDepth ? depth : kMaxDepth;
  return depth > 2 ? depth : 2;
}

template <int kDepth>
struct __align__(16) StagedScratch {
  float a[kDepth][kSub][kSub];
  unsigned short list[occ::kBatch * 8];
};

template <int kWarps, int kCols>
constexpr size_t staged_scratch_bytes() {
  return sizeof(StagedScratch<kSubDepth<kWarps, kCols>>) * kWarps;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies are done
// (the barrier's count includes the arrival).
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4 bytes, or 4 zero bytes when !live (source size 0; src is not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// Registers: the same budget a thread for every kWarps (about 112).
template <int kWarps>
constexpr int kStagedMinBlocks = kWarps == 8 ? 2 : kWarps == 4 ? 3 : 6;

template <bool kGram, int kCols, int kWarps>
__global__ void __launch_bounds__(32 * (kWarps + 1), kStagedMinBlocks<kWarps>)
band_staged_kernel(const float* __restrict__ band,
                   const int* __restrict__ starts, int pre,
                   const unsigned long long* __restrict__ occupancy,
                   const float* __restrict__ U, float* __restrict__ W,
                   float* __restrict__ partial, int n, int n_u, int B, int k,
                   int depth, int n_units) {
  static_assert(!kGram || kWarps == 8, "the Gram takes whole tiles");
  constexpr int kDepth = kSubDepth<kWarps, kCols>;
  constexpr int kParts = 8 / kWarps;   // blocks of a tile
  using Scratch = StagedScratch<kDepth>;
  using L = occ::PairLayout<kCols>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + kMaxDepth;
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  const int group_floats = kSub * k;
  const int slot_floats = 8 * group_floats;
  Scratch* scratch = reinterpret_cast<Scratch*>(ring + depth * slot_floats);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = B / kT;

  if (threadIdx.x == 0) {
    for (int i = 0; i < depth; ++i) {
      mbar_init(&full[i], 33);     // lane 0's expect_tx + 32 cp.async lanes
      mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[kSub * kCols];
  int s = 0;  // staged pieces so far: slot s % depth, use s / depth
  // The block's units (a tile's kWarps stripes) in turn: the copy warp
  // runs ahead into the next unit's pieces as far as the ring allows.
  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const int t = unit / kParts;
    const int stripe0 = (unit % kParts) * kWarps;
    const int row0 = t * kT;
    const int q0 = t * P, q1 = q0 + P;
    // The U row above band column 0 of the tile, and (rolling: no
    // starts) the column at which the window wraps to it.
    const int start = starts == nullptr ? row0 - pre : starts[t];
    const int shift = starts == nullptr ? row0 % B : 0;

    // Piece q's union byte (bit j: U group j is staged) and, for a
    // stripe warp, its own byte.
    auto bytes = [&](int q, unsigned& own) {
      const unsigned long long w = occupancy[q] >> (8 * stripe0);
      unsigned u = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) u |= (unsigned)(w >> (8 * i)) & 0xffu;
      own = (unsigned)(w >> (8 * (warp < kWarps ? warp : 0))) & 0xffu;
      return u;
    };

#pragma unroll
    for (int i = 0; i < kSub * kCols; ++i) acc[i] = 0.f;

    if (warp == kWarps) {
      // ---- the copy warp ----
      for (int qb = q0; qb < q1; qb += occ::kBatch) {
        const int q = qb + lane;
        unsigned u = 0, own;
        int ub = 0;
        if (q < q1) {
          u = bytes(q, own);
          const int c = (q - q0) * kT;
          ub = start + (c >= shift ? c - shift : c - shift + B);
        }
        for (unsigned m = __ballot_sync(occ::kFull, u != 0); m;
             m &= m - 1, ++s) {
          const int pl = __ffs(m) - 1;
          const unsigned groups = __shfl_sync(occ::kFull, u, pl);
          const int urow = __shfl_sync(occ::kFull, ub, pl);
          const int slot = s % depth, use = s / depth;
          if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
          float* dst = ring + slot * slot_floats;
          unsigned bulk = 0;  // whole groups at a 16-byte aligned start
          for (unsigned b = groups; b; b &= b - 1) {
            const int r = urow + (__ffs(b) - 1) * kSub;
            if (r >= 0 && r + kSub <= n_u
                && (reinterpret_cast<uintptr_t>(U + (long long)r * k) & 15)
                       == 0)
              bulk |= b & (~b + 1);
          }
          if (lane == 0) {
            mbar_arrive_expect_tx(
                &full[slot], (unsigned)(__popc(bulk) * group_floats * 4));
            for (unsigned b = bulk; b; b &= b - 1) {
              const int j = __ffs(b) - 1;
              bulk_copy(dst + j * group_floats,
                        U + (long long)(urow + j * kSub) * k,
                        (unsigned)(group_floats * 4), &full[slot]);
            }
          }
          for (unsigned b = groups & ~bulk; b; b &= b - 1) {
            const int j = __ffs(b) - 1;
            float* d = dst + j * group_floats;
            for (int e = lane; e < group_floats; e += 32) {
              const int r = urow + j * kSub + e / k;
              const bool live = (unsigned)r < (unsigned)n_u;
              cp_async4(d + e, live ? U + (long long)r * k + e % k : U,
                        live);
            }
          }
          cp_async_arrive(&full[slot]);
        }
      }
    } else {
      // ---- a stripe warp ----
      const int stripe = stripe0 + warp;
      Scratch& ws = scratch[warp];
      for (int qb = q0; qb < q1; qb += occ::kBatch) {
        const int q = qb + lane;
        unsigned u = 0, bits = 0;
        long long off = 0;
        if (q < q1) {
          u = bytes(q, bits);
          off = (long long)(row0 + stripe * kSub) * B + (q - q0) * kT;
        }
        const unsigned staged = __ballot_sync(occ::kFull, u != 0);
        // Exclusive scan of the lanes' sub-block counts -> list positions.
        const int cnt = __popc(bits);
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int up = __shfl_up_sync(occ::kFull, incl, d);
          if (lane >= d) incl += up;
        }
        int pos = incl - cnt;
        for (unsigned b = bits; b; b &= b - 1)
          ws.list[pos++] = (unsigned short)((lane << 3) | (__ffs(b) - 1));
        __syncwarp();
        const int total = __shfl_sync(occ::kFull, incl, 31);

        // Entry e's sub-block into stage e % kSubDepth (one commit group
        // an entry, empty past the list).
        auto issue = [&](int e) {
          if (e < total) {
            const int id = ws.list[e];
            const long long off_e = __shfl_sync(occ::kFull, off, id >> 3);
            const float* p = band + off_e + (id & 7) * kSub
                             + (size_t)(lane >> 2) * B + (lane & 3) * 4;
            float(*a)[kSub] = ws.a[e % kDepth];
            cp_async16(&a[lane >> 2][(lane & 3) * 4], p);
            cp_async16(&a[8 + (lane >> 2)][(lane & 3) * 4],
                       p + 8 * (size_t)B);
          }
          cp_async_commit();
        };
#pragma unroll
        for (int e = 0; e < kDepth - 1; ++e) issue(e);

        int e = 0;
        for (unsigned m = staged; m; m &= m - 1, ++s) {
          const int pl = __ffs(m) - 1;
          const int slot = s % depth;
          mbar_wait(&full[slot], (s / depth) & 1);
          const float* us = ring + slot * slot_floats;
          for (; e < total && (ws.list[e] >> 3) == pl; ++e) {
            issue(e + kDepth - 1);
            cp_async_wait<kDepth - 1>();
            __syncwarp();
            const float(*a)[kSub] = ws.a[e % kDepth];
            const float4 v0 = *reinterpret_cast<const float4*>(
                &a[lane >> 2][(lane & 3) * 4]);
            const float4 v1 = *reinterpret_cast<const float4*>(
                &a[8 + (lane >> 2)][(lane & 3) * 4]);
            // Bit 4 r + q of nz: the group of row r, columns 4 q .. 4 q +
            // 3 of the sub-block holds a nonzero (the walk's vote).
            const unsigned lo = __ballot_sync(
                occ::kFull, v0.x != 0.f || v0.y != 0.f || v0.z != 0.f
                                || v0.w != 0.f);
            const unsigned hi = __ballot_sync(
                occ::kFull, v1.x != 0.f || v1.y != 0.f || v1.z != 0.f
                                || v1.w != 0.f);
            const unsigned long long nz =
                ((unsigned long long)hi << 32) | lo;
            // The group's U rows, this lane's adjacent columns: one 8-byte
            // load a row at 64 columns and even k. A column past k reads
            // whatever follows in shared memory: its sums are never
            // stored.
            const float* ug =
                us + (ws.list[e] & 7) * group_floats + kCols * lane;
            float uv[kSub][kCols];
            if (kCols == 2 && !(k & 1)) {
#pragma unroll
              for (int kk = 0; kk < kSub; ++kk) {
                const float2 v =
                    *reinterpret_cast<const float2*>(ug + kk * k);
                uv[kk][0] = v.x;
                uv[kk][kCols - 1] = v.y;
              }
            } else {
#pragma unroll
              for (int kk = 0; kk < kSub; ++kk) {
#pragma unroll
                for (int c = 0; c < kCols; ++c) uv[kk][c] = ug[kk * k + c];
              }
            }
#pragma unroll
            for (int r = 0; r < kSub; ++r) {
              const unsigned row_nz = (unsigned)(nz >> (4 * r)) & 15u;
              if (!row_nz) continue;                        // warp-uniform
#pragma unroll
              for (int q4 = 0; q4 < kSub / 4; ++q4) {
                if (!((row_nz >> q4) & 1)) continue;        // warp-uniform
                const float4 av =
                    *reinterpret_cast<const float4*>(&a[r][4 * q4]);
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                  float sum = acc[kCols * r + c];
                  sum = fmaf(av.x, uv[4 * q4][c], sum);
                  sum = fmaf(av.y, uv[4 * q4 + 1][c], sum);
                  sum = fmaf(av.z, uv[4 * q4 + 2][c], sum);
                  sum = fmaf(av.w, uv[4 * q4 + 3][c], sum);
                  acc[kCols * r + c] = sum;
                }
              }
            }
            __syncwarp();  // the stage is refilled by the next issue
          }
          __syncwarp();    // every lane is done with the slot
          if (lane == 0) mbar_arrive(&empty[slot]);
        }
        __syncwarp();      // the list is reused by the next batch
      }
      occ::store_stripe<float, kCols, L>(W, row0 + stripe * kSub, n, k, 0,
                                         acc);
    }

    if constexpr (kGram) {  // one unit a block: the grid covers the tiles
      occ::tile_gram<float, kCols, 32 * (kWarps + 1), L>(
          acc, U, row0, n, k, 0, ring, partial + (size_t)t * k * k);
    }
  }
}

// Dynamic shared memory of a staged launch.
template <bool kGram, int kCols, int kWarps>
size_t staged_smem_bytes(int k, int depth) {
  const size_t need = kBarBytes + (size_t)depth * 8 * kSub * k * 4
                      + staged_scratch_bytes<kWarps, kCols>();
  const size_t gram = kGram ? kBarBytes + sizeof(float)
                                  * occ::kGramFloats<kCols> : 0;
  return need > gram ? need : gram;
}

// G[e] = sum over tiles t of partial[t, e]. Block (8 x 128): lane x owns
// element e, lane y sums tiles y, y + 128, ... in order; the 128 sums are
// then added in y order. Fixed order throughout: G is reproducible.
constexpr int kRedX = 8, kRedY = 128;

__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ G, int n_tiles,
                                   int kk) {
  __shared__ float red[kRedY][kRedX + 1];
  const int x = threadIdx.x, y = threadIdx.y;
  const int e = blockIdx.x * kRedX + x;
  float s = 0.f;
  if (e < kk)
    for (int t = y; t < n_tiles; t += kRedY) s += partial[(size_t)t * kk + e];
  red[y][x] = s;
  __syncthreads();
  if (y == 0 && e < kk) {
    float tot = 0.f;
    for (int r = 0; r < kRedY; ++r) tot += red[r][x];
    G[e] = tot;
  }
}

template <typename BandT, bool kRoundU, bool kRolling, bool kGram, int kCols>
cudaError_t launch_cols(const void* band, const int* starts, int pre,
                        const void* occupancy, const float* U, float* W,
                        float* partial, int n, int n_u, int n_pad, int B,
                        int k, cudaStream_t s) {
  const int n_cb = (k + 32 * kCols - 1) / (32 * kCols);
  const dim3 grid((unsigned)(n_pad / kT) * n_cb);
  band_spmm_kernel<BandT, kRoundU, kRolling, kGram, kCols>
      <<<grid, kThreads, 0, s>>>(
          static_cast<const BandT*>(band), starts, pre,
          static_cast<const unsigned char*>(occupancy), U, W, partial, n, n_u,
          B, k, n_cb);
  return cudaGetLastError();
}

template <bool kGram, int kCols, int kWarps>
cudaError_t launch_staged(const void* band, const int* starts, int pre,
                          const void* occupancy, const float* U, float* W,
                          float* partial, int n, int n_u, int n_pad, int B,
                          int k, cudaStream_t s) {
  const int depth =
      stage_depth(k, B / kT, (int)staged_scratch_bytes<kWarps, kCols>());
  const size_t bytes = staged_smem_bytes<kGram, kCols, kWarps>(k, depth);
  auto kernel = band_staged_kernel<kGram, kCols, kWarps>;
  // Above 48 KB a kernel needs the attribute, once per instantiation.
  static size_t granted = 48 * 1024;
  if (bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    granted = bytes;
  }
  // Without the Gram the grid is the blocks the card holds at once, each
  // walking units blockIdx.x, blockIdx.x + gridDim.x, ...; with it, one
  // block a unit (the epilogue takes the whole block).
  const int n_units = (n_pad / kT) * (8 / kWarps);
  int grid = n_units;
  if (!kGram) {
    static int resident = 0;   // blocks the card holds at `resident_bytes`
    static size_t resident_bytes = 0;
    if (resident == 0 || resident_bytes != bytes) {
      int device = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, 32 * (kWarps + 1), bytes);
      if (err != cudaSuccess) return err;
      resident = sms * (per_sm > 0 ? per_sm : 1);
      resident_bytes = bytes;
    }
    grid = n_units < resident ? n_units : resident;
  }
  kernel<<<(unsigned)grid, 32 * (kWarps + 1), bytes, s>>>(
      static_cast<const float*>(band), starts, pre,
      static_cast<const unsigned long long*>(occupancy), U, W, partial, n,
      n_u, B, k, depth, n_units);
  return cudaGetLastError();
}

template <bool kGram, int kCols>
cudaError_t launch_staged_warps(int warps, const void* band, const int* starts,
                                int pre, const void* occupancy,
                                const float* U, float* W, float* partial,
                                int n, int n_u, int n_pad, int B, int k,
                                cudaStream_t s) {
#define EPK_STAGED_ARGS \
  band, starts, pre, occupancy, U, W, partial, n, n_u, n_pad, B, k, s
  if constexpr (kGram) {
    return launch_staged<true, kCols, 8>(EPK_STAGED_ARGS);
  } else {
    switch (warps) {
      case 2:
        return launch_staged<false, kCols, 2>(EPK_STAGED_ARGS);
      case 4:
        return launch_staged<false, kCols, 4>(EPK_STAGED_ARGS);
      default:
        return launch_staged<false, kCols, 8>(EPK_STAGED_ARGS);
    }
  }
#undef EPK_STAGED_ARGS
}

template <typename BandT, bool kRoundU, bool kRolling, bool kGram, int kCols>
cudaError_t launch_route(int warps, int staged, const void* band,
                         const int* starts, int pre, const void* occupancy,
                         const float* U, float* W, float* partial, int n,
                         int n_u, int n_pad, int B, int k, cudaStream_t s) {
#define EPK_BAND_ARGS \
  band, starts, pre, occupancy, U, W, partial, n, n_u, n_pad, B, k, s
  if constexpr (std::is_same<BandT, float>::value) {
    if (staged)
      return launch_staged_warps<kGram, kCols>(warps, EPK_BAND_ARGS);
  }
  return launch_cols<BandT, kRoundU, kRolling, kGram, kCols>(EPK_BAND_ARGS);
#undef EPK_BAND_ARGS
}

template <typename BandT, bool kRoundU, bool kRolling>
cudaError_t launch(const void* band, const int* starts, int pre,
                   const void* occupancy, const float* U, float* W,
                   float* partial, int n, int n_u, int n_pad, int B, int k,
                   int col_block, int warps, int staged, cudaStream_t s) {
#define EPK_BAND_ARGS                                                     \
  warps, staged, band, starts, pre, occupancy, U, W, partial, n, n_u, n_pad, \
      B, k, s
  if (partial != nullptr) {
    return col_block == 64
        ? launch_route<BandT, kRoundU, kRolling, true, 2>(EPK_BAND_ARGS)
        : launch_route<BandT, kRoundU, kRolling, true, 1>(EPK_BAND_ARGS);
  }
  return col_block == 64
      ? launch_route<BandT, kRoundU, kRolling, false, 2>(EPK_BAND_ARGS)
      : launch_route<BandT, kRoundU, kRolling, false, 1>(EPK_BAND_ARGS);
#undef EPK_BAND_ARGS
}

template <typename BandT, bool kRoundU>
cudaError_t launch_layout(const void* band, const int* starts, int pre,
                          const void* occupancy, const float* U, float* W,
                          float* partial, int n, int n_u, int n_pad, int B,
                          int k, int col_block, int warps, int staged,
                          cudaStream_t s) {
  return starts == nullptr
             ? launch<BandT, kRoundU, true>(band, starts, pre, occupancy, U,
                                            W, partial, n, n_u, n_pad, B, k,
                                            col_block, warps, staged, s)
             : launch<BandT, kRoundU, false>(band, starts, pre, occupancy, U,
                                             W, partial, n, n_u, n_pad, B, k,
                                             col_block, warps, staged, s);
}

}  // namespace

extern "C" {

// W = A U, and when partial and G are given also G = U^T A U. A is a
// full-window band (starts (n_pad / 128,) int32; pre is not read: K4, K5)
// or, with starts == nullptr, a rolling band whose windows start pre rows
// above their tile (K1). Shapes: band (n_pad, B) fp32 or bf16, occupancy
// (n_pad / 128, B / 128) int64, U (n_u, k) and W (n, k) fp32, partial
// (n_pad / 128, k, k) and G (k, k) fp32; col_block is 32 or 64 output
// columns per block. n_u == n for the rolling band and the Gram; a
// full-window block may be rectangular. `staged` takes the staged route
// (an fp32 band, k <= col_block) on blocks of `warps` stripes (8, 4 or
// 2; 8 with the Gram); otherwise the walk, 8 stripes a block. The
// wrappers check types, shapes, contiguity, B % 128 == 0, pre % 128 == 0
// and 16-byte alignment of the band. Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for a route the band cannot take).
int epk_banded_spmm(const void* band, int band_is_bf16, const int* starts,
                    int pre, const void* occupancy, const float* U, float* W,
                    float* partial, float* G, int n, int n_u, int n_pad,
                    int B, int k, int col_block, int warps, int staged,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged && (band_is_bf16 || k > col_block
                 || (warps != 8 && warps != 4 && warps != 2)
                 || (partial != nullptr && warps != 8)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      band_is_bf16
          ? launch_layout<__nv_bfloat16, true>(band, starts, pre, occupancy,
                                               U, W, partial, n, n_u, n_pad, B,
                                               k, col_block, warps, staged, s)
          : launch_layout<float, false>(band, starts, pre, occupancy, U, W,
                                        partial, n, n_u, n_pad, B, k,
                                        col_block, warps, staged, s);
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  const int kk = k * k;
  gram_reduce_kernel<<<(kk + kRedX - 1) / kRedX, dim3(kRedX, kRedY), 0, s>>>(
      partial, G, n_pad / kT, kk);
  return (int)cudaGetLastError();
}

const char* epk_banded_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
