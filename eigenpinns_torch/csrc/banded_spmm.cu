// Banded SpMM W = A U, and its fused k x k Gram, for Hopper (sm_90a), on
// both band layouts of the package: the full-window band and the rolling
// band. The kernels read and multiply only the occupied 16 x 16
// sub-blocks of the band.
//
// Replaces the Pallas TPU kernels
//   band_spmm_kernel<..., kRolling = false, kGram = false>
//       <-  eigenpinns_tpu/sparse/banded.py::banded_spmm_pallas (K4)
//   band_spmm_kernel<..., kRolling = false, kGram = true>
//       <-  eigenpinns_tpu/sparse/banded.py::banded_spmm_gram_pallas (K5)
//   band_spmm_kernel<..., kRolling = true, kGram = false or true>
//       <-  eigenpinns_tpu/sparse/rolling.py::_rolling_kernel_call (K1,
//           public there as rolling_spmm_pallas / rolling_spmm_gram_pallas)
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
// U rows outside [0, n) read as zero (no padded copy of U is made).
//
// The Pallas kernels walked the tiles in order on a sequential grid: the
// full-window ones double-buffered each tile's whole U window into VMEM,
// the rolling one kept a ring buffer of U there from one grid step to the
// next and loaded only the 128 new rows; all multiplied the dense (128,
// B) slice on the MXU and carried the Gram in a VMEM-resident output
// across the grid. None of that has a counterpart here: CUDA blocks run
// in no order, so each block owns one (128-row tile, column block of 32
// or 64) pair and writes each output once, and the L2 cache does what the
// ring did. Inside the block a warp owns a 16-row stripe and walks the
// set bits of its byte of the tile's words (occupancy_spmm.cuh: the entry
// list, the per-warp stages, the register prefetch of the next sub-block
// and its U rows); no block-wide barrier in the loop, no atomics: W is
// the same bit for bit from run to run and between column blocks. Any k
// works, in masked column blocks (no padding of k to 128 lanes). Offsets
// into the band are 64-bit: the rolling band of a 300k-point cloud holds
// 1.15e9 elements, the full-window band of 1M rows at B = 1024 1.0e9.
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
// dense band is 4.6 GB in fp32, the occupied sub-blocks 0.2 GB).
// The kernel reads the occupied sub-blocks (tens of microseconds at
// 3.35 TB/s) and per sub-block 16 U rows of the column block's width
// from L2 and L1 (0.75 GB at k = 60, far more than U's 72 MB: the price
// of 16-row stripes). In fp32 a dense product of every occupied
// sub-block would be 256 FFMA per lane and 32 columns (94 M warp
// instructions at k = 60, ~0.1 ms over 132 SMs) fed by as many
// shared-memory loads as the FFMA pipe can take; but a sub-block holds
// ~12 nonzeros, so the warp votes on its 64 groups of 1 x 4 values and
// skips the zero ones (about five in six), loads and FFMA alike. What a
// nonzero group costs is then one broadcast load for 4 FFMA at 32
// columns per block and for 8 at 64, which is why k = 60 runs as one
// block of 64 columns (faster than two of 32 that read the band twice;
// chip_smoke.py times both). A bf16 band is multiplied by
// mma.sync.m16n8k16, one per sub-block and 8 columns, with both
// fragments loaded straight from global memory. A warp sees about 10
// sub-blocks per tile, the busiest stripe of a tile 1.3 times the mean,
// so latency (table, first sub-block) is hidden only by the other
// resident blocks: instruction slots and latency bound it at 300k rows,
// not bytes. The rolling band of the multigrid path's fused
// block-diagonal operator is tiny (4352 x 512: 34 tiles, one column
// block at k = 10), so there the grid fills a quarter of the 132 SMs and
// one stripe's dependent chain (table, list, then about 8 sub-blocks
// fetched one ahead) is the whole time, about 17 microseconds on an
// NVIDIA H100 80GB HBM3; a deeper prefetch is left open. chip_smoke.py
// measures every case against torch.sparse.mm of the same operator.
//
// Left open: the masked columns at k = 20 in fp32 (12 of a warp's 32
// lanes), sharing a U row between the stripes of a tile, and a compact
// copy of the occupied sub-blocks. TMA descriptors and wgmma do not fit
// this work: the sub-blocks are tiny, irregularly placed, and wgmma
// wants 64-row tiles. Blocks of 32 columns run three to an SM, except
// with the Gram on an fp32 band (80 registers a thread spill there and
// it is slower); blocks of 64 columns run two.
//
// Precision: an fp32 band is exact fp32 FFMA (the TPU's
// Precision.HIGHEST; the rolling band's 'high' mode, bf16 x 3 on the MXU,
// is the same exact product here). A bf16 band rounds U to bf16 before
// the product (tensor cores, fp32 accumulation), as the Pallas kernels
// do; the Gram is taken from the fp32 W and the unrounded U.

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
                 float* __restrict__ partial, int n, int B, int k, int n_cb) {
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
      band, (size_t)B, occupancy, t * P, (t + 1) * P, piece, U, n, k, col0,
      scratch[stripe], acc);
  occ::store_stripe<BandT, kCols>(W, row0 + stripe * kSub, n, k, col0, acc);

  if constexpr (kGram) {
    occ::tile_gram<BandT, kCols>(acc, U, row0, n, k, col0,
                                 reinterpret_cast<float*>(smem),
                                 partial + (size_t)t * k * k);
  }
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
                        float* partial, int n, int n_pad, int B, int k,
                        cudaStream_t s) {
  const int n_cb = (k + 32 * kCols - 1) / (32 * kCols);
  const dim3 grid((unsigned)(n_pad / kT) * n_cb);
  band_spmm_kernel<BandT, kRoundU, kRolling, kGram, kCols>
      <<<grid, kThreads, 0, s>>>(
          static_cast<const BandT*>(band), starts, pre,
          static_cast<const unsigned char*>(occupancy), U, W, partial, n, B,
          k, n_cb);
  return cudaGetLastError();
}

template <typename BandT, bool kRoundU, bool kRolling>
cudaError_t launch(const void* band, const int* starts, int pre,
                   const void* occupancy, const float* U, float* W,
                   float* partial, int n, int n_pad, int B, int k,
                   int col_block, cudaStream_t s) {
#define EPK_BAND_ARGS \
  band, starts, pre, occupancy, U, W, partial, n, n_pad, B, k, s
  if (partial != nullptr) {
    return col_block == 64
               ? launch_cols<BandT, kRoundU, kRolling, true, 2>(EPK_BAND_ARGS)
               : launch_cols<BandT, kRoundU, kRolling, true, 1>(EPK_BAND_ARGS);
  }
  return col_block == 64
             ? launch_cols<BandT, kRoundU, kRolling, false, 2>(EPK_BAND_ARGS)
             : launch_cols<BandT, kRoundU, kRolling, false, 1>(EPK_BAND_ARGS);
#undef EPK_BAND_ARGS
}

template <typename BandT, bool kRoundU>
cudaError_t launch_layout(const void* band, const int* starts, int pre,
                          const void* occupancy, const float* U, float* W,
                          float* partial, int n, int n_pad, int B, int k,
                          int col_block, cudaStream_t s) {
  return starts == nullptr
             ? launch<BandT, kRoundU, true>(band, starts, pre, occupancy, U,
                                            W, partial, n, n_pad, B, k,
                                            col_block, s)
             : launch<BandT, kRoundU, false>(band, starts, pre, occupancy, U,
                                             W, partial, n, n_pad, B, k,
                                             col_block, s);
}

}  // namespace

extern "C" {

// W = A U, and when partial and G are given also G = U^T A U. A is a
// full-window band (starts (n_pad / 128,) int32; pre is not read: K4, K5)
// or, with starts == nullptr, a rolling band whose windows start pre rows
// above their tile (K1). Shapes: band (n_pad, B) fp32 or bf16, occupancy
// (n_pad / 128, B / 128) int64, U and W (n, k) fp32, partial (n_pad /
// 128, k, k) and G (k, k) fp32; col_block is 32 or 64 output columns per
// block. The wrappers check types, shapes, contiguity, B % 128 == 0,
// pre % 128 == 0 and 16-byte alignment of the band. Returns
// cudaGetLastError() after the launches.
int epk_banded_spmm(const void* band, int band_is_bf16, const int* starts,
                  int pre, const void* occupancy, const float* U, float* W,
                  float* partial, float* G, int n, int n_pad, int B, int k,
                  int col_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      band_is_bf16
          ? launch_layout<__nv_bfloat16, true>(band, starts, pre, occupancy,
                                               U, W, partial, n, n_pad, B, k,
                                               col_block, s)
          : launch_layout<float, false>(band, starts, pre, occupancy, U, W,
                                        partial, n, n_pad, B, k, col_block,
                                        s);
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
