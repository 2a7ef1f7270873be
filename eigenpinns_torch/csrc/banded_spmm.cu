// Full-window banded SpMM W = A U, and its fused k x k Gram, for Hopper
// (sm_90a): kernels that read and multiply only the occupied 16 x 16
// sub-blocks of the band.
//
// Replaces the Pallas TPU kernels of eigenpinns_tpu/sparse/banded.py:
//   banded_spmm_kernel<..., kGram = false>  <-  banded_spmm_pallas (K4)
//   banded_spmm_kernel<..., kGram = true>   <-  banded_spmm_gram_pallas (K5)
//
// Layout (built on the host by BandedELL.from_scipy or the core of
// SplitBanded.from_scipy, unchanged): band is (n_pad, B) row-major, B a
// multiple of 128; row i of tile t = i / 128 multiplies the window
// U[starts[t] : starts[t] + B], so W[i, :] = sum_j band[i, j] U[starts[t]
// + j, :]. starts is clamped to n_pad - B, so a window may reach past n:
// those U rows read as zero (no padded copy of U is made). occupancy
// (n_pad / 128, B / 128) holds one 64-bit word per 128 x 128 piece of a
// tile's window: bit 8 i + j is set when the piece's 16 x 16 sub-block
// (i, j) holds a nonzero.
//
// The Pallas kernels walked the tiles in order on a sequential grid,
// double-buffering each tile's whole U window into VMEM, multiplying the
// dense (128, B) slice on the MXU and (K5) carrying the Gram in a
// VMEM-resident output across the grid. CUDA blocks run in no order, so
// each block owns one (128-row tile, column block of 32 or 64) pair and
// writes each output once. Inside it a warp owns a 16-row stripe and
// walks the set bits of its byte of the tile's words
// (occupancy_spmm.cuh: the entry list, the per-warp stages, the register
// prefetch of the next sub-block and its U rows); no block-wide barrier
// in the loop. Any k works, in masked column blocks (no padding of k to
// 128 lanes). Offsets into the band are 64-bit: at 1M rows and B = 1024
// the band holds 1.0e9 elements.
//
// K5's Gram: each block writes the partial U[tile]^T W[tile, cols] of its
// tile (from the fp32 W staged in shared memory and the tile's own,
// unrounded U rows) into partial[t] (n_tiles, k, k); a second kernel sums
// the partials in a fixed order, so G is the same bit for bit from run
// to run (no fp32 atomics). K5 always takes 32-column blocks, so that
// its W is K4's bit for bit and a block's W tile fits the stage.
//
// What bounds it. On a 300k-point cloud the cluster-ordered core
// (B = 1024, fp32, 2.16M nonzeros) has 15.3% of its sub-blocks occupied
// (184k sub-blocks, 12 nonzeros each), the Hilbert core (B = 512) 21.6%.
// The kernel reads 0.19 GB of the 1.229 GB band (56 microseconds at
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
// resident blocks. On an NVIDIA H100 80GB HBM3 (700 W) K4 on the cluster
// core at k = 60 takes about the time of torch.sparse.mm of the same
// core as fp32 CSR; K5's Gram epilogue (plain FFMA from shared memory, k
// rows of U per tile) adds about 0.1 ms to the product at k = 20 and
// 0.5 ms at k = 60.
//
// Left open: the masked columns at k = 20 in fp32 (12 of a warp's 32
// lanes), sharing a U row between the stripes of a tile, the Gram
// epilogue, and a compact copy of the occupied sub-blocks. TMA
// descriptors and wgmma do not fit this work: the sub-blocks are tiny,
// irregularly placed, and wgmma wants 64-row tiles. K4's blocks of 32
// columns run three to an SM, its blocks of 64 and K5's two (K5 was
// slower with three).
//
// Precision: an fp32 band is exact fp32 FFMA (the TPU's
// Precision.HIGHEST). A bf16 band rounds U to bf16 before the product
// (tensor cores, fp32 accumulation), as both Pallas kernels do.

#include "occupancy_spmm.cuh"

namespace {

using occ::kSub;
using occ::kT;
using occ::kThreads;

constexpr int kBN = 32;  // K5's column block

template <typename BandT, bool kRoundU, bool kGram, int kCols>
__global__ void __launch_bounds__(kThreads, kCols == 1 && !kGram ? 3 : 2)
banded_spmm_kernel(const BandT* __restrict__ band,
                   const int* __restrict__ starts,
                   const unsigned char* __restrict__ occupancy,
                   const float* __restrict__ U, float* __restrict__ W,
                   float* __restrict__ partial, int n, int B, int k,
                   int n_cb) {
  static_assert(!kGram || kCols == 1, "K5 takes 32-column blocks");
  __shared__ occ::WarpScratch scratch[kThreads / 32];

  const int tid = threadIdx.x;
  const int stripe = tid >> 5;
  const int t = blockIdx.x / n_cb;   // row tile; its column blocks are
  const int cb = blockIdx.x % n_cb;  // neighbours and share it through L2
  const int col0 = cb * 32 * kCols;
  const int row0 = t * kT;
  const int start = starts[t];
  const int P = B / kT;              // pieces (table words) per tile

  float acc[kSub * kCols];
#pragma unroll
  for (int i = 0; i < kSub * kCols; ++i) acc[i] = 0.f;

  // Piece q = t * P + i: columns [128 i, 128 i + 128) of the tile's window.
  auto piece = [&](int q, int& ub, long long& off) {
    const int i = q - t * P;
    ub = start + i * kT;
    off = (long long)(row0 + stripe * kSub) * B + (long long)i * kT;
  };
  occ::stripe_product<kRoundU, kCols>(
      band, (size_t)B, occupancy, t * P, (t + 1) * P, piece, U, n, k, col0,
      scratch[stripe], acc);
  occ::store_stripe<BandT, kCols>(W, row0 + stripe * kSub, n, k, col0, acc);

  if constexpr (kGram) {
    // Partial Gram of this tile and column block: U[rows, :]^T W[rows,
    // cols], with W staged in shared memory.
    __shared__ float Ws[kT][kBN + 1];
    using L = occ::Layout<BandT, kCols>;
    const int lane = tid & 31;
#pragma unroll
    for (int i = 0; i < kSub * kCols; ++i) {
      const int row = stripe * kSub + L::row(i, lane);
      Ws[row][L::col(i, lane)] = row0 + row < n ? acc[i] : 0.f;
    }
    __syncthreads();
    const int rows_here = min(kT, n - row0);
    float* out = partial + (size_t)t * k * k;
    // A warp shares one U column i (a broadcast load) and spans 32 columns.
    for (int e = tid; e < k * kBN; e += kThreads) {
      const int i = e / kBN, c = e % kBN;
      const int col = col0 + c;
      if (col >= k) continue;
      float s = 0.f;
      for (int r = 0; r < rows_here; ++r)
        s = fmaf(__ldg(U + (size_t)(row0 + r) * k + i), Ws[r][c], s);
      out[(size_t)i * k + col] = s;
    }
  }
}

// G[e] = sum over tiles t of partial[t, e]. Block (32 x 32): lane x owns
// element e, lane y sums tiles y, y + 32, ... in order; the 32 sums are
// then added in y order. Fixed order throughout: G is reproducible.
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ G, int n_tiles,
                                   int kk) {
  __shared__ float red[32][33];
  const int x = threadIdx.x, y = threadIdx.y;
  const int e = blockIdx.x * 32 + x;
  float s = 0.f;
  if (e < kk)
    for (int t = y; t < n_tiles; t += 32) s += partial[(size_t)t * kk + e];
  red[y][x] = s;
  __syncthreads();
  if (y == 0 && e < kk) {
    float tot = 0.f;
    for (int r = 0; r < 32; ++r) tot += red[r][x];
    G[e] = tot;
  }
}

template <typename BandT, bool kRoundU, bool kGram, int kCols>
cudaError_t launch_cols(const void* band, const int* starts,
                        const void* occupancy, const float* U, float* W,
                        float* partial, int n, int n_pad, int B, int k,
                        cudaStream_t s) {
  const int n_cb = (k + 32 * kCols - 1) / (32 * kCols);
  const dim3 grid((unsigned)(n_pad / kT) * n_cb);
  banded_spmm_kernel<BandT, kRoundU, kGram, kCols><<<grid, kThreads, 0, s>>>(
      static_cast<const BandT*>(band), starts,
      static_cast<const unsigned char*>(occupancy), U, W, partial, n, B, k,
      n_cb);
  return cudaGetLastError();
}

template <typename BandT, bool kRoundU>
cudaError_t launch(const void* band, const int* starts, const void* occupancy,
                   const float* U, float* W, float* partial, int n, int n_pad,
                   int B, int k, int col_block, cudaStream_t s) {
  if (partial != nullptr) {
    return launch_cols<BandT, kRoundU, true, 1>(band, starts, occupancy, U, W,
                                                partial, n, n_pad, B, k, s);
  }
  return col_block == 64
             ? launch_cols<BandT, kRoundU, false, 2>(
                   band, starts, occupancy, U, W, partial, n, n_pad, B, k, s)
             : launch_cols<BandT, kRoundU, false, 1>(
                   band, starts, occupancy, U, W, partial, n, n_pad, B, k, s);
}

}  // namespace

extern "C" {

// W = A U (K4), and when partial and G are given also G = U^T A U (K5).
// Shapes: band (n_pad, B) fp32 or bf16, starts (n_pad / 128,) int32,
// occupancy (n_pad / 128, B / 128) int64, U and W (n, k) fp32, partial
// (n_pad / 128, k, k) and G (k, k) fp32; col_block is 32 or 64 output
// columns per block (K5 always takes 32). The wrapper checks types,
// shapes, contiguity, B % 128 == 0 and 16-byte alignment of the band.
// Returns cudaGetLastError() after the launches.
int epk_banded_spmm(const void* band, int band_is_bf16, const int* starts,
                    const void* occupancy, const float* U, float* W,
                    float* partial, float* G, int n, int n_pad, int B, int k,
                    int col_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      band_is_bf16
          ? launch<__nv_bfloat16, true>(band, starts, occupancy, U, W,
                                        partial, n, n_pad, B, k, col_block, s)
          : launch<float, false>(band, starts, occupancy, U, W, partial, n,
                                 n_pad, B, k, col_block, s);
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  const int kk = k * k;
  gram_reduce_kernel<<<(kk + 31) / 32, dim3(32, 32), 0, s>>>(partial, G,
                                                             n_pad / kT, kk);
  return (int)cudaGetLastError();
}

const char* epk_banded_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
