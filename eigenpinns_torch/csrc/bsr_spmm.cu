// Strip-BSR SpMM W = A U for Hopper, sm_90a: a grouped and a burst kernel
// that read and multiply only the occupied 16 x 16 sub-blocks of the
// tiles, and the two routes over the operator's nonzeros that both take
// on fp32 strips: the narrow path at k <= 8 and the row-wise route above
// it (both in nonzero_spmm.cuh, shared with the band kernels).
//
// Replaces the Pallas TPU kernels of eigenpinns_tpu/sparse/bsr.py:
//   bsr_spmm_kernel<..., kGrouped = true>   <-  bsr_spmm_pallas_grouped
//       (column tiles through the group tables)
//   bsr_spmm_kernel<..., kGrouped = false>  <-  bsr_spmm_pallas
//       (column tiles through cid)
//   nz::narrow_kernel, nz::rows_kernel      <-  either, on fp32 strips
//       (the narrow path at k <= 8, the row-wise route from k = 9 to
//       bsr.ROWS_MAX_K), and nz::rows_kernel on bf16 strips over their
//       bf16 table through nz::round_kernel's bf16 copy of U (k = 8 to
//       128, bsr.BF16_ROWS_K: the training loss's products at k = 20);
//       the wrapper counts the launch as the kernel's it was called for
//
// Layout (built on the host by BSRTile.from_scipy, unchanged): data is
// (S*128, C*128) row-major; chunk s holds C tiles of 128 x 128 of row
// tile rowid[s], side by side. The chunks of row tile r are the
// contiguous range [chunk_start[r], chunk_start[r+1]) because rowid is
// nondecreasing. Slot j of chunk s multiplies U rows [128 c, 128 c + 128)
// with c = gcid[gid[s] * C_u + lcid[s * C + j]] (grouped) or
// c = cid[s * C + j] (burst). occupancy (S, C) holds one 64-bit word per
// slot: bit 8 i + j is set when the tile's 16 x 16 sub-block (i, j) holds
// a nonzero; a pad slot's word is 0, so both kernels pass over it after
// reading one byte (the grouped kernel no longer needs the valid counts).
//
// The Pallas grid walked the chunks in order and kept the output block of
// rowid[s] resident in VMEM across a row tile's chunks, multiplying whole
// 128 x 128 tiles on the MXU. CUDA blocks run in no order, so each block
// owns 32 or 64 output columns of one row tile's stripes and writes each
// output element once: no atomics, and the result is the same bit for
// bit from run to run. Inside the block a warp owns a 16-row stripe and
// walks the set bits of its byte of every slot's word (occupancy_spmm.cuh:
// the entry list, the per-warp stages, the register prefetch of the next
// sub-block and its U rows). U rows >= n_cols read as zero (no padded
// copy of U); any k works, in masked column blocks (no padding of k to
// 128 lanes).
//
// What bounds the walk. On the RCM-ordered Laplacian of a 300k-point
// cloud 12.6% of the real tiles' 16 x 16 sub-blocks are occupied (192k
// sub-blocks, 11 nonzeros each): the kernel reads ~0.1 GB of bf16 strips
// (0.2 GB in fp32) instead of the 0.8 (1.6) GB of dense tiles, 30-60
// microseconds at 3.35 TB/s, and per sub-block 16 U rows of the column
// block's width, which come from L2 and L1. In fp32 a sub-block holds
// ~11 nonzeros, so the warp votes on its 64 groups of 1 x 4 values and
// skips the zero ones (about five in six), loads and FFMA alike. In
// 'bf16' the product is one mma.sync.m16n8k16 per sub-block and 8
// columns, with both fragments loaded straight from global memory. The
// loop is short (about 8 sub-blocks per warp and row tile), so what is
// left is latency: the table, the column-tile lookup (two dependent
// lookups through the group tables), then the first sub-block, each a
// dependent trip to L2 or HBM that only the other resident blocks hide.
// At k = 20 both kernels take about the time of torch.sparse.mm on the
// same operator as fp32 CSR in fp32, and less in 'bf16' (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py measures all three).
//
// The narrow path (fp32 strips, 1 <= k <= 8; the Dirichlet CG runs at
// k = 1). The walk reads whole sub-blocks: at k = 1 that is ~1 KB for
// ~11 nonzeros, ~0.2 GB at 300k, and 31 of a warp's 32 lanes own a
// masked column, so it took 0.2018 ms where torch.sparse.mm takes
// 0.0244. The narrow kernel reads instead the operator's nonzeros as a
// sliced ELL (BSRTile.narrow, built from the strips): 8 bytes a nonzero
// (an fp32 value and an int32 U row) plus the padding to each 32-row
// slice's widest row (1.48 x at 300k: 25.6 MB), one lane a row with k
// fp32 accumulators, the next 8 entries of every lane loaded while the
// U values of the present ones are on their way. Each row lists its
// nonzeros in the order in which the walk sums them (slot, sub-block
// column, column) and the lane chains its FFMA in that order, skipping
// only the padding, as the walk skips only exact zeros: W has the walk's
// bits at every k <= 8. On the 300k K: 0.0088 ms at k = 1 (bound 0.0063,
// torch.sparse.mm 0.0244), 0.0119 at 2, 0.0256 at 4, 0.0491 at 8, where
// the walk takes 0.2018-0.2042 and the library 0.1755-0.1897 past k = 1
// (times on the card, NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py's
// Dirichlet phase): so k <= 8.
//
// The row-wise route (fp32 strips, 8 < k <= bsr.ROWS_MAX_K; the
// polish's products at k = 28 and 84). The same table, ceil(k / 4)
// lanes a row, each owning 4 adjacent columns and loading its row's U
// values of an entry as one 16-byte vector; the FFMA chain of each output
// is the narrow kernel's, so W keeps the walk's bits. The walk reads
// every occupied sub-block (1 KB for ~11 nonzeros) once per column block
// (k = 84 runs two of 64 columns); the row-wise route reads ~12 bytes a
// nonzero of table once, and each nonzero's U row (4 k bytes, mostly
// from L2 and L1). On the 1M K at k = 84: 0.5878 ms on the card, where
// the walk takes 1.5427 and torch.sparse.mm 0.7481; it beats the walk at
// every k from 12 to 128 on the 300k and 1M K and on CLI run B's K_blk
// (NVIDIA H100 80GB HBM3, 700 W, polish_products.py): so k <= 128.
//
// Small operators (CLI run B's K_blk, 35 row tiles, k = 64). The walk's
// grid is (column blocks, row tiles) of 8-warp blocks: 35 blocks at 64
// columns, on 132 SMs. When row tiles x column blocks give fewer than two
// blocks an SM, the wrapper takes 32 columns (half the work a warp) and
// blocks of 4 or 2 warps, each holding that many of a row tile's 8
// stripes; a warp sums its stripe as before, so W keeps its bits. On
// K_blk at k = 64 in fp32: 0.0203 ms on the 8-warp grid of 64 columns,
// 0.0162 on 2-warp blocks of 32 columns; torch.sparse.mm 0.0170 (on the
// card, NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py's CLI phase).
// What is left there is each stripe's chain of dependent loads (the
// lookups, then ~7 sub-blocks with one in flight), which more blocks do
// not shorten.
//
// Left open: the walk's masked lanes at 8 < k < 32 in fp32; a U row
// shared by the stripes of a tile is fetched once per stripe; the
// grouped kernel's second lookup (cid holds the same column tiles); the
// walk in 'bf16' past k = 128 and below 8 (mma.sync with fragments from
// global memory). TMA
// descriptors and wgmma do not fit this
// work: the sub-blocks are tiny and irregularly placed, and wgmma wants
// 64-row tiles. Blocks of 32 columns run three to an SM (fewer
// registers), blocks of 64 two; 4- and 2-warp blocks keep the registers
// a thread may use.
//
// Precision: 'highest' and 'high' are both exact fp32 FFMA (the TPU's
// bf16x3 split was its way to near-f32 on the MXU). 'bf16' reads bf16
// strips and rounds U to bf16 before the product (tensor cores, fp32
// accumulation), as both Pallas kernels do.

#include "nonzero_spmm.cuh"
#include "occupancy_spmm.cuh"

namespace {

using occ::kSub;
using occ::kT;

constexpr int kStripes = kT / kSub;  // 16-row stripes of a row tile

// The column-block walk: block (x, y) owns output columns [32 kCols x,
// 32 kCols (x + 1)) of kWarps stripes of row tile y / (8 / kWarps), one
// stripe a warp. kWarps = 8 is the whole tile; 4 and 2 give the card more
// blocks on a small operator. A warp sums its stripe in the same order
// whatever kWarps, so W has the same bits. The launch bounds keep the
// registers a thread may use the same for every kWarps.
template <typename DataT, bool kRoundU, bool kGrouped, int kCols, int kWarps>
__global__ void __launch_bounds__(32 * kWarps,
                                  (kCols == 1 ? 3 : 2) * (kStripes / kWarps))
bsr_spmm_kernel(const DataT* __restrict__ data, const int* __restrict__ cols,
                const int* __restrict__ lcid, const int* __restrict__ gid,
                const unsigned char* __restrict__ occupancy,
                const int* __restrict__ chunk_start, int C, int C_u,
                const float* __restrict__ U, float* __restrict__ W, int n,
                int n_cols, int k) {
  constexpr int kPerTile = kStripes / kWarps;  // blocks of a row tile
  __shared__ occ::WarpScratch scratch[kWarps];

  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.y / kPerTile;  // row tile
  const int stripe0 = (blockIdx.y % kPerTile) * kWarps;
  const int stripe = stripe0 + warp;
  const int col0 = blockIdx.x * 32 * kCols;
  const size_t ld = (size_t)C * kT;

  float acc[kSub * kCols];
#pragma unroll
  for (int i = 0; i < kSub * kCols; ++i) acc[i] = 0.f;

  // Slot q = s * C + j: its column tile's first U row, and the offset of
  // this warp's stripe of chunk s at the slot's first column.
  auto piece = [&](int q, int& ub, long long& off) {
    const int s = q / C;
    const int ct = kGrouped ? cols[(size_t)gid[s] * C_u + lcid[q]] : cols[q];
    ub = ct * kT;
    off = ((long long)s * kT + stripe * kSub) * (long long)ld
          + (long long)(q - s * C) * kT;
  };
  // The walk reads byte (threadIdx.x >> 5) of each word: offsetting the
  // table by the block's first stripe makes that byte this warp's stripe.
  occ::stripe_product<kRoundU, kCols>(
      data, ld, occupancy + stripe0, chunk_start[r] * C,
      chunk_start[r + 1] * C, piece, U, n_cols, k, col0, scratch[warp], acc);
  occ::store_stripe<DataT, kCols>(W, r * kT + stripe * kSub, n, k, col0, acc);
}

template <typename DataT, bool kRoundU, bool kGrouped, int kCols, int kWarps>
cudaError_t launch_grid(const void* data, const int* cols, const int* lcid,
                        const int* gid, const void* occupancy,
                        const int* chunk_start, int C, int C_u,
                        const float* U, float* W, int n, int n_cols, int n_rt,
                        int k, cudaStream_t s) {
  const dim3 grid((k + 32 * kCols - 1) / (32 * kCols),
                  n_rt * (kStripes / kWarps));
  bsr_spmm_kernel<DataT, kRoundU, kGrouped, kCols, kWarps>
      <<<grid, 32 * kWarps, 0, s>>>(
          static_cast<const DataT*>(data), cols, lcid, gid,
          static_cast<const unsigned char*>(occupancy), chunk_start, C, C_u,
          U, W, n, n_cols, k);
  return cudaGetLastError();
}

template <typename DataT, bool kRoundU, bool kGrouped, int kCols>
cudaError_t launch_cols(int warps, const void* data, const int* cols,
                        const int* lcid, const int* gid,
                        const void* occupancy, const int* chunk_start, int C,
                        int C_u, const float* U, float* W, int n, int n_cols,
                        int n_rt, int k, cudaStream_t s) {
#define EPK_BSR_ARGS \
  data, cols, lcid, gid, occupancy, chunk_start, C, C_u, U, W, n, n_cols, \
      n_rt, k, s
  switch (warps) {
    case 2:
      return launch_grid<DataT, kRoundU, kGrouped, kCols, 2>(EPK_BSR_ARGS);
    case 4:
      return launch_grid<DataT, kRoundU, kGrouped, kCols, 4>(EPK_BSR_ARGS);
    default:
      return launch_grid<DataT, kRoundU, kGrouped, kCols, 8>(EPK_BSR_ARGS);
  }
#undef EPK_BSR_ARGS
}

template <typename DataT, bool kRoundU>
cudaError_t launch(const void* data, const int* cols, const int* lcid,
                   const int* gid, const void* occupancy,
                   const int* chunk_start, int grouped, int C, int C_u,
                   const float* U, float* W, int n, int n_cols, int n_rt,
                   int k, int col_block, int warps, cudaStream_t s) {
#define EPK_BSR_ARGS \
  warps, data, cols, lcid, gid, occupancy, chunk_start, C, C_u, U, W, n, \
      n_cols, n_rt, k, s
  if (grouped) {
    return col_block == 64
               ? launch_cols<DataT, kRoundU, true, 2>(EPK_BSR_ARGS)
               : launch_cols<DataT, kRoundU, true, 1>(EPK_BSR_ARGS);
  }
  return col_block == 64
             ? launch_cols<DataT, kRoundU, false, 2>(EPK_BSR_ARGS)
             : launch_cols<DataT, kRoundU, false, 1>(EPK_BSR_ARGS);
#undef EPK_BSR_ARGS
}

}  // namespace

extern "C" {

// W = A U by the column-block walk. cols is gcid (n_groups, C_u) when
// grouped, else cid (S, C); lcid (S, C) and gid (S,) are read only when
// grouped. occupancy (S, C) int64, chunk_start (n_rt + 1,), U (n_cols, k)
// and W (n, k) fp32; col_block is 32 or 64 output columns per block,
// warps 8, 4 or 2 stripes per block (n_rt * 8 / warps <= 65535). The
// wrapper checks types, shapes, contiguity and 16-byte alignment of data.
// Returns cudaGetLastError() after the launch.
int epk_bsr_spmm(const void* data, int data_is_bf16, const int* cols,
                 const int* lcid, const int* gid, const void* occupancy,
                 const int* chunk_start, int grouped, int C, int C_u,
                 const float* U, float* W, int n, int n_cols, int n_rt, int k,
                 int col_block, int warps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (data_is_bf16) {
    return (int)launch<__nv_bfloat16, true>(
        data, cols, lcid, gid, occupancy, chunk_start, grouped, C, C_u, U, W,
        n, n_cols, n_rt, k, col_block, warps, s);
  }
  return (int)launch<float, false>(data, cols, lcid, gid, occupancy,
                                   chunk_start, grouped, C, C_u, U, W, n,
                                   n_cols, n_rt, k, col_block, warps, s);
}

// W = A U by the narrow path: val (L,) fp32 and idx (L,) int32 the sliced
// ELL (nonzero_spmm.cuh), slice_start (n_slices + 1,) int64, U (n_cols,
// k) and W (n, k) fp32, 1 <= k <= 8. Returns cudaGetLastError() after the
// launch.
int epk_bsr_spmm_narrow(const float* val, const int* idx,
                        const long long* slice_start, int n_slices,
                        const float* U, float* W, int n, int k,
                        void* stream) {
  return (int)nz::launch_narrow(val, idx, slice_start, n_slices, U, W, n, k,
                                static_cast<cudaStream_t>(stream));
}

// W = A U by the row-wise route over the same table: val (L,) fp32, or
// bf16 when val_is_bf16 (bf16 strips: U rounded to bf16, through its copy
// in U_bf16 (n_cols, nz::copy_ld(k)) bf16), U (n_cols, k) and W (n, k)
// fp32, 1 <= k <= 256, on a card of `sms` SMs. Returns
// cudaGetLastError() after the launches.
int epk_bsr_spmm_rows(const void* val, int val_is_bf16, const int* idx,
                      const long long* slice_start, const float* U,
                      void* U_bf16, float* W, int n, int n_cols, int k,
                      int sms, void* stream) {
  return (int)nz::launch_rows(val, val_is_bf16, idx, slice_start, U,
                              static_cast<nz::bf16_bits*>(U_bf16), W, n,
                              n_cols, k, sms,
                              static_cast<cudaStream_t>(stream));
}

const char* epk_bsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
