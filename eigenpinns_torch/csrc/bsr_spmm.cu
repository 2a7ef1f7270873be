// Strip-BSR SpMM W = A U for Hopper, sm_90a: a grouped and a burst kernel
// that read and multiply only the occupied 16 x 16 sub-blocks of the
// tiles.
//
// Replaces the Pallas TPU kernels of eigenpinns_tpu/sparse/bsr.py:
//   bsr_spmm_kernel<..., kGrouped = true>   <-  bsr_spmm_pallas_grouped
//       (column tiles through the group tables)
//   bsr_spmm_kernel<..., kGrouped = false>  <-  bsr_spmm_pallas
//       (column tiles through cid)
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
// owns one row tile (128 rows) and 32 or 64 output columns and writes
// each output element once: no atomics, and the result is the same bit
// for bit from run to run. Inside the block a warp owns a 16-row stripe
// and walks the set bits of its byte of every slot's word
// (occupancy_spmm.cuh: the entry list, the per-warp stages, the register
// prefetch of the next sub-block and its U rows). U rows >= n_cols read
// as zero (no padded copy of U); any k works, in masked column blocks (no
// padding of k to 128 lanes).
//
// What bounds it. On the RCM-ordered Laplacian of a 300k-point cloud
// 12.6% of the real tiles' 16 x 16 sub-blocks are occupied (192k
// sub-blocks, 11 nonzeros each): the kernel reads ~0.1 GB of bf16 strips
// (0.2 GB in fp32) instead of the 0.8 (1.6) GB of dense tiles, 30-60
// microseconds at 3.35 TB/s, and per sub-block 16 U rows of the column
// block's width, which come from L2 and L1 (U is 24 MB at k = 20;
// neighbouring stripes share rows): 0.4 GB at 32 columns, more than the
// strips. In fp32 a dense product of every occupied sub-block would be
// 256 FFMA per lane (~50 M warp instructions at k = 20, ~60
// microseconds over 132 SMs) fed by as many shared-memory loads as the
// FFMA pipe can take; but a sub-block holds ~11 nonzeros, so the warp
// votes on its 64 groups of 1 x 4 values and skips the zero ones (about
// five in six), loads and FFMA alike. In 'bf16' the product is one
// mma.sync.m16n8k16 per sub-block and 8 columns, with both fragments
// loaded straight from global memory, so arithmetic is no longer a
// cost. The loop is short (about 8 sub-blocks per warp and row tile,
// the busiest stripe of a tile 1.3 times the mean), so what is left is
// latency: the table, the column-tile lookup (two dependent lookups
// through the group tables: the grouped kernel is the slower of the
// two), then the first sub-block, each a dependent trip to L2 or HBM
// that only the other resident blocks hide. On an NVIDIA H100 80GB HBM3
// (700 W) at k = 20 both kernels take about the time of
// torch.sparse.mm on the same operator as fp32 CSR in fp32, and less in
// 'bf16' (chip_smoke.py measures all three).
//
// Left open: at k = 20 in fp32 12 of a warp's 32 lanes own a masked
// column; a U row shared by the stripes of a tile is fetched once per
// stripe; the grouped kernel's second lookup (cid holds the same column
// tiles); and a compact copy of the occupied sub-blocks, which would
// turn the scattered 32-64 B row reads into one contiguous read. TMA
// descriptors and wgmma do not fit this work: the sub-blocks are tiny,
// irregularly placed, and wgmma wants 64-row tiles. Blocks of 32 columns
// run three to an SM (fewer registers), blocks of 64 two.
//
// Precision: 'highest' and 'high' are both exact fp32 FFMA (the TPU's
// bf16x3 split was its way to near-f32 on the MXU). 'bf16' reads bf16
// strips and rounds U to bf16 before the product (tensor cores, fp32
// accumulation), as both Pallas kernels do.

#include "occupancy_spmm.cuh"

namespace {

using occ::kSub;
using occ::kT;
using occ::kThreads;

template <typename DataT, bool kRoundU, bool kGrouped, int kCols>
__global__ void __launch_bounds__(kThreads, kCols == 1 ? 3 : 2)
bsr_spmm_kernel(const DataT* __restrict__ data, const int* __restrict__ cols,
                const int* __restrict__ lcid, const int* __restrict__ gid,
                const unsigned char* __restrict__ occupancy,
                const int* __restrict__ chunk_start, int C, int C_u,
                const float* __restrict__ U, float* __restrict__ W, int n,
                int n_cols, int k) {
  __shared__ occ::WarpScratch scratch[kThreads / 32];

  const int stripe = threadIdx.x >> 5;
  const int r = blockIdx.y;  // row tile
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
  occ::stripe_product<kRoundU, kCols>(
      data, ld, occupancy, chunk_start[r] * C, chunk_start[r + 1] * C, piece,
      U, n_cols, k, col0, scratch[stripe], acc);
  occ::store_stripe<DataT, kCols>(W, r * kT + stripe * kSub, n, k, col0, acc);
}

template <typename DataT, bool kRoundU, bool kGrouped, int kCols>
cudaError_t launch_cols(const void* data, const int* cols, const int* lcid,
                        const int* gid, const void* occupancy,
                        const int* chunk_start, int C, int C_u,
                        const float* U, float* W, int n, int n_cols, int n_rt,
                        int k, cudaStream_t s) {
  const dim3 grid((k + 32 * kCols - 1) / (32 * kCols), n_rt);
  bsr_spmm_kernel<DataT, kRoundU, kGrouped, kCols><<<grid, kThreads, 0, s>>>(
      static_cast<const DataT*>(data), cols, lcid, gid,
      static_cast<const unsigned char*>(occupancy), chunk_start, C, C_u, U, W,
      n, n_cols, k);
  return cudaGetLastError();
}

template <typename DataT, bool kRoundU>
cudaError_t launch(const void* data, const int* cols, const int* lcid,
                   const int* gid, const void* occupancy,
                   const int* chunk_start, int grouped, int C, int C_u,
                   const float* U, float* W, int n, int n_cols, int n_rt,
                   int k, int col_block, cudaStream_t s) {
#define EPK_BSR_ARGS \
  data, cols, lcid, gid, occupancy, chunk_start, C, C_u, U, W, n, n_cols, \
      n_rt, k, s
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

// W = A U. cols is gcid (n_groups, C_u) when grouped, else cid (S, C);
// lcid (S, C) and gid (S,) are read only when grouped. occupancy (S, C)
// int64, chunk_start (n_rt + 1,), U (n_cols, k) and W (n, k) fp32;
// col_block is 32 or 64 output columns per block. The wrapper checks
// types, shapes, contiguity and 16-byte alignment of data. Returns
// cudaGetLastError() after the launch.
int epk_bsr_spmm(const void* data, int data_is_bf16, const int* cols,
                 const int* lcid, const int* gid, const void* occupancy,
                 const int* chunk_start, int grouped, int C, int C_u,
                 const float* U, float* W, int n, int n_cols, int n_rt, int k,
                 int col_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (data_is_bf16) {
    return (int)launch<__nv_bfloat16, true>(
        data, cols, lcid, gid, occupancy, chunk_start, grouped, C, C_u, U, W,
        n, n_cols, n_rt, k, col_block, s);
  }
  return (int)launch<float, false>(data, cols, lcid, gid, occupancy,
                                   chunk_start, grouped, C, C_u, U, W, n,
                                   n_cols, n_rt, k, col_block, s);
}

const char* epk_bsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
