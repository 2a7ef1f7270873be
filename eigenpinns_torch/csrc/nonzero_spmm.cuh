// W = A U from an operator's nonzeros listed as a sliced ELL, for both
// tiled formats of the package: the strip-BSR strips (bsr_spmm.cu,
// BSRTile.narrow) and the bands (banded_spmm.cu, RollingBanded.narrow;
// sparse/nonzeros.py builds the table for either from the dense layout
// and its occupancy table).
//
// The table. Slice i holds rows [32 i, 32 i + 32); its entries sit in
// [slice_start[i], slice_start[i + 1]), 32 times the slice's widest row,
// entry e of row 32 i + l at slice_start[i] + 32 e + l, so 32
// neighbouring rows read 32 neighbouring values and U-row indices. Each
// row lists its nonzeros in the order in which the column-block walk of
// the dense layout sums them (strip-BSR: chunk, slot, sub-block column,
// column; a band: its window's pieces in order, sub-block column,
// column); padding has index -1 and is skipped. Each output is one FFMA
// chain over its row's entries in that order, which is the walk's chain
// (the walk skips only exact zeros, loads and FFMA alike), so W has the
// walk's bits on both routes below. A U row at or past n_u reads as zero,
// as in the walk (a band's window may reach past U).
//
// Why. The walk reads each occupied 16 x 16 sub-block whole: 1 KB of
// fp32 for ~11 nonzeros on a cloud Laplacian (4.4% of its values), and
// every entry of the table of occupied sub-blocks again for each column
// block (k = 84 runs as two blocks of 64 columns). The table reads 8
// bytes a nonzero (a 4-byte value, a 4-byte U row) plus the padding to
// each slice's widest row (1.48 x on the RCM-ordered 300k and 1M
// clouds), once whatever k.
//
// The narrow kernel (1 <= k <= 8; strip-BSR only): one lane a row with k
// fp32 accumulators, one warp a slice, the next 8 entries of every lane
// loaded while the U values of the present ones are on their way.
//
// The row-wise kernel (k up to kRowsMaxK): a row takes ceil(k / 4) lanes,
// each owning 4 adjacent output columns, so the row's U values of an
// entry are one coalesced read of 4 k contiguous bytes, a 16-byte vector
// a lane when k % 4 == 0 and U is 16-byte aligned (4 scalar loads
// otherwise). Thread t of a block is lane t % ceil(k / 4) of row t /
// ceil(k / 4): no lane is idle whatever k (at k = 84 a warp holds lanes
// of two rows), and a block holds 8, 16, 32 or 64 whole rows of one
// slice or two, so its rows share each 32-byte sector of the table in
// L1. The lanes of a row load the same value and index (a broadcast).
// Each lane keeps kRowsBatch entries of its row in flight and loads the
// next batch's values and indices while the present batch's U vectors
// are on their way. What bounds it is U: every nonzero's U row, 4 k
// bytes, mostly from L2 and L1 (neighbouring rows of an RCM ordering
// share most of their U rows), against ~12 bytes a nonzero of table.
// On the card (NVIDIA H100 80GB HBM3, 700 W, polish_products.py): the
// 1M K at k = 28 / 84 0.2350 / 0.5878 ms (the walk 0.6502 / 1.5427,
// torch.sparse.mm 0.5585 / 0.7481, bound 0.0853 / 0.2191); the 300k
// rolling band at k = 84 0.1812 (the walk 0.4646, the library 0.2474).

#pragma once

#include <cuda_runtime.h>

namespace nz {

constexpr int kSlice = 32;         // rows of a slice of the table
constexpr int kNarrowWarps = 8;    // slices of a narrow block
constexpr int kNarrowBatch = 8;    // entries of a lane in flight (narrow)
constexpr int kRowsThreads = 512;  // threads of a row-wise block, at most
constexpr int kRowsBatch = 4;      // entries of a row in flight (row-wise)
constexpr int kRowsMaxK = 256;     // widest product of the row-wise kernel

// ---- the narrow kernel: one lane a row, k <= kK <= 8 -------------------

template <int kK>
__global__ void __launch_bounds__(kSlice * kNarrowWarps)
narrow_kernel(const float* __restrict__ val, const int* __restrict__ idx,
              const long long* __restrict__ slice_start, int n_slices,
              const float* __restrict__ U, float* __restrict__ W, int n,
              int k) {
  const int lane = threadIdx.x & 31;
  const int slice = blockIdx.x * kNarrowWarps + (threadIdx.x >> 5);
  if (slice >= n_slices) return;
  const long long e0 = slice_start[slice];
  const int width = (int)((slice_start[slice + 1] - e0) / kSlice);
  const float* vp = val + e0 + lane;
  const int* ip = idx + e0 + lane;

  float v_next[kNarrowBatch];
  int i_next[kNarrowBatch];
  auto fetch = [&](int eb) {  // entries eb .. eb + 7 (warp-uniform bounds)
#pragma unroll
    for (int b = 0; b < kNarrowBatch; ++b) {
      const bool in = eb + b < width;
      v_next[b] = in ? __ldg(vp + (size_t)(eb + b) * kSlice) : 0.f;
      i_next[b] = in ? __ldg(ip + (size_t)(eb + b) * kSlice) : -1;
    }
  };

  float acc[kK];
#pragma unroll
  for (int c = 0; c < kK; ++c) acc[c] = 0.f;
  if (width > 0) fetch(0);
  for (int eb = 0; eb < width; eb += kNarrowBatch) {
    float v[kNarrowBatch], u[kNarrowBatch][kK];
    int ix[kNarrowBatch];
#pragma unroll
    for (int b = 0; b < kNarrowBatch; ++b) {
      v[b] = v_next[b];
      ix[b] = i_next[b];
#pragma unroll
      for (int c = 0; c < kK; ++c)
        u[b][c] = ix[b] >= 0 && c < k
                      ? __ldg(U + (size_t)ix[b] * k + c) : 0.f;
    }
    if (eb + kNarrowBatch < width) fetch(eb + kNarrowBatch);
#pragma unroll
    for (int b = 0; b < kNarrowBatch; ++b) {
      if (ix[b] >= 0) {
#pragma unroll
        for (int c = 0; c < kK; ++c) acc[c] = fmaf(v[b], u[b][c], acc[c]);
      }
    }
  }
  const int row = slice * kSlice + lane;
  if (row < n) {
#pragma unroll
    for (int c = 0; c < kK; ++c)
      if (c < k) W[(size_t)row * k + c] = acc[c];
  }
}

template <int kK>
cudaError_t launch_narrow_k(const float* val, const int* idx,
                            const long long* slice_start, int n_slices,
                            const float* U, float* W, int n, int k,
                            cudaStream_t s) {
  const int grid = (n_slices + kNarrowWarps - 1) / kNarrowWarps;
  narrow_kernel<kK><<<grid, kSlice * kNarrowWarps, 0, s>>>(
      val, idx, slice_start, n_slices, U, W, n, k);
  return cudaGetLastError();
}

// 1 <= k <= 8; U rows are all below n_u (the strips' columns).
inline cudaError_t launch_narrow(const float* val, const int* idx,
                                 const long long* slice_start, int n_slices,
                                 const float* U, float* W, int n, int k,
                                 cudaStream_t s) {
  if (k < 1 || k > 8) return cudaErrorInvalidValue;
  if (k == 1)
    return launch_narrow_k<1>(val, idx, slice_start, n_slices, U, W, n, k, s);
  if (k == 2)
    return launch_narrow_k<2>(val, idx, slice_start, n_slices, U, W, n, k, s);
  if (k <= 4)
    return launch_narrow_k<4>(val, idx, slice_start, n_slices, U, W, n, k, s);
  return launch_narrow_k<8>(val, idx, slice_start, n_slices, U, W, n, k, s);
}

// ---- the row-wise kernel: ceil(k / 4) lanes a row ----------------------

// The 4 U values of row ix, columns c0 .. c0 + 3 (zero past k, and for a
// row at or past n_u; ix >= 0).
template <bool kVec>
__device__ __forceinline__ float4 u_group(const float* __restrict__ U,
                                          int ix, int n_u, int k, int c0) {
  float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ix >= n_u) return u;
  const float* p = U + (size_t)ix * k + c0;
  if constexpr (kVec) {
    u = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (c0 < k) u.x = __ldg(p);
    if (c0 + 1 < k) u.y = __ldg(p + 1);
    if (c0 + 2 < k) u.z = __ldg(p + 2);
    if (c0 + 3 < k) u.w = __ldg(p + 3);
  }
  return u;
}

// kVec: k % 4 == 0 and U, W 16-byte aligned (vector loads and stores).
template <bool kVec>
__global__ void __launch_bounds__(kRowsThreads, 2)
rows_kernel(const float* __restrict__ val, const int* __restrict__ idx,
            const long long* __restrict__ slice_start,
            const float* __restrict__ U, float* __restrict__ W, int n,
            int n_u, int k, int lanes) {
  const int rows_per_block = blockDim.x / lanes;
  const int row = blockIdx.x * rows_per_block + threadIdx.x / lanes;
  const int c0 = 4 * (threadIdx.x % lanes);
  if (row >= n) return;
  const int slice = row / kSlice;
  const long long e0 = slice_start[slice];
  const int width = (int)((slice_start[slice + 1] - e0) / kSlice);
  const float* vp = val + e0 + row % kSlice;
  const int* ip = idx + e0 + row % kSlice;

  float v_next[kRowsBatch];
  int i_next[kRowsBatch];
  auto fetch = [&](int eb) {
#pragma unroll
    for (int b = 0; b < kRowsBatch; ++b) {
      const bool in = eb + b < width;
      v_next[b] = in ? __ldg(vp + (size_t)(eb + b) * kSlice) : 0.f;
      i_next[b] = in ? __ldg(ip + (size_t)(eb + b) * kSlice) : -1;
    }
  };

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (width > 0) fetch(0);
  for (int eb = 0; eb < width; eb += kRowsBatch) {
    float v[kRowsBatch];
    int ix[kRowsBatch];
    float4 u[kRowsBatch];
#pragma unroll
    for (int b = 0; b < kRowsBatch; ++b) {
      v[b] = v_next[b];
      ix[b] = i_next[b];
      u[b] = ix[b] >= 0 ? u_group<kVec>(U, ix[b], n_u, k, c0)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (eb + kRowsBatch < width) fetch(eb + kRowsBatch);
#pragma unroll
    for (int b = 0; b < kRowsBatch; ++b) {
      if (ix[b] >= 0) {  // the same for every lane of the row
        acc.x = fmaf(v[b], u[b].x, acc.x);
        acc.y = fmaf(v[b], u[b].y, acc.y);
        acc.z = fmaf(v[b], u[b].z, acc.z);
        acc.w = fmaf(v[b], u[b].w, acc.w);
      }
    }
  }
  float* wp = W + (size_t)row * k + c0;
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(wp) = acc;
  } else {
    if (c0 < k) wp[0] = acc.x;
    if (c0 + 1 < k) wp[1] = acc.y;
    if (c0 + 2 < k) wp[2] = acc.z;
    if (c0 + 3 < k) wp[3] = acc.w;
  }
}

// Rows of a row-wise block for `lanes` lanes a row: the most of 64, 32,
// 16 and 8 that keep the block within kRowsThreads threads.
inline int rows_per_block(int lanes) {
  int r = 64;
  while (r > 8 && r * lanes > kRowsThreads) r /= 2;
  return r;
}

// W (n, k) = A U from the table (the table covers rows [0, n) at least),
// U (n_u, k); 1 <= k <= kRowsMaxK. Vector loads and stores when k % 4 ==
// 0 and U and W are 16-byte aligned.
inline cudaError_t launch_rows(const float* val, const int* idx,
                               const long long* slice_start, const float* U,
                               float* W, int n, int n_u, int k,
                               cudaStream_t s) {
  if (k < 1 || k > kRowsMaxK || n < 1) return cudaErrorInvalidValue;
  const int lanes = (k + 3) / 4;
  const int rows = rows_per_block(lanes);
  const unsigned grid = (unsigned)((n + rows - 1) / rows);
  const bool vec = k % 4 == 0 && reinterpret_cast<size_t>(U) % 16 == 0
                   && reinterpret_cast<size_t>(W) % 16 == 0;
  if (vec)
    rows_kernel<true><<<grid, rows * lanes, 0, s>>>(val, idx, slice_start, U,
                                                    W, n, n_u, k, lanes);
  else
    rows_kernel<false><<<grid, rows * lanes, 0, s>>>(val, idx, slice_start,
                                                     U, W, n, n_u, k, lanes);
  return cudaGetLastError();
}

}  // namespace nz
