// W = A U from an operator's nonzeros listed as a sliced ELL, for both
// tiled formats of the package: the strip-BSR strips (bsr_spmm.cu,
// BSRTile.narrow) and the bands (banded_spmm.cu, RollingBanded.narrow,
// BandedELL.narrow; sparse/nonzeros.py builds the table for either from
// the dense layout and its occupancy table).
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
// A lane's U values of an entry stay packed in the 4 registers of their
// 16-byte load until the multiply-adds.
//
// The bf16 route (a bf16 table: bf16 strips, a bf16 band; 'bf16' means a
// bf16 operator, U rounded to bf16, fp32 sums). Its values are 2 bytes,
// its U rows and slices the fp32 table's. The tensor-core walk it
// replaces (occupancy_spmm.cuh: one mma.sync.m16n8k16 a sub-block and 8
// columns, both fragments from global memory) read 512 B a sub-block for
// ~11 nonzeros and lost to the fp32 row-wise route on the same operator.
// Here round_kernel first writes U rounded to bf16 (to nearest even, as
// torch rounds) into a copy whose rows are padded to 8 values (16 bytes),
// and the row-wise kernel reads it with 8 columns a lane: ceil(k / 8)
// lanes a row, one 16-byte load an entry, half the lanes and loads of the
// fp32 route's 4 columns, 2 ceil(k / 8) 8 bytes of U a nonzero. A product
// of a bf16 value and a bf16 U value is exact in fp32, so each output is
// one fp32 FFMA chain in the table's order, rounding once a step: W is
// the same bits from launch to launch, but not the walk's, whose tensor
// cores sum 16 products an instruction in their own order. The copy beat
// rounding each fp32 U value in registers as it is loaded (4 columns a
// lane, 4 k bytes a nonzero) at every width measured, both passes
// counted (at k = 20 on the 300k K 0.0516 against 0.0638 ms; PERF.md), so
// it is the one feed. At k = 20 the copy is 14.4 MB at 300k and 48 MB at
// 1M (k padded to 24), within the card's 50 MB L2.
//
// The Gram (the fused G = U^T A U of a square band, rolling or full
// window, rows_gram_kernel): a block owns a 128-row tile, runs the
// product over its rows in passes, keeps the tile's W rows in shared
// memory beside its U rows (copied in while the product runs), and writes
// the tile's k x k partial summed as the walk's occ::tile_gram sums it, from
// a register-tiled epilogue; banded_spmm.cu's gram_reduce_kernel then
// adds the partials in the walk's order. So on an fp32 table G has the
// walk's bits as W does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

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

// A bf16 value is the top half of an fp32's bits, so its fp32 value is
// exact; tables and U copies in bf16 are read as their raw 16-bit words.
using bf16_bits = unsigned short;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16_bits v) {
  return __uint_as_float((unsigned)v << 16);
}

__device__ __forceinline__ bf16_bits bits_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// A lane's U fragment of one entry: the 16 bytes of row ix, columns c0
// onward, that hold its kC values (4 fp32 or 8 bf16), kept packed until
// the multiply-adds, so that an entry in flight costs 4 registers either
// way. Zero for padding (ix < 0) and for a row at or past n_u. U holds
// rows of ld values: fp32 U (ld = k), or U's bf16 copy (ld a multiple of
// 8, its pad columns zero). kVecU: one 16-byte load; otherwise scalar
// loads masked at k (fp32 U only).
template <typename UT, bool kVecU>
__device__ __forceinline__ uint4 u_frag(const UT* __restrict__ U, int ix,
                                        int n_u, int ld, int k, int c0) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (ix < 0 || ix >= n_u) return w;
  const UT* p = U + (size_t)ix * ld + c0;
  if constexpr (kVecU) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    static_assert(sizeof(UT) == 4, "U's bf16 copy is read by vectors");
    if (c0 < k) w.x = __float_as_uint(__ldg(p));
    if (c0 + 1 < k) w.y = __float_as_uint(__ldg(p + 1));
    if (c0 + 2 < k) w.z = __float_as_uint(__ldg(p + 2));
    if (c0 + 3 < k) w.w = __float_as_uint(__ldg(p + 3));
  }
  return w;
}

// Value j of a fragment of kC values (j a constant after unrolling).
template <int kC>
__device__ __forceinline__ float frag_value(const uint4& w, int j) {
  const int i = kC == 4 ? j : j / 2;
  const unsigned q = i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
  if constexpr (kC == 4) return __uint_as_float(q);
  return __uint_as_float(j % 2 == 0 ? q << 16 : q & 0xffff0000u);
}

// ValT: the table's values, fp32 or bf16. UT: fp32 U (an fp32 table) or
// U's bf16 copy (a bf16 table). A lane owns kC adjacent output columns: 4
// on fp32 U (one 16-byte load), 8 on the bf16 copy (one 16-byte load of
// its padded row). kVecU: 16-byte U loads (fp32 U: k % 4 == 0 and U
// 16-byte aligned; the copy: always). A product of a bf16 value and a
// bf16-rounded U value is exact in fp32, so a bf16 table's FFMA chain
// rounds once a step, as an fp32 table's does. acc: row `row`'s outputs
// c0 .. c0 + kC - 1, one FFMA chain each over the row's entries in the
// table's order.
template <typename ValT, typename UT, bool kVecU, int kC>
__device__ __forceinline__ void row_sum(
    const ValT* __restrict__ val, const int* __restrict__ idx,
    const long long* __restrict__ slice_start, const UT* __restrict__ U,
    int ld, int row, int n_u, int k, int c0, float (&acc)[kC]) {
  const int slice = row / kSlice;
  const long long e0 = slice_start[slice];
  const int width = (int)((slice_start[slice + 1] - e0) / kSlice);
  const ValT* vp = val + e0 + row % kSlice;
  const int* ip = idx + e0 + row % kSlice;

  float v_next[kRowsBatch];
  int i_next[kRowsBatch];
  auto fetch = [&](int eb) {
#pragma unroll
    for (int b = 0; b < kRowsBatch; ++b) {
      const bool in = eb + b < width;
      v_next[b] = in ? as_float(__ldg(vp + (size_t)(eb + b) * kSlice)) : 0.f;
      i_next[b] = in ? __ldg(ip + (size_t)(eb + b) * kSlice) : -1;
    }
  };

#pragma unroll
  for (int j = 0; j < kC; ++j) acc[j] = 0.f;
  if (width > 0) fetch(0);
  for (int eb = 0; eb < width; eb += kRowsBatch) {
    float v[kRowsBatch];
    int ix[kRowsBatch];
    uint4 u[kRowsBatch];
#pragma unroll
    for (int b = 0; b < kRowsBatch; ++b) {
      v[b] = v_next[b];
      ix[b] = i_next[b];
      u[b] = u_frag<UT, kVecU>(U, ix[b], n_u, ld, k, c0);
    }
    if (eb + kRowsBatch < width) fetch(eb + kRowsBatch);
#pragma unroll
    for (int b = 0; b < kRowsBatch; ++b) {
      if (ix[b] >= 0) {  // the same for every lane of the row
#pragma unroll
        for (int j = 0; j < kC; ++j)
          acc[j] = fmaf(v[b], frag_value<kC>(u[b], j), acc[j]);
      }
    }
  }
}

// W[row, c0 ..] = acc, the columns below k. kVecW: 16-byte stores (k % 4
// == 0, W 16-byte aligned).
template <bool kVecW, int kC>
__device__ __forceinline__ void store_row(float* __restrict__ W, int row,
                                          int k, int c0,
                                          const float (&acc)[kC]) {
  float* wp = W + (size_t)row * k + c0;
#pragma unroll
  for (int h = 0; h < kC / 4; ++h) {
    if constexpr (kVecW) {
      if (c0 + 4 * h < k)
        reinterpret_cast<float4*>(wp)[h] = make_float4(
            acc[4 * h], acc[4 * h + 1], acc[4 * h + 2], acc[4 * h + 3]);
    } else {
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j)
        if (c0 + j < k) wp[j] = acc[j];
    }
  }
}

template <typename ValT, typename UT, bool kVecU, bool kVecW, int kC>
__global__ void __launch_bounds__(kRowsThreads, 2)
rows_kernel(const ValT* __restrict__ val, const int* __restrict__ idx,
            const long long* __restrict__ slice_start,
            const UT* __restrict__ U, int ld, float* __restrict__ W, int n,
            int n_u, int k, int lanes) {
  const int rows_per_block = blockDim.x / lanes;
  const int row = blockIdx.x * rows_per_block + threadIdx.x / lanes;
  const int c0 = kC * (threadIdx.x % lanes);
  if (row >= n) return;
  float acc[kC];
  row_sum<ValT, UT, kVecU, kC>(val, idx, slice_start, U, ld, row, n_u, k, c0,
                               acc);
  store_row<kVecW, kC>(W, row, k, c0, acc);
}

// ---- the Gram on the row-wise route ------------------------------------
//
// G = U^T W for a square operator, in the walk's order (occ::tile_gram,
// then banded_spmm.cu's gram_reduce_kernel): per 128-row tile t,
// partial[t][i][j] = the FFMA chain from 0 over the tile's rows in order
// of U[r, i] * W[r, j], from the unrounded fp32 U and the fp32 W, rows
// past n zero; then the tiles' sum in the reduce's fixed order. Where W
// has the walk's bits (an fp32 table), the partials and G have them too.
// A block owns a tile's whole partial; no atomics.
//
// The epilogue is register-tiled: a thread owns a kTI x 4 block of a
// tile's partial (kTI = 1, 2 or 4 Gram rows, 4 Gram columns) and, per row
// of the tile, reads its kTI U values (one 4-, 8- or 16-byte shared load)
// and its 4 W values (one 16-byte load) for kTI x 4 FFMA, each output still
// one chain over the tile's rows 0 .. 127 in order. The lanes of a warp
// take neighbouring blocks, column blocks fastest, so a warp's U load is
// a few broadcast words and its W load one or two 128-byte wavefronts: at
// 4 x 4 the epilogue is bound by the FFMA pipes, where a 4 x 1 strip a
// thread (a 16-byte and a 4-byte load for 4 FFMA) was bound by
// shared-memory wavefronts, two a row for each warp. On the 1M cluster
// core at k = 60 the kernel takes 0.6814 ms at 4 x 4, 0.8319 at 2 x 4,
// 1.1194 at 1 x 4 and 0.8755 with the 4 x 1 strip; fewer rows a thread
// win where the tile's items would leave most of the block idle: on
// K_blk at k = 10 1 x 4 0.0100 against 2 x 4 0.0104, at k = 20 2 x 4 and
// 4 x 4 0.0669 and 0.0687 on the 300k cluster core (gram_thread_rows).
// The tile's U rows reach shared memory by cp.async issued before the
// product, so their latency hides behind it, where element-by-element
// loads after the product each waited for global memory in turn: without
// its multiply-adds the kernel takes 0.0674 ms on the 300k Hilbert core
// in bf16 at k = 20, against 0.0883 with those loads and 0.0509 for the
// product alone (on the card, NVIDIA H100 80GB HBM3, 700 W,
// gram_epilogue_variants.py).

constexpr int kGramTile = 128;    // rows of a partial (the walk's tile)

// Row stride of the staged U tile: k rounded up to 4 values, so that a
// thread reads 2 or 4 Gram rows' U values in one 8- or 16-byte load.
__host__ __device__ __forceinline__ int gram_ldu(int k) {
  return (k + 3) / 4 * 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from src into shared memory without waiting, or as
// many zero bytes when !live (source size 0; src is not read).
__device__ __forceinline__ void copy16_async(void* dst, const void* src,
                                             bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4_async(void* dst, const void* src,
                                            bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// Waits for this thread's copies (the block still needs a barrier before
// it reads the others').
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Starts the copies of U rows row0 .. row0 + rows - 1 (U: n x k fp32) into
// us (rows, gram_ldu(k)), zero past n and in the pad columns. `vec` (k %
// 4 == 0 and U 16-byte aligned: the rows are one contiguous run and ldu ==
// k): 16 bytes a copy; otherwise 4.
__device__ __forceinline__ void stage_u_async(const float* __restrict__ U,
                                              int row0, int rows, int n,
                                              int k, bool vec,
                                              float* __restrict__ us) {
  if (vec) {
    const long long live = row0 < n ? (long long)(n - row0) * k : 0;
    const float* base = U + (size_t)row0 * k;
    for (int c = 4 * threadIdx.x; c < rows * k; c += 4 * blockDim.x) {
      const bool in = c < live;
      copy16_async(us + c, in ? base + c : U, in);
    }
  } else {  // element e = r ldu + c, (r, c) stepped without a division
    const int ldu = gram_ldu(k);
    const int dr = blockDim.x / ldu, dc = blockDim.x % ldu;
    int r = threadIdx.x / ldu, c = threadIdx.x % ldu;
    for (int e = threadIdx.x; e < rows * ldu; e += blockDim.x) {
      const bool in = row0 + r < n && c < k;
      copy4_async(us + e, in ? U + (size_t)(row0 + r) * k + c : U, in);
      r += dr;
      c += dc;
      if (c >= ldu) {
        c -= ldu;
        ++r;
      }
    }
  }
}

// A tile's partial (k x k, at out) from shared memory: its U rows in us
// (128, ldu; zero past n and in the pad columns), its W rows in ws (128,
// ldw). Thread item q owns Gram rows i0 .. i0 + kTI - 1 and columns j0 ..
// j0 + 3, the block's threads striding the items, column blocks fastest.
// `vec_out`: 16-byte stores (k % 4 == 0, out 16-byte aligned).
template <int kTI>
__device__ __forceinline__ void gram_tile(const float* __restrict__ us,
                                          int ldu,
                                          const float* __restrict__ ws,
                                          int ldw, int k, bool vec_out,
                                          float* __restrict__ out) {
  static_assert(kTI == 1 || kTI == 2 || kTI == 4,
                "a thread owns 1, 2 or 4 Gram rows");
  const int bj = (k + 3) / 4;
  for (int q = threadIdx.x; q < (k + kTI - 1) / kTI * bj; q += blockDim.x) {
    const int i0 = kTI * (q / bj), j0 = 4 * (q % bj);
    const float* up = us + i0;
    const float* wp = ws + j0;
    float g[kTI][4];
#pragma unroll
    for (int a = 0; a < kTI; ++a)
      g[a][0] = g[a][1] = g[a][2] = g[a][3] = 0.f;
#pragma unroll(kTI == 1 ? 8 : 4)
    for (int r = 0; r < kGramTile; ++r) {
      float u[kTI];
      if constexpr (kTI == 4) {
        const float4 v = *reinterpret_cast<const float4*>(up + r * ldu);
        u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
      } else if constexpr (kTI == 2) {
        const float2 v = *reinterpret_cast<const float2*>(up + r * ldu);
        u[0] = v.x; u[1] = v.y;
      } else {
        u[0] = up[r * ldu];
      }
      const float4 w = *reinterpret_cast<const float4*>(wp + r * ldw);
#pragma unroll
      for (int a = 0; a < kTI; ++a) {
        g[a][0] = fmaf(u[a], w.x, g[a][0]);
        g[a][1] = fmaf(u[a], w.y, g[a][1]);
        g[a][2] = fmaf(u[a], w.z, g[a][2]);
        g[a][3] = fmaf(u[a], w.w, g[a][3]);
      }
    }
#pragma unroll
    for (int a = 0; a < kTI; ++a) {
      const int i = i0 + a;
      if (i >= k) continue;
      if (vec_out) {
        *reinterpret_cast<float4*>(out + (size_t)i * k + j0) =
            make_float4(g[a][0], g[a][1], g[a][2], g[a][3]);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (j0 + b < k) out[(size_t)i * k + j0 + b] = g[a][b];
      }
    }
  }
}

// The product with the Gram: block t owns tile t. It starts the copies
// of the tile's U rows (Uf, the unrounded fp32 U; `stage_vec` as for
// stage_u_async), runs the product over its rows in passes of
// blockDim.x / lanes (the row-wise kernel's rows a block), each row's
// outputs written to W and kept in shared memory, then waits for the
// copies and computes the tile's partial from both. Two tiles a block
// (their products, then their partials: twice the epilogue's items) won
// 4% on the 300k cluster core at k = 20 (0.0648 against 0.0672 ms) and
// lost at k = 60 (0.3089 against 0.2205: twice the shared memory, one
// block an SM) and on K_blk at k = 10 (0.0132 against 0.0096: half the
// blocks; on the card, NVIDIA H100 80GB HBM3, 700 W,
// gram_epilogue_variants.py). Keeping W in the product's blocks beat a
// second kernel that read the fresh W back from L2 tile by tile at every
// shape timed, fp32 and bf16 (on the card, NVIDIA H100 80GB HBM3, 700 W,
// polish_products.py --gram: K_blk at k = 10 0.0100 against 0.0128 ms,
// the 300k rolling band at k = 20 0.0741 against 0.0968 in fp32, 0.0973
// against 0.1031 in bf16), by the launch and the W and U tile reads it
// saves.
template <typename ValT, typename UT, bool kVecU, bool kVecW, int kC,
          int kTI>
__global__ void __launch_bounds__(kRowsThreads, 2)
rows_gram_kernel(const ValT* __restrict__ val, const int* __restrict__ idx,
                 const long long* __restrict__ slice_start,
                 const UT* __restrict__ U, int ld,
                 const float* __restrict__ Uf, float* __restrict__ W,
                 float* __restrict__ partial, int n, int k, int lanes,
                 bool stage_vec, bool vec_out) {
  extern __shared__ float4 gram_smem4[];
  float* us = reinterpret_cast<float*>(gram_smem4);
  const int ldu = gram_ldu(k), ldw = lanes * kC;
  float* ws = us + (size_t)kGramTile * ldu;
  const int row0 = blockIdx.x * kGramTile;
  stage_u_async(Uf, row0, kGramTile, n, k, stage_vec, us);
  const int rows = blockDim.x / lanes;
  const int c0 = kC * (threadIdx.x % lanes);
  for (int p = 0; p < kGramTile; p += rows) {
    const int r = p + threadIdx.x / lanes;
    float acc[kC];
    if (row0 + r < n) {
      row_sum<ValT, UT, kVecU, kC>(val, idx, slice_start, U, ld, row0 + r,
                                   n, k, c0, acc);
      store_row<kVecW, kC>(W, row0 + r, k, c0, acc);
    } else {
#pragma unroll
      for (int j = 0; j < kC; ++j) acc[j] = 0.f;
    }
    float4* wr = reinterpret_cast<float4*>(ws + (size_t)r * ldw + c0);
#pragma unroll
    for (int h = 0; h < kC / 4; ++h)
      wr[h] = make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2],
                          acc[4 * h + 3]);
  }
  copies_wait();
  __syncthreads();
  gram_tile<kTI>(us, ldu, ws, ldw, k, vec_out,
                 partial + (size_t)blockIdx.x * k * k);
}

// U's bf16 copy: out (n_u, ld) with out[r, c] = U[r, c] rounded to
// nearest even for c < k and 0 in the pad columns k <= c < ld (ld a
// multiple of 8). One thread writes 8 values (a 16-byte store) from two
// 16-byte loads of U when `vec` (k % 4 == 0, U 16-byte aligned) and the
// group lies inside the row, over a grid that strides the groups.
__global__ void __launch_bounds__(256)
round_kernel(const float* __restrict__ U, bf16_bits* __restrict__ out,
             int n_u, int k, int ld, bool vec) {
  const int groups = ld / 8;
  const size_t count = (size_t)n_u * groups;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < count;
       q += stride) {
    const size_t r = q / groups;
    const int c0 = 8 * (int)(q % groups);
    const float* p = U + r * k + c0;
    float x[8];
    if (vec && c0 + 8 <= k) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = c0 + j < k ? __ldg(p + j) : 0.f;
    }
    uint4 w;
    w.x = bits_bf16(x[0]) | (unsigned)bits_bf16(x[1]) << 16;
    w.y = bits_bf16(x[2]) | (unsigned)bits_bf16(x[3]) << 16;
    w.z = bits_bf16(x[4]) | (unsigned)bits_bf16(x[5]) << 16;
    w.w = bits_bf16(x[6]) | (unsigned)bits_bf16(x[7]) << 16;
    reinterpret_cast<uint4*>(out + r * ld)[c0 / 8] = w;
  }
}

// Rows of a row-wise block for `lanes` lanes a row: the most of 64, 32,
// 16 and 8 that keep the block within kRowsThreads threads.
inline int rows_per_block(int lanes) {
  int r = 64;
  while (r > 8 && r * lanes > kRowsThreads) r /= 2;
  return r;
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<size_t>(p) % bytes == 0;
}

// Row stride of U's bf16 copy: k rounded up to 8 values (16 bytes).
inline int copy_ld(int k) { return (k + 7) / 8 * 8; }

// Widest product whose Gram the row-wise route takes: a tile's U and W
// rows in shared memory, 128 KB at k = 128.
constexpr int kRowsGramMaxK = 128;

// Gram rows a thread owns in the epilogue (gram_tile's kTI), by k.
inline int gram_thread_rows(int k) { return k > 32 ? 4 : k > 16 ? 2 : 1; }

// A kernel's dynamic shared memory above the default 48 KB needs the
// attribute, once per kernel (`granted`: the most granted so far).
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

template <typename ValT, typename UT, bool kVecU, bool kVecW, int kC,
          int kTI>
cudaError_t launch_rows_gram_t(const ValT* val, const int* idx,
                               const long long* slice_start, const UT* U,
                               int ld, const float* Uf, float* W,
                               float* partial, int n, int k, int lanes,
                               int rows, int n_tiles, cudaStream_t s) {
  auto kernel = rows_gram_kernel<ValT, UT, kVecU, kVecW, kC, kTI>;
  static size_t granted = 48 * 1024;
  const size_t bytes = sizeof(float) * kGramTile * (gram_ldu(k) + lanes * kC);
  const cudaError_t err = grant_smem(kernel, bytes, granted);
  if (err != cudaSuccess) return err;
  const bool stage_vec = k % 4 == 0 && aligned(Uf, 16);
  const bool vec_out = k % 4 == 0 && aligned(partial, 16);
  kernel<<<(unsigned)n_tiles, rows * lanes, bytes, s>>>(
      val, idx, slice_start, U, ld, Uf, W, partial, n, k, lanes, stage_vec,
      vec_out);
  return cudaGetLastError();
}

template <typename ValT, typename UT, bool kVecU, bool kVecW, int kC>
cudaError_t launch_rows_gram_k(const ValT* val, const int* idx,
                               const long long* slice_start, const UT* U,
                               int ld, const float* Uf, float* W,
                               float* partial, int n, int k, int lanes,
                               int rows, int n_tiles, cudaStream_t s) {
#define EPK_GRAM_ARGS \
  val, idx, slice_start, U, ld, Uf, W, partial, n, k, lanes, rows, n_tiles, s
  switch (gram_thread_rows(k)) {
    case 4:
      return launch_rows_gram_t<ValT, UT, kVecU, kVecW, kC, 4>(EPK_GRAM_ARGS);
    case 2:
      return launch_rows_gram_t<ValT, UT, kVecU, kVecW, kC, 2>(EPK_GRAM_ARGS);
    default:
      return launch_rows_gram_t<ValT, UT, kVecU, kVecW, kC, 1>(EPK_GRAM_ARGS);
  }
#undef EPK_GRAM_ARGS
}

// The product, and with `partial` the tiles' Gram partials from the fp32
// U (Uf), in the product's blocks.
template <typename ValT, typename UT, bool kVecU, int kC>
cudaError_t launch_rows_t(const void* val, const int* idx,
                          const long long* slice_start, const UT* U, int ld,
                          const float* Uf, float* W, float* partial, int n,
                          int n_u, int k, int n_tiles, cudaStream_t s) {
  const int lanes = (k + kC - 1) / kC;
  const int rows = rows_per_block(lanes);
  const unsigned grid = (unsigned)((n + rows - 1) / rows);
  const ValT* v = static_cast<const ValT*>(val);
  const bool vec_w = k % 4 == 0 && aligned(W, 16);
  if (partial != nullptr) {
    return vec_w ? launch_rows_gram_k<ValT, UT, kVecU, true, kC>(
                       v, idx, slice_start, U, ld, Uf, W, partial, n, k,
                       lanes, rows, n_tiles, s)
                 : launch_rows_gram_k<ValT, UT, kVecU, false, kC>(
                       v, idx, slice_start, U, ld, Uf, W, partial, n, k,
                       lanes, rows, n_tiles, s);
  }
  if (vec_w)
    rows_kernel<ValT, UT, kVecU, true, kC>
        <<<grid, rows * lanes, 0, s>>>(v, idx, slice_start, U, ld, W, n, n_u,
                                       k, lanes);
  else
    rows_kernel<ValT, UT, kVecU, false, kC>
        <<<grid, rows * lanes, 0, s>>>(v, idx, slice_start, U, ld, W, n, n_u,
                                       k, lanes);
  return cudaGetLastError();
}

// W (n, k) = A U from the table (the table covers rows [0, n) at least),
// U (n_u, k) fp32; 1 <= k <= kRowsMaxK, on a card of `sms` SMs. An fp32
// table (val_is_bf16 0) multiplies U as it is. A bf16 table multiplies U
// rounded to bf16: round_kernel writes the rounded U into U_bf16 ((n_u,
// copy_ld(k)), 2 bytes a value, 16-byte aligned) first, over at most 16
// blocks an SM, and the product reads it, 8 columns a lane. With
// `partial` ((n_tiles, k, k) fp32; a square operator, n_u == n, k <=
// kRowsGramMaxK, n_tiles >= ceil(n / 128)) also each 128-row tile's
// partial of U^T W, from the unrounded U.
inline cudaError_t launch_rows_impl(const void* val, int val_is_bf16,
                                    const int* idx,
                                    const long long* slice_start,
                                    const float* U, bf16_bits* U_bf16,
                                    float* W, float* partial, int n, int n_u,
                                    int k, int n_tiles, int sms,
                                    cudaStream_t s) {
  if (k < 1 || k > kRowsMaxK || n < 1 || n_u < 1 || sms < 1)
    return cudaErrorInvalidValue;
  if (partial != nullptr
      && (n_u != n || k > kRowsGramMaxK
          || (size_t)n_tiles * kGramTile < (size_t)n))
    return cudaErrorInvalidValue;
  const bool vec_u = k % 4 == 0 && aligned(U, 16);
  if (!val_is_bf16) {
    return vec_u ? launch_rows_t<float, float, true, 4>(
                       val, idx, slice_start, U, k, U, W, partial, n, n_u, k,
                       n_tiles, s)
                 : launch_rows_t<float, float, false, 4>(
                       val, idx, slice_start, U, k, U, W, partial, n, n_u, k,
                       n_tiles, s);
  }
  if (U_bf16 == nullptr || !aligned(U_bf16, 16)) return cudaErrorInvalidValue;
  const int ld = copy_ld(k);
  const size_t groups = (size_t)n_u * (ld / 8);
  const size_t most = (size_t)sms * 16;
  const unsigned blocks = (unsigned)std::min((groups + 255) / 256, most);
  round_kernel<<<blocks, 256, 0, s>>>(U, U_bf16, n_u, k, ld, vec_u);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_rows_t<bf16_bits, bf16_bits, true, 8>(
      val, idx, slice_start, U_bf16, ld, U, W, partial, n, n_u, k, n_tiles,
      s);
}

inline cudaError_t launch_rows(const void* val, int val_is_bf16,
                               const int* idx, const long long* slice_start,
                               const float* U, bf16_bits* U_bf16, float* W,
                               int n, int n_u, int k, int sms,
                               cudaStream_t s) {
  return launch_rows_impl(val, val_is_bf16, idx, slice_start, U, U_bf16, W,
                          nullptr, n, n_u, k, 0, sms, s);
}

}  // namespace nz
