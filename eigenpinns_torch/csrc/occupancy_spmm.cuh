// The inner loops shared by the strip-BSR kernels (bsr_spmm.cu) and the
// band kernels (banded_spmm.cu: the full-window band and the rolling
// band): one warp's 16-row stripe of a 128-row tile times the U rows of
// the stripe's occupied 16 x 16 sub-blocks, and the fused Gram's
// epilogue (tile_gram, at the end).
//
// Both layouts are dense and mostly zero (13-22% of the 16 x 16
// sub-blocks of a 300k-point cloud Laplacian hold a nonzero), and both
// come with an occupancy table (eigenpinns_torch/sparse/occupancy.py):
// one 64-bit word per 128 x 128 piece, bit 8 i + j set when sub-block
// (i, j) holds a nonzero. Byte i of a word (little-endian) is therefore
// the column-group mask of row stripe i, and warp i of a block reads
// exactly that byte.
//
// A row tile's pieces are a contiguous range [q0, q1) of the table (the
// slots of its chunks, or the 128-column pieces of its window). The warp
// takes them 32 at a time, one per lane: each lane reads its piece's
// byte and, when it is not 0, the piece's U row and data offset (the
// caller's `piece` functor: the cid or group-table lookup, or the window
// start; a rolling window may start before U's row 0 or end past its
// last row, and U rows outside [0, n_urows) read as zero). A warp scan turns the bytes into a list of (lane, sub-block)
// entries in shared memory, in piece order, so the product is summed in
// the same order whatever the column block, and bit for bit the same
// from run to run. For each entry the warp reads the 16 x 16 sub-block
// straight from the dense layout (16 rows of 64 B in fp32, 32 B in bf16:
// whole 32-byte sectors) and 16 rows of U, 32 or 64 columns wide. The
// next entry's sub-block and U rows are loaded into registers before the
// current entry is multiplied, so its loads are in flight during the
// arithmetic. No block-wide barrier.
//
// fp32 data (exact FFMA). Every lane needs every value of the sub-block,
// so it goes through a per-warp shared-memory stage and is read back as
// broadcast 16-byte loads; lane l owns all 16 rows of column l (32
// columns per block) or of columns l and l + 32 (64 per block). A
// sub-block of a cloud Laplacian holds about 12 nonzeros of 256, so most
// of its 64 (row, 4 columns) groups are zero: the lane that loaded a
// group from global memory votes on it (two ballots per sub-block), and
// the warp skips a zero group as a whole, its shared-memory load and its
// 4 or 8 FFMA (a warp-uniform branch). Adding an exact zero changes no
// sum, so the product is the same bit for bit with or without the skip.
//
// The band kernels (banded_spmm.cu) take this walk for a bf16 band and
// for a product wider than one column block. An fp32 band whose product
// fits one column block takes their staged route instead: the same
// entries summed in the same order with the same zero-group skip, but
// each piece's U groups copied once into shared memory for all the
// stripes of a block, and several sub-blocks of a stripe in flight by
// cp.async, so W has this walk's bits either way.
//
// bf16 data (U rounded to bf16, fp32 accumulation). Tensor cores:
// mma.sync.m16n8k16 takes the 16 x 16 sub-block as its A operand and 8
// columns of the 16 rounded U rows as B. Both fragments are loaded
// straight from global memory in the layout the instruction wants (A: 4
// words a lane; B: 4 fp32 values a lane and 8 columns, packed to bf16
// pairs), so this path uses no shared-memory stage at all, and column
// groups of 8 that lie past k are skipped.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace occ {

constexpr int kT = 128;          // edge of the piece one table word covers
constexpr int kSub = 16;         // edge of a sub-block
constexpr int kThreads = 256;    // 8 warps, one per 16-row stripe
constexpr int kBatch = 32;       // pieces listed at a time: one per lane
constexpr unsigned kFull = 0xffffffffu;

// Per-warp shared memory: two fp32 stages of one sub-block (fp32 data
// only), and the entry list of one batch of pieces ((lane << 3) |
// sub-block column).
struct __align__(16) WarpScratch {
  float a[2][kSub][kSub];
  unsigned short list[kBatch * 8];
};

// Which outputs of the stripe's 16 x (32 kCols) block a lane's
// accumulators hold: acc[i] is (row(i), col(i)), both relative.
template <typename DataT, int kCols>
struct Layout;

template <int kCols>
struct Layout<float, kCols> {   // rows r, columns l + 32 c
  static __device__ __forceinline__ int row(int i, int) { return i / kCols; }
  static __device__ __forceinline__ int col(int i, int lane) {
    return lane + 32 * (i % kCols);
  }
};

template <int kCols>
struct Layout<__nv_bfloat16, kCols> {  // the mma.m16n8 C fragment, 8-column
  static __device__ __forceinline__ int row(int i, int lane) {  // group i/4
    return (lane >> 2) + 8 * ((i >> 1) & 1);
  }
  static __device__ __forceinline__ int col(int i, int lane) {
    return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
  }
};

// The band kernels' staged route, fp32: lane l owns the kCols adjacent
// columns kCols l .. kCols l + kCols - 1, so its U values of a row are
// one vector load from shared memory.
template <int kCols>
struct PairLayout {
  static __device__ __forceinline__ int row(int i, int) { return i / kCols; }
  static __device__ __forceinline__ int col(int i, int lane) {
    return kCols * lane + i % kCols;
  }
};

// Lists the occupied sub-blocks of pieces [qb, min(qb + 32, q1)) of this
// warp's stripe into ws.list, in piece order; returns their number.
// Lane l keeps piece qb + l's first U row and data offset in ub and off.
template <typename PieceFn>
__device__ __forceinline__ int list_batch(
    const unsigned char* __restrict__ occupancy, int qb, int q1,
    PieceFn piece, WarpScratch& ws, int& ub, long long& off) {
  const int lane = threadIdx.x & 31;
  const int q = qb + lane;
  unsigned bits = 0;
  ub = 0;
  off = 0;
  if (q < q1) {
    bits = occupancy[(size_t)q * 8 + (threadIdx.x >> 5)];
    if (bits) piece(q, ub, off);
  }
  // Exclusive scan of the lanes' sub-block counts -> list positions.
  const int cnt = __popc(bits);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  int pos = incl - cnt;
  while (bits) {
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    ws.list[pos++] = (unsigned short)((lane << 3) | j);
  }
  __syncwarp();
  return __shfl_sync(kFull, incl, 31);
}

// ---- fp32 data: FFMA from a shared-memory stage ------------------------

// One fp32 sub-block in flight: 16 bytes per lane and instruction.
struct SubRegs {
  float4 v[2];  // rows lane / 4 and 8 + lane / 4, columns 4 (lane % 4) ..
  __device__ __forceinline__ void load(const float* __restrict__ p,
                                       size_t ld, int lane) {
    const float* q = p + (size_t)(lane >> 2) * ld + (lane & 3) * 4;
    v[0] = __ldg(reinterpret_cast<const float4*>(q));
    v[1] = __ldg(reinterpret_cast<const float4*>(q + 8 * ld));
  }
  // Whether the 4 values of v[i] hold a nonzero.
  __device__ __forceinline__ bool any(int i) const {
    return v[i].x != 0.f || v[i].y != 0.f || v[i].z != 0.f || v[i].w != 0.f;
  }
  __device__ __forceinline__ void store(float (*a)[kSub], int lane) const {
    *reinterpret_cast<float4*>(&a[lane >> 2][(lane & 3) * 4]) = v[0];
    *reinterpret_cast<float4*>(&a[8 + (lane >> 2)][(lane & 3) * 4]) = v[1];
  }
};

// acc[kCols r + c] += sum over the occupied sub-blocks of pieces [q0, q1)
// of this warp's stripe, for the outputs Layout<float, kCols> names.
// `piece(q, ub, off)` gives piece q's first U row and the element offset
// in `data` of the stripe's first row at the piece's first column;
// `occupancy` is the table as bytes. Must be called by all 32 lanes.
template <bool kRoundU, int kCols, typename PieceFn>
__device__ __forceinline__ void stripe_product(
    const float* __restrict__ data, size_t ld,
    const unsigned char* __restrict__ occupancy, int q0, int q1,
    PieceFn piece, const float* __restrict__ U, int n_urows, int k,
    int col0, WarpScratch& ws, float (&acc)[kSub * kCols]) {
  static_assert(!kRoundU, "fp32 data multiplies the unrounded U");
  using L = Layout<float, kCols>;
  const int lane = threadIdx.x & 31;
  // This lane's output columns, as offsets into a row of U (-1: past k,
  // reads as zero).
  int ucol[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = col0 + L::col(c, lane);
    ucol[c] = col < k ? col : -1;
  }

  for (int qb = q0; qb < q1; qb += kBatch) {
    int ub;
    long long off;
    const int total = list_batch(occupancy, qb, q1, piece, ws, ub, off);

    SubRegs a_next;
    float u_next[kSub][kCols];
    auto fetch = [&](int e) {
      const int id = ws.list[e];
      const int j = id & 7;
      const int urow0 = __shfl_sync(kFull, ub, id >> 3) + j * kSub;
      const long long off_e = __shfl_sync(kFull, off, id >> 3);
      a_next.load(data + off_e + j * kSub, ld, lane);
      const float* up = U + (long long)urow0 * k;
#pragma unroll
      for (int kk = 0; kk < kSub; ++kk) {
        const bool live = (unsigned)(urow0 + kk) < (unsigned)n_urows;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          u_next[kk][c] = live && ucol[c] >= 0
                              ? __ldg(up + (size_t)kk * k + ucol[c]) : 0.f;
      }
    };
    if (total > 0) fetch(0);
    for (int e = 0; e < total; ++e) {
      float(*a)[kSub] = ws.a[e & 1];
      a_next.store(a, lane);
      // Bit 4 r + q of nz: the group of row r, columns 4 q .. 4 q + 3 of
      // the sub-block holds a nonzero. Lane l loaded groups (l / 4, l % 4)
      // and (8 + l / 4, l % 4).
      const unsigned lo = __ballot_sync(kFull, a_next.any(0));
      const unsigned hi = __ballot_sync(kFull, a_next.any(1));
      const unsigned long long nz = ((unsigned long long)hi << 32) | lo;
      float u[kSub][kCols];
#pragma unroll
      for (int kk = 0; kk < kSub; ++kk) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) u[kk][c] = u_next[kk][c];
      }
      // The stage written two entries ago is free: every lane passed the
      // barrier of the entry between.
      __syncwarp();
      if (e + 1 < total) fetch(e + 1);
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
#pragma unroll
        for (int q4 = 0; q4 < kSub / 4; ++q4) {
          if (!((nz >> (4 * r + q4)) & 1)) continue;  // warp-uniform
          const float4 av = *reinterpret_cast<const float4*>(&a[r][4 * q4]);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float s = acc[kCols * r + c];
            s = fmaf(av.x, u[4 * q4][c], s);
            s = fmaf(av.y, u[4 * q4 + 1][c], s);
            s = fmaf(av.z, u[4 * q4 + 2][c], s);
            s = fmaf(av.w, u[4 * q4 + 3][c], s);
            acc[kCols * r + c] = s;
          }
        }
      }
    }
    __syncwarp();  // the list and the stages are reused by the next batch
  }
}

// ---- bf16 data: mma.sync.m16n8k16, fragments straight from global ------

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product for bf16 data: acc[4 nb + i] is element i of the C
// fragment of column group nb (Layout<__nv_bfloat16, kCols>). U is
// rounded to bf16 (round to nearest even, as torch does).
template <bool kRoundU, int kCols, typename PieceFn>
__device__ __forceinline__ void stripe_product(
    const __nv_bfloat16* __restrict__ data, size_t ld,
    const unsigned char* __restrict__ occupancy, int q0, int q1,
    PieceFn piece, const float* __restrict__ U, int n_urows, int k,
    int col0, WarpScratch& ws, float (&acc)[kSub * kCols]) {
  static_assert(kRoundU, "bf16 data multiplies U rounded to bf16");
  constexpr int kGroups = 4 * kCols;  // column groups of 8
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // Column groups that hold a column < k (the rest are skipped), and this
  // lane's B column in each group (-1: past k, reads as zero).
  const int n_live = min(kGroups, (k - col0 + 7) / 8);
  int ucol[kGroups];
#pragma unroll
  for (int nb = 0; nb < kGroups; ++nb) {
    const int col = col0 + 8 * nb + g;
    ucol[nb] = col < k ? col : -1;
  }

  for (int qb = q0; qb < q1; qb += kBatch) {
    int ub;
    long long off;
    const int total = list_batch(occupancy, qb, q1, piece, ws, ub, off);

    unsigned a_next[4];
    float u_next[kGroups][4];  // B rows 2t, 2t + 1, 2t + 8, 2t + 9
    auto fetch = [&](int e) {
      const int id = ws.list[e];
      const int j = id & 7;
      const int urow0 = __shfl_sync(kFull, ub, id >> 3) + j * kSub;
      const long long off_e = __shfl_sync(kFull, off, id >> 3);
      // A fragment: rows g and g + 8, column pairs 2t and 2t + 8.
      const __nv_bfloat16* ap = data + off_e + j * kSub + (size_t)g * ld
                                + 2 * t;
      a_next[0] = __ldg(reinterpret_cast<const unsigned*>(ap));
      a_next[1] = __ldg(reinterpret_cast<const unsigned*>(ap + 8 * ld));
      a_next[2] = __ldg(reinterpret_cast<const unsigned*>(ap + 8));
      a_next[3] = __ldg(reinterpret_cast<const unsigned*>(ap + 8 * ld + 8));
      const float* up = U + (long long)(urow0 + 2 * t) * k;
      const bool whole = urow0 >= 0 && urow0 + kSub <= n_urows;  // uniform
#pragma unroll
      for (int nb = 0; nb < kGroups; ++nb) {
        if (nb < n_live) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int dr = (i & 1) + 8 * (i >> 1);
            const bool live = ucol[nb] >= 0
                              && (whole || (unsigned)(urow0 + 2 * t + dr)
                                               < (unsigned)n_urows);
            u_next[nb][i] = live ? __ldg(up + (size_t)dr * k + ucol[nb]) : 0.f;
          }
        }
      }
    };
    if (total > 0) fetch(0);
    for (int e = 0; e < total; ++e) {
      unsigned a[4], b[kGroups][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_next[i];
#pragma unroll
      for (int nb = 0; nb < kGroups; ++nb) {
        if (nb < n_live) {
          b[nb][0] = pack_bf16(u_next[nb][0], u_next[nb][1]);
          b[nb][1] = pack_bf16(u_next[nb][2], u_next[nb][3]);
        }
      }
      if (e + 1 < total) fetch(e + 1);
#pragma unroll
      for (int nb = 0; nb < kGroups; ++nb) {
        if (nb < n_live) {
          float(&c)[4] = *reinterpret_cast<float(*)[4]>(&acc[4 * nb]);
          mma_bf16(c, a, b[nb][0], b[nb][1]);
        }
      }
    }
    __syncwarp();  // the list is reused by the next batch
  }
}

// W[row0 + row(i), col0 + col(i)] = acc[i] for the rows and columns that
// exist, in the accumulators' layout L.
template <typename DataT, int kCols, typename L = Layout<DataT, kCols>>
__device__ __forceinline__ void store_stripe(float* __restrict__ W, int row0,
                                             int n, int k, int col0,
                                             const float (&acc)[kSub * kCols]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kSub * kCols; ++i) {
    const int row = row0 + L::row(i, lane);
    const int col = col0 + L::col(i, lane);
    if (row < n && col < k) W[(size_t)row * k + col] = acc[i];
  }
}

// ---- the fused Gram's epilogue ------------------------------------------

constexpr int kGramPanel = 32;  // U columns (Gram rows) staged at a time

// Row stride of the staged W tile: odd for 32 columns (no bank conflicts
// whatever the accumulator layout), 64 for 64 columns (the two stages
// then fill the 48 KB of static shared memory exactly).
template <int kCols>
constexpr int kGramLd = kCols == 1 ? 33 : 64;

// Floats of shared memory tile_gram needs: the U panel, then the W tile.
template <int kCols>
constexpr int kGramFloats = kT * (kGramPanel + kGramLd<kCols>);

// out[i, col0 + c] = sum over the tile's 128 rows r of U[row0 + r, i] *
// W[row0 + r, col0 + c] for i < k: the tile's partial Gram, from the
// block's W tile (acc, in Layout<DataT, kCols>) and the tile's own,
// unrounded U rows. Exact fp32 FFMA, rows summed in order.
//
// The W tile (128 x 32 kCols) and, 32 columns at a time, the tile's U
// rows (128 x 32) go through shared memory with coalesced loads; `smem`
// starts at the warps' scratch, which the product no longer needs. Warp
// w owns Gram rows 4 w .. 4 w + 3 of the panel in registers and lane c
// columns c (and c + 32): per row of the tile one broadcast 16-byte
// load of U and one conflict-free load of W per column feed 4 FFMA per
// column. Shared memory per block: 32.5 KB at 32 columns, 48 KB at 64,
// whatever k (k = 128 is four panels), so it never limits the blocks
// per SM below the launch bounds' two or three. Must be called by the
// whole block of kBlockThreads threads; warps 0..7 hold the tile's
// stripes, and a warp past them (the staged kernel's copy warp) only
// helps stage U. L is the accumulators' layout.
template <typename DataT, int kCols, int kBlockThreads = kThreads,
          typename L = Layout<DataT, kCols>>
__device__ __forceinline__ void tile_gram(
    const float (&acc)[kSub * kCols], const float* __restrict__ U, int row0,
    int n, int k, int col0, float* __restrict__ smem,
    float* __restrict__ out) {
  constexpr int kLd = kGramLd<kCols>;
  float(*us)[kGramPanel] = reinterpret_cast<float(*)[kGramPanel]>(smem);
  float(*ws)[kLd] = reinterpret_cast<float(*)[kLd]>(smem + kT * kGramPanel);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stripe_warp = warp < kT / kSub;
  __syncthreads();  // every warp is done with the scratch
  if (stripe_warp) {
#pragma unroll
    for (int i = 0; i < kSub * kCols; ++i) {
      const int row = warp * kSub + L::row(i, lane);
      ws[row][L::col(i, lane)] = row0 + row < n ? acc[i] : 0.f;
    }
  }
  for (int p0 = 0; p0 < k; p0 += kGramPanel) {
    if (p0 > 0) __syncthreads();  // the last panel has been used
    for (int e = tid; e < kT * kGramPanel; e += kBlockThreads) {
      const int r = e / kGramPanel, i = p0 + e % kGramPanel;
      us[r][e % kGramPanel] =
          row0 + r < n && i < k ? __ldg(U + (size_t)(row0 + r) * k + i) : 0.f;
    }
    __syncthreads();
    if (!stripe_warp || p0 + 4 * warp >= k) continue;  // warp-uniform
    float g[kCols][4];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      g[c][0] = g[c][1] = g[c][2] = g[c][3] = 0.f;
#pragma unroll 8
    for (int r = 0; r < kT; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(&us[r][4 * warp]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float w = ws[r][lane + 32 * c];
        g[c][0] = fmaf(u.x, w, g[c][0]);
        g[c][1] = fmaf(u.y, w, g[c][1]);
        g[c][2] = fmaf(u.z, w, g[c][2]);
        g[c][3] = fmaf(u.w, w, g[c][3]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = col0 + lane + 32 * c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = p0 + 4 * warp + j;
        if (i < k && col < k) out[(size_t)i * k + col] = g[c][j];
      }
    }
  }
}

}  // namespace occ
