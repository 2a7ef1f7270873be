// Full-window banded SpMM W = A U, and its fused k x k Gram, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of eigenpinns_tpu/sparse/banded.py:
//   banded_spmm_kernel<..., kGram = false>  <-  banded_spmm_pallas (K4)
//   banded_spmm_kernel<..., kGram = true>   <-  banded_spmm_gram_pallas (K5)
//
// Layout (built on the host by BandedELL.from_scipy or the core of
// SplitBanded.from_scipy): band is (n_pad, B) row-major, B a multiple of
// 128; row i of tile t = i / 128 multiplies the window
// U[starts[t] : starts[t] + B], so W[i, :] = sum_j band[i, j] U[starts[t]
// + j, :]. starts is clamped to n_pad - B, so a window may reach past n:
// those U rows read as zero (no padded copy of U is made).
//
// The Pallas kernels walked the tiles in order on a sequential grid,
// double-buffering each tile's U window into VMEM and (K5) carrying the
// Gram in a VMEM-resident output across the grid. CUDA blocks run in no
// order, so each block owns one (128-row tile, 32-column block) pair: it
// streams the tile's (128, B) band rows and the matching U window rows
// through shared memory in slabs of 32 along B and accumulates in fp32
// registers. Any k works, in masked blocks of 32 columns (no padding of
// k to 128 lanes). Offsets into the band are 64-bit: at 1M rows and
// B = 1024 the band holds 1.0e9 elements.
//
// K5's Gram: each block writes the partial U[tile]^T W[tile, cols] of its
// tile (from the fp32 W in registers and the tile's own, unrounded U
// rows) into partial[t] (n_tiles, k, k); a second kernel sums the
// partials in a fixed order, so G is the same bit for bit from run to
// run (no fp32 atomics).
//
// Work split: 256 threads; thread (ty, tx) = (tid / 8, tid % 8) holds the
// 4 x 4 outputs of rows ty + 32 i and columns 4 tx + j. Each slab stages
// the 128 x 32 band slice (16-byte loads, converted to fp32) and the
// 32 x 32 U slice, then every thread does 16 FFMA per reduction step.
//
// What bounds it: the band is dense, so the kernel reads every band
// entry and executes 2 n_pad B k FLOP where the product needs only the
// nonzeros and 2 nnz k. At 300k points with the cluster core (B = 1024,
// fp32, 2.16M nonzeros) and k = 60 the product must move ~0.16 GB (each
// nonzero with its column index, U and W): 0.05 ms at 3.35 TB/s. The
// kernel moves ~1.37 GB (the 1.229 GB band, U and W; 0.41 ms) and its
// 36.9 GFLOP of FFMA take >= 0.55 ms at the 67 TFLOP/s fp32 peak, more
// at the ~40% of peak this staging reaches (see bsr_spmm.cu): the band's
// zeros, multiplied by FFMA, set its time. The design is the simple one:
// no skipping of the band's all-zero slabs, no double-buffered slabs, no
// tensor cores for a bf16 band.
//
// Precision: an fp32 band is exact fp32 FFMA (the TPU's
// Precision.HIGHEST). A bf16 band rounds U to bf16 before the product and
// accumulates in fp32, as both Pallas kernels do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 128;        // rows per tile
constexpr int kBN = 32;        // output columns per block
constexpr int kBK = 32;        // band columns per shared-memory slab
constexpr int kThreads = 256;  // 8 warps
constexpr int kTM = 4;         // rows per thread: ty + 32 i
constexpr int kTN = 4;         // columns per thread: 4 tx + j

// Stage band[0:128, 0:32] (row pitch ld) into As as fp32.
__device__ __forceinline__ void load_slab(const float* __restrict__ band,
                                          size_t ld, float (*As)[kBK + 1],
                                          int tid) {
#pragma unroll
  for (int it = 0; it < kT * kBK / 4 / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int m = e >> 3;          // 8 threads per row
    const int q = (e & 7) * 4;
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(band + (size_t)m * ld + q));
    As[m][q] = v.x;
    As[m][q + 1] = v.y;
    As[m][q + 2] = v.z;
    As[m][q + 3] = v.w;
  }
}

__device__ __forceinline__ void load_slab(
    const __nv_bfloat16* __restrict__ band, size_t ld, float (*As)[kBK + 1],
    int tid) {
#pragma unroll
  for (int it = 0; it < kT * kBK / 8 / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int m = e >> 2;          // 4 threads per row
    const int q = (e & 3) * 8;
    const uint4 raw =
        __ldg(reinterpret_cast<const uint4*>(band + (size_t)m * ld + q));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int c = 0; c < 8; ++c) As[m][q + c] = __bfloat162float(h[c]);
  }
}

template <typename BandT, bool kRoundU, bool kGram>
__global__ void __launch_bounds__(kThreads)
banded_spmm_kernel(const BandT* __restrict__ band,
                   const int* __restrict__ starts,
                   const float* __restrict__ U, float* __restrict__ W,
                   float* __restrict__ partial, int n, int B, int k,
                   int n_cb) {
  __shared__ float As[kT][kBK + 1];  // +1: conflict-free staging writes
  __shared__ __align__(16) float Us[kBK][kBN];

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int t = blockIdx.x / n_cb;   // row tile; its column blocks are
  const int cb = blockIdx.x % n_cb;  // neighbours and share it through L2
  const int col0 = cb * kBN;
  const int row0 = t * kT;
  const int start = starts[t];
  const size_t ld = (size_t)B;
  const BandT* tile_band = band + (size_t)row0 * ld;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int kk0 = 0; kk0 < B; kk0 += kBK) {
    load_slab(tile_band + kk0, ld, As, tid);
#pragma unroll
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int kk = e / kBN, c = e % kBN;
      const int urow = start + kk0 + kk;
      const int col = col0 + c;
      float v = 0.f;
      if (urow < n && col < k) {
        v = __ldg(U + (size_t)urow * k + col);
        if (kRoundU) v = __bfloat162float(__float2bfloat16(v));
      }
      Us[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[ty + 32 * i][kk];
      const float4 b = *reinterpret_cast<const float4*>(&Us[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty + 32 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx * kTN + j;
      if (col < k) W[(size_t)row * k + col] = acc[i][j];
    }
  }
  if constexpr (kGram) {
    // Partial Gram of this tile and column block: U[rows, :]^T W[rows,
    // cols], with W staged in As (the slab loop has ended and
    // synchronised).
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const bool live = row0 + ty + 32 * i < n;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        As[ty + 32 * i][tx * kTN + j] = live ? acc[i][j] : 0.f;
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
        s = fmaf(__ldg(U + (size_t)(row0 + r) * k + i), As[r][c], s);
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

template <typename BandT, bool kRoundU>
cudaError_t launch(const void* band, const int* starts, const float* U,
                   float* W, float* partial, int n, int n_pad, int B, int k,
                   cudaStream_t s) {
  const int n_cb = (k + kBN - 1) / kBN;
  const dim3 grid((unsigned)(n_pad / kT) * n_cb);
  const BandT* b = static_cast<const BandT*>(band);
  if (partial != nullptr) {
    banded_spmm_kernel<BandT, kRoundU, true><<<grid, kThreads, 0, s>>>(
        b, starts, U, W, partial, n, B, k, n_cb);
  } else {
    banded_spmm_kernel<BandT, kRoundU, false><<<grid, kThreads, 0, s>>>(
        b, starts, U, W, partial, n, B, k, n_cb);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// W = A U (K4), and when partial and G are given also G = U^T A U (K5).
// Shapes: band (n_pad, B) fp32 or bf16, starts (n_pad / 128,) int32, U and
// W (n, k) fp32, partial (n_pad / 128, k, k) and G (k, k) fp32. The
// wrapper checks types, shapes, contiguity, B % 128 == 0 and 16-byte
// alignment of the band. Returns cudaGetLastError() after the launches.
int epk_banded_spmm(const void* band, int band_is_bf16, const int* starts,
                    const float* U, float* W, float* partial, float* G,
                    int n, int n_pad, int B, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      band_is_bf16
          ? launch<__nv_bfloat16, true>(band, starts, U, W, partial, n, n_pad,
                                        B, k, s)
          : launch<float, false>(band, starts, U, W, partial, n, n_pad, B, k,
                                 s);
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
