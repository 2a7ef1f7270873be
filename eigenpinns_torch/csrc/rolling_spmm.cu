// Rolling-window banded SpMM (and fused k x k Gram) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// eigenpinns_tpu/sparse/rolling.py::_rolling_kernel_call
// (public there as rolling_spmm_pallas / rolling_spmm_gram_pallas).
//
// Layout (built on the host by RollingBanded.from_scipy): band is
// (n_pad, bp) row-major, bp = B + tile. Row i's entry for column c sits
// at band[i, (c + pre) mod bp]. For the 128-row tile t that holds row i,
// band column j therefore multiplies original U row
//     t*tile + ((j - t*tile) mod bp) - pre,
// and rows outside [0, n) read as zero. The TPU kernel walked the tiles
// in order and kept a ring buffer of U in VMEM from one grid step to the
// next; CUDA blocks run in no order, so each block rebuilds the piece of
// the window it needs straight from U, and no padded copy of U is made.
//
// Work split: block (bx, by) computes output rows [32 bx, 32 bx + 32)
// (a quarter of one 128-row tile, so every block of a tile shares one
// window origin) and output columns [16 by, 16 by + 16). It walks the
// bp band columns in slices of 32: the band slice (32 x 32) and the 32
// matching U rows (32 x 16) are staged in shared memory and each of the
// 128 threads accumulates 4 outputs in fp32 registers with FFMA. Any k
// works: the last column chunk is masked, nothing is padded to 128.
//
// What bounds it: the band read. K_blk of the bench hierarchy is
// 4352 x 512 fp32 = 8.9 MB per product against ~0.2 MB of U and W at
// k = 10, so the kernel is memory-bound (~3 us at 3.35 TB/s); at k > 16
// the band is re-read once per 16-column chunk (L2-resident at this size).
//
// Precision: 'highest' and 'high' are both exact fp32 FFMA (the TPU's
// bf16x3 split was its way to near-f32 on the MXU). 'bf16' reads a bf16
// band and rounds U to bf16 before the product, accumulating in fp32, as
// the TPU kernel does.
//
// Gram (partial != nullptr): each block writes its partial
// U[rows]^T W[rows, cols] into partial[bx] (n_blocks, k, k); a second
// kernel sums the partials in block order, so G is reproducible from
// run to run (no fp32 atomics). The Gram uses the unrounded U.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;     // output rows per block
constexpr int kCols = 16;     // output columns per block
constexpr int kSlice = 32;    // band columns per shared-memory slice
constexpr int kThreads = 128; // 4 warps; warp w owns 4 of the 16 columns
constexpr int kPerThread = kCols / (kThreads / kRows);

__device__ __forceinline__ float band_value(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float band_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename BandT, bool kRoundU>
__global__ void __launch_bounds__(kThreads)
rolling_spmm_kernel(const BandT* __restrict__ band,
                    const float* __restrict__ U, float* __restrict__ W,
                    float* __restrict__ partial, int n, int bp, int pre,
                    int tile, int k) {
  __shared__ float s_band[kRows][kSlice + 1];  // +1: no bank conflicts
  __shared__ float s_u[kSlice][kCols];
  __shared__ float s_w[kRows][kCols];

  const int tid = threadIdx.x;
  const int r = tid % kRows;            // output row within the block
  const int grp = tid / kRows;          // column group (one warp)
  const int row0 = blockIdx.x * kRows;  // first band row of this block
  const int col0 = blockIdx.y * kCols;  // first output column
  const int origin = (row0 / tile) * tile;  // window origin t*tile
  const int shift = origin % bp;

  float acc[kPerThread];
#pragma unroll
  for (int c = 0; c < kPerThread; ++c) acc[c] = 0.f;

  for (int j0 = 0; j0 < bp; j0 += kSlice) {
    for (int e = tid; e < kRows * kSlice; e += kThreads) {
      const int rr = e / kSlice, jj = e % kSlice;
      s_band[rr][jj] = band_value(band + (size_t)(row0 + rr) * bp + j0 + jj);
    }
    for (int e = tid; e < kSlice * kCols; e += kThreads) {
      const int jj = e / kCols, c = e % kCols;
      int m = j0 + jj - shift;
      if (m < 0) m += bp;
      const int urow = origin + m - pre;
      const int col = col0 + c;
      float v = 0.f;
      if (col < k && urow >= 0 && urow < n) {
        v = __ldg(U + (size_t)urow * k + col);
        if (kRoundU) v = __bfloat162float(__float2bfloat16(v));
      }
      s_u[jj][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kSlice; ++jj) {
      const float a = s_band[r][jj];
#pragma unroll
      for (int c = 0; c < kPerThread; ++c)
        acc[c] = fmaf(a, s_u[jj][grp * kPerThread + c], acc[c]);
    }
    __syncthreads();
  }

  const int row = row0 + r;
#pragma unroll
  for (int c = 0; c < kPerThread; ++c) {
    const int col = col0 + grp * kPerThread + c;
    if (row < n && col < k) W[(size_t)row * k + col] = acc[c];
  }
  if (partial == nullptr) return;

  // Partial Gram of this block: U[row0:row0+32, :]^T W[row0:row0+32, cols].
#pragma unroll
  for (int c = 0; c < kPerThread; ++c)
    s_w[r][grp * kPerThread + c] = (row < n) ? acc[c] : 0.f;
  __syncthreads();
  const int rows_here = min(kRows, n - row0);
  float* out = partial + (size_t)blockIdx.x * k * k;
  for (int e = tid; e < k * kCols; e += kThreads) {
    const int i = e / kCols, c = e % kCols;
    const int col = col0 + c;
    if (col >= k) continue;
    float s = 0.f;
    for (int rr = 0; rr < rows_here; ++rr)
      s = fmaf(__ldg(U + (size_t)(row0 + rr) * k + i), s_w[rr][c], s);
    out[(size_t)i * k + col] = s;
  }
}

// G[e] = sum over blocks b of partial[b, e], in block order.
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ G, int n_blocks,
                                   int kk) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kk) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * kk + e];
  G[e] = s;
}

}  // namespace

extern "C" {

// W = A U (and, when partial/G are given, G = U^T A U). Shapes: band
// (n_pad, bp), U and W (n, k), partial (n_pad / 32, k, k), G (k, k).
// tile, n_pad and bp must be multiples of 32 (the wrapper checks).
// Returns cudaGetLastError() after the launches.
int epk_rolling_spmm(const void* band, int band_is_bf16, const float* U,
                     float* W, float* partial, float* G, int n, int n_pad,
                     int bp, int pre, int tile, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_pad / kRows, (k + kCols - 1) / kCols);
  if (band_is_bf16) {
    rolling_spmm_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(band), U, W, partial, n, bp, pre,
        tile, k);
  } else {
    rolling_spmm_kernel<float, false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(band), U, W, partial, n, bp, pre, tile, k);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  const int kk = k * k;
  gram_reduce_kernel<<<(kk + 255) / 256, 256, 0, s>>>(partial, G,
                                                      n_pad / kRows, kk);
  return (int)cudaGetLastError();
}

const char* epk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
