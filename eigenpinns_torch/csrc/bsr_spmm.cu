// Strip-BSR SpMM W = A U for Hopper, sm_90a: a grouped and a burst kernel.
//
// Replaces the Pallas TPU kernels of eigenpinns_tpu/sparse/bsr.py:
//   bsr_spmm_kernel<..., kGrouped = true>   <-  bsr_spmm_pallas_grouped
//       (column tiles through the group tables, pad slots skipped by the
//       valid count nv)
//   bsr_spmm_kernel<..., kGrouped = false>  <-  bsr_spmm_pallas
//       (column tiles through cid, every slot of every chunk)
//
// Layout (built on the host by BSRTile.from_scipy): data is (S*128,
// C*128) row-major; chunk s holds C tiles of 128 x 128 of row tile
// rowid[s], side by side. The chunks of row tile r are the contiguous
// range [chunk_start[r], chunk_start[r+1]) because rowid is
// nondecreasing. Slot j of chunk s multiplies U rows [128 c, 128 c + 128)
// with c = gcid[gid[s] * C_u + lcid[s * C + j]] (grouped, j < nv[s]) or
// c = cid[s * C + j] (burst, all C slots; pad slots hold zero tiles).
//
// The Pallas grid walked the chunks in order and kept the output block of
// rowid[s] resident in VMEM across a row tile's chunks. CUDA blocks run in
// no order, so each block owns one row tile (128 rows) and 32 output
// columns, loops over that row tile's chunks itself, accumulates in
// registers and writes each output element once: no atomics, and the
// result is the same bit for bit from run to run. U rows >= n_cols read
// as zero (no padded copy of U); any k works, in masked blocks of 32
// columns (no padding of k to 128 lanes).
//
// Work split: 256 threads; thread (ty, tx) = (tid / 8, tid % 8) holds the
// 4 x 4 outputs of rows ty + 32 i and columns 4 tx + j. Each 128 x 128
// tile product runs in four stages of 32 reduction steps: the 128 x 32
// strip slice (16-byte loads, converted to fp32) and the 32 x 32 U slice
// are staged in shared memory, then every thread does 16 FFMA per step.
//
// What bounds it: instruction issue, not bytes. At 300k nodes the real
// tiles are ~1.6 GB in fp32 against 24 MB of U at k = 20, a memory floor
// of ~0.5 ms at 3.35 TB/s; yet bf16 strips, half the bytes, take the same
// ~1.0 ms as fp32 on an H100 80GB HBM3 at 700 W. Each 32-column block
// runs 2 x 128^2 x 32 FLOP per tile at ~40% of the 67 TFLOP/s fp32 FFMA
// peak: five shared-memory loads per 16 FFMA, and no overlap of the next
// stage's loads with this stage's math. The design is the simple one: no
// double-buffered stages, no tensor cores for 'bf16', no shared union of
// U tiles.
//
// Precision: 'highest' and 'high' are both exact fp32 FFMA (the TPU's
// bf16x3 split was its way to near-f32 on the MXU). 'bf16' reads bf16
// strips and rounds U to bf16 before the product, accumulating in fp32,
// as both Pallas kernels do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 128;        // tile edge
constexpr int kBN = 32;        // output columns per block
constexpr int kBK = 32;        // reduction steps per shared-memory stage
constexpr int kThreads = 256;  // 8 warps
constexpr int kTM = 4;         // rows per thread: ty + 32 i
constexpr int kTN = 4;         // columns per thread: 4 tx + j

// Stage strip[0:128, 0:32] (row pitch ld) into As as fp32.
__device__ __forceinline__ void load_strip(const float* __restrict__ strip,
                                           size_t ld, float (*As)[kBK + 1],
                                           int tid) {
#pragma unroll
  for (int it = 0; it < kT * kBK / 4 / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int m = e >> 3;          // 8 threads per row
    const int q = (e & 7) * 4;
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(strip + (size_t)m * ld + q));
    As[m][q] = v.x;
    As[m][q + 1] = v.y;
    As[m][q + 2] = v.z;
    As[m][q + 3] = v.w;
  }
}

__device__ __forceinline__ void load_strip(
    const __nv_bfloat16* __restrict__ strip, size_t ld,
    float (*As)[kBK + 1], int tid) {
#pragma unroll
  for (int it = 0; it < kT * kBK / 8 / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int m = e >> 2;          // 4 threads per row
    const int q = (e & 3) * 8;
    const uint4 raw =
        __ldg(reinterpret_cast<const uint4*>(strip + (size_t)m * ld + q));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int c = 0; c < 8; ++c) As[m][q + c] = __bfloat162float(h[c]);
  }
}

template <typename DataT, bool kRoundU, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const DataT* __restrict__ data, const int* __restrict__ cols,
                const int* __restrict__ lcid, const int* __restrict__ gid,
                const int* __restrict__ nv,
                const int* __restrict__ chunk_start, int C, int C_u,
                const float* __restrict__ U, float* __restrict__ W, int n,
                int n_cols, int k) {
  __shared__ float As[kT][kBK + 1];  // +1: conflict-free staging writes
  __shared__ __align__(16) float Us[kBK][kBN];

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int r = blockIdx.y;          // row tile
  const int col0 = blockIdx.x * kBN;
  const size_t ld = (size_t)C * kT;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int s_end = chunk_start[r + 1];
  for (int s = chunk_start[r]; s < s_end; ++s) {
    const int n_slots = kGrouped ? nv[s] : C;
    const int* group_cols = kGrouped ? cols + (size_t)gid[s] * C_u : cols;
    for (int j = 0; j < n_slots; ++j) {
      const int ct = kGrouped ? group_cols[lcid[(size_t)s * C + j]]
                              : cols[(size_t)s * C + j];
      const DataT* strip = data + (size_t)s * kT * ld + (size_t)j * kT;
      for (int kk0 = 0; kk0 < kT; kk0 += kBK) {
        load_strip(strip + kk0, ld, As, tid);
#pragma unroll
        for (int it = 0; it < kBK * kBN / kThreads; ++it) {
          const int e = tid + it * kThreads;
          const int kk = e / kBN, c = e % kBN;
          const int urow = ct * kT + kk0 + kk;
          const int col = col0 + c;
          float v = 0.f;
          if (urow < n_cols && col < k) {
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
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = r * kT + ty + 32 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx * kTN + j;
      if (col < k) W[(size_t)row * k + col] = acc[i][j];
    }
  }
}

template <typename DataT, bool kRoundU>
cudaError_t launch(const void* data, const int* cols, const int* lcid,
                   const int* gid, const int* nv, const int* chunk_start,
                   int grouped, int C, int C_u, const float* U, float* W,
                   int n, int n_cols, int n_rt, int k, cudaStream_t s) {
  const dim3 grid((k + kBN - 1) / kBN, n_rt);
  const DataT* d = static_cast<const DataT*>(data);
  if (grouped) {
    bsr_spmm_kernel<DataT, kRoundU, true><<<grid, kThreads, 0, s>>>(
        d, cols, lcid, gid, nv, chunk_start, C, C_u, U, W, n, n_cols, k);
  } else {
    bsr_spmm_kernel<DataT, kRoundU, false><<<grid, kThreads, 0, s>>>(
        d, cols, lcid, gid, nv, chunk_start, C, C_u, U, W, n, n_cols, k);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// W = A U. cols is gcid (n_groups, C_u) when grouped, else cid (S, C);
// lcid (S, C) and gid (S,) are read only when grouped. nv (S,),
// chunk_start (n_rt + 1,), U (n_cols, k) and W (n, k) fp32. The wrapper
// checks types, shapes, contiguity and 16-byte alignment of data.
// Returns cudaGetLastError() after the launch.
int epk_bsr_spmm(const void* data, int data_is_bf16, const int* cols,
                 const int* lcid, const int* gid, const int* nv,
                 const int* chunk_start, int grouped, int C, int C_u,
                 const float* U, float* W, int n, int n_cols, int n_rt, int k,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (data_is_bf16) {
    return (int)launch<__nv_bfloat16, true>(data, cols, lcid, gid, nv,
                                            chunk_start, grouped, C, C_u, U,
                                            W, n, n_cols, n_rt, k, s);
  }
  return (int)launch<float, false>(data, cols, lcid, gid, nv, chunk_start,
                                   grouped, C, C_u, U, W, n, n_cols, n_rt,
                                   k, s);
}

const char* epk_bsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
