// Pieces shared by the local-similarity kernels (xattn_sim_fwd.cu and
// xattn_sim_bwd.cu): the row normalisation, warp reductions and the
// register-tiled 64 x 128 product of the backward's f32 mode.
//
// Products: 256 threads own a 64 x 128 output tile, 4 x 8 outputs a thread,
// fed by 16-deep operand chunks staged in shared memory and read back as
// float4 (3 vector shared loads per 32 FMAs). All arithmetic is IEEE f32
// FFMA: no TF32, no fast-math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace xattn {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTileM = 64;     // output rows a tile (4 a thread)
constexpr int kTileN = 128;    // output columns a tile (8 a thread)
constexpr int kDepth = 16;     // contraction chunk staged in shared memory
constexpr int kStrideA = kTileM + 4;  // padded, 16-byte aligned rows
constexpr int kStrideB = kTileN + 4;
constexpr int kStageFloats = kDepth * (kStrideA + kStrideB);
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_sum(const float* row, int n, int lane) {
  float v = 0.f;
  for (int s = lane; s < n; s += 32) v += row[s];
  return warp_sum(v);
}

__device__ __forceinline__ float row_dot(const float* a, const float* b, int n, int lane) {
  float v = 0.f;
  for (int s = lane; s < n; s += 32) v = fmaf(a[s], b[s], v);
  return warp_sum(v);
}

// xn = x / (|x| + eps) and |x| for each of `rows` rows of length D; one warp a row.
__global__ void l2norm_rows_kernel(const float* __restrict__ x, float* __restrict__ xn,
                                   float* __restrict__ norm, long long rows, int D) {
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* in = x + r * D;
  float v = 0.f;
  for (int d = lane; d < D; d += 32) v += in[d] * in[d];
  const float n = sqrtf(warp_sum(v));
  const float den = n + kEps;
  for (int d = lane; d < D; d += 32) xn[r * D + d] = in[d] / den;
  if (lane == 0 && norm != nullptr) norm[r] = n;
}

// Launches l2norm_rows_kernel over `rows` rows (8 warps a block).
inline void launch_l2norm_rows(const float* x, float* xn, float* norm, long long rows, int D,
                               cudaStream_t st) {
  if (rows == 0) return;
  const int rows_per_block = kThreads / 32;
  l2norm_rows_kernel<<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), kThreads, 0,
                       st>>>(x, xn, norm, rows, D);
}

// acc[4][8] += A(64 x kDepth) B(kDepth x 128) from the staged chunks.
__device__ __forceinline__ void mma_chunk(const float* As, const float* Bs, int tx, int ty,
                                          float acc[4][8]) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * kStrideA + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kStrideB + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * kStrideB + 64 + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Column of the 4 x 8 micro-tile: j < 4 -> tx*4 + j, else 64 + tx*4 + j-4.
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4 ? 0 : 64 - 4) + tx * 4 + j;
}

// acc = A[m0:m0+64, :K] B[:K, n0:n0+128] for an (M x K) A and a (K x N) B
// given as element functions fa(m, k) and fb(k, n), read only inside
// [0,M) x [0,K) and [0,K) x [0,N) (zero outside). kAK / kBK say the source
// is contiguous along k, which picks the staging order so neighbouring
// threads read neighbouring addresses. Thread (tx, ty) owns rows
// m0 + ty*4 + i and columns n0 + tile_col(tx, j). Ends with a barrier, so
// the staging buffers are free again on return.
template <bool kAK, bool kBK, class FA, class FB>
__device__ __forceinline__ void tile_product(int m0, int n0, int M, int N, int K, FA fa,
                                             FB fb, float* As, float* Bs, float acc[4][8]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kDepth) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // A chunk: 64 x 16, 4 values a thread
      const int m = kAK ? (tid >> 4) + 16 * r : (tid & 63);
      const int k = kAK ? (tid & 15) : (tid >> 6) + 4 * r;
      const int gm = m0 + m, gk = k0 + k;
      As[k * kStrideA + m] = (gm < M && gk < K) ? fa(gm, gk) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {  // B chunk: 16 x 128, 8 values a thread
      const int n = kBK ? (tid >> 4) + 16 * r : (tid & 127);
      const int k = kBK ? (tid & 15) : (tid >> 7) + 2 * r;
      const int gn = n0 + n, gk = k0 + k;
      Bs[k * kStrideB + n] = (gn < N && gk < K) ? fb(gk, gn) : 0.f;
    }
    __syncthreads();
    mma_chunk(As, Bs, tx, ty, acc);
    __syncthreads();
  }
}

}  // namespace xattn
