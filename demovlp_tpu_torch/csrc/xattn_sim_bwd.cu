// Fused cross-modal attention similarity, backward (one direction): the
// gradients of sim (Bc, Bq) with respect to the query and to the context,
// in an f32 mode and a bf16 mode.
//
// Replaces the TPU kernels demovlp_tpu/ops/pallas_xattn.py::_fa_bwd_dq_kernel
// and ::_fa_bwd_dc_kernel (launched by _fa_bwd_pallas from the custom_vjp
// backward _pds_bwd), which share the per-tile math of _fa_bwd_tile and
// _cn_to_c_grad.
//
// Given g = dL/dsim, each (context c, query q) pair recomputes its forward,
// exactly as xattn_sim_fwd.cu computes it (the same
// no-max-pass softmax with p = 0 on fully masked rows, focal "equal"
// against Ls with its renorm to 0), and runs the analytic chain back to
// the normalised rows:
//
//   a0 = qn cn^T, a1 = leaky(a0), a2 = a1 / (|a1|_Lq + eps), p = softmax
//   over Ls of lam (a2 + mask), ph = focal(p), w = ph cn,
//   cos_l = (w_l . q_l) / max(|w_l| |q_l|, eps), sim = mean_l cos_l;
//   dw = dnum q + cw w, dq_direct = dnum w + cq q,
//   dph = dw cn^T -> dp (focal renorm, h not differentiated) -> da3
//   (softmax) -> da1 (l2norm over Lq: column sums t = sum_l da2 a1 first)
//   -> da0; dqn = da0 cn; dcn = ph^T dw + da0^T qn.
//
// Guards are where-selects on exact zeros, never eps maxima, as in the TPU
// kernel (pallas_xattn.py:276-279): live = |w||q| >= eps, |w| > 0, |q| > 0,
// the focal sum > 0, sq > 0 (divisions taken in sequence), |c| > 0. A fully
// masked context item has p = 0 and gives finite, zero gradients.
//
// Design. No float atomics: every sum has one owner and a fixed order, so
// two calls give bit-identical gradients. Each gradient takes two kernels:
//   * the main kernel, on a grid (items, S): block (i, s) owns output item i
//     and loops over the partners [s P / S, (s + 1) P / S) of the other side
//     (P of them), accumulating into its own slice (s, i) of a partial
//     buffer. S comes from the caller (ops/xattn_kernel.py::backward_splits:
//     enough blocks to fill the card's slots, so that at f = 8, 32 items,
//     128 blocks of 8 partners run where 32 blocks of 32 did).
//       - xattn_sim_bwd_dq_kernel: item q, partners c; accumulates
//         dq_direct in part (S, Bq, Lq, D) and dqn in part_dqn (the same
//         shape);
//       - xattn_sim_bwd_dc_kernel: item c, partners q; accumulates dcn in
//         part (S, Bc, Ls, D).
//   * the reduce kernel, one warp a row: sums the S partials in the order
//     s = 0 .. S - 1 and applies what is linear in the totals:
//       - xattn_sim_bwd_dq_reduce_kernel: dq = sum_s part plus the
//         qn = q / (|q| + eps) backward of sum_s part_dqn;
//       - xattn_sim_bwd_dc_reduce_kernel: the cn = c / (|c| + eps) backward.
//     S = 1 goes through the same two kernels.
// The l2norm over Lq couples the Lq rows of a pair and the softmax couples
// its Ls columns, so the whole (Lq x Ls) tile of one pair is kept: four
// such tiles (a0, p, ph, dph -> da0) and w then dw (Lq x D). Two layouts:
//   * resident: the tiles, the operands and the row/column vectors all in
//     shared memory. At f = 1 (Lq, Ls = 99, 30 or 30, 99; D = 256) that is
//     165 KB or 94 KB in f32 mode (two blocks an SM fit the second), 221 KB
//     or 149 KB in bf16 mode (the operands as bf16 rows, 68 KB).
//   * workspace: where the tiles do not fit one block's 227 KB (f = 8:
//     (Lq, Ls) = (99, 240) or (240, 99), 481 KB), the launcher puts them
//     in a device workspace the caller allocates, one slice a block of the
//     (items, S) grid (xattn_sim_bwd_workspace gives its size); operands and
//     vectors stay in shared memory. At 32 items and S = 4 that is 62 MB,
//     more than the 50 MB L2. The kernel does the same work in the same
//     order either way; only the tiles' address space differs.
// A shape whose operands and vectors alone exceed shared memory is refused
// by the launcher with cudaErrorInvalidValue before any launch. Each
// element of a partial slice is read and written by one thread with a
// mapping fixed across the partner loop.
//
// The column passes (the l2norm over Lq forward and backward) run on every
// thread: a column's Lq rows are split over `parts` threads whose partial
// sums meet in shared memory in a fixed order; divisions with a zero
// numerator (masked positions) are skipped by a select.
//
// Products. f32 mode: IEEE f32 FFMA on staged 64 x 128 tiles (tile_product,
// xattn_common.cuh; no TF32, no fast-math, expf). bf16 mode:
// mma.sync.m16n8k16 (bf16 operands, f32 sums) with every product operand
// rounded to bf16 (nearest even), as the TPU kernel casts them for the MXU: qn, cn for a0; ph, cn for w; dw, cn for dph; da0, cn for
// dqn; [ph; da0] and [dw; qn] for dcn. The block's own item's qn (d_query)
// or cn (d_context) is rounded into shared memory once, the partner's once
// a pair; ph, da0 and dw are rounded as their fragments are read from the
// f32 tiles. A product of two bf16 values is exact in f32, so the modes'
// sums differ from the plain version's only in their order. M, N and K are
// padded to the mma's 16, 8 and 16 by zero fragments, not stored. The
// callers pass inputs already rounded to bf16 (held in f32).
//
// Bound on an H100: 12 * Lq * Ls * D flops per pair for the whole backward
// (4 recomputed forward, 2 dph, 2 dqn, 4 dcn), counted once however it is
// split; the split here recomputes the forward and dph in both kernels.
// At the training shape (128 x 128 pairs, Lq * Ls = 2970, D = 256) that is
// 1.5e11 flops a direction, operations and not bytes bound it.
#include <stdint.h>

#include "xattn_common.cuh"

namespace {

using namespace xattn;

// Carve-up of one block: the product operands (f32 staging chunks, or in
// bf16 mode the pair's qn and cn rounded to bf16) and the vectors in shared
// memory; the tiles A0, P, PH, DA, W (f32) in shared memory (resident
// layout) or in the block's slice of the device workspace.
struct Shm {
  float* As;    // f32 mode: staging, kDepth * kStrideA
  float* Bs;    // f32 mode: staging, kDepth * kStrideB
  __nv_bfloat16* QNb;  // bf16 mode: (Lq, bf16_stride(D)) qn, rounded
  __nv_bfloat16* CNb;  // bf16 mode: (Ls, bf16_stride(D)) cn, rounded
  float* A0;    // (Lq, Ls) raw attention a0
  float* P;     // (Lq, Ls) softmax p
  float* PH;    // (Lq, Ls) focal-renormalised ph (equal only)
  float* DA;    // (Lq, Ls) dph, then da3, then da0
  float* W;     // (Lq, D) w, then dw
  float* dnum;  // (Lq) d cos / d num
  float* cw;    // (Lq) coefficient of w in dw
  float* cq;    // (Lq) coefficient of q in dq_direct
  float* psum;  // (Lq) sum_s p (focal threshold)
  float* fsum;  // (Lq) sum_s h p (focal renorm)
  float* cm;    // (Ls) additive mask of the context item
  float* rc;    // (Ls) sqrt(sq) + eps of the l2norm over Lq
  float* sqc;   // (Ls) sq
  float* colw;  // column-pass scratch, column_floats(Ls)
};

// The tiles of one pair, rounded up to a multiple of 4 floats (16 bytes).
__host__ __device__ inline long long tile_floats(int Ls, int Lq, int D) {
  return (4LL * Lq * Ls + (long long)Lq * D + 3) / 4 * 4;
}

// Column-pass scratch: the parts x Ls partial sums (parts x Ls <= kThreads
// below kThreads columns, one part a column from there).
__host__ __device__ inline int column_floats(int Ls) { return Ls < kThreads ? kThreads : Ls; }

// Row stride (bf16 elements) of the bf16-mode operands: 8 past a multiple
// of 64, so that the 8 rows of an mma fragment load fall on distinct banks.
__host__ __device__ inline int bf16_stride(int D) { return (D + 63) / 64 * 64 + 8; }

// The product operands in shared memory, in floats: the f32 staging
// chunks, or in bf16 mode qn and cn as bf16 rows (a multiple of 16 bytes).
long long operand_floats(int Ls, int Lq, int D, bool bf16) {
  return bf16 ? (long long)(Lq + Ls) * bf16_stride(D) / 2 : (long long)kStageFloats;
}

// The operands and the row/column vectors.
long long vector_floats(int Ls, int Lq, int D, bool bf16) {
  return operand_floats(Ls, Lq, D, bf16) + 5LL * Lq + 3LL * Ls + column_floats(Ls);
}

constexpr long long kMaxSmemBytes = 232448;  // one block's shared memory

bool tiles_resident(int Ls, int Lq, int D, bool bf16) {
  return (vector_floats(Ls, Lq, D, bf16) + tile_floats(Ls, Lq, D)) * (long long)sizeof(float) <=
         kMaxSmemBytes;
}

// kWs: the tiles in `ws`, this block's workspace slice; else resident. The
// layout is a template parameter so that the resident kernel's tile
// pointers derive from shared memory alone and compile to shared-memory
// loads, as they did before the workspace layout existed.
template <bool kBf16, bool kWs>
__device__ Shm carve(float* smem, float* ws, int Ls, int Lq, int D) {
  Shm s;
  float* after;  // past the operands
  if constexpr (kBf16) {
    s.As = s.Bs = nullptr;
    s.QNb = reinterpret_cast<__nv_bfloat16*>(smem);
    s.CNb = s.QNb + Lq * bf16_stride(D);
    after = reinterpret_cast<float*>(s.CNb + Ls * bf16_stride(D));
  } else {
    s.QNb = s.CNb = nullptr;
    s.As = smem;
    s.Bs = s.As + kDepth * kStrideA;
    after = s.Bs + kDepth * kStrideB;
  }
  float* vectors;
  if constexpr (kWs) {
    s.A0 = ws;
    vectors = after;
  } else {
    s.A0 = after;
  }
  s.P = s.A0 + Lq * Ls;
  s.PH = s.P + Lq * Ls;
  s.DA = s.PH + Lq * Ls;
  s.W = s.DA + Lq * Ls;
  if constexpr (!kWs) vectors = s.W + Lq * D;
  s.dnum = vectors;
  s.cw = s.dnum + Lq;
  s.cq = s.cw + Lq;
  s.psum = s.cq + Lq;
  s.fsum = s.psum + Lq;
  s.cm = s.fsum + Lq;
  s.rc = s.cm + Ls;
  s.sqc = s.rc + Ls;
  s.colw = s.sqc + Ls;
  return s;
}

// This block's slice of the workspace: one a block of the (items, S) grid.
__device__ __forceinline__ float* block_slice(float* ws, int Ls, int Lq, int D) {
  return ws + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * tile_floats(Ls, Lq, D);
}

// This block's partners [lo, hi) of `partners`: split s = blockIdx.y of S.
__device__ __forceinline__ void partner_range(int partners, int& lo, int& hi) {
  lo = (int)((long long)blockIdx.y * partners / gridDim.y);
  hi = (int)((long long)(blockIdx.y + 1) * partners / gridDim.y);
}

// One (context item, query item) pair: row-major (rows, D) operands.
struct Pair {
  const float* CN;     // (Ls, D) normalised context
  const float* CM;     // (Ls) additive mask
  const float* QN;     // (Lq, D) normalised query
  const float* QF;     // (Lq, D) raw query
  const float* QNORM;  // (Lq) |q|
  float g;             // cotangent of sim[c, q]
};

__device__ __forceinline__ float leaky(float a) { return a >= 0.f ? a : 0.1f * a; }

// x / y, or 0 where y <= 0 or x = 0: 0 / y is 0, and skipping it spares
// IEEE division's slow path on a zero numerator (masked positions).
__device__ __forceinline__ float div_or_zero(float x, float y) {
  return (y > 0.f && x != 0.f) ? x / y : 0.f;
}

// Threads a column in the column passes: parts x Ls <= kThreads where Ls
// is below the block's threads, so that every thread has work.
__device__ __forceinline__ int column_parts(int Ls) { return Ls < kThreads ? kThreads / Ls : 1; }

// sums[col] = sum over l < Lq of term(l, col) for each col < Ls, on every
// thread: thread (col, part) adds the rows l = part (mod parts) in order,
// then the parts meet in part order. `sums` is column scratch
// (column_floats(Ls)); the totals are left in its first Ls. Starts and ends
// with a barrier.
template <class F>
__device__ __forceinline__ void column_sums(int parts, int Ls, int Lq, float* sums, F term) {
  __syncthreads();
  for (int w = threadIdx.x; w < parts * Ls; w += kThreads) {
    const int part = w / Ls, col = w - part * Ls;
    float t = 0.f;
#pragma unroll 4
    for (int l = part; l < Lq; l += parts) t += term(l, col);  // loads batched, sums in order
    sums[w] = t;
  }
  __syncthreads();
  if (parts > 1) {  // each thread reads and writes only its own column
    for (int col = threadIdx.x; col < Ls; col += kThreads) {
      float t = sums[col];
      for (int p = 1; p < parts; ++p) t += sums[p * Ls + col];
      sums[col] = t;
    }
    __syncthreads();
  }
}

// ---- bf16 mode: products on mma.sync.m16n8k16 (bf16 operands, f32 sums)

// c += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col), f32 C
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even) and packed,
// `lo` in the low half: the operand pair of one fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 values packed, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Elements X[r, k], X[r, k + 1] of `rows` bf16 rows of D (stride Dp), k even:
// the pair along a row, 0 outside.
__device__ __forceinline__ uint32_t row_pair(const __nv_bfloat16* X, int rows, int D, int Dp,
                                             int r, int k) {
  return (r < rows && k < D) ? *reinterpret_cast<const uint32_t*>(X + r * Dp + k) : 0u;
}

// Elements X[k, n], X[k + 1, n] of the same: the pair down a column.
__device__ __forceinline__ uint32_t col_pair(const __nv_bfloat16* X, int rows, int D, int Dp,
                                             int k, int n) {
  if (n >= D || k >= rows) return 0u;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  return pack_raw(X[k * Dp + n], k + 1 < rows ? X[(k + 1) * Dp + n] : zero);
}

// T[i, j], T[i, j + 1] of an f32 (ni, nj) tile with row stride nj, rounded
// to bf16: the pair along a row, 0 outside.
__device__ __forceinline__ uint32_t tile_row_pair(const float* T, int ni, int nj, int i, int j) {
  if (i >= ni || j >= nj) return 0u;
  return pack_bf16(T[i * nj + j], j + 1 < nj ? T[i * nj + j + 1] : 0.f);
}

// T[i, j], T[i + 1, j] of the same: the pair down a column.
__device__ __forceinline__ uint32_t tile_col_pair(const float* T, int ni, int nj, int i, int j) {
  if (i >= ni || j >= nj) return 0u;
  return pack_bf16(T[i * nj + j], i + 1 < ni ? T[(i + 1) * nj + j] : 0.f);
}

constexpr int kMmaNT = 4;  // 8-column tiles in a warp's unit: a 16 x 32 output block

// out[m * ld + n] = sum_k A[m, k] B[k, n] (kAcc: += ) for m < M, n < N on
// bf16 mma tiles: the warps take 16 x 32 output blocks in turn and each
// sums over K in 16-deep steps. a(m, k) gives A[m, k], A[m, k + 1] and
// b(k, n) gives B[k, n], B[k + 1, n] as packed bf16 pairs (k even), 0
// outside the operands. Each output has one lane; with kAcc the lane loads
// all its old values before it stores any, so that the loads are in flight
// together. Ends with a barrier.
template <bool kAcc, class FA, class FB>
__device__ __forceinline__ void mma_product(int M, int N, int K, FA a, FB b, float* out, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int ng = (N + 8 * kMmaNT - 1) / (8 * kMmaNT), units = (M + 15) / 16 * ng;
  for (int unit = warp; unit < units; unit += kThreads / 32) {
    const int m0 = unit / ng * 16, n0 = unit % ng * 8 * kMmaNT;
    float acc[kMmaNT][4];
#pragma unroll
    for (int t = 0; t < kMmaNT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      const uint32_t af[4] = {a(m0 + g, k0 + 2 * c), a(m0 + g + 8, k0 + 2 * c),
                              a(m0 + g, k0 + 2 * c + 8), a(m0 + g + 8, k0 + 2 * c + 8)};
#pragma unroll
      for (int t = 0; t < kMmaNT; ++t) {
        if (n0 + 8 * t < N)  // the same for every lane of the warp
          mma_16816(acc[t], af, b(k0 + 2 * c, n0 + 8 * t + g), b(k0 + 2 * c + 8, n0 + 8 * t + g));
      }
    }
    if constexpr (kAcc) {
#pragma unroll
      for (int t = 0; t < kMmaNT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + g + 8 * (e >> 1), n = n0 + 8 * t + 2 * c + (e & 1);
          if (m < M && n < N) acc[t][e] += out[m * ld + n];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMmaNT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + g + 8 * (e >> 1), n = n0 + 8 * t + 2 * c + (e & 1);
        if (m < M && n < N) out[m * ld + n] = acc[t][e];
      }
    }
  }
  __syncthreads();
}

// acc[4][8] += out at a 64 x 128 tile's outputs (rows m0 + ty * 4 + i,
// columns n0 + tile_col(tx, j), inside M x N, row stride ld), then stored:
// all the loads before any store, so that they are in flight together.
__device__ __forceinline__ void tile_accumulate(float acc[4][8], float* out, int m0, int n0,
                                                int M, int N, int ld) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tile_col(tx, j);
      if (m < M && n < N) acc[i][j] += out[m * ld + n];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tile_col(tx, j);
      if (m < M && n < N) out[m * ld + n] = acc[i][j];
    }
  }
}

// rows x D f32 rows (src) rounded to bf16 into shared rows of stride Dp
// (dst); D is a multiple of 4. The caller places the barriers.
__device__ __forceinline__ void stage_bf16(const float* __restrict__ src, int rows, int D, int Dp,
                                           __nv_bfloat16* dst) {
  const int quads = D / 4;
  for (int i = threadIdx.x; i < rows * quads; i += kThreads) {
    const int r = i / quads, d = 4 * (i - r * quads);
    const float4 v = *reinterpret_cast<const float4*>(src + (long long)r * D + d);
    uint2 out;
    out.x = pack_bf16(v.x, v.y);
    out.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(dst + r * Dp + d) = out;
  }
}

// f32 mode: out[l * Ls + s] = sum_d X[l, d] Y[s, d] for X (Lq, D) and Y
// (Ls, D), both contiguous along d, on FFMA tiles. The longer side goes
// along the 128-wide tile columns.
template <class FX, class FY>
__device__ void product_nt(FX fx, FY fy, int Lq, int Ls, int D, float* out, const Shm& sh) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool trans = Ls < Lq;  // compute out^T: (Ls x Lq) tiles
  const int M = trans ? Ls : Lq, N = trans ? Lq : Ls;
  for (int m0 = 0; m0 < M; m0 += kTileM) {
    for (int n0 = 0; n0 < N; n0 += kTileN) {
      float acc[4][8];
      if (trans)
        tile_product<true, true>(m0, n0, M, N, D, fy, [&](int k, int n) { return fx(n, k); },
                                        sh.As, sh.Bs, acc);
      else
        tile_product<true, true>(m0, n0, M, N, D, fx, [&](int k, int n) { return fy(n, k); },
                                        sh.As, sh.Bs, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + tile_col(tx, j);
          if (m < M && n < N) out[trans ? n * Ls + m : m * Ls + n] = acc[i][j];
        }
      }
    }
  }
  __syncthreads();
}

// The pair's forward, recomputed: A0, P, PH, W = ph cn, and the row
// coefficients dnum, cw, cq of the cosine's backward.
template <bool kBf16>
__device__ void forward_recompute(const Pair& pr, const Shm& sh, int Ls, int Lq, int D,
                                  float lam, bool focal) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;
  const int tx = tid & 15, ty = tid >> 4;
  for (int s = tid; s < Ls; s += kThreads) sh.cm[s] = pr.CM[s];

  // a0 = qn cn^T
  const int Dp = bf16_stride(D);
  if constexpr (kBf16) {
    mma_product<false>(Lq, Ls, D, [&](int l, int k) { return row_pair(sh.QNb, Lq, D, Dp, l, k); },
                       [&](int k, int s) { return row_pair(sh.CNb, Ls, D, Dp, s, k); }, sh.A0, Ls);
  } else {
    product_nt([&](int l, int d) { return pr.QN[l * D + d]; },
                      [&](int s, int d) { return pr.CN[s * D + d]; }, Lq, Ls, D, sh.A0, sh);
  }

  // leaky-ReLU, l2norm over Lq, + mask, exp(lam * a), on every thread:
  // thread (col, part) takes the rows l = part (mod parts) of column col
  const int parts = column_parts(Ls);
  column_sums(parts, Ls, Lq, sh.colw, [&](int l, int col) {
    const float a = leaky(sh.A0[l * Ls + col]);
    return a * a;
  });
  for (int col = tid; col < Ls; col += kThreads) {
    const float sq = sh.colw[col];
    sh.rc[col] = sqrtf(sq) + kEps;
    sh.sqc[col] = sq;
  }
  __syncthreads();
  for (int w = tid; w < parts * Ls; w += kThreads) {
    const int part = w / Ls, col = w - part * Ls;
    const float r = sh.rc[col], m = sh.cm[col];
#pragma unroll 4
    for (int l = part; l < Lq; l += parts) {
      const float a = div_or_zero(leaky(sh.A0[l * Ls + col]), r) + m;
      sh.P[l * Ls + col] = expf(a * lam);
    }
  }
  __syncthreads();

  // softmax normalisation and focal renorm: one warp per row
  for (int l = warp; l < Lq; l += nwarps) {
    float* row = sh.P + l * Ls;
    const float s1 = row_sum(row, Ls, lane);
    for (int s = lane; s < Ls; s += 32) row[s] = div_or_zero(row[s], s1);
    if (focal) {
      __syncwarp();
      const float ps = row_sum(row, Ls, lane);
      float* hrow = sh.PH + l * Ls;
      for (int s = lane; s < Ls; s += 32) {
        const float p = row[s];
        hrow[s] = (p * (float)Ls - ps) > 0.f ? p : 0.f;
      }
      __syncwarp();
      const float fs = row_sum(hrow, Ls, lane);
      for (int s = lane; s < Ls; s += 32) hrow[s] = div_or_zero(hrow[s], fs);
      if (lane == 0) {
        sh.psum[l] = ps;
        sh.fsum[l] = fs;
      }
    }
  }
  __syncthreads();

  // w = ph cn (Lq x D), contraction over Ls
  const float* PH = focal ? sh.PH : sh.P;
  if constexpr (kBf16) {
    mma_product<false>(Lq, D, Ls, [&](int l, int k) { return tile_row_pair(PH, Lq, Ls, l, k); },
                       [&](int k, int d) { return col_pair(sh.CNb, Ls, D, Dp, k, d); }, sh.W, D);
  } else {
    for (int l0 = 0; l0 < Lq; l0 += kTileM) {
      for (int d0 = 0; d0 < D; d0 += kTileN) {
        float acc[4][8];
        tile_product<true, false>(
            l0, d0, Lq, D, Ls, [&](int l, int s) { return PH[l * Ls + s]; },
            [&](int s, int d) { return pr.CN[s * D + d]; }, sh.As, sh.Bs, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int d = d0 + tile_col(tx, j);
            if (l < Lq && d < D) sh.W[l * D + d] = acc[i][j];
          }
        }
      }
    }
    __syncthreads();
  }

  // cosine backward coefficients: one warp per row
  const float dcos = pr.g / (float)Lq;
  for (int l = warp; l < Lq; l += nwarps) {
    const float num = row_dot(sh.W + l * D, pr.QF + l * D, D, lane);
    const float wsq = row_dot(sh.W + l * D, sh.W + l * D, D, lane);
    if (lane == 0) {
      const float wn = sqrtf(wsq);
      const float qnorm = pr.QNORM[l];
      const float den_raw = wn * qnorm;
      const float den = fmaxf(den_raw, kEps);
      const float dden = den_raw >= kEps ? -dcos * num / (den * den) : 0.f;
      sh.dnum[l] = dcos / den;
      sh.cw[l] = wn > 0.f ? dden * qnorm / wn : 0.f;
      sh.cq[l] = qnorm > 0.f ? dden * wn / qnorm : 0.f;
    }
  }
  __syncthreads();
}

// From dw (in W) back to da0 (in DA).
template <bool kBf16>
__device__ void backward_to_da0(const Pair& pr, const Shm& sh, int Ls, int Lq, int D,
                                float lam, bool focal) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;

  // dph = dw cn^T
  if constexpr (kBf16) {
    const int Dp = bf16_stride(D);
    mma_product<false>(Lq, Ls, D, [&](int l, int k) { return tile_row_pair(sh.W, Lq, D, l, k); },
                       [&](int k, int s) { return row_pair(sh.CNb, Ls, D, Dp, s, k); }, sh.DA, Ls);
  } else {
    product_nt([&](int l, int d) { return sh.W[l * D + d]; },
                      [&](int s, int d) { return pr.CN[s * D + d]; }, Lq, Ls, D, sh.DA, sh);
  }

  // focal renorm and softmax backward: one warp per row
  for (int l = warp; l < Lq; l += nwarps) {
    float* drow = sh.DA + l * Ls;
    const float* prow = sh.P + l * Ls;
    if (focal) {
      const float dps = row_dot(drow, sh.PH + l * Ls, Ls, lane);
      const float fs = sh.fsum[l], ps = sh.psum[l];
      for (int s = lane; s < Ls; s += 32) {
        const float dpt = fs > 0.f ? (drow[s] - dps) / fs : 0.f;
        drow[s] = (prow[s] * (float)Ls - ps) > 0.f ? dpt : 0.f;
      }
      __syncwarp();
    }
    const float s2 = row_dot(drow, prow, Ls, lane);
    __syncwarp();
    for (int s = lane; s < Ls; s += 32) drow[s] = lam * prow[s] * (drow[s] - s2);
  }
  __syncthreads();

  // l2norm over Lq and leaky-ReLU backward, on every thread as the
  // forward's column pass: the column sums t = sum_l da3 a1 first
  const int parts = column_parts(Ls);
  column_sums(parts, Ls, Lq, sh.colw, [&](int l, int col) {
    return sh.DA[l * Ls + col] * leaky(sh.A0[l * Ls + col]);
  });
  for (int col = tid; col < Ls; col += kThreads) {  // colw: t, then the ratio
    const float r = sh.rc[col];
    const bool sq_pos = sh.sqc[col] > 0.f;
    const float sqrt_sq = sq_pos ? r - kEps : 1.f;
    sh.colw[col] = sq_pos ? sh.colw[col] / r / sqrt_sq : 0.f;
  }
  __syncthreads();
  for (int w = tid; w < parts * Ls; w += kThreads) {
    const int part = w / Ls, col = w - part * Ls;
    const float r = sh.rc[col], rt = sh.colw[col];
#pragma unroll 4
    for (int l = part; l < Lq; l += parts) {
      const float a0 = sh.A0[l * Ls + col];
      const float a2 = div_or_zero(leaky(a0), r);
      const float da1 = div_or_zero(sh.DA[l * Ls + col], r) - rt * a2;
      sh.DA[l * Ls + col] = a0 >= 0.f ? da1 : 0.1f * da1;
    }
  }
  __syncthreads();
}

template <bool kBf16, bool kWs>
__global__ void __launch_bounds__(kThreads, 1)
xattn_sim_bwd_dq_kernel(const float* __restrict__ cn,     // (Bc, Ls, D) normalised
                        const float* __restrict__ cmask,  // (Bc, Ls) additive
                        const float* __restrict__ qn,     // (Bq, Lq, D) normalised
                        const float* __restrict__ qry,    // (Bq, Lq, D) raw
                        const float* __restrict__ qnorm,  // (Bq, Lq) |q|
                        const float* __restrict__ g,      // (Bc, Bq) cotangent
                        float* __restrict__ part,         // (S, Bq, Lq, D) out
                        float* __restrict__ part_dqn,     // (S, Bq, Lq, D) out
                        float* __restrict__ ws,           // (S, Bq, tile) when kWs
                        int Bc, int Bq, int Ls, int Lq, int D, float lam, int focal_equal) {
  extern __shared__ __align__(16) float smem[];
  const Shm sh = carve<kBf16, kWs>(smem, kWs ? block_slice(ws, Ls, Lq, D) : nullptr, Ls, Lq, D);
  const int tid = threadIdx.x;
  const int Dp = bf16_stride(D);
  const int q = blockIdx.x;
  const bool focal = focal_equal != 0;
  const long long qoff = (long long)q * Lq * D;
  const long long slice = (long long)blockIdx.y * Bq + q;
  const float* QF = qry + qoff;
  const float* QNORM = qnorm + (long long)q * Lq;
  float* DQ = part + slice * Lq * D;     // dq_direct
  float* DQN = part_dqn + slice * Lq * D;  // dqn
  const int n = Lq * D;
  int c0, c1;
  partner_range(Bc, c0, c1);

  for (int i = tid; i < n; i += kThreads) DQ[i] = DQN[i] = 0.f;
  if constexpr (kBf16) stage_bf16(qn + qoff, Lq, D, Dp, sh.QNb);  // this block's item
  __syncthreads();

  for (int c = c0; c < c1; ++c) {
    const Pair pr{cn + (long long)c * Ls * D, cmask + (long long)c * Ls, qn + qoff, QF, QNORM,
                  g[(long long)c * Bq + q]};
    if constexpr (kBf16) {  // the partner, once a pair
      stage_bf16(pr.CN, Ls, D, Dp, sh.CNb);
      __syncthreads();
    }
    forward_recompute<kBf16>(pr, sh, Ls, Lq, D, lam, focal);
    // dq += dnum w + cq q; then W holds dw = dnum q + cw w
    for (int i = tid; i < n; i += kThreads) {
      const int l = i / D;
      const float w = sh.W[i], qf = QF[i];
      DQ[i] += sh.dnum[l] * w + sh.cq[l] * qf;
      sh.W[i] = sh.dnum[l] * qf + sh.cw[l] * w;
    }
    __syncthreads();
    backward_to_da0<kBf16>(pr, sh, Ls, Lq, D, lam, focal);
    // dqn = da0 cn (Lq x D), accumulated
    if constexpr (kBf16) {
      mma_product<true>(Lq, D, Ls, [&](int l, int k) { return tile_row_pair(sh.DA, Lq, Ls, l, k); },
                        [&](int k, int d) { return col_pair(sh.CNb, Ls, D, Dp, k, d); }, DQN, D);
    } else {
      for (int l0 = 0; l0 < Lq; l0 += kTileM) {
        for (int d0 = 0; d0 < D; d0 += kTileN) {
          float acc[4][8];
          tile_product<true, false>(
              l0, d0, Lq, D, Ls, [&](int l, int s) { return sh.DA[l * Ls + s]; },
              [&](int s, int d) { return pr.CN[s * D + d]; }, sh.As, sh.Bs, acc);
          tile_accumulate(acc, DQN, l0, d0, Lq, D, D);
        }
      }
      __syncthreads();
    }
  }
}

template <bool kBf16, bool kWs>
__global__ void __launch_bounds__(kThreads, 1)
xattn_sim_bwd_dc_kernel(const float* __restrict__ cn,     // (Bc, Ls, D) normalised
                        const float* __restrict__ cmask,  // (Bc, Ls) additive
                        const float* __restrict__ qn,     // (Bq, Lq, D) normalised
                        const float* __restrict__ qry,    // (Bq, Lq, D) raw
                        const float* __restrict__ qnorm,  // (Bq, Lq) |q|
                        const float* __restrict__ g,      // (Bc, Bq) cotangent
                        float* __restrict__ part,         // (S, Bc, Ls, D) out
                        float* __restrict__ ws,           // (S, Bc, tile) when kWs
                        int Bc, int Bq, int Ls, int Lq, int D, float lam, int focal_equal) {
  extern __shared__ __align__(16) float smem[];
  const Shm sh = carve<kBf16, kWs>(smem, kWs ? block_slice(ws, Ls, Lq, D) : nullptr, Ls, Lq, D);
  const int tid = threadIdx.x;
  const int Dp = bf16_stride(D);
  const int c = blockIdx.x;
  const bool focal = focal_equal != 0;
  const long long coff = (long long)c * Ls * D;
  float* DC = part + ((long long)blockIdx.y * Bc + c) * Ls * D;
  const int n = Ls * D;
  int q0, q1;
  partner_range(Bq, q0, q1);

  for (int i = tid; i < n; i += kThreads) DC[i] = 0.f;
  if constexpr (kBf16) stage_bf16(cn + coff, Ls, D, Dp, sh.CNb);  // this block's item
  __syncthreads();

  for (int q = q0; q < q1; ++q) {
    const long long qoff = (long long)q * Lq * D;
    const Pair pr{cn + coff, cmask + (long long)c * Ls, qn + qoff, qry + qoff,
                  qnorm + (long long)q * Lq, g[(long long)c * Bq + q]};
    if constexpr (kBf16) {  // the partner, once a pair
      stage_bf16(pr.QN, Lq, D, Dp, sh.QNb);
      __syncthreads();
    }
    forward_recompute<kBf16>(pr, sh, Ls, Lq, D, lam, focal);
    for (int i = tid; i < Lq * D; i += kThreads) {  // W holds dw = dnum q + cw w
      const int l = i / D;
      sh.W[i] = sh.dnum[l] * pr.QF[i] + sh.cw[l] * sh.W[i];
    }
    __syncthreads();
    backward_to_da0<kBf16>(pr, sh, Ls, Lq, D, lam, focal);
    // dcn = [ph; da0]^T [dw; qn] (Ls x D), one contraction over 2 Lq (in
    // bf16 mode over two ranges of K1 = Lq rounded up to 16, each
    // zero-padded)
    const float* PH = focal ? sh.PH : sh.P;
    if constexpr (kBf16) {
      const int K1 = (Lq + 15) / 16 * 16;
      mma_product<true>(
          Ls, D, 2 * K1,
          [&](int s, int k) {
            return k < K1 ? tile_col_pair(PH, Lq, Ls, k, s) : tile_col_pair(sh.DA, Lq, Ls, k - K1, s);
          },
          [&](int k, int d) {
            return k < K1 ? tile_col_pair(sh.W, Lq, D, k, d)
                          : col_pair(sh.QNb, Lq, D, Dp, k - K1, d);
          },
          DC, D);
    } else {
      for (int s0 = 0; s0 < Ls; s0 += kTileM) {
        for (int d0 = 0; d0 < D; d0 += kTileN) {
          float acc[4][8];
          tile_product<false, false>(
              s0, d0, Ls, D, 2 * Lq,
              [&](int s, int k) { return k < Lq ? PH[k * Ls + s] : sh.DA[(k - Lq) * Ls + s]; },
              [&](int k, int d) { return k < Lq ? sh.W[k * D + d] : pr.QN[(k - Lq) * D + d]; },
              sh.As, sh.Bs, acc);
          tile_accumulate(acc, DC, s0, d0, Ls, D, D);
        }
      }
      __syncthreads();
    }
  }
}

// d_query from its S partials, one warp a query row r of rows = Bq * Lq:
// dqn = sum_s part_dqn, then dq = sum_s part + dqn / (|q| + eps) - coef q
// with coef = (dqn . q) / |q| / (|q| + eps)^2 (0 where |q| = 0).
__global__ void xattn_sim_bwd_dq_reduce_kernel(const float* __restrict__ part,
                                               const float* __restrict__ part_dqn,
                                               const float* __restrict__ qry,
                                               const float* __restrict__ qnorm,
                                               float* __restrict__ dq, long long rows, int D,
                                               int S) {
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* qrow = qry + r * D;
  float* drow = dq + r * D;
  const long long stride = rows * D;
  float dot = 0.f;
  for (int d = lane; d < D; d += 32) {  // drow holds dqn until the second pass
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += part_dqn[s * stride + r * D + d];
    drow[d] = v;
    dot = fmaf(v, qrow[d], dot);
  }
  dot = warp_sum(dot);
  const float qnl = qnorm[r];
  const float qden = qnl + kEps;
  const float coef = qnl > 0.f ? dot / qnl / (qden * qden) : 0.f;
  for (int d = lane; d < D; d += 32) {
    float direct = 0.f;
    for (int s = 0; s < S; ++s) direct += part[s * stride + r * D + d];
    drow[d] = direct + (drow[d] / qden - coef * qrow[d]);
  }
}

// d_context from its S partials, one warp a context row r of rows = Bc * Ls:
// dcn = sum_s part, then the cn = c / (|c| + eps) backward.
__global__ void xattn_sim_bwd_dc_reduce_kernel(const float* __restrict__ part,
                                               const float* __restrict__ ctx,
                                               float* __restrict__ dc, long long rows, int D,
                                               int S) {
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* crow = ctx + r * D;
  float* drow = dc + r * D;
  const long long stride = rows * D;
  float dot = 0.f;
  for (int d = lane; d < D; d += 32) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += part[s * stride + r * D + d];
    drow[d] = v;
    dot = fmaf(v, crow[d], dot);
  }
  dot = warp_sum(dot);
  const float cnorm = sqrtf(row_dot(crow, crow, D, lane));
  const float den = cnorm + kEps;
  const float coef = cnorm > 0.f ? dot / cnorm / (den * den) : 0.f;
  for (int d = lane; d < D; d += 32) drow[d] = drow[d] / den - coef * crow[d];
}

template <class K>
int prepare(K kernel, long long smem) {
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// Blocks of `kernel` one SM holds at once with `smem` bytes each, or
// -cudaError_t.
template <class K>
int blocks_per_sm(K kernel, long long smem) {
  int blocks = 0;
  int err = prepare(kernel, smem);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                             (size_t)smem);
  return err != 0 ? -err : blocks;
}

// Dynamic shared memory of one block: everything (resident) or operands and
// vectors only (workspace).
long long smem_bytes(int Ls, int Lq, int D, bool bf16) {
  const long long floats = vector_floats(Ls, Lq, D, bf16) +
                           (tiles_resident(Ls, Lq, D, bf16) ? tile_floats(Ls, Lq, D) : 0);
  return floats * (long long)sizeof(float);
}

using DqKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, float*, float*, float*, int, int, int, int, int, float,
                          int);
using DcKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, float*, float*, int, int, int, int, int, float, int);

// The instantiation a shape and mode launch.
DqKernel dq_kernel(bool resident, bool bf16) {
  return resident ? (bf16 ? xattn_sim_bwd_dq_kernel<true, false>
                          : xattn_sim_bwd_dq_kernel<false, false>)
                  : (bf16 ? xattn_sim_bwd_dq_kernel<true, true>
                          : xattn_sim_bwd_dq_kernel<false, true>);
}

DcKernel dc_kernel(bool resident, bool bf16) {
  return resident ? (bf16 ? xattn_sim_bwd_dc_kernel<true, false>
                          : xattn_sim_bwd_dc_kernel<false, false>)
                  : (bf16 ? xattn_sim_bwd_dc_kernel<true, true>
                          : xattn_sim_bwd_dc_kernel<false, true>);
}

// Blocks per launch of the reduce kernels: one warp a row.
unsigned reduce_blocks(long long rows) {
  const int rows_per_block = kThreads / 32;
  return (unsigned)((rows + rows_per_block - 1) / rows_per_block);
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return the cudaError_t of their
// launches (0 = ok). cn_buf (Bc*Ls*D), qn_buf (Bq*Lq*D) and qnorm_buf
// (Bq*Lq) are scratch the caller allocates; each launcher first fills them
// with l2norm_rows_kernel, then runs its main kernel on a grid (items,
// splits) and its reduce kernel. ctx, qry: (Bc, Ls, D), (Bq, Lq, D) f32
// (bf16 values in bf16 mode); cmask (Bc, Ls); g (Bc, Bq). part: the partial
// buffer, splits * (Bq*Lq*D for d_query, Bc*Ls*D for d_context) floats,
// and part_dqn (d_query only) the same size, both written before
// they are read. ws: the workspace, xattn_sim_bwd_workspace(Ls, Lq, D, mxu_bf16)
// floats for each of the items * splits blocks, or nullptr where that size
// is 0. A shape whose operands and vectors exceed one block's shared memory,
// a missing workspace, or splits outside [1, min(partners, 65535)] returns
// cudaErrorInvalidValue before any launch. mxu_bf16 != 0 selects the bf16
// mode.

// Workspace floats one block needs: 0 when the pair's tiles fit shared
// memory (resident layout).
long long xattn_sim_bwd_workspace(int Ls, int Lq, int D, int mxu_bf16) {
  return tiles_resident(Ls, Lq, D, mxu_bf16 != 0) ? 0 : tile_floats(Ls, Lq, D);
}

// Blocks of the main kernel (dc = 0: d_query's, 1: d_context's) that one
// SM holds at once for this shape and mode
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -cudaError_t.
int xattn_sim_bwd_blocks_per_sm(int dc, int Ls, int Lq, int D, int mxu_bf16) {
  const bool bf16 = mxu_bf16 != 0;
  const long long smem = smem_bytes(Ls, Lq, D, bf16);
  const bool resident = tiles_resident(Ls, Lq, D, bf16);
  return dc ? blocks_per_sm(dc_kernel(resident, bf16), smem)
            : blocks_per_sm(dq_kernel(resident, bf16), smem);
}

// d_query (Bq, Lq, D).
int xattn_sim_bwd_dq(const float* ctx, const float* qry, const float* cmask, const float* g,
                     float* dq, float* cn_buf, float* qn_buf, float* qnorm_buf, float* part,
                     float* part_dqn, float* ws, int Bc, int Bq, int Ls, int Lq, int D,
                     float lam, int focal_equal, int mxu_bf16, int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long smem = smem_bytes(Ls, Lq, D, mxu_bf16 != 0);
  const bool resident = tiles_resident(Ls, Lq, D, mxu_bf16 != 0);
  if (!resident && ws == nullptr) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > (Bc > 1 ? Bc : 1) || splits > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = dq_kernel(resident, mxu_bf16 != 0);
  int err = prepare(kernel, smem);
  if (err != 0 || Bq == 0) return err;
  launch_l2norm_rows(ctx, cn_buf, nullptr, (long long)Bc * Ls, D, st);
  launch_l2norm_rows(qry, qn_buf, qnorm_buf, (long long)Bq * Lq, D, st);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kernel<<<dim3((unsigned)Bq, (unsigned)splits), kThreads, (size_t)smem, st>>>(
      cn_buf, cmask, qn_buf, qry, qnorm_buf, g, part, part_dqn, resident ? nullptr : ws, Bc, Bq,
      Ls, Lq, D, lam, focal_equal);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long rows = (long long)Bq * Lq;
  xattn_sim_bwd_dq_reduce_kernel<<<reduce_blocks(rows), kThreads, 0, st>>>(
      part, part_dqn, qry, qnorm_buf, dq, rows, D, splits);
  return (int)cudaGetLastError();
}

// d_context (Bc, Ls, D). part_dqn is unused.
int xattn_sim_bwd_dc(const float* ctx, const float* qry, const float* cmask, const float* g,
                     float* dc, float* cn_buf, float* qn_buf, float* qnorm_buf, float* part,
                     float* part_dqn, float* ws, int Bc, int Bq, int Ls, int Lq, int D,
                     float lam, int focal_equal, int mxu_bf16, int splits, void* stream) {
  (void)part_dqn;
  cudaStream_t st = (cudaStream_t)stream;
  const long long smem = smem_bytes(Ls, Lq, D, mxu_bf16 != 0);
  const bool resident = tiles_resident(Ls, Lq, D, mxu_bf16 != 0);
  if (!resident && ws == nullptr) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > (Bq > 1 ? Bq : 1) || splits > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = dc_kernel(resident, mxu_bf16 != 0);
  int err = prepare(kernel, smem);
  if (err != 0 || Bc == 0) return err;
  launch_l2norm_rows(ctx, cn_buf, nullptr, (long long)Bc * Ls, D, st);
  launch_l2norm_rows(qry, qn_buf, qnorm_buf, (long long)Bq * Lq, D, st);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kernel<<<dim3((unsigned)Bc, (unsigned)splits), kThreads, (size_t)smem, st>>>(
      cn_buf, cmask, qn_buf, qry, qnorm_buf, g, part, resident ? nullptr : ws, Bc, Bq, Ls, Lq, D,
      lam, focal_equal);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long rows = (long long)Bc * Ls;
  xattn_sim_bwd_dc_reduce_kernel<<<reduce_blocks(rows), kThreads, 0, st>>>(part, ctx, dc, rows,
                                                                            D, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
