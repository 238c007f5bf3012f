// Fused cross-modal attention similarity, backward (one direction): the
// gradients of sim (Bc, Bq) with respect to the query and to the context,
// in an f32 mode and a bf16 mode.
//
// Replaces the TPU kernels demovlp_tpu/ops/pallas_xattn.py::_fa_bwd_dq_kernel
// and ::_fa_bwd_dc_kernel (launched by _fa_bwd_pallas from the custom_vjp
// backward _pds_bwd), which share the per-tile math of _fa_bwd_tile and
// _cn_to_c_grad.
//
// Given g = dL/dsim, each (context c, query q) pair recomputes its forward
// in shared memory, exactly as xattn_sim_fwd.cu computes it (the same
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
// Design. No float atomics: one block owns one output item and loops over
// the other side, so two calls give bit-identical gradients.
//   * xattn_sim_bwd_dq_kernel: one block per query item q, looping over
//     every context item c; accumulates dq_direct + dqn / (|q| + eps) in the
//     block's own rows of d_query and the per-row dot dqn . q in shared
//     memory, then applies the rest of the qn = q / (|q| + eps) backward
//     once at the end (it is linear in dqn).
//   * xattn_sim_bwd_dc_kernel: one block per context item c, looping over
//     every query item q; accumulates dcn in the block's own rows of
//     d_context and applies the cn = c / (|c| + eps) backward at the end.
// The l2norm over Lq couples the Lq rows of a pair, so the whole (Lq x Ls)
// tile of one pair is resident: four such tiles (a0, p, ph, dph -> da0),
// w then dw (Lq x D), and the staging buffers. At f = 1 (Lq, Ls = 99, 30
// or 30, 99; D = 256) that is 165 KB or 94 KB of shared memory. Shapes that
// do not fit one block (f = 8: Ls = 240) are refused by the launcher with
// cudaErrorInvalidValue before any launch. The accumulators live in the
// output tensors (device memory, L2-resident), each element read and
// written by one thread with a mapping fixed across the loop.
//
// Arithmetic is IEEE f32 FFMA (no TF32, no fast-math, expf). In bf16 mode
// the product operands are rounded to bf16 as they are staged, as the TPU
// kernel casts them for the MXU: qn, cn for a0; ph, cn for w; dw, cn for
// dph; da0, cn for dqn; [ph; da0] and [dw; qn] for dcn. The callers pass
// inputs already rounded to bf16 (held in f32).
//
// Bound on an H100: 12 * Lq * Ls * D flops per pair for the whole backward
// (4 recomputed forward, 2 dph, 2 dqn, 4 dcn), counted once however it is
// split; the split here recomputes the forward and dph in both kernels.
// At the training shape (128 x 128 pairs, Lq * Ls = 2970, D = 256) that is
// 1.5e11 flops a direction, operations and not bytes bound it.
#include "xattn_common.cuh"

namespace {

using namespace xattn;

// Shared-memory carve-up of one block (floats).
struct Shm {
  float* As;    // staging, kDepth * kStrideA
  float* Bs;    // staging, kDepth * kStrideB
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
  float* gam;   // (Lq) dq kernel: sum over c of dqn . q
  float* cm;    // (Ls) additive mask of the context item
  float* rc;    // (Ls) sqrt(sq) + eps of the l2norm over Lq
  float* sqc;   // (Ls) sq
};

long long smem_floats(int Ls, int Lq, int D) {
  return (long long)kStageFloats + 4LL * Lq * Ls + (long long)Lq * D + 6LL * Lq + 3LL * Ls;
}

__device__ Shm carve(float* smem, int Ls, int Lq, int D) {
  Shm s;
  s.As = smem;
  s.Bs = s.As + kDepth * kStrideA;
  s.A0 = s.Bs + kDepth * kStrideB;
  s.P = s.A0 + Lq * Ls;
  s.PH = s.P + Lq * Ls;
  s.DA = s.PH + Lq * Ls;
  s.W = s.DA + Lq * Ls;
  s.dnum = s.W + Lq * D;
  s.cw = s.dnum + Lq;
  s.cq = s.cw + Lq;
  s.psum = s.cq + Lq;
  s.fsum = s.psum + Lq;
  s.gam = s.fsum + Lq;
  s.cm = s.gam + Lq;
  s.rc = s.cm + Ls;
  s.sqc = s.rc + Ls;
  return s;
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

// out[l * Ls + s] = sum_d X[l, d] Y[s, d] for X (Lq, D) and Y (Ls, D), both
// contiguous along d. The longer side goes along the 128-wide tile columns.
template <bool kBf16, class FX, class FY>
__device__ void product_nt(FX fx, FY fy, int Lq, int Ls, int D, float* out, const Shm& sh) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool trans = Ls < Lq;  // compute out^T: (Ls x Lq) tiles
  const int M = trans ? Ls : Lq, N = trans ? Lq : Ls;
  for (int m0 = 0; m0 < M; m0 += kTileM) {
    for (int n0 = 0; n0 < N; n0 += kTileN) {
      float acc[4][8];
      if (trans)
        tile_product<kBf16, true, true>(m0, n0, M, N, D, fy, [&](int k, int n) { return fx(n, k); },
                                        sh.As, sh.Bs, acc);
      else
        tile_product<kBf16, true, true>(m0, n0, M, N, D, fx, [&](int k, int n) { return fy(n, k); },
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
  product_nt<kBf16>([&](int l, int d) { return pr.QN[l * D + d]; },
                    [&](int s, int d) { return pr.CN[s * D + d]; }, Lq, Ls, D, sh.A0, sh);

  // leaky-ReLU, l2norm over Lq, + mask, exp(lam * a): one thread per column
  for (int s = tid; s < Ls; s += kThreads) {
    float sq = 0.f;
    for (int l = 0; l < Lq; ++l) {
      const float a = leaky(sh.A0[l * Ls + s]);
      sq = fmaf(a, a, sq);
    }
    const float r = sqrtf(sq) + kEps;
    sh.rc[s] = r;
    sh.sqc[s] = sq;
    const float m = sh.cm[s];
    for (int l = 0; l < Lq; ++l) {
      const float a = leaky(sh.A0[l * Ls + s]) / r + m;
      sh.P[l * Ls + s] = expf(a * lam);
    }
  }
  __syncthreads();

  // softmax normalisation and focal renorm: one warp per row
  for (int l = warp; l < Lq; l += nwarps) {
    float* row = sh.P + l * Ls;
    const float s1 = row_sum(row, Ls, lane);
    for (int s = lane; s < Ls; s += 32) row[s] = s1 > 0.f ? row[s] / s1 : 0.f;
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
      for (int s = lane; s < Ls; s += 32) hrow[s] = fs > 0.f ? hrow[s] / fs : 0.f;
      if (lane == 0) {
        sh.psum[l] = ps;
        sh.fsum[l] = fs;
      }
    }
  }
  __syncthreads();

  // w = ph cn (Lq x D), contraction over Ls
  const float* PH = focal ? sh.PH : sh.P;
  for (int l0 = 0; l0 < Lq; l0 += kTileM) {
    for (int d0 = 0; d0 < D; d0 += kTileN) {
      float acc[4][8];
      tile_product<kBf16, true, false>(
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
  product_nt<kBf16>([&](int l, int d) { return sh.W[l * D + d]; },
                    [&](int s, int d) { return pr.CN[s * D + d]; }, Lq, Ls, D, sh.DA, sh);

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

  // l2norm over Lq and leaky-ReLU backward: one thread per column
  for (int s = tid; s < Ls; s += kThreads) {
    float t = 0.f;
    for (int l = 0; l < Lq; ++l) t = fmaf(sh.DA[l * Ls + s], leaky(sh.A0[l * Ls + s]), t);
    const float r = sh.rc[s];
    const bool sq_pos = sh.sqc[s] > 0.f;
    const float sqrt_sq = sq_pos ? r - kEps : 1.f;
    const float ratio = sq_pos ? t / r / sqrt_sq : 0.f;
    for (int l = 0; l < Lq; ++l) {
      const float a0 = sh.A0[l * Ls + s];
      const float a2 = leaky(a0) / r;
      const float da1 = sh.DA[l * Ls + s] / r - ratio * a2;
      sh.DA[l * Ls + s] = a0 >= 0.f ? da1 : 0.1f * da1;
    }
  }
  __syncthreads();
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
xattn_sim_bwd_dq_kernel(const float* __restrict__ cn,     // (Bc, Ls, D) normalised
                        const float* __restrict__ cmask,  // (Bc, Ls) additive
                        const float* __restrict__ qn,     // (Bq, Lq, D) normalised
                        const float* __restrict__ qry,    // (Bq, Lq, D) raw
                        const float* __restrict__ qnorm,  // (Bq, Lq) |q|
                        const float* __restrict__ g,      // (Bc, Bq) cotangent
                        float* __restrict__ dq,           // (Bq, Lq, D) out
                        int Bc, int Bq, int Ls, int Lq, int D, float lam, int focal_equal) {
  extern __shared__ __align__(16) float smem[];
  const Shm sh = carve(smem, Ls, Lq, D);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q = blockIdx.x;
  const bool focal = focal_equal != 0;
  const long long qoff = (long long)q * Lq * D;
  const float* QF = qry + qoff;
  const float* QNORM = qnorm + (long long)q * Lq;
  float* DQ = dq + qoff;
  const int n = Lq * D;

  for (int i = tid; i < n; i += kThreads) DQ[i] = 0.f;
  for (int l = tid; l < Lq; l += kThreads) sh.gam[l] = 0.f;
  __syncthreads();

  for (int c = 0; c < Bc; ++c) {
    const Pair pr{cn + (long long)c * Ls * D, cmask + (long long)c * Ls, qn + qoff, QF, QNORM,
                  g[(long long)c * Bq + q]};
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
    // dqn = da0 cn (Lq x D): dq += dqn / (|q| + eps), gam += dqn . q
    for (int l0 = 0; l0 < Lq; l0 += kTileM) {
      for (int d0 = 0; d0 < D; d0 += kTileN) {
        float acc[4][8];
        tile_product<kBf16, true, false>(
            l0, d0, Lq, D, Ls, [&](int l, int s) { return sh.DA[l * Ls + s]; },
            [&](int s, int d) { return pr.CN[s * D + d]; }, sh.As, sh.Bs, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty * 4 + i;
          float pg = 0.f;
          if (l < Lq) {
            const float qden = QNORM[l] + kEps;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int d = d0 + tile_col(tx, j);
              if (d < D) {
                DQ[l * D + d] += acc[i][j] / qden;
                pg = fmaf(acc[i][j], QF[l * D + d], pg);
              }
            }
          }
          // the 16 threads of one row are 16 consecutive lanes of one warp
          for (int o = 8; o > 0; o >>= 1) pg += __shfl_xor_sync(0xffffffffu, pg, o);
          if (tx == 0 && l < Lq) sh.gam[l] += pg;
        }
      }
    }
    __syncthreads();
  }

  // the rest of the qn = q / (|q| + eps) backward, once: - coef q
  for (int i = tid; i < n; i += kThreads) {
    const int l = i / D;
    const float qnl = QNORM[l];
    const float qden = qnl + kEps;
    const float coef = qnl > 0.f ? sh.gam[l] / qnl / (qden * qden) : 0.f;
    DQ[i] -= coef * QF[i];
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
xattn_sim_bwd_dc_kernel(const float* __restrict__ ctx,    // (Bc, Ls, D) raw
                        const float* __restrict__ cn,     // (Bc, Ls, D) normalised
                        const float* __restrict__ cmask,  // (Bc, Ls) additive
                        const float* __restrict__ qn,     // (Bq, Lq, D) normalised
                        const float* __restrict__ qry,    // (Bq, Lq, D) raw
                        const float* __restrict__ qnorm,  // (Bq, Lq) |q|
                        const float* __restrict__ g,      // (Bc, Bq) cotangent
                        float* __restrict__ dc,           // (Bc, Ls, D) out
                        int Bq, int Ls, int Lq, int D, float lam, int focal_equal) {
  extern __shared__ __align__(16) float smem[];
  const Shm sh = carve(smem, Ls, Lq, D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;
  const int tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x;
  const bool focal = focal_equal != 0;
  const long long coff = (long long)c * Ls * D;
  const float* CR = ctx + coff;
  float* DC = dc + coff;
  const int n = Ls * D;

  for (int i = tid; i < n; i += kThreads) DC[i] = 0.f;
  __syncthreads();

  for (int q = 0; q < Bq; ++q) {
    const long long qoff = (long long)q * Lq * D;
    const Pair pr{cn + coff, cmask + (long long)c * Ls, qn + qoff, qry + qoff,
                  qnorm + (long long)q * Lq, g[(long long)c * Bq + q]};
    forward_recompute<kBf16>(pr, sh, Ls, Lq, D, lam, focal);
    for (int i = tid; i < Lq * D; i += kThreads) {  // W holds dw = dnum q + cw w
      const int l = i / D;
      sh.W[i] = sh.dnum[l] * pr.QF[i] + sh.cw[l] * sh.W[i];
    }
    __syncthreads();
    backward_to_da0<kBf16>(pr, sh, Ls, Lq, D, lam, focal);
    // dcn = [ph; da0]^T [dw; qn] (Ls x D), one contraction over 2 Lq
    const float* PH = focal ? sh.PH : sh.P;
    for (int s0 = 0; s0 < Ls; s0 += kTileM) {
      for (int d0 = 0; d0 < D; d0 += kTileN) {
        float acc[4][8];
        tile_product<kBf16, false, false>(
            s0, d0, Ls, D, 2 * Lq,
            [&](int s, int k) { return k < Lq ? PH[k * Ls + s] : sh.DA[(k - Lq) * Ls + s]; },
            [&](int k, int d) { return k < Lq ? sh.W[k * D + d] : pr.QN[(k - Lq) * D + d]; },
            sh.As, sh.Bs, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int d = d0 + tile_col(tx, j);
            if (s < Ls && d < D) DC[s * D + d] += acc[i][j];
          }
        }
      }
    }
    __syncthreads();
  }

  // cn = c / (|c| + eps) backward, once: one warp per context row
  for (int s = warp; s < Ls; s += nwarps) {
    const float* crow = CR + s * D;
    float* drow = DC + s * D;
    const float cnorm = sqrtf(row_dot(crow, crow, D, lane));
    const float dot = row_dot(drow, crow, D, lane);
    const float den = cnorm + kEps;
    const float coef = cnorm > 0.f ? dot / cnorm / (den * den) : 0.f;
    __syncwarp();
    for (int d = lane; d < D; d += 32) drow[d] = drow[d] / den - coef * crow[d];
  }
}

template <class K>
int prepare(K kernel, long long smem) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // one block's shared memory
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return the cudaError_t of their
// launches (0 = ok). cn_buf (Bc*Ls*D), qn_buf (Bq*Lq*D) and qnorm_buf
// (Bq*Lq) are scratch the caller allocates; each launcher first fills them
// with l2norm_rows_kernel. ctx, qry: (Bc, Ls, D), (Bq, Lq, D) f32 (bf16
// values in bf16 mode); cmask (Bc, Ls); g (Bc, Bq). A pair tile too large
// for one block's shared memory returns cudaErrorInvalidValue before any
// launch. mxu_bf16 != 0 selects the bf16 mode.

// d_query (Bq, Lq, D).
int xattn_sim_bwd_dq(const float* ctx, const float* qry, const float* cmask, const float* g,
                     float* dq, float* cn_buf, float* qn_buf, float* qnorm_buf, int Bc, int Bq,
                     int Ls, int Lq, int D, float lam, int focal_equal, int mxu_bf16,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long smem = smem_floats(Ls, Lq, D) * (long long)sizeof(float);
  auto kernel = mxu_bf16 ? xattn_sim_bwd_dq_kernel<true> : xattn_sim_bwd_dq_kernel<false>;
  int err = prepare(kernel, smem);
  if (err != 0 || Bq == 0) return err;
  launch_l2norm_rows(ctx, cn_buf, nullptr, (long long)Bc * Ls, D, st);
  launch_l2norm_rows(qry, qn_buf, qnorm_buf, (long long)Bq * Lq, D, st);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kernel<<<(unsigned)Bq, kThreads, (size_t)smem, st>>>(cn_buf, cmask, qn_buf, qry, qnorm_buf, g,
                                                      dq, Bc, Bq, Ls, Lq, D, lam, focal_equal);
  return (int)cudaGetLastError();
}

// d_context (Bc, Ls, D).
int xattn_sim_bwd_dc(const float* ctx, const float* qry, const float* cmask, const float* g,
                     float* dc, float* cn_buf, float* qn_buf, float* qnorm_buf, int Bc, int Bq,
                     int Ls, int Lq, int D, float lam, int focal_equal, int mxu_bf16,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long smem = smem_floats(Ls, Lq, D) * (long long)sizeof(float);
  auto kernel = mxu_bf16 ? xattn_sim_bwd_dc_kernel<true> : xattn_sim_bwd_dc_kernel<false>;
  int err = prepare(kernel, smem);
  if (err != 0 || Bc == 0) return err;
  launch_l2norm_rows(ctx, cn_buf, nullptr, (long long)Bc * Ls, D, st);
  launch_l2norm_rows(qry, qn_buf, qnorm_buf, (long long)Bq * Lq, D, st);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kernel<<<(unsigned)Bc, kThreads, (size_t)smem, st>>>(ctx, cn_buf, cmask, qn_buf, qry,
                                                      qnorm_buf, g, dc, Bq, Ls, Lq, D, lam,
                                                      focal_equal);
  return (int)cudaGetLastError();
}

}  // extern "C"
