// Grouped masked attention, out = softmax(q k^T + bias) v over groups, in
// f32 and bf16.
//
// Replaces the TPU kernel demovlp_tpu/ops/pallas_attention.py::_attn_kernel
// (launched by grouped_attention_pallas, and by the custom_vjp
// grouped_attention_fused, whose backward is a recompute through the plain
// version and has no kernel).
//
//   q (G, Lq, hd) (already scaled), k, v (G, Lk, hd), bias (G, Lk) f32
//   additive, out (G, Lq, hd) in q's type.
//
// Numerics of the JAX op: the logits q.k are accumulated in f32 (products
// of bf16 values are exact in f32), the bias added in f32, the softmax in
// f32 with the row maximum subtracted (exp(x - max) / sum), the
// probabilities rounded to v's type (bf16 in bf16 mode), the second product
// accumulated in f32 and the result rounded to q's type. No padding: Lk
// keys are exactly the group's keys, so a group whose every key carries a
// bias of -1e9 averages over its own keys (as grouped_attention_xla does),
// not over the TPU wrapper's 128-lane padding.
//
// Design. One block of 256 threads (8 warps) takes `gpb` consecutive
// groups, and stages their keys and values in shared memory as f32 (keys
// with a padded row stride of hd + 1, so that 32 lanes reading 32 keys at
// one depth hit 32 banks) with their bias. Each warp then takes one query
// row at a time: the row into shared memory; lane j computes the logits of
// keys j, j + 32, ... against it; a warp max and a warp sum give the
// softmax, whose probabilities go to the warp's shared row; lane d then
// accumulates out[d], out[d + 32], ... over the keys (values read along d,
// conflict-free). gpb is chosen so a block has about 32 query rows and its
// staging fits shared memory; at the region tower's f = 8 shapes Lk = 241
// (hd = 64) takes 126 KB, and Lk up to about 417 fits. A larger Lk, with
// one group a block, is refused by the launcher with cudaErrorInvalidValue.
//
// Bound on an H100: 4 * G * Lq * Lk * hd flops (two products) against
// reading q, k, v, bias and writing out once. At the tower's shapes the
// groups are small (Lk = 9 to 241) and bytes bound the time; the work per
// byte is at most 2 * Lq * Lk * hd / ((Lq + 2 Lk) hd * 4) flop.
//
// Two kernels. grouped_attention_kernel (above, FFMA) takes f32, where
// TF32 products would lose the op's precision, and head widths other than
// 32, 64 and 128. grouped_attention_mma_kernel (below) takes bf16 on the
// tensor cores; on an H100 it is the faster of the two at each of the
// region tower's four shapes, the small ones included.
// ops/attention_kernel.py picks one from the dtype and the head width
// alone (`kernel_path`).
//
// grouped_attention_mma_kernel. Bytes bound it on this card: at
// (G, Lq, Lk, hd) = (384, 241, 241, 64) the op moves 47 MB (14 us at
// 3.35 TB/s) for 5.7 GFLOP (6 us at 989 TFLOP/s bf16), so the products
// must run on the tensor cores and K and V must not be read from device
// memory once per query row. A block takes one group and 64 query rows,
// four warps of 16 rows each. The group's K and V go to shared memory as
// bf16 with cp.async (row stride hd + 8, so the 32-bit fragment loads and
// ldmatrix hit distinct banks); keys are padded to a multiple of 16 with
// zero rows, and the padded columns take no part in the max or the sum.
// Both products are mma.sync.m16n8k16 with bf16 operands and f32
// accumulation. The JAX op's rounding sites are kept with two passes over
// the keys: pass 1 computes the logits (q.k in f32, + bias) and each row's
// max and sum of exp(x - max); pass 2 computes the logits again, rounds the
// normalised probability p = exp(x - max) / sum to bf16 and multiplies it
// by V (ldmatrix.trans gives V's fragments). There is no online rescaling
// of unnormalised bf16 probabilities, which would round at other places.
// Recomputing q k^T costs operations, which are not the limit. The output
// is rounded to bf16 once. Shared memory holds the whole group: at
// hd = 64 up to 784 keys, beyond which the launcher refuses with
// cudaErrorInvalidValue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;            // query rows a block aims at
constexpr long long kMaxSmemBytes = 232448;  // one block's shared memory

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float x) { p[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}
// A probability in v's type: rounded to bf16 in bf16 mode.
__device__ __forceinline__ float prob(float x, const float*) { return x; }
__device__ __forceinline__ float prob(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

long long smem_floats(int gpb, int Lk, int hd) {
  return (long long)gpb * Lk * (2LL * hd + 2) + (long long)kWarps * (hd + Lk);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
grouped_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         T* __restrict__ out, int G, int Lq, int Lk, int hd, int gpb) {
  extern __shared__ __align__(16) float smem[];
  const int ks = hd + 1;  // padded key row stride
  const int g0 = blockIdx.x * gpb;
  const int ng = min(gpb, G - g0);
  float* Ks = smem;                             // (gpb * Lk, hd + 1)
  float* Vs = Ks + (long long)gpb * Lk * ks;    // (gpb * Lk, hd)
  float* Bs = Vs + (long long)gpb * Lk * hd;    // (gpb * Lk)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qrow = Bs + gpb * Lk + warp * (hd + Lk);  // (hd) this warp's query row
  float* prow = qrow + hd;                          // (Lk) its probabilities

  const long long kv0 = (long long)g0 * Lk * hd;
  const int nkv = ng * Lk * hd;
  for (int i = threadIdx.x; i < nkv; i += kThreads) {
    const int row = i / hd, d = i - row * hd;
    Ks[row * ks + d] = load(k, kv0 + i);
    Vs[i] = load(v, kv0 + i);
  }
  for (int i = threadIdx.x; i < ng * Lk; i += kThreads) Bs[i] = bias[(long long)g0 * Lk + i];
  __syncthreads();

  for (int r = warp; r < ng * Lq; r += kWarps) {
    const int gl = r / Lq;
    const long long row = (long long)g0 * Lq + r;  // global query row
    for (int d = lane; d < hd; d += 32) qrow[d] = load(q, row * hd + d);
    __syncwarp();
    const float* Kg = Ks + gl * Lk * ks;
    const float* Bg = Bs + gl * Lk;
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kr = Kg + j * ks;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(qrow[d], kr[d], acc);
      const float x = acc + Bg[j];
      prow[j] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < Lk; j += 32) prow[j] = prob(prow[j] / s, v);
    __syncwarp();
    const float* Vg = Vs + gl * Lk * hd;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(prow[j], Vg[j * hd + d], acc);
      store(out, row * hd + d, acc);
    }
    __syncwarp();
  }
}

template <class T>
int launch(const T* q, const T* k, const T* v, const float* bias, T* out, int G, int Lq,
           int Lk, int hd, cudaStream_t st) {
  if (G == 0 || Lq == 0) return 0;
  if (Lk < 1 || hd < 1) return (int)cudaErrorInvalidValue;
  int gpb = kRowsPerBlock / Lq;
  if (gpb < 1) gpb = 1;
  if (gpb > G) gpb = G;
  while (gpb > 1 && smem_floats(gpb, Lk, hd) * (long long)sizeof(float) > kMaxSmemBytes) --gpb;
  const long long smem = smem_floats(gpb, Lk, hd) * (long long)sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(grouped_attention_kernel<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((G + gpb - 1) / gpb);
  grouped_attention_kernel<T><<<blocks, kThreads, (size_t)smem, st>>>(q, k, v, bias, out, G, Lq,
                                                                      Lk, hd, gpb);
  return (int)cudaGetLastError();
}

// ---- bf16 tensor-core path

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// c += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col), f32 C
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Merges two (max, sum of exp(x - max)) pairs of one row.
__device__ __forceinline__ void merge_max_sum(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

long long mma_smem_bytes(int Lk, int hd) {
  const long long keys = (Lk + 15) / 16 * 16;
  return keys * (2LL * (hd + 8) * (long long)sizeof(__nv_bfloat16) + (long long)sizeof(float));
}

// Logits of this warp's 16 rows against keys n0..n0+7: s[0..1] row g,
// keys n0 + 2c and n0 + 2c + 1; s[2..3] row g + 8, the same keys.
template <int HD>
__device__ __forceinline__ void logits8(const uint32_t qa[HD / 16][4], const __nv_bfloat16* Ks,
                                        int n0, int lane, float s[4]) {
  constexpr int ks = HD + 8;
  const __nv_bfloat16* kr = Ks + (n0 + (lane >> 2)) * ks + 2 * (lane & 3);
  s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + 16 * kk);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8);
    mma_16816(s, qa[kk], b0, b1);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
grouped_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                             int Lq, int Lk) {
  constexpr int ks = HD + 8;  // padded bf16 row stride of K and V
  constexpr int kPieces = HD / 8;  // 16-byte pieces a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lk16 = (Lk + 15) / 16 * 16;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (Lk16, hd + 8)
  __nv_bfloat16* Vs = Ks + Lk16 * ks;                               // (Lk16, hd + 8)
  float* Bs = reinterpret_cast<float*>(Vs + Lk16 * ks);             // (Lk16)

  const long long grp = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const __nv_bfloat16* kg = k + grp * Lk * HD;
  const __nv_bfloat16* vg = v + grp * Lk * HD;

  // K (one cp.async group), then V (a second): pass 1 needs only K
  for (int i = tid; i < Lk16 * kPieces; i += kMmaThreads) {
    const int row = i / kPieces, p = i - row * kPieces;
    const bool ok = row < Lk;
    cp_async16(Ks + row * ks + 8 * p, kg + (long long)(ok ? row : 0) * HD + 8 * p, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < Lk16 * kPieces; i += kMmaThreads) {
    const int row = i / kPieces, p = i - row * kPieces;
    const bool ok = row < Lk;
    cp_async16(Vs + row * ks + 8 * p, vg + (long long)(ok ? row : 0) * HD + 8 * p, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int j = tid; j < Lk; j += kMmaThreads) Bs[j] = bias[grp * Lk + j];

  // this warp's 16 query rows as A fragments, straight from device memory
  const int r0 = blockIdx.y * kMmaRows + warp * 16;
  const bool active = r0 < Lq;
  const int ra = r0 + g, rb = r0 + g + 8;
  const __nv_bfloat16* qg = q + grp * Lq * HD;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int d = 16 * kk + 2 * c;
    qa[kk][0] = ra < Lq ? *reinterpret_cast<const uint32_t*>(qg + (long long)ra * HD + d) : 0u;
    qa[kk][1] = rb < Lq ? *reinterpret_cast<const uint32_t*>(qg + (long long)rb * HD + d) : 0u;
    qa[kk][2] = ra < Lq ? *reinterpret_cast<const uint32_t*>(qg + (long long)ra * HD + d + 8) : 0u;
    qa[kk][3] = rb < Lq ? *reinterpret_cast<const uint32_t*>(qg + (long long)rb * HD + d + 8) : 0u;
  }
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();

  // pass 1: each row's max and sum of exp(x - max) over the real keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (active) {
    for (int n0 = 0; n0 < Lk16; n0 += 8) {
      float s[4];
      logits8<HD>(qa, Ks, n0, lane, s);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n0 + 2 * c + (e & 1);
        if (j >= Lk) continue;
        const float x = s[e] + Bs[j];
        const int h = e >> 1;
        if (x > m[h]) {
          l[h] = l[h] * expf(m[h] - x) + 1.f;
          m[h] = x;
        } else {
          l[h] += expf(x - m[h]);
        }
      }
    }
    // the four lanes of a quad hold the same two rows
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[h], o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[h], o);
        merge_max_sum(m[h], l[h], m2, l2);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (!active) return;

  // pass 2: p = exp(x - max) / sum rounded to bf16, times V
  float o[HD / 8][4];
#pragma unroll
  for (int t = 0; t < HD / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  // ldmatrix rows: lanes 0-7 keys j0..j0+7 at column d, 8-15 keys j0+8.., 16-31
  // the same at column d + 8
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  for (int j0 = 0; j0 < Lk16; j0 += 16) {
    float s[2][4];
    logits8<HD>(qa, Ks, j0, lane, s[0]);
    logits8<HD>(qa, Ks, j0 + 8, lane, s[1]);
    uint32_t pa[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * t + 2 * c + (e & 1);
        p[e] = j < Lk ? expf(s[t][e] + Bs[j] - m[e >> 1]) / l[e >> 1] : 0.f;
      }
      pa[2 * t] = pack_bf16(p[0], p[1]);      // row g
      pa[2 * t + 1] = pack_bf16(p[2], p[3]);  // row g + 8
    }
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt) {
      uint32_t b0, b1, b2, b3;
      const uint32_t addr = smem_addr(Vs + (j0 + lrow) * ks + 16 * dt + lcol);
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                   : "r"(addr));
      mma_16816(o[2 * dt], pa, b0, b1);
      mma_16816(o[2 * dt + 1], pa, b2, b3);
    }
  }
  __nv_bfloat16* og = out + grp * Lq * HD;
#pragma unroll
  for (int t = 0; t < HD / 8; ++t) {
    const int d = 8 * t + 2 * c;
    if (ra < Lq)
      *reinterpret_cast<uint32_t*>(og + (long long)ra * HD + d) = pack_bf16(o[t][0], o[t][1]);
    if (rb < Lq)
      *reinterpret_cast<uint32_t*>(og + (long long)rb * HD + d) = pack_bf16(o[t][2], o[t][3]);
  }
}

template <int HD>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const float* bias, __nv_bfloat16* out, int G, int Lq, int Lk, cudaStream_t st) {
  const long long smem = mma_smem_bytes(Lk, HD);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(grouped_attention_mma_kernel<HD>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)G, (unsigned)((Lq + kMmaRows - 1) / kMmaRows));
  grouped_attention_mma_kernel<HD><<<grid, kMmaThreads, (size_t)smem, st>>>(q, k, v, bias, out,
                                                                            Lq, Lk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (G, Lq, hd) = softmax(q k^T + bias) v on `stream`; q, k, v and out
// float32 (bf16 == 0) or bfloat16 (bf16 != 0), bias float32 (G, Lk), all
// contiguous. Returns the cudaError_t of the launch (0 = ok);
// cudaErrorInvalidValue before any launch when one group's keys and values
// do not fit one block's shared memory.
int grouped_attention(const void* q, const void* k, const void* v, const float* bias, void* out,
                      int G, int Lq, int Lk, int hd, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch((const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                  bias, (__nv_bfloat16*)out, G, Lq, Lk, hd, st);
  return launch((const float*)q, (const float*)k, (const float*)v, bias, (float*)out, G, Lq, Lk,
                hd, st);
}

// The same on the tensor cores for bfloat16 q, k, v and out (hd 32, 64 or
// 128). Returns cudaErrorInvalidValue before any launch for another hd or
// when one group's keys and values do not fit one block's shared memory.
int grouped_attention_mma(const void* q, const void* k, const void* v, const float* bias,
                          void* out, int G, int Lq, int Lk, int hd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G == 0 || Lq == 0) return 0;
  if (Lk < 1) return (int)cudaErrorInvalidValue;
  const auto* qb = (const __nv_bfloat16*)q;
  const auto* kb = (const __nv_bfloat16*)k;
  const auto* vb = (const __nv_bfloat16*)v;
  auto* ob = (__nv_bfloat16*)out;
  switch (hd) {
    case 32: return launch_mma<32>(qb, kb, vb, bias, ob, G, Lq, Lk, st);
    case 64: return launch_mma<64>(qb, kb, vb, bias, ob, G, Lq, Lk, st);
    case 128: return launch_mma<128>(qb, kb, vb, bias, ob, G, Lq, Lk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
