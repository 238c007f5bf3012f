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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // extern "C"
