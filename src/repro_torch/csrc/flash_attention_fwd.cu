// Flash-attention forward for Hopper (sm_90a): causal / sliding-window
// GQA attention returning the output and the fp32 log-sum-exp.
//
// Replaces: src/repro/kernels/flash_attention.py, function
// `flash_attention_fwd` (Pallas body `_fwd_kernel`, tile skip
// `_tile_live`).  Same semantics -- online softmax over key tiles, fully
// masked tiles skipped, lse = m + log(l) with l clamped at 1e-30 -- plus
// what serving prefill needs and the Pallas kernel lacked: a `q_offset`
// (query row i sits at absolute position q_offset + i, key j at j) so a
// prefill chunk attends over the earlier pages gathered in front of it,
// separate query and key lengths, arbitrary strides (the model's
// (B, S, H, D) layout is read in place, no transposes), and ragged tails
// masked instead of dropped.
//
// What bounds it on the H100: operations.  A 512-token tinyllama chunk
// over ~1k keys does ~1k operations per byte of Q/K/V, above the card's
// ~295 operations per byte, so the arithmetic is the limit.
//
// What this first design does about it: little yet, on purpose.  It is
// the flash recurrence on the SIMT cores in fp32: one block of 256
// threads per (64-query tile, head, batch); each thread owns a 4x4 tile
// of scores and 4 x D/16 outputs; K/V tiles of 64 keys are staged in
// shared memory as fp32 and shared by the block; GQA indexes the KV head
// as h / G, so KV is never expanded in memory; tiles outside the causal
// / window band are never loaded.  It runs at the fp32 SIMT rate, well
// under the bf16 tensor-core peak the bound is computed against: moving
// the two products onto `mma`/`wgmma` with bf16 operands is the work of a
// later change, measured against this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16: 4 query rows x 4 keys each
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  long long b, h, s;  // in elements; the head dim is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int KVH, int Sq, int Sk,
                 Strides sq, Strides sk, Strides sv, Strides so, int causal,
                 int window, int q_offset, float scale) {
  constexpr int DC = D / 16;        // output columns per thread
  constexpr int LQ = kBQ + 4;       // padded rows of the transposed tiles
  constexpr int LV = D + 4;
  constexpr int LP = kBK + 1;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // D x LQ   (q transposed)
  float* kt = qt + D * LQ;          // D x LQ   (k transposed; kBK == kBQ)
  float* vs = kt + D * LQ;          // kBK x LV
  float* ps = vs + kBK * LV;        // kBQ x LP probabilities

  const int q_start = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // query rows ty*4 .. +3
  const int tx = tid & 15;          // keys tx*4 .. +3, out cols tx*DC ..

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qi = q_start + r;
    qt[d * LQ + r] = qi < Sq ? to_float(qb[qi * sq.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // key range any row of this tile can see (the Pallas `_tile_live`)
  const int q_last = min(q_start + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_offset + q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_offset + q_start - window + 1) : 0;

  for (int k_start = (k_begin / kBK) * kBK; k_start < k_end; k_start += kBK) {
    __syncthreads();  // previous tile's readers are done with kt / vs / ps
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const int kj = k_start + c;
      const bool in = kj < Sk;
      kt[d * LQ + c] = in ? to_float(kb[kj * sk.s + d]) : 0.f;
      vs[c * LV + d] = in ? to_float(vb[kj * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * LQ + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(kt + d * LQ + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * ka[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_start + ty * 4 + i;
      const int qpos = q_offset + qi;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k_start + tx * 4 + j;
        bool ok = qi < Sq && kj < Sk;
        if (causal) ok = ok && kj <= qpos;
        if (window > 0) ok = ok && kj > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of one row group are lanes [0,16) or [16,32)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > kNegInf ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * LP + tx * 4 + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[c * LV + tx * DC + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * LP + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] += p * vv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_start + ty * 4 + i;
    if (qi >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + h * so.h + qi * so.s;
#pragma unroll
    for (int j = 0; j < DC; ++j) store(orow + tx * DC + j, acc[i][j] / lc);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + qi] = m[i] + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int KVH, int Sq, int Sk, Strides sq, Strides sk,
           Strides sv, Strides so, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)D * (kBQ + 4) +
                                       (size_t)kBK * (D + 4) +
                                       (size_t)kBQ * (kBK + 1));
  // raise the opt-in shared-memory limit once per instantiation and
  // device (the attribute is per device; this also keeps the call out of
  // CUDA-graph captures after the first launch)
  static size_t configured[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > configured[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = smem;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, KVH, Sq, Sk, sq, sk, sv, so, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int H, int KVH, int Sq, int Sk, Strides sq,
             Strides sk, Strides sv, Strides so, int causal, int window,
             int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, KVH, Sq, Sk, sq, sk, sv, so,
                           causal, window, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, KVH, Sq, Sk, sq, sk, sv, so,
                           causal, window, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, KVH, Sq, Sk, sq, sk, sv, so,
                           causal, window, q_offset, scale, stream);
    case 80:  // zamba2-2.7b's shared attention
      return launch<T, 80>(q, k, v, o, lse, B, H, KVH, Sq, Sk, sq, sk, sv, so,
                           causal, window, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, KVH, Sq, Sk, sq, sk, sv, so,
                            causal, window, q_offset, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements, (batch, head, sequence) for each of q, k, v, o;
// the head dim of each is contiguous and lse is a contiguous (B, H, Sq).
// dtype: 0 = bfloat16, 1 = float32.  Returns cudaGetLastError().
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KVH, int Sq, int Sk, int D, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    int causal, int window, int q_offset, float scale, int dtype,
    void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs}, so{ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, lse, B, H, KVH, Sq, Sk, sq,
                                   sk, sv, so, causal, window, q_offset, scale,
                                   s);
  return dispatch<float>(D, q, k, v, o, lse, B, H, KVH, Sq, Sk, sq, sk, sv, so,
                         causal, window, q_offset, scale, s);
}
