// Decode attention for Hopper (sm_90a): one query token per lane, attending
// over that lane's contiguous KV cache up to its valid length.
//
// Replaces: src/repro/kernels/decode_attention.py, function
// `decode_attention` (Pallas body `_decode_kernel`).  Same semantics: GQA
// with the G = H / KV query heads of one KV head sharing its keys, fp32
// online softmax over key tiles, keys at positions >= the lane's valid
// length masked, and a lane with valid length 0 returns zeros (the l
// clamp).  Unlike the Pallas wrapper, which drops a ragged tail of the
// cache by integer division, any cache length S is taken and the last tile
// is masked; a valid length above S reads S keys.
//
// What bounds it on the H100: bytes.  Decode reads every valid K and V row
// of the lane once and does 4 operations per (query head, key, dim): with
// G = 1 (zamba2's shared attention) that is 1 operation per byte of bf16
// KV, with G = 8 (tinyllama) 8 -- both far below the ~295 operations per
// byte at which the tensor cores would become the limit.
//
// What the design does about it: one block per (lane, KV head) holds all G
// query rows of the group, so each K/V row is read from device memory once
// for the whole group (GQA folded, KV never expanded).  The block stops at
// the lane's valid length, so the zero tail of a preallocated cache is
// never read.  Each tile of 128 keys is staged in shared memory with
// 16-byte loads (a tile is one contiguous run of the (B, KV, S, D) cache;
// rows padded by 16 bytes so the per-key 16-byte reads of the score loop
// hit distinct banks); the running max, sum and fp32 accumulator stay in
// shared memory across tiles.  No split over S yet: at zamba2's decode
// shape the grid (8 lanes x 32 KV heads = 256 blocks) fills the 132 SMs,
// at tinyllama's (8 x 4 = 32 blocks) it does not -- a split-K ("flash
// decoding") combine is the next step once this kernel has its numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTile = 128;  // keys staged per step
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q,          // (B, H, D)
                        const T* __restrict__ k,          // (B, KV, S, D)
                        const T* __restrict__ v,          // (B, KV, S, D)
                        const int* __restrict__ valid_len,  // (B,)
                        T* __restrict__ out,              // (B, H, D)
                        int H, int KV, int S, int D, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ld = D + kVec;  // padded shared row, in elements

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                     // kTile x ld
  T* vs = ks + kTile * ld;                                // kTile x ld
  float* qs = reinterpret_cast<float*>(vs + kTile * ld);  // G x D
  float* sc = qs + G * D;                                 // G x kTile
  float* acc = sc + G * kTile;                            // G x D
  float* m_s = acc + G * D;                               // G running max
  float* l_s = m_s + G;                                   // G running sum
  float* a_s = l_s + G;                                   // G rescale

  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    qs[i] = to_float(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int vlen = min(valid_len[b], S);
  const size_t kv_base = ((size_t)b * KV + kvh) * (size_t)S * D;
  const int vec_per_row = D / kVec;
  __syncthreads();

  for (int s0 = 0; s0 < vlen; s0 += kTile) {  // block-uniform
    const int n = min(kTile, vlen - s0);
    for (int i = tid; i < n * vec_per_row; i += blockDim.x) {
      const int t = i / vec_per_row;
      const int c = (i - t * vec_per_row) * kVec;
      const size_t g_off = kv_base + (size_t)(s0 + t) * D + c;
      *reinterpret_cast<uint4*>(ks + t * ld + c) =
          *reinterpret_cast<const uint4*>(k + g_off);
      *reinterpret_cast<uint4*>(vs + t * ld + c) =
          *reinterpret_cast<const uint4*>(v + g_off);
    }
    __syncthreads();

    for (int t = tid; t < kTile; t += blockDim.x) {
      for (int g = 0; g < G; ++g) {
        float s = kNegInf;
        if (t < n) {
          float dot = 0.f;
          for (int c = 0; c < D; c += kVec) {
            const uint4 raw = *reinterpret_cast<const uint4*>(ks + t * ld + c);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < kVec; ++j) dot += qs[g * D + c + j] * to_float(e[j]);
          }
          s = dot * scale;
        }
        sc[g * kTile + t] = s;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, sc[g * kTile + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float s = sc[g * kTile + t];
        const float p = s > kNegInf ? expf(s - m_new) : 0.f;
        sc[g * kTile + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D;
      const int d = i - g * D;
      const float* p = sc + g * kTile;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < n; ++t) a += p[t] * to_float(vs[t * ld + d]);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    store(out + q_base + i, acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid_len,
           void* out, int B, int H, int KV, int S, int D, float scale,
           cudaStream_t stream) {
  const int G = H / KV;
  const int ld = D + 16 / (int)sizeof(T);
  const size_t smem = 2 * (size_t)kTile * ld * sizeof(T) +
                      sizeof(float) * ((size_t)G * D * 2 + (size_t)G * kTile + 3 * G);
  // raise the opt-in shared-memory limit once per instantiation and
  // device (the attribute is per device; this also keeps the call out of
  // CUDA-graph captures after the first launch); an oversize request
  // returns the attribute call's error
  static size_t configured[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > configured[dev]) {
    e = cudaFuncSetAttribute(decode_attention_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = smem;
  }
  dim3 grid(B, KV);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid_len),
      static_cast<T*>(out), H, KV, S, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D), k and v (B, KV, S, D) and out (B, H, D) contiguous, 16-byte
// aligned, D a multiple of 8; valid_len (B,) int32.  dtype: 0 = bfloat16,
// 1 = float32.  Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid_len, void* out, int B, int H,
                                int KV, int S, int D, float scale, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, valid_len, out, B, H, KV, S, D,
                                 scale, s);
  return launch<float>(q, k, v, valid_len, out, B, H, KV, S, D, scale, s);
}
