// Paged-attention decode for Hopper (sm_90a): one query token per lane,
// attending over that lane's pages of the paged KV pool.
//
// Replaces: src/repro/kernels/paged_attention.py, function
// `paged_attention` (Pallas body `_paged_kernel`, slot rule
// `_slot_positions`).  Same semantics: GQA with the G = H / KV query
// heads of one KV head sharing its keys, fp32 online softmax page by
// page, table entries < 0 skipped, per-lane valid length, optional
// sliding `window`, optional `ring` position recovery (a ring slot holds
// the latest position p <= last congruent to it modulo the ring size),
// and a lane whose table is all -1 returns zeros (the l clamp), not NaN.
//
// What bounds it on the H100: bytes.  Decode reads every live KV byte of
// the lane once and does 4 operations per (query head, key, dim) -- with
// G = 8 that is ~8 operations per byte of bf16 KV, far below the ~295
// operations per byte at which the tensor cores would become the limit.
//
// What the design does about it: one block per (lane, KV head) holds all
// G query rows of the group, so each K/V page is read from device memory
// once for the whole group (not once per query head, which is what
// expanding KV heads would cost).  The block walks the lane's table
// itself (the TPU kernel's scalar prefetch), stops at the lane's valid
// length for linear tables, stages each page's K and V rows in shared
// memory with 16-byte loads (rows padded by 16 bytes so the per-token
// 16-byte reads of the score loop hit distinct banks), and keeps the
// running max, sum and fp32 accumulator in shared memory across pages.
// No tensor cores, TMA or split over pages yet: at small batch the grid
// (lanes x KV heads) under-fills the 132 SMs, which is the next thing to
// fix (split-K "flash decoding") once this simple kernel has its numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ int positive_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
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
paged_decode_kernel(const T* __restrict__ q,        // (B, H, D)
                    const T* __restrict__ k_pages,  // (P, page, KV, D)
                    const T* __restrict__ v_pages,  // (P, page, KV, D)
                    const int* __restrict__ table,  // (B, maxp)
                    const int* __restrict__ valid_len,  // (B,)
                    T* __restrict__ out,            // (B, H, D)
                    int H, int KV, int D, int page, int maxp, int window,
                    int ring, float scale) {
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
  T* ks = reinterpret_cast<T*>(smem);             // page x ld
  T* vs = ks + page * ld;                         // page x ld
  float* qs = reinterpret_cast<float*>(vs + page * ld);  // G x D
  float* sc = qs + G * D;                         // G x page scores / probs
  float* acc = sc + G * page;                     // G x D
  float* m_s = acc + G * D;                       // G running max
  float* l_s = m_s + G;                           // G running sum
  float* a_s = l_s + G;                           // G rescale of this page

  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    qs[i] = to_float(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int vlen = valid_len[b];
  const int last = vlen - 1;
  const int ring_tokens = maxp * page;
  const int vec_per_row = D / kVec;
  __syncthreads();

  for (int pi = 0; pi < maxp; ++pi) {
    const int pid = table[(size_t)b * maxp + pi];
    const int s_start = pi * page;
    // a ring page can hold live tokens whatever its table index, so the
    // beyond-the-length exit applies to linear tables only
    if (pid < 0 || (!ring && s_start >= vlen)) continue;  // block-uniform

    for (int i = tid; i < page * vec_per_row; i += blockDim.x) {
      const int t = i / vec_per_row;
      const int c = (i - t * vec_per_row) * kVec;
      const size_t g_off = (((size_t)pid * page + t) * KV + kvh) * D + c;
      *reinterpret_cast<uint4*>(ks + t * ld + c) =
          *reinterpret_cast<const uint4*>(k_pages + g_off);
      *reinterpret_cast<uint4*>(vs + t * ld + c) =
          *reinterpret_cast<const uint4*>(v_pages + g_off);
    }
    __syncthreads();

    for (int t = tid; t < page; t += blockDim.x) {
      const int slot = s_start + t;
      const int pos = ring ? last - positive_mod(last - slot, ring_tokens) : slot;
      const bool ok = pos >= 0 && pos <= last && (window <= 0 || pos > last - window);
      for (int g = 0; g < G; ++g) {
        float s = kNegInf;
        if (ok) {
          float dot = 0.f;
          for (int c = 0; c < D; c += kVec) {
            const uint4 raw = *reinterpret_cast<const uint4*>(ks + t * ld + c);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < kVec; ++j) dot += qs[g * D + c + j] * to_float(e[j]);
          }
          s = dot * scale;
        }
        sc[g * page + t] = s;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sc[g * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float s = sc[g * page + t];
        const float p = s > kNegInf ? expf(s - m_new) : 0.f;
        sc[g * page + t] = p;
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
      const float* p = sc + g * page;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < page; ++t) a += p[t] * to_float(vs[t * ld + d]);
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
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* valid_len, void* out, int B, int H,
           int KV, int D, int page, int maxp, int window, int ring,
           float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int ld = D + 16 / (int)sizeof(T);
  const size_t smem = 2 * (size_t)page * ld * sizeof(T) +
                      sizeof(float) * ((size_t)G * D * 2 + (size_t)G * page + 3 * G);
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
    e = cudaFuncSetAttribute(paged_decode_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = smem;
  }
  dim3 grid(B, KV);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(valid_len), static_cast<T*>(out), H, KV, D,
      page, maxp, window, ring, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  Returns cudaGetLastError().
extern "C" int paged_attention_decode(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* valid_len, void* out, int B,
                                      int H, int KV, int D, int page, int maxp,
                                      int window, int ring, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, valid_len, out,
                                 B, H, KV, D, page, maxp, window, ring, scale, s);
  return launch<float>(q, k_pages, v_pages, table, valid_len, out, B, H, KV, D,
                       page, maxp, window, ring, scale, s);
}
