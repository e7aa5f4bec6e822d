// Split-KV ("flash decoding") helpers shared by the two decode-attention
// kernels for Hopper (sm_90a): paged_attention.cu (K1, over a page table)
// and decode_attention.cu (K4, over a contiguous cache).
//
// Both cut a lane's keys into splits; each (lane, KV head, split) block
// writes the fp32 softmax state (m, l, acc) of its G query rows to a
// workspace of the wrapper's, (B, H, splits, 2) for (m, l) and (B, H,
// splits, D) for acc, and `split_combine_kernel` merges the splits of each
// (lane, query head) into o.  A split that saw no live key writes m = -inf
// and l = 0 and adds nothing; a row with no live split gets 0 / 1e-30 = 0.
// Where the caller asks for it (K4's `return_lse`, a rank's block of a
// sequence-sharded cache), the combine also writes the row's log-sum-exp
// of its scaled scores, max m + log(sum l), from the (m, l) it reduces
// anyway (-inf for a row with no live key), so that the ranks' partial
// softmax states can be merged across blocks.

#pragma once

#include "mma_bf16.cuh"

namespace {

constexpr int kCombineThreads = 128;  // 4 warps, one (lane, query head) each
constexpr int kCombineWarps = kCombineThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of shared memory as fp32: 8 bf16 or 4 fp32 values
__device__ __forceinline__ void load16(float* f, const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ void load16(float* f, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the softmax state (m, l, acc) of two disjoint key sets, merged into the
// first; either may be empty (m = -inf, l = 0, acc = 0)
template <int V>
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float mo, float lo, const float* acco) {
  const float mm = fmaxf(m, mo);
  const float a = m == -INFINITY ? 0.f : expf(m - mm);
  const float c = mo == -INFINITY ? 0.f : expf(mo - mm);
  l = l * a + lo * c;
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = acc[j] * a + acco[j] * c;
  m = mm;
}

// One warp per (lane, query head): o = sum_s w_s acc_s / sum_s w_s l_s
// with w_s = exp(m_s - max m); splits with m_s = -inf are skipped, and a
// row with no live split gets 0 / 1e-30 = 0.  `lse`, where not null,
// takes max m + log(sum_s w_s l_s), or -inf for such a row.  Launched as a programmatic
// dependent of the split kernel (`launch_combine`): its blocks may start
// while the split kernel's last blocks run, and `griddepcontrol.wait`
// holds them until that grid has finished and its writes are visible.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
split_combine_kernel(const float* __restrict__ ws_ml,
                     const float* __restrict__ ws_acc, T* __restrict__ out,
                     float* __restrict__ lse, int rows, int D, int splits) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* ml = ws_ml + (size_t)row * splits * 2;
  float mm = -INFINITY;
  for (int s = lane; s < splits; s += 32) mm = fmaxf(mm, ml[2 * s]);
  mm = warp_max(mm);
  float ll = 0.f;
  for (int s = lane; s < splits; s += 32)
    if (ml[2 * s] != -INFINITY) ll += expf(ml[2 * s] - mm) * ml[2 * s + 1];
  ll = warp_sum(ll);
  if (lse != nullptr && lane == 0)
    lse[row] = mm == -INFINITY ? -INFINITY : mm + logf(ll);
  ll = fmaxf(ll, 1e-30f);
  const float* ac = ws_acc + (size_t)row * splits * D;
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      if (ml[2 * s] != -INFINITY) a += expf(ml[2 * s] - mm) * ac[s * D + d];
    store(out + (size_t)row * D + d, a / ll);
  }
}

// the combine on `stream`, after the split kernel launched just before it
// there; programmatic stream serialization lets its launch overlap that
// kernel's tail (Hopper).  `lse` (rows,) fp32, or null for none.
template <typename T>
int launch_combine(const void* ws_ml, const void* ws_acc, void* out,
                   void* lse, int rows, int D, int splits,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kCombineWarps - 1) / kCombineWarps);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, split_combine_kernel<T>, static_cast<const float*>(ws_ml),
      static_cast<const float*>(ws_acc), static_cast<T*>(out),
      static_cast<float*>(lse), rows, D, splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
