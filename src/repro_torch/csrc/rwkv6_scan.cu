// RWKV-6 WKV for Hopper (sm_90a): the linear-attention recurrence with a
// data-dependent per-channel decay of one RWKV-6 time-mix layer over a
// whole prompt, from a zero state.
//
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)       S: (hd x hd) per head, fp32
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,          w_t = exp(logw_t)
//
// Replaces: src/repro/kernels/rwkv6_scan.py, function `rwkv6_wkv` (Pallas
// body `_wkv_kernel`).  The function is the recurrence of the Pallas
// kernel's docstring and of its oracle `ref.rwkv6_wkv_ref`, computed
// exactly.  The Pallas kernel and the model's `wkv_chunked` instead split
// the pairwise decay exp(csum[t-1] - csum[s]) into exp(csum[t-1]) and
// exp(-csum[s]), each clamped at +-30: once a chunk's cumulative log-decay
// falls below -30 both clamps bite and distant pairs get weight ~1 instead
// of ~0 (at the model's decay of about -1 per token, any chunk longer than
// ~30 tokens).  This kernel steps the recurrence token by token, so every
// decay is a product of factors w <= 1 and nothing is clamped.  It also
// takes any sequence length (the Pallas wrapper drops a ragged tail by
// integer division) and strides, so the model's (B, S, H, hd) r, k, v and
// logw are read in place and o is written in the model's layout.
//
// What bounds it on the H100: bytes (5 operations per state element per
// token: r . S and w * S + k v; 14 bytes of r, k, v, logw and o per
// channel; at the bf16 matrix peak a chunked form would run the products
// at), but a sequential recurrence over S tokens is latency-bound in
// practice.
//
// What this first design does about it: it spreads each head's state over
// threads so that each step is short.  One block per (32 columns of v,
// head, batch): at rwkv6-7b's shape (hd 64, 64 heads) that is 128 blocks
// of 256 threads.  Each thread keeps 8 state values of its column in
// registers (k = j * NG + lane group), so a token costs 24 fused
// multiply-adds and a 3-step shuffle reduction for o.  Tokens are staged
// 32 at a time in shared memory (r, k and w = exp(logw) rows, the block's
// v columns), so the recurrence never waits on device memory; o is
// gathered per chunk and written back as whole rows.  A chunked matrix
// form on tensor cores, with the pairwise decay computed exactly, is later
// work, measured against this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kChunk = 32;     // tokens staged per step
constexpr int kColsMax = 32;   // columns of v per block
constexpr int kPerThread = 8;  // state values of a column per thread (max)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Element strides (batch, head, seq) of r, k, v, logw and o; the last dim
// of each is contiguous.
struct Strides {
  long long rb, rh, rs, kb, kh, ks, vb, vh, vs, wb, wh, ws, ob, oh, os;
};

template <typename T>
__global__ void rwkv6_wkv_kernel(const T* __restrict__ r,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const float* __restrict__ logw,
                                 const float* __restrict__ u,
                                 float* __restrict__ o,
                                 float* __restrict__ state_out, int H, int S,
                                 int hd, int cols, int ng, Strides st) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * cols;
  const int tid = threadIdx.x;
  const int col = tid / ng;   // the thread's column of v in the block
  const int grp = tid % ng;   // its lane group: k = j * ng + grp
  const int vc = c0 + col;
  const int nthreads = blockDim.x;
  // lanes of one column are adjacent (ng is a power of two, so a group
  // never straddles a warp); the reduction shuffles within them, over the
  // lanes that exist in this warp
  const int in_warp = min(32, nthreads - (tid & ~31));
  const unsigned mask = in_warp == 32 ? 0xffffffffu : ((1u << in_warp) - 1u);

  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                  // kChunk x hd  r rows
  float* sk = sr + kChunk * hd;      // kChunk x hd  k rows
  float* sw = sk + kChunk * hd;      // kChunk x hd  w = exp(logw) rows
  float* sv = sw + kChunk * hd;      // kChunk x cols  v columns
  float* so = sv + kChunk * cols;    // kChunk x cols  o columns
  float* su = so + kChunk * cols;    // hd  bonus u of this head

  const T* rbh = r + b * st.rb + h * st.rh;
  const T* kbh = k + b * st.kb + h * st.kh;
  const T* vbh = v + b * st.vb + h * st.vh;
  const float* wbh = logw + b * st.wb + h * st.wh;
  float* obh = o + b * st.ob + h * st.oh;
  for (int i = tid; i < hd; i += nthreads) su[i] = u[(size_t)h * hd + i];

  float ss[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) ss[j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int nt = min(kChunk, S - s0);
    __syncthreads();  // the previous chunk's readers are done (and su set)
    for (int i = tid; i < nt * hd; i += nthreads) {
      const int t = i / hd, c = i - t * hd;
      const long long s = s0 + t;
      sr[i] = to_float(rbh[s * st.rs + c]);
      sk[i] = to_float(kbh[s * st.ks + c]);
      sw[i] = expf(wbh[s * st.ws + c]);
    }
    for (int i = tid; i < nt * cols; i += nthreads) {
      const int t = i / cols, c = i - t * cols;
      sv[i] = c0 + c < hd ? to_float(vbh[(long long)(s0 + t) * st.vs + c0 + c])
                          : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float vv = sv[t * cols + col];
      const float* rrow = sr + t * hd;
      const float* krow = sk + t * hd;
      const float* wrow = sw + t * hd;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int kk = j * ng + grp;
        if (kk < hd) {
          const float kv = krow[kk] * vv;
          acc += rrow[kk] * (ss[j] + su[kk] * kv);
          ss[j] = ss[j] * wrow[kk] + kv;
        }
      }
      for (int off = ng >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(mask, acc, off);
      if (grp == 0) so[t * cols + col] = acc;
    }
    __syncthreads();
    for (int i = tid; i < nt * cols; i += nthreads) {
      const int t = i / cols, c = i - t * cols;
      if (c0 + c < hd) obh[(long long)(s0 + t) * st.os + c0 + c] = so[i];
    }
  }

  if (vc < hd) {
    float* sbh = state_out + ((size_t)b * H + h) * hd * hd;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int kk = j * ng + grp;
      if (kk < hd) sbh[(size_t)kk * hd + vc] = ss[j];
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* o, void* state, int B, int H, int S, int hd,
           const Strides& st, cudaStream_t stream) {
  // lane groups per column: a power of two with ng * kPerThread >= hd
  int ng = 1;
  while (ng * kPerThread < hd) ng <<= 1;
  const int cols = hd < kColsMax ? hd : kColsMax;
  if (ng > 32 || cols * ng > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (3 * (size_t)kChunk * hd +
                                       2 * (size_t)kChunk * cols + hd);
  static size_t configured[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > configured[dev]) {
    e = cudaFuncSetAttribute(rwkv6_wkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = smem;
  }
  dim3 grid((hd + cols - 1) / cols, H, B);
  rwkv6_wkv_kernel<T><<<grid, cols * ng, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<float*>(state), H, S, hd, cols, ng, st);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v (B, H, S, hd) in `dtype` (0 = bfloat16, 1 = float32); logw
// (B, H, S, hd) float32; u (H, hd) float32 contiguous; o (B, H, S, hd) and
// state (B, H, hd, hd) float32, state contiguous and indexed [k][v].
// `strides` points to 15 int64 element strides in the order of `Strides`.
// Returns cudaGetLastError().
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, void* o, void* state,
                         int B, int H, int S, int hd, const long long* strides,
                         int dtype, void* stream) {
  Strides st;
  memcpy(&st, strides, sizeof(st));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(r, k, v, logw, u, o, state, B, H, S, hd, st,
                                 s);
  return launch<float>(r, k, v, logw, u, o, state, B, H, S, hd, st, s);
}
