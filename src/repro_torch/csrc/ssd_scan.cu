// Mamba-2 SSD scan for Hopper (sm_90a): the selective state-space
// recurrence of one Mamba-2 layer over a whole prompt, from a zero state.
//
//   h_t = exp(a_t) h_{t-1} + dt_t x_t B_t^T      h: (P x N) per head, fp32
//   y_t = h_t C_t
//
// Replaces: src/repro/kernels/ssd_scan.py, function `ssd_scan` (Pallas
// body `_ssd_kernel`).  Same function -- the oracle is the per-step
// recurrence `ref.ssd_ref`, which the Pallas kernel and the model's
// chunked `ssd_chunked` compute in chunked form -- with what the port's
// path needs: any sequence length (the Pallas wrapper drops a ragged tail
// by integer division; here the final state is the state after exactly S
// tokens), and strides, so the model's (B, S, H, P) x and its (B, S, conv)
// B and C slices are read in place, and y is written in the model's
// (B, S, H, P) layout.
//
// What bounds it on the H100: bytes (5 operations per state element per
// token: h * exp(a) + (x dt) B and C . h; at the bf16 matrix peak a
// chunked form would run the products at), but a sequential recurrence
// over S tokens is latency-bound in practice.
//
// What this first design does about it: it computes the recurrence itself,
// token by token, in fp32, and spreads the state over threads so that each
// step is short.  One block per (32 columns of P, head, batch): at
// zamba2's shape (P 64, 80 heads) that is 160 blocks of 256 threads.  Each
// thread keeps 8 of its row's N state values in registers (n = j * NG +
// lane group), so a token costs 16 fused multiply-adds and a 3-step
// shuffle reduction for y.  Tokens are staged 32 at a time in shared
// memory (B and C rows, the block's x columns, dt and exp(a)), so the
// recurrence never waits on device memory; y is gathered per chunk and
// written back as whole rows.  The chunked matrix form (the intra-chunk
// C B^T product on tensor cores, as the Pallas kernel does on the MXU) is
// later work, measured against this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kChunk = 32;    // tokens staged per step
constexpr int kColsMax = 32;  // columns of P per block
constexpr int kPerThread = 8;  // state values of a row per thread (max)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Element strides: x, dt, a, y as (batch, head, seq); b, c as (batch, seq).
// The last dim of x, b, c and y is contiguous.
struct Strides {
  long long xb, xh, xs, db, dh, ds, ab, ah, as, bb, bs, cb, cs, yb, yh, ys;
};

template <typename T>
__global__ void ssd_scan_kernel(const T* __restrict__ x,
                                const float* __restrict__ dt,
                                const float* __restrict__ a,
                                const T* __restrict__ bm,
                                const T* __restrict__ cm,
                                float* __restrict__ y,
                                float* __restrict__ state_out, int H, int S,
                                int P, int N, int cols, int ng, Strides st) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * cols;
  const int tid = threadIdx.x;
  const int col = tid / ng;   // the thread's column of P in the block
  const int grp = tid % ng;   // its lane group: n = j * ng + grp
  const int p = p0 + col;
  const int nthreads = blockDim.x;
  // lanes of one column are adjacent (ng is a power of two, so a group
  // never straddles a warp); the reduction shuffles within them, over the
  // lanes that exist in this warp
  const int in_warp = min(32, nthreads - (tid & ~31));
  const unsigned mask = in_warp == 32 ? 0xffffffffu : ((1u << in_warp) - 1u);

  extern __shared__ __align__(16) float smem[];
  float* sb = smem;                 // kChunk x N   B rows
  float* sc = sb + kChunk * N;      // kChunk x N   C rows
  float* sx = sc + kChunk * N;      // kChunk x cols  x columns
  float* sy = sx + kChunk * cols;   // kChunk x cols  y columns
  float* sdt = sy + kChunk * cols;  // kChunk
  float* sda = sdt + kChunk;        // kChunk  exp(a_t)

  const T* xbh = x + b * st.xb + h * st.xh;
  const float* dbh = dt + b * st.db + h * st.dh;
  const float* abh = a + b * st.ab + h * st.ah;
  const T* bb = bm + b * st.bb;
  const T* cb = cm + b * st.cb;
  float* ybh = y + b * st.yb + h * st.yh;

  float hs[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) hs[j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int nt = min(kChunk, S - s0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < nt * N; i += nthreads) {
      const int t = i / N, n = i - t * N;
      sb[i] = to_float(bb[(long long)(s0 + t) * st.bs + n]);
      sc[i] = to_float(cb[(long long)(s0 + t) * st.cs + n]);
    }
    for (int i = tid; i < nt * cols; i += nthreads) {
      const int t = i / cols, c = i - t * cols;
      sx[i] = p0 + c < P ? to_float(xbh[(long long)(s0 + t) * st.xs + p0 + c])
                         : 0.f;
    }
    for (int t = tid; t < nt; t += nthreads) {
      sdt[t] = dbh[(long long)(s0 + t) * st.ds];
      sda[t] = expf(abh[(long long)(s0 + t) * st.as]);
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float da = sda[t];
      const float xdt = sx[t * cols + col] * sdt[t];
      const float* brow = sb + t * N;
      const float* crow = sc + t * N;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int n = j * ng + grp;
        if (n < N) {
          hs[j] = hs[j] * da + xdt * brow[n];
          acc += crow[n] * hs[j];
        }
      }
      for (int off = ng >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(mask, acc, off);
      if (grp == 0) sy[t * cols + col] = acc;
    }
    __syncthreads();
    for (int i = tid; i < nt * cols; i += nthreads) {
      const int t = i / cols, c = i - t * cols;
      if (p0 + c < P) ybh[(long long)(s0 + t) * st.ys + p0 + c] = sy[i];
    }
  }

  if (p < P) {
    float* srow = state_out + (((size_t)b * H + h) * P + p) * N;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int n = j * ng + grp;
      if (n < N) srow[n] = hs[j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int B, int H, int S, int P,
           int N, const Strides& st, cudaStream_t stream) {
  // lane groups per column: a power of two with ng * kPerThread >= N
  int ng = 1;
  while (ng * kPerThread < N) ng <<= 1;
  const int cols = P < kColsMax ? P : kColsMax;
  if (ng > 32 || cols * ng > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * (size_t)kChunk * N +
                                       2 * (size_t)kChunk * cols + 2 * kChunk);
  static size_t configured[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > configured[dev]) {
    e = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = smem;
  }
  dim3 grid((P + cols - 1) / cols, H, B);
  ssd_scan_kernel<T><<<grid, cols * ng, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(state), H, S, P, N, cols, ng, st);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, S, P) and b, c (B, S, N) in `dtype` (0 = bfloat16, 1 =
// float32); dt, a (B, H, S) float32; y (B, H, S, P) and state (B, H, P, N)
// float32, state contiguous.  `strides` points to 16 int64 element strides
// in the order of `Strides`.  Returns cudaGetLastError().
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* bm, const void* cm, void* y, void* state,
                        int B, int H, int S, int P, int N,
                        const long long* strides, int dtype, void* stream) {
  Strides st;
  memcpy(&st, strides, sizeof(st));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, B, H, S, P, N,
                                 st, s);
  return launch<float>(x, dt, a, bm, cm, y, state, B, H, S, P, N, st, s);
}
