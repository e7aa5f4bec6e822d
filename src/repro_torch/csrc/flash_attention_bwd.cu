// Flash-attention backward for Hopper (sm_90a): the two passes that turn
// dO into dQ, dK and dV from the forward's saved log-sum-exp.
//
// Replaces: src/repro/kernels/flash_attention.py, function
// `flash_attention_bwd` -- its two `pallas_call`s, `_dq_kernel` (dQ) and
// `_dkv_kernel` (dK, dV), with the tile skip of `_tile_live`.  Same
// function: p = exp(s - lse) recomputed under the causal / window mask,
// ds = p * (dO.V^T - delta) * scale, dQ = ds.K, dK = ds^T.Q, dV = p^T.dO,
// dK and dV summed over the G query heads of each KV head.  The port adds
// what K2 (csrc/flash_attention_fwd.cu) has: a `q_offset` (query row i at
// absolute position q_offset + i, key j at j), separate query and key
// lengths, arbitrary (batch, head, sequence) strides with a contiguous
// head dim, and ragged tails masked instead of dropped.  `delta` =
// rowsum(dO * O), which the Pallas wrapper computes with jnp before its
// kernels, is fused into the dQ pass: each dQ block computes it for its
// 64 rows and writes it out for the dK/dV pass, which runs after it on
// the same stream.
//
// What bounds it on the H100: operations.  At the training shape (S 4096,
// D 64, causal) the seven S x S x D products of the two passes do ~3,000
// operations per byte of Q/K/V/O/dO read and dQ/dK/dV written, ten times
// the card's ~295 per byte at the bf16 tensor-core peak.
//
// What this first design does about it: little yet, on purpose -- it is
// right and simple first.  Both passes are the flash recurrence on the
// SIMT cores in fp32, shaped like K2: 256 threads per block, each thread
// owning a 4 x 4 tile of scores and 4 rows x D/16 columns of its output;
// tiles of 64 rows staged in shared memory as fp32 (transposed, so the
// score products read float4s); tiles outside the causal / window band
// never loaded.
// - dQ: one block per (64-query tile, head, batch), looping over the live
//   64-key tiles; dQ accumulates in registers and is written once.
// - dK/dV: one block per (64-key tile, KV head, batch), looping over the G
//   query heads of that KV head and, for each, over the live 64-query
//   tiles -- the Pallas grid (b, kvh, nk, nq, g) with its scratch held
//   over q and g becomes that loop.  dK and dV accumulate in registers
//   and are written once: no atomics, so the result is deterministic.
// A thread's output columns are tx + 16 j, so the products that read the
// transposed tiles by column conflict at most two ways in shared memory
// and the final stores are coalesced.  Scores, probabilities and every
// accumulator are fp32; the outputs are rounded once.  Moving the
// products onto `mma`/`wgmma` with bf16 operands is later work, measured
// against this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;           // rows of every tile, queries and keys
constexpr int kThreads = 256;    // 16 x 16: 4 rows x 4 columns each
constexpr int kLT = kB + 4;      // padded row of a transposed (D x 64) tile
constexpr int kLS = kB + 1;      // padded row of a (64 x 64) score tile
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

struct Mask {
  int Sq, Sk, causal, window, q_offset;
  __device__ __forceinline__ bool visible(int qi, int kj) const {
    if (qi >= Sq || kj >= Sk) return false;
    const int qpos = q_offset + qi;
    if (causal && kj > qpos) return false;
    if (window > 0 && kj <= qpos - window) return false;
    return true;
  }
};

// rows [row0, row0 + 64) of one (S, D) matrix -> dst[d * kLT + r] as fp32,
// zeros past `rows`
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 long long stride, int row0,
                                                 int rows) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = row0 + r;
    dst[d * kLT + r] = row < rows ? to_float(src[row * stride + d]) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void dot_4x4(const float* a, const float* b,
                                        int ai, int bi, float acc[4][4]) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 av = *reinterpret_cast<const float4*>(a + d * kLT + ai);
    const float4 bv = *reinterpret_cast<const float4*>(b + d * kLT + bi);
    const float aa[4] = {av.x, av.y, av.z, av.w};
    const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += aa[i] * ba[j];
  }
}

// ---------------------------------------------------------------------------
// dQ (and delta): grid (ceil(Sq / 64), H, B)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int H,
                    int KVH, Mask mask, Strides sq, Strides sk, Strides sv,
                    Strides so, Strides sdo, Strides sdq, float scale) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // D x kLT   q^T
  float* dot = qt + D * kLT;        // D x kLT   dO^T
  float* kt = dot + D * kLT;        // D x kLT   k^T
  float* vt = kt + D * kLT;         // D x kLT   v^T
  float* ds = vt + D * kLT;         // 64 x kLS  ds
  __shared__ float lse_s[kB], delta_s[kB];

  const int Sq = mask.Sq, Sk = mask.Sk;
  const int q_start = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // query rows ty*4 .. +3
  const int tx = tid & 15;          // keys tx*4 .. +3, dq cols tx + 16 j

  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  const size_t row_base = ((size_t)b * H + h) * Sq;

  stage_transposed<T, D>(qt, q + b * sq.b + h * sq.h, sq.s, q_start, Sq);
  stage_transposed<T, D>(dot, dout + b * sdo.b + h * sdo.h, sdo.s, q_start,
                         Sq);
  __syncthreads();
  {  // delta = rowsum(dO * O): 4 threads per row, lanes 4r .. 4r+3
    const int r = tid >> 2, part = tid & 3;
    const int qi = q_start + r;
    float acc = 0.f;
    if (qi < Sq) {
      const T* orow = o + b * so.b + h * so.h + qi * so.s;
      for (int d = part; d < D; d += 4) acc += dot[d * kLT + r] * to_float(orow[d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      delta_s[r] = acc;
      lse_s[r] = qi < Sq ? lse[row_base + qi] : 0.f;
      if (qi < Sq) delta[row_base + qi] = acc;
    }
  }
  __syncthreads();

  float lse_r[4], delta_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse_s[ty * 4 + i];
    delta_r[i] = delta_s[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // key range any row of this tile can see (the Pallas `_tile_live`)
  const int q_last = min(q_start + kB, Sq) - 1;
  const int k_end = mask.causal ? min(Sk, mask.q_offset + q_last + 1) : Sk;
  const int k_begin =
      mask.window > 0 ? max(0, mask.q_offset + q_start - mask.window + 1) : 0;

  for (int k_start = (k_begin / kB) * kB; k_start < k_end; k_start += kB) {
    __syncthreads();  // the previous tile's readers are done with kt/vt/ds
    stage_transposed<T, D>(kt, kb, sk.s, k_start, Sk);
    stage_transposed<T, D>(vt, vb, sv.s, k_start, Sk);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    dot_4x4<D>(qt, kt, ty * 4, tx * 4, s);
    dot_4x4<D>(dot, vt, ty * 4, tx * 4, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_start + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k_start + tx * 4 + j;
        const float p =
            mask.visible(qi, kj) ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds[(ty * 4 + i) * kLS + tx * 4 + j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

    // dQ += ds . K
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float kk[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) kk[j] = kt[(tx + 16 * j) * kLT + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dsv = ds[(ty * 4 + i) * kLS + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] += dsv * kk[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_start + ty * 4 + i;
    if (qi >= Sq) continue;
    T* row = dq + b * sdq.b + h * sdq.h + qi * sdq.s;
#pragma unroll
    for (int j = 0; j < DC; ++j) store(row + tx + 16 * j, acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: grid (ceil(Sk / 64), KVH, B)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int KVH, Mask mask, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, float scale) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                 // D x kLT   k^T (whole block)
  float* vt = kt + D * kLT;         // D x kLT   v^T (whole block)
  float* qt = vt + D * kLT;         // D x kLT   q^T (per query tile)
  float* dot = qt + D * kLT;        // D x kLT   dO^T (per query tile)
  float* ps = dot + D * kLT;        // 64 x kLS  p^T  (keys x queries)
  float* dss = ps + kB * kLS;       // 64 x kLS  ds^T
  __shared__ float lse_s[kB], delta_s[kB];

  const int Sq = mask.Sq, Sk = mask.Sk;
  const int k_start = blockIdx.x * kB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;          // keys ty*4 .. +3
  const int tx = tid & 15;          // queries tx*4 .. +3, out cols tx + 16 j

  stage_transposed<T, D>(kt, k + b * sk.b + kvh * sk.h, sk.s, k_start, Sk);
  stage_transposed<T, D>(vt, v + b * sv.b + kvh * sv.h, sv.s, k_start, Sk);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // query range that can see any key of this tile (the Pallas `_tile_live`)
  const int k_last = min(k_start + kB, Sk) - 1;
  const int q_begin = mask.causal ? max(0, k_start - mask.q_offset) : 0;
  const int q_end = mask.window > 0
                        ? min(Sq, k_last - mask.q_offset + mask.window)
                        : Sq;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* dob = dout + b * sdo.b + h * sdo.h;
    const size_t row_base = ((size_t)b * H + h) * Sq;
    for (int q_start = (q_begin / kB) * kB; q_start < q_end; q_start += kB) {
      __syncthreads();  // the previous tile's readers are done
      stage_transposed<T, D>(qt, qb, sq.s, q_start, Sq);
      stage_transposed<T, D>(dot, dob, sdo.s, q_start, Sq);
      if (tid < kB) {
        const int qi = q_start + tid;
        lse_s[tid] = qi < Sq ? lse[row_base + qi] : 0.f;
        delta_s[tid] = qi < Sq ? delta[row_base + qi] : 0.f;
      }
      __syncthreads();

      float st[4][4] = {}, dpt[4][4] = {};
      dot_4x4<D>(kt, qt, ty * 4, tx * 4, st);
      dot_4x4<D>(vt, dot, ty * 4, tx * 4, dpt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q_start + tx * 4 + j;
        const float l = lse_s[tx * 4 + j], dl = delta_s[tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k_start + ty * 4 + i;
          const float p =
              mask.visible(qi, kj) ? expf(st[i][j] * scale - l) : 0.f;
          ps[(ty * 4 + i) * kLS + tx * 4 + j] = p;
          dss[(ty * 4 + i) * kLS + tx * 4 + j] = p * (dpt[i][j] - dl) * scale;
        }
      }
      __syncthreads();

      // dV += p^T . dO,  dK += ds^T . Q
#pragma unroll 4
      for (int c = 0; c < kB; ++c) {
        float qq[DC], dd[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          qq[j] = qt[(tx + 16 * j) * kLT + c];
          dd[j] = dot[(tx + 16 * j) * kLT + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = ps[(ty * 4 + i) * kLS + c];
          const float dsv = dss[(ty * 4 + i) * kLS + c];
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            acc_v[i][j] += pv * dd[j];
            acc_k[i][j] += dsv * qq[j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k_start + ty * 4 + i;
    if (kj >= Sk) continue;
    T* krow = dk + b * sdk.b + kvh * sdk.h + kj * sdk.s;
    T* vrow = dv + b * sdv.b + kvh * sdv.h + kj * sdv.s;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      store(krow + tx + 16 * j, acc_k[i][j]);
      store(vrow + tx + 16 * j, acc_v[i][j]);
    }
  }
}

// Raise the opt-in shared-memory limit of one kernel once per device (the
// attribute is per device; this also keeps the call out of CUDA-graph
// captures after the first launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > configured[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    configured[dev] = smem;
  }
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int B, H, KVH;
  Mask mask;
  Strides s[6];
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = sizeof(float) * (4 * (size_t)D * kLT + kB * kLS);
  static size_t configured[kMaxDevices];
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.mask.Sq + kB - 1) / kB, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.H, a.KVH, a.mask,
      a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t smem =
      sizeof(float) * (4 * (size_t)D * kLT + 2 * kB * kLS);
  static size_t configured[kMaxDevices];
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.mask.Sk + kB - 1) / kB, a.KVH, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.KVH, a.mask,
      a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.scale);
  return (int)cudaGetLastError();
}

template <bool DQ, typename T>
int by_dim(int D, const Args& a) {
  switch (D) {
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
int by_type(int dtype, int D, const Args& a) {
  return dtype == 0 ? by_dim<DQ, __nv_bfloat16>(D, a) : by_dim<DQ, float>(D, a);
}

Args make_args(int B, int H, int KVH, int Sq, int Sk, const long long* st,
               int causal, int window, int q_offset, float scale,
               void* stream) {
  Args a{};
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.mask = Mask{Sq, Sk, causal, window, q_offset};
  for (int i = 0; i < 6; ++i) a.s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// Both entry points: `strides` is a host array of 18 int64, the (batch,
// head, sequence) element strides of six tensors in the order named
// below; every head dim is contiguous, lse and delta are contiguous
// (B, H, Sq) fp32.  dtype: 0 = bfloat16, 1 = float32.  Returns
// cudaGetLastError() after the launch.

// dQ and delta.  Stride order: q, k, v, o, dO, dQ.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, int B, int H,
    int KVH, int Sq, int Sk, int D, const long long* strides, int causal,
    int window, int q_offset, float scale, int dtype, void* stream) {
  Args a = make_args(B, H, KVH, Sq, Sk, strides, causal, window, q_offset,
                     scale, stream);
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse;
  a.delta = delta; a.dq = dq;
  return by_type<true>(dtype, D, a);
}

// dK and dV, from the delta the dQ pass wrote.  Stride order: q, k, v, dO,
// dK, dV.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KVH, int Sq, int Sk, int D, const long long* strides, int causal,
    int window, int q_offset, float scale, int dtype, void* stream) {
  Args a = make_args(B, H, KVH, Sq, Sk, strides, causal, window, q_offset,
                     scale, stream);
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse;
  a.delta = const_cast<void*>(delta); a.dk = dk; a.dv = dv;
  return by_type<false>(dtype, D, a);
}
