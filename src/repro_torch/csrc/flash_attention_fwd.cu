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
// over ~1k keys does ~1k operations per byte of Q/K/V, and the training
// shape (S 4096, D 64, causal) ~8k, above the card's ~295 operations per
// byte at the bf16 tensor-core peak, so the arithmetic is the limit.
//
// Two routes, chosen by the dtype the caller passes:
// - bfloat16 (every call of the model): the tensor-core kernel
//   `flash_fwd_tc` below.
// - float32 (only the checks use it): the SIMT kernel `flash_fwd_kernel`,
//   every product in fp32 FMAs, so it agrees with the fp32 plain version
//   to summation order: one block of 256 threads per (64-query tile,
//   head, batch), each thread a 4x4 tile of scores and 4 x D/16 outputs,
//   K/V tiles of 64 keys staged in shared memory as fp32.
//
// The bf16 design, FlashAttention-2 shaped on `mma.sync.m16n8k16` (bf16
// operands, fp32 accumulators) with the helpers of `mma_bf16.cuh` that the
// backward uses too.  One block of 4 warps per (64-query tile, head,
// batch), 16 query rows a warp.  Q is copied once with `cp.async` and held
// as A fragments in registers for the whole key loop.  K and V tiles of 64
// keys are double-buffered in shared memory as padded bf16 rows with
// `cp.async`: tile i + 1 loads while tile i is computed.  S = Q K^T takes
// K through `ldmatrix`; the online softmax runs in registers (each row's
// max and sum over the four lanes of a quad, p = exp2(s scale log2e -
// m scale log2e)); O += P V takes P straight from the score accumulators,
// repacked as bf16 A fragments, and V through `ldmatrix.trans`, so P never
// touches shared memory.  GQA indexes the KV head as h / G, so KV is never
// expanded in memory; key tiles outside the causal / window band are
// never loaded, and only tiles that cross the band's edge or the ragged
// tail evaluate the mask.  The grid is one dimension with the query tile
// slowest and, under a causal mask, reversed: the last query tiles, which
// see the most keys, are dispatched first and the light ones fill the
// tail.
// Rounding: S is exact bf16 products summed in fp32, and l sums the fp32
// p; p is rounded to bf16 where it becomes the operand of P V, as every
// tensor-core flash forward does.  The Pallas kernel keeps p in fp32; the
// plain version rounds it at the same place when called with
// `operand_dtype=torch.bfloat16` and the kernel's key tile (`block_k` 64).
// The output is rounded once from fp32.
//
// Head dim 256 (gemma3-12b): the output accumulator of a warp's 16 rows is
// then 128 fp32 registers a thread, and Q's fragments would be 64 more, so
// at D = 256 Q stays in shared memory and each k-step loads its fragment
// there (`ldmatrix`, `mma_abt`), and the key tile is 32 keys instead of 64
// (`kTcBK`): 16 score registers instead of 32, and shared memory of
// (64 + 4 x 32) rows x 264 bf16 = 99 KB, so two blocks fit an SM.  The
// plain version repeats the tile with `block_k = fwd_block_k(256) = 32`.

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16: 4 query rows x 4 keys each

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// ===========================================================================
// fp32: the SIMT kernel
// ===========================================================================

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

// ===========================================================================
// bf16: the tensor-core kernel
// ===========================================================================

// the key tile of the bf16 kernel: 64 keys, 32 at head dim 256
template <int D>
constexpr int kTcBK = D > 128 ? 32 : 64;
// Q's A fragments held in registers for the whole key loop, or (head dim
// 256) loaded from shared memory at each k-step
template <int D>
constexpr bool kQInRegs = D <= 128;

// shared memory: the 64-row Q tile and the double-buffered K and V tiles
template <int D>
constexpr size_t kTcSmem = sizeof(bf16) * (kBQ + 4 * kTcBK<D>) * kPitch<D>;

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int B, int H, int KVH, Mask mask,
             Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  constexpr int P = kPitch<D>, N = kTcBK<D>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // 64 x P    Q
  bf16* ks = qs + kBQ * P;                      // 2 x N x P K tiles
  bf16* vs = ks + 2 * N * P;                    // 2 x N x P V tiles

  const int Sq = mask.Sq, Sk = mask.Sk;
  // causal: the last query tiles see the most keys; dispatch them first
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int t = blockIdx.x / (H * B), hb = blockIdx.x % (H * B);
  const int q_start = (mask.causal ? n_qt - 1 - t : t) * kBQ;
  const int h = hb % H, b = hb / H;
  const int kvh = h / (H / KVH);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  load_rows<kBQ, D>(qs, q + b * sq.b + h * sq.h, sq.s, q_start, Sq);
  cp_async_commit();

  // key tiles any row of this tile can see (the Pallas `_tile_live`)
  const int q_last = min(q_start + kBQ, Sq) - 1;
  const int k_end = mask.causal ? min(Sk, mask.q_offset + q_last + 1) : Sk;
  const int k_begin =
      mask.window > 0 ? max(0, mask.q_offset + q_start - mask.window + 1) : 0;
  const int k_first = (k_begin / N) * N;
  const int n_tiles = k_end > k_first ? (k_end - k_first + N - 1) / N : 0;
  auto issue = [&](int it) {
    const int s = it & 1, k0 = k_first + it * N;
    load_rows<N, D>(ks + s * N * P, kb, sk.s, k0, Sk);
    load_rows<N, D>(vs + s * N * P, vb, sv.s, k0, Sk);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; the first K/V may not
  __syncthreads();

  // this warp's 16 rows of Q, as A fragments in registers (D <= 128)
  const bf16* qw = qs + warp * 16 * P;
  uint32_t qf[kQInRegs<D> ? D / 16 : 1][4];
  if constexpr (kQInRegs<D>) load_a_frags<D>(qf, qw, lane);

  // this lane's two rows of the warp's 16: lane / 4 and lane / 4 + 8; the
  // running max m (of the unscaled scores) and this lane's part of the
  // running sum l, reduced over the quad once at the end
  const int r0 = q_start + warp * 16 + (lane >> 2);
  const float sl2 = scale * kLog2e;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; all are done with tile it - 1
    if (it + 1 < n_tiles) issue(it + 1);
    cp_async_commit();
    const int k0 = k_first + it * N;
    const bf16* kt = ks + (it & 1) * N * P;
    const bf16* vt = vs + (it & 1) * N * P;

    float s[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (kQInRegs<D>) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma_abt_step<D, N / 8>(s, qf[kc], kt, kc, lane);  // S = Q K^T
    } else {
      mma_abt<D, N / 8>(s, qw, kt, lane);  // S = Q K^T, Q from shared
    }

    if (!tile_full(mask, q_start + warp * 16, 16, k0, N)) {
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!mask.visible(r0 + 8 * (e >> 1),
                            k0 + n * 8 + (lane & 3) * 2 + (e & 1)))
            s[n][e] = -INFINITY;
    }

    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float ms[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row that has seen no visible key yet keeps m = -inf: its p and
      // alpha must come out 0, not exp2(-inf + inf)
      ms[i] = mx[i] == -INFINITY ? 0.f : mx[i] * sl2;
      alpha[i] = exp2f(m_r[i] * sl2 - ms[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], sl2, -ms[e >> 1]));
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rs[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    uint32_t pa[N / 16][4];
    to_a_frags<N / 16>(pa, s);
    mma_ab<D, N / 16>(acc, pa, vt, lane);  // O += P V
  }
  cp_async_wait<0>();

  float lc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    lc[i] = fmaxf(l_r[i], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= lc[e >> 1];
  store_rows<D>(o + b * so.b + h * so.h, so.s, acc, q_start + warp * 16, Sq,
                lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row < Sq)
        lse[((size_t)b * H + h) * Sq + row] =
            (m_r[i] == -INFINITY ? kNegInf : m_r[i] * scale) + logf(lc[i]);
    }
  }
}

// ===========================================================================
// launchers
// ===========================================================================

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int B, H, KVH;
  Mask mask;
  Strides sq, sk, sv, so;
  float scale;
  cudaStream_t stream;
};

// fp32: the SIMT kernel
template <int D>
int launch_simt(const Args& a) {
  const size_t smem = sizeof(float) * (2 * (size_t)D * (kBQ + 4) +
                                       (size_t)kBK * (D + 4) +
                                       (size_t)kBQ * (kBK + 1));
  static size_t configured[kMaxDevices];
  cudaError_t e = allow_smem(flash_fwd_kernel<float, D>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.mask.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.H, a.KVH, a.mask.Sq, a.mask.Sk, a.sq,
      a.sk, a.sv, a.so, a.mask.causal, a.mask.window, a.mask.q_offset,
      a.scale);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core kernel
template <int D>
int launch_tc(const Args& a) {
  static size_t configured[kMaxDevices];
  cudaError_t e = allow_smem(flash_fwd_tc<D>, kTcSmem<D>, configured);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (a.mask.Sq + kBQ - 1) / kBQ * a.H * a.B;
  flash_fwd_tc<D><<<blocks, kTcThreads, kTcSmem<D>, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
      static_cast<float*>(a.lse), a.B, a.H, a.KVH, a.mask, a.sq, a.sk, a.sv,
      a.so, a.scale);
  return (int)cudaGetLastError();
}

// dtype 0 (bf16) -> the tensor-core kernel, 1 (fp32) -> the SIMT one
template <int D>
int launch(int dtype, const Args& a) {
  return dtype == 0 ? launch_tc<D>(a) : launch_simt<D>(a);
}

}  // namespace

// Strides are in elements, (batch, head, sequence) for each of q, k, v, o;
// the head dim of each is contiguous and lse is a contiguous (B, H, Sq).
// dtype: 0 = bfloat16 (the tensor-core kernel, whose `cp.async` needs
// every q, k, v row 16-byte aligned: base pointers and the three strides
// multiples of 8 elements), 1 = float32 (the SIMT kernel).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KVH, int Sq, int Sk, int D, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    int causal, int window, int q_offset, float scale, int dtype,
    void* stream) {
  const Args a{q, k, v, o, lse, B, H, KVH,
               Mask{Sq, Sk, causal, window, q_offset},
               Strides{qb, qh, qs}, Strides{kb, kh, ks}, Strides{vb, vh, vs},
               Strides{ob, oh, os}, scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return launch<16>(dtype, a);
    case 32: return launch<32>(dtype, a);
    case 64: return launch<64>(dtype, a);
    case 80: return launch<80>(dtype, a);  // zamba2-2.7b's shared attention
    case 128: return launch<128>(dtype, a);
    case 256: return launch<256>(dtype, a);  // gemma3-12b
    default: return (int)cudaErrorInvalidValue;
  }
}
