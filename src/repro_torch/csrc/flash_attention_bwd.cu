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
// D 64, causal) the seven S x S x D products of the two passes (dQ: q.k,
// dO.v, ds.k; dK/dV: the same two scores again, p^T.dO, ds^T.q) do
// ~3,000 operations per byte of Q/K/V/O/dO read and dQ/dK/dV written,
// ten times the card's ~295 per byte at the bf16 tensor-core peak.  The
// two-pass design recomputes the scores in each pass (7 products against
// a one-pass design's 5) and buys with that a result without atomics:
// deterministic, bit-equal from launch to launch.
//
// Two routes, chosen by the dtype the caller passes:
// - bfloat16 (every call of the model, whose dtype is bf16): the
//   tensor-core kernels `flash_bwd_dq_tc` and `flash_bwd_dkv_tc` below.
// - float32 (only the checks use it): the SIMT kernels `flash_bwd_dq_kernel`
//   and `flash_bwd_dkv_kernel`, which compute every product in fp32 FMAs
//   and so agree with the fp32 plain versions to summation order.  The
//   tensor cores take no fp32 operands short of TF32, which would round
//   the inputs; the fp32 route keeps the reference's arithmetic.
//
// The bf16 design, FlashAttention-2 shaped on `mma.sync.m16n8k16` (bf16
// operands, fp32 accumulators; chosen over `wgmma` + TMA because its
// fragments let the two score products feed the next two products from
// registers with no shared-memory round trip, and because it is simpler
// to make right first).  128 threads a block: 4 warps, each owning 16 of
// the block's 64 rows.  Tiles sit in shared memory as bf16, one copy
// each, rows padded by 8 elements (16 bytes) so that the 8 row addresses
// of every `ldmatrix` fall in distinct bank groups; `ldmatrix` reads an
// operand in its stored orientation and `ldmatrix.trans` transposed, so
// each of Q, K, V, dO is read both ways from that one copy.  The loop's
// tiles are double-buffered with `cp.async` (16 bytes a thread, zero-fill
// past the ragged tail): tile i + 1 loads while tile i is computed.  The
// device helpers (copies, `ldmatrix`, `mma`, fragment repacking) are in
// `mma_bf16.cuh`, shared with the forward's tensor-core kernel.
// - dK/dV (`flash_bwd_dkv_tc`): one block per (64-key tile, KV head,
//   batch); K and V stay in shared memory; the block loops over the G
//   query heads and, for each, over the live query tiles.  Each warp
//   computes S^T = K Q^T and dP^T = V dO^T (16 keys x the tile's queries),
//   then P^T = exp2((S^T scale - lse) log2e) and dS^T = P^T (dP^T - delta)
//   scale in registers, and dV += P^T dO, dK += dS^T Q with P^T and
//   dS^T taken straight from the accumulator registers, repacked as bf16
//   A fragments; Q and dO come through `ldmatrix.trans`.  dK and dV stay
//   in fp32 registers and are written once.  The grid is one dimension
//   with the key tile slowest, so under a causal mask the heaviest blocks
//   (the first keys, which every later query sees) are dispatched first
//   and the light ones fill the tail.
// - dQ (`flash_bwd_dq_tc`): one block per (64-query tile, head, batch);
//   Q and dO stay in shared memory, K and V tiles are double-buffered.
//   delta = rowsum(dO * O) first, then per key tile S = Q K^T, dP = dO
//   V^T, dS = P (dP - delta) scale, and dQ += dS K with dS from registers
//   and K through `ldmatrix.trans`.  Causal grids dispatch the last query
//   tiles, the heaviest, first.
// The loop's tile is 64 rows at head dims up to 64 and 32 at 128, which
// keeps dK + dV (128 fp32 a thread at D 128) and the score tiles in
// registers.  Only tiles that cross the causal / window band or the
// ragged tail evaluate the mask; tiles outside the band are never loaded.
// Rounding: S and dP are exact bf16 products summed in fp32; the exponent
// s scale - lse is formed as the plain version forms it, so that P and dS
// round to the same bf16 values as there except where the two fp32 values
// straddle a rounding boundary.  P and dS
// are rounded to bf16 where they become operands of dV += P^T dO, dK +=
// dS^T Q and dQ += dS K -- as every tensor-core flash backward does --
// and dS is formed from the fp32 P, not the rounded one.  The Pallas
// kernel keeps them in fp32; the plain versions round them at the same
// two places when called with `operand_dtype=torch.bfloat16`.  Outputs
// are rounded once from fp32.

#include "mma_bf16.cuh"

namespace {

constexpr int kB = 64;           // rows of a block's own tile, both routes
constexpr int kThreads = 256;    // SIMT: 16 x 16, 4 rows x 4 columns each
constexpr int kLT = kB + 4;      // padded row of a transposed (D x 64) tile
constexpr int kLS = kB + 1;      // padded row of a (64 x 64) score tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// ===========================================================================
// fp32: the SIMT kernels, every product in fp32 FMAs
// ===========================================================================

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

// ===========================================================================
// bf16: the tensor-core kernels
// ===========================================================================

template <int D>
struct Tile {
  static constexpr int kInner = D <= 64 ? 64 : 32;  // rows of a loop tile
  // shared memory: the two 64-row tiles held, the two double-buffered ones
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kB + 4 * kInner) * kPitch<D>;
};

// ROWS fp32 of one (S,) vector, zeros past `rows`
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int rows) {
  for (int i = threadIdx.x; i < ROWS; i += kTcThreads) {
    const int row = row0 + i;
    const bool ok = row < rows;
    cp_async4(dst + i, src + (ok ? row : 0), ok);
  }
}

// ---------------------------------------------------------------------------
// dQ (and delta): a 1-D grid of ceil(Sq / 64) x H x B blocks
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, bf16* __restrict__ dq, int B,
                int H, int KVH, Mask mask, Strides sq, Strides sk, Strides sv,
                Strides so, Strides sdo, Strides sdq, float scale) {
  constexpr int P = kPitch<D>, N = Tile<D>::kInner;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // 64 x P    Q
  bf16* dos = qs + kB * P;                      // 64 x P    dO
  bf16* ks = dos + kB * P;                      // 2 x N x P K tiles
  bf16* vs = ks + 2 * N * P;                    // 2 x N x P V tiles
  __shared__ float lse_s[kB], delta_s[kB];

  const int Sq = mask.Sq, Sk = mask.Sk;
  // causal: the last query tiles see the most keys; dispatch them first
  const int n_qt = (Sq + kB - 1) / kB;
  const int t = blockIdx.x / (H * B), hb = blockIdx.x % (H * B);
  const int q_start = (mask.causal ? n_qt - 1 - t : t) * kB;
  const int h = hb % H, b = hb / H;
  const int kvh = h / (H / KVH);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row_base = ((size_t)b * H + h) * Sq;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  load_rows<kB, D>(qs, q + b * sq.b + h * sq.h, sq.s, q_start, Sq);
  load_rows<kB, D>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q_start, Sq);
  load_vec<kB>(lse_s, lse + row_base, q_start, Sq);
  cp_async_commit();

  // key tiles any row of this tile can see (the Pallas `_tile_live`)
  const int q_last = min(q_start + kB, Sq) - 1;
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
  cp_async_wait<1>();  // Q, dO and lse have landed; the first K/V may not
  __syncthreads();

  {  // delta = rowsum(dO * O): 2 threads a row, D / 2 columns each
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    const int qi = q_start + r;
    float acc = 0.f;
    if (qi < Sq) {
      const bf16* orow = o + b * so.b + h * so.h + qi * so.s + c0;
      const bf16* drow = dos + r * P + c0;
#pragma unroll
      for (int d = 0; d < D / 2; d += 2) {
        const float2 of = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + d));
        const float2 df = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(drow + d));
        acc = fmaf(of.x, df.x, acc);
        acc = fmaf(of.y, df.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) {
      delta_s[r] = acc;
      if (qi < Sq) delta[row_base + qi] = acc;
    }
  }
  __syncthreads();

  // this lane's two rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int r0 = warp * 16 + (lane >> 2);
  const float ls[2] = {lse_s[r0], lse_s[r0 + 8]};
  const float dl[2] = {delta_s[r0], delta_s[r0 + 8]};
  const bf16* qw = qs + warp * 16 * P;
  const bf16* dow = dos + warp * 16 * P;

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

    float s[N / 8][4], dp[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, N / 8>(s, qw, kt, lane);    // S = Q K^T
    mma_abt<D, N / 8>(dp, dow, vt, lane);  // dP = dO V^T

    const bool full = tile_full(mask, q_start + warp * 16, 16, k0, N);
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f((s[n][e] * scale - ls[i]) * kLog2e);
        if (!full && !mask.visible(q_start + r0 + 8 * i,
                                   k0 + n * 8 + (lane & 3) * 2 + (e & 1)))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - dl[i]) * scale;  // dS
      }
    uint32_t ds[N / 16][4];
    to_a_frags<N / 16>(ds, dp);
    mma_ab<D, N / 16>(acc, ds, kt, lane);  // dQ += dS K
  }
  cp_async_wait<0>();

  store_rows<D>(dq + b * sdq.b + h * sdq.h, sdq.s, acc, q_start + warp * 16,
                Sq, lane);
}

// ---------------------------------------------------------------------------
// dK, dV: a 1-D grid of ceil(Sk / 64) x KVH x B blocks
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int B, int H, int KVH, Mask mask,
                 Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                 Strides sdv, float scale) {
  constexpr int P = kPitch<D>, N = Tile<D>::kInner;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);  // 64 x P    K
  bf16* vs = ks + kB * P;                       // 64 x P    V
  bf16* qs = vs + kB * P;                       // 2 x N x P Q tiles
  bf16* dos = qs + 2 * N * P;                   // 2 x N x P dO tiles
  __shared__ float lse_s[2][N], delta_s[2][N];

  const int Sq = mask.Sq, Sk = mask.Sk;
  // the key tile is the slowest index: under a causal mask the first keys,
  // which every later query sees, make the heaviest blocks and go first
  const int kvb = blockIdx.x % (KVH * B);
  const int k_start = (blockIdx.x / (KVH * B)) * kB;
  const int kvh = kvb % KVH, b = kvb / KVH;
  const int G = H / KVH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_rows<kB, D>(ks, k + b * sk.b + kvh * sk.h, sk.s, k_start, Sk);
  load_rows<kB, D>(vs, v + b * sv.b + kvh * sv.h, sv.s, k_start, Sk);

  // query tiles that can see any key of this tile (the Pallas `_tile_live`)
  const int k_last = min(k_start + kB, Sk) - 1;
  const int q_begin = mask.causal ? max(0, k_start - mask.q_offset) : 0;
  const int q_end = mask.window > 0
                        ? min(Sq, k_last - mask.q_offset + mask.window)
                        : Sq;
  const int q_first = (q_begin / N) * N;
  const int n_tiles = q_end > q_first ? (q_end - q_first + N - 1) / N : 0;
  const int total = G * n_tiles;  // (query head, query tile) pairs
  auto issue = [&](int it) {
    const int s = it & 1, h = kvh * G + it / n_tiles;
    const int q0 = q_first + (it % n_tiles) * N;
    const size_t row_base = ((size_t)b * H + h) * Sq;
    load_rows<N, D>(qs + s * N * P, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
    load_rows<N, D>(dos + s * N * P, dout + b * sdo.b + h * sdo.h, sdo.s,
                    q0, Sq);
    load_vec<N>(lse_s[s], lse + row_base, q0, Sq);
    load_vec<N>(delta_s[s], delta + row_base, q0, Sq);
  };
  if (total > 0) issue(0);
  cp_async_commit();

  const int kw = k_start + warp * 16;  // this warp's first key
  const bf16* kws = ks + warp * 16 * P;
  const bf16* vws = vs + warp * 16 * P;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; all are done with tile it - 1
    if (it + 1 < total) issue(it + 1);
    cp_async_commit();
    const int s = it & 1;
    const int q0 = q_first + (it % n_tiles) * N;
    const bf16* qt = qs + s * N * P;
    const bf16* dot = dos + s * N * P;

    float st[N / 8][4], dpt[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    mma_abt<D, N / 8>(st, kws, qt, lane);    // S^T = K Q^T
    mma_abt<D, N / 8>(dpt, vws, dot, lane);  // dP^T = V dO^T

    const bool full = tile_full(mask, q0, N, kw, 16);
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + (lane & 3) * 2 + (e & 1);  // query in tile
        float p = exp2f((st[n][e] * scale - lse_s[s][c]) * kLog2e);
        if (!full && !mask.visible(q0 + c, kw + (lane >> 2) + (e >> 1) * 8))
          p = 0.f;
        st[n][e] = p;                                         // P^T
        dpt[n][e] = p * (dpt[n][e] - delta_s[s][c]) * scale;  // dS^T
      }
    uint32_t pa[N / 16][4], dsa[N / 16][4];
    to_a_frags<N / 16>(pa, st);
    to_a_frags<N / 16>(dsa, dpt);
    mma_ab<D, N / 16>(acc_v, pa, dot, lane);  // dV += P^T dO
    mma_ab<D, N / 16>(acc_k, dsa, qt, lane);  // dK += dS^T Q
  }
  cp_async_wait<0>();

  store_rows<D>(dk + b * sdk.b + kvh * sdk.h, sdk.s, acc_k, kw, Sk, lane);
  store_rows<D>(dv + b * sdv.b + kvh * sdv.h, sdv.s, acc_v, kw, Sk, lane);
}

// ===========================================================================
// launchers
// ===========================================================================

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int B, H, KVH;
  Mask mask;
  Strides s[6];
  float scale;
  cudaStream_t stream;
};

// fp32: the SIMT kernels
template <int D>
int launch_dq(const Args& a) {
  const size_t smem = sizeof(float) * (4 * (size_t)D * kLT + kB * kLS);
  static size_t configured[kMaxDevices];
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<float, D>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.mask.Sq + kB - 1) / kB, a.H, a.B);
  flash_bwd_dq_kernel<float, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<float*>(a.dq), a.H, a.KVH,
      a.mask, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a) {
  const size_t smem =
      sizeof(float) * (4 * (size_t)D * kLT + 2 * kB * kLS);
  static size_t configured[kMaxDevices];
  cudaError_t e =
      allow_smem(flash_bwd_dkv_kernel<float, D>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.mask.Sk + kB - 1) / kB, a.KVH, a.B);
  flash_bwd_dkv_kernel<float, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.KVH,
      a.mask, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.scale);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core kernels
template <int D>
int launch_dq_tc(const Args& a) {
  static size_t configured[kMaxDevices];
  cudaError_t e =
      allow_smem(flash_bwd_dq_tc<D>, Tile<D>::kSmem, configured);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (a.mask.Sq + kB - 1) / kB * a.H * a.B;
  flash_bwd_dq_tc<D><<<blocks, kTcThreads, Tile<D>::kSmem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<bf16*>(a.dq), a.B, a.H,
      a.KVH, a.mask, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5],
      a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tc(const Args& a) {
  static size_t configured[kMaxDevices];
  cudaError_t e =
      allow_smem(flash_bwd_dkv_tc<D>, Tile<D>::kSmem, configured);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (a.mask.Sk + kB - 1) / kB * a.KVH * a.B;
  flash_bwd_dkv_tc<D><<<blocks, kTcThreads, Tile<D>::kSmem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.B, a.H, a.KVH,
      a.mask, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.scale);
  return (int)cudaGetLastError();
}

// dtype 0 (bf16) -> the tensor-core kernels, 1 (fp32) -> the SIMT ones
template <bool DQ, int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return DQ ? launch_dq_tc<D>(a) : launch_dkv_tc<D>(a);
  return DQ ? launch_dq<D>(a) : launch_dkv<D>(a);
}

template <bool DQ>
int by_dim(int dtype, int D, const Args& a) {
  switch (D) {
    case 16: return launch<DQ, 16>(dtype, a);
    case 32: return launch<DQ, 32>(dtype, a);
    case 64: return launch<DQ, 64>(dtype, a);
    case 128: return launch<DQ, 128>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
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
// (B, H, Sq) fp32.  dtype: 0 = bfloat16 (the tensor-core kernels, whose
// `cp.async` needs every input row 16-byte aligned: base pointers and the
// three strides multiples of 8 elements), 1 = float32 (the SIMT kernels).
// Returns cudaGetLastError() after the launch.

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
  return by_dim<true>(dtype, D, a);
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
  return by_dim<false>(dtype, D, a);
}
