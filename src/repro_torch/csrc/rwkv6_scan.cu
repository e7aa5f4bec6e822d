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
// without the reference's fault: the Pallas kernel and the model's
// `wkv_chunked` split the pairwise decay exp(csum[t-1] - csum[s]) into
// exp(csum[t-1]) and exp(-csum[s]), each clamped at +-30, so once a
// chunk's cumulative log-decay falls below -30 distant pairs get weight ~1
// instead of ~0.  It also takes any sequence length (the Pallas wrapper
// drops a ragged tail by integer division) and strides, so the model's
// (B, S, H, hd) r, k, v and logw are read in place and o is written in the
// model's layout.
//
// What bounds it on the H100: bytes (5 operations per state element and
// token, on the tensor cores in the chunked form below; 14 bytes of r, k,
// v, logw and o per channel and token).  A recurrence stepped token by
// token is instead bound by its dependent chain: the first design did
// that, ~1600 cycles a token, 0.92 ms for 1000 tokens.
//
// The design (bf16 inputs, every model call): the chunked matrix form of
// the Pallas kernel, in chunks of kQ = 64 tokens cut into 4 sub-chunks of
// 16, in three launches, so that all (chunk, head) pairs run in parallel
// and only a short pass over the chunks' states is sequential (1024
// blocks a launch at rwkv6-7b's shape, against 128 if the columns of v
// were split across blocks that step the chunks in turn; the price is one
// (hd x hd) fp32 state per chunk in device memory, 17 MB there, written,
// passed and read once each).
//   1. wkv_state_tc, one block per (chunk, head, batch): csum = the
//      inclusive sum of logw per channel (one thread a channel, in
//      order); the chunk's own state dS = (k exp(total - csum))^T V
//      (3xTF32 `mma.m16n8k8`, the decayed k split) and its log-decay
//      total per channel, into the scratch.
//   2. wkv_pass_states, one thread per state element: S = exp(total_k) S
//      + dS over the chunks in order, leaving in each chunk's slot the
//      state before it; the last S is the final state.
//   3. wkv_out_tc, one block per (chunk, head, batch), one warp per
//      sub-chunk i of 16 rows t, excl_t = csum_{t-1}:  o = (r
//      exp(excl)) S_prev (both split) + A V (A split), o written once.
//      Columns s of earlier sub-chunks: A[t,s] = (r_t exp(excl_t - rho))
//      . (k_s exp(rho - csum_s)) with the reference point rho = csum at
//      the token before sub-chunk i, both factors split.  The sub-chunk's
//      upper 8 rows against its lower 8 the same way, through rho2 = csum
//      at the lower half's last token.  The 56 pairs s < t inside a half
//      exactly in fp32, spread over the warp's lanes, sum_k r_tk k_sk
//      exp(excl_tk - csum_sk), and the bonus sum_k r_tk u_k k_tk at s = t.
// Every exponent is <= 0 by construction, and nothing is clamped: logw <=
// 0 (the model's logw = -exp(.)), so csum, summed in order, never
// increases; rho and rho2 sit between the two tokens of every pair they
// serve (s <= the point's token <= t - 1), so excl_t - rho and rho -
// csum_s are <= 0; the pairs inside a half take excl_t - csum_s only for
// s < t; and
// total - csum_s, excl_t and total are <= 0.  A factor that underflows
// bounds a true weight below it.  A ragged tail is zero-filled (k = v = 0
// add nothing, logw = 0 keeps the state), so the final state is the state
// after exactly S tokens.  The wrapper counts the three launches as one.
//
// fp32 inputs keep the first design, the recurrence stepped token by token
// in fp32 (rwkv6_wkv_fp32): one block per (32 columns of v, head, batch),
// each thread holding 8 state values of its column in registers, tokens
// staged 32 at a time in shared memory.

#include "chunked_scan.cuh"

#include <string.h>

namespace {

// Element strides (batch, head, seq) of r, k, v, logw and o; the last dim
// of each is contiguous.
struct WkvStrides {
  long long rb, rh, rs, kb, kh, ks, vb, vh, vs, wb, wh, ws, ob, oh, os;
};

// ---------------------------------------------------------------------------
// bf16: the chunked form on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kSub = 16;  // rows of a sub-chunk
constexpr int kHalfPairs = (kSub / 2) * (kSub / 2 - 1) / 2;  // s < t, a half

// shared memory of wkv_state_tc, byte offsets
template <int D>
struct StateTile {
  static constexpr int kP = kPitch<D>;  // bf16 rows of k, v
  static constexpr int kF = D + 4;      // fp32 rows of csum (4 mod 32 words)
  static constexpr size_t k = 0, v = k + 2 * kQ * kP, cs = v + 2 * kQ * kP,
                          bytes = cs + 4 * kQ * kF;
};

// shared memory of wkv_out_tc, byte offsets
template <int D>
struct OutTile {
  static constexpr int kP = kPitch<D>;  // bf16 rows of r, k, v
  static constexpr int kF = D + 4;      // fp32 rows of csum
  static constexpr int kS = D + 8;      // fp32 rows of S (8 mod 32 words)
  static constexpr int kT = kSub + 1;   // fp32 rows of a diagonal block
  static constexpr size_t r = 0, k = r + 2 * kQ * kP, v = k + 2 * kQ * kP,
                          cs = v + 2 * kQ * kP, s = cs + 4 * kQ * kF,
                          dg = s + 4 * D * kS, u = dg + 4 * kQ * kT,
                          bytes = u + 4 * D;
};

// logw (staged into scs) -> its inclusive sum over the chunk per channel,
// in place, in order (one thread a channel)
template <int D, int kF>
__device__ __forceinline__ void channel_csum(float* scs) {
  if (threadIdx.x < D) {
    float* col = scs + threadIdx.x;
    float w[kQ];
#pragma unroll
    for (int t = 0; t < kQ; ++t) w[t] = col[t * kF];
    float run = 0.f;
#pragma unroll
    for (int t = 0; t < kQ; ++t) {
      run += w[t];
      col[t * kF] = run;
    }
  }
  __syncthreads();
}

// 1. the chunk's own state dS = (k exp(total - csum))^T V (hd x hd) and
// its log-decay total per channel
template <int D>
__global__ void __launch_bounds__(kScanThreads)
    wkv_state_tc(const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const float* __restrict__ logw, float* __restrict__ states,
                 float* __restrict__ totals, int H, int S, int hd, int nc,
                 WkvStrides st, int kbytes, int vbytes, int wbytes) {
  using L = StateTile<D>;
  constexpr int kP = L::kP, kF = L::kF;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::v);
  float* scs = reinterpret_cast<float*>(smem + L::cs);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, nt = min(kQ, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  stage<kQ, D>(sk, kP, k + b * st.kb + h * st.kh + t0 * st.ks, st.ks, nt, hd,
               kbytes);
  stage<kQ, D>(sv, kP, v + b * st.vb + h * st.vh + t0 * st.vs, st.vs, nt, hd,
               vbytes);
  stage<kQ, D>(scs, kF, logw + b * st.wb + h * st.wh + t0 * st.ws, st.ws, nt,
               hd, wbytes);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  channel_csum<D, kF>(scs);

  // 16 rows of k a warp; each A element k exp(total - csum) taken once
  const float* tot = scs + (kQ - 1) * kF;
  float* ds = states + ((size_t)(b * H + h) * nc + c) * hd * hd;
  for (int p0 = 16 * warp; p0 < D; p0 += 64) {
    float sacc[D / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = p0 + g + (i & 1) * 8, s = 8 * ks + q + (i >> 1) * 4;
        const Split a = split_tf32(ldf(sk + s * kP + kr) *
                                   __expf(tot[kr] - scs[s * kF + kr]));
        ahi[i] = a.hi;
        alo[i] = a.lo;
      }
      const bf16* v0 = sv + (8 * ks + q) * kP + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_split_a(sacc[n], ahi, alo, exact_tf32(ldf(v0 + 8 * n)),
                    exact_tf32(ldf(v0 + 4 * kP + 8 * n)));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kr = p0 + g + half * 8;
      if (kr >= hd) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * q;
        if (col < hd) ds[kr * hd + col] = sacc[n][2 * half];
        if (col + 1 < hd) ds[kr * hd + col + 1] = sacc[n][2 * half + 1];
      }
    }
  }
  for (int i = tid; i < hd; i += kScanThreads)
    totals[((size_t)(b * H + h) * nc + c) * hd + i] = tot[i];
}

// 2. the states in chunk order
__global__ void wkv_pass_states(float* __restrict__ states,
                                const float* __restrict__ totals,
                                float* __restrict__ state_out, int H, int hd,
                                int nc) {
  pass_states(states, totals, state_out, H, hd, hd, nc, true);
}

// 3. o = (r exp(excl)) S_prev + A V, one warp a sub-chunk of 16 rows
template <int D>
__global__ void __launch_bounds__(kScanThreads)
    wkv_out_tc(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, float* __restrict__ o,
               const float* __restrict__ states, int H, int S, int hd,
               int nc, WkvStrides st, int rbytes, int kbytes, int vbytes,
               int wbytes, int sbytes) {
  using L = OutTile<D>;
  constexpr int kP = L::kP, kF = L::kF, kS = L::kS, kT = L::kT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sr = reinterpret_cast<bf16*>(smem + L::r);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::v);
  float* scs = reinterpret_cast<float*>(smem + L::cs);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* su = reinterpret_cast<float*>(smem + L::u);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, nt = min(kQ, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = warp * kSub;
  float* sdg = reinterpret_cast<float*>(smem + L::dg) + r0 * kT;

  stage<kQ, D>(sr, kP, r + b * st.rb + h * st.rh + t0 * st.rs, st.rs, nt, hd,
               rbytes);
  stage<kQ, D>(sk, kP, k + b * st.kb + h * st.kh + t0 * st.ks, st.ks, nt, hd,
               kbytes);
  stage<kQ, D>(sv, kP, v + b * st.vb + h * st.vh + t0 * st.vs, st.vs, nt, hd,
               vbytes);
  stage<kQ, D>(scs, kF, logw + b * st.wb + h * st.wh + t0 * st.ws, st.ws, nt,
               hd, wbytes);
  if (c > 0)  // the state before the chunk (zero before the first)
    stage<D, D>(ss, kS, states + ((size_t)(b * H + h) * nc + c) * hd * hd,
                hd, hd, hd, sbytes);
  cp_async_commit();
  for (int i = tid; i < D; i += kScanThreads)
    su[i] = i < hd ? u[(size_t)h * hd + i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  channel_csum<D, kF>(scs);
  // excl_t = csum_{t-1}, 0 at the chunk's first token
  auto excl = [&](int t, int kc) {
    return t > 0 ? scs[(t - 1) * kF + kc] : 0.f;
  };

  float oacc[D / 8][4] = {};
  if (c > 0) {
    // (r exp(excl)) S_prev over k in steps of 8
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + g + (i & 1) * 8, kc = 8 * kk + q + (i >> 1) * 4;
        const Split a =
            split_tf32(ldf(sr + t * kP + kc) * __expf(excl(t, kc)));
        ahi[i] = a.hi;
        alo[i] = a.lo;
      }
      const float* s0 = ss + (8 * kk + q) * kS + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_split_ab(oacc[n], ahi, alo, split_tf32(s0[8 * n]),
                     split_tf32(s0[4 * kS + 8 * n]));
    }
  }

  // the sub-chunk's own pairs, into its 16 x 16 block sdg.  Its lower and
  // upper 8 rows meet through a second reference point, rho2 = csum at
  // the lower half's last token, on the tensor cores (rows t >= 8,
  // columns s < 8 of `mid`; the A operand's rows t < 8 are zero).  The 56
  // pairs s < t inside a half are summed exactly in fp32, spread over the
  // lanes, two channels a load, each lane from its own start so that the
  // lanes' rows meet few bank conflicts; the bonus at s = t on 16 lanes.
  {
    const float* rho2 = scs + (r0 + 7) * kF;
    const int t = r0 + 8 + g, s = r0 + g;
    float mid[4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int kc = 8 * kk + q;
      const Split a1 = split_tf32(ldf(sr + t * kP + kc) *
                                  __expf(scs[(t - 1) * kF + kc] - rho2[kc]));
      const Split a3 = split_tf32(
          ldf(sr + t * kP + kc + 4) *
          __expf(scs[(t - 1) * kF + kc + 4] - rho2[kc + 4]));
      const uint32_t ahi[4] = {0u, a1.hi, 0u, a3.hi};
      const uint32_t alo[4] = {0u, a1.lo, 0u, a3.lo};
      const Split b0 = split_tf32(ldf(sk + s * kP + kc) *
                                  __expf(rho2[kc] - scs[s * kF + kc]));
      const Split b1 = split_tf32(ldf(sk + s * kP + kc + 4) *
                                  __expf(rho2[kc + 4] - scs[s * kF + kc + 4]));
      mma_split_ab(mid, ahi, alo, b0, b1);
    }
    sdg[(8 + g) * kT + 2 * q] = mid[2];
    sdg[(8 + g) * kT + 2 * q + 1] = mid[3];
  }
  for (int idx = lane; idx < 2 * kHalfPairs; idx += 32) {
    const int half = idx < kHalfPairs ? 0 : 8;
    const int j = idx < kHalfPairs ? idx : idx - kHalfPairs;
    int t = 1;
    while (t * (t + 1) / 2 <= j) ++t;
    const int s = half + j - t * (t - 1) / 2;
    t += half;
    const bf16* rt = sr + (r0 + t) * kP;
    const bf16* ks = sk + (r0 + s) * kP;
    const float* et = scs + (r0 + t - 1) * kF;
    const float* cs = scs + (r0 + s) * kF;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 8
    for (int i = 0; i < D; i += 2) {
      const int kc = (2 * lane + i) & (D - 1);
      const float2 rr = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(rt + kc));
      const float2 kv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ks + kc));
      const float2 e = *reinterpret_cast<const float2*>(et + kc);
      const float2 cv = *reinterpret_cast<const float2*>(cs + kc);
      acc0 += rr.x * kv.x * __expf(e.x - cv.x);
      acc1 += rr.y * kv.y * __expf(e.y - cv.y);
    }
    sdg[t * kT + s] = acc0 + acc1;
  }
  if (lane < kSub) {
    const bf16* rt = sr + (r0 + lane) * kP;
    const bf16* kt = sk + (r0 + lane) * kP;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 8
    for (int i = 0; i < D; i += 2) {
      const int kc = (2 * lane + i) & (D - 1);
      const float2 rr = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(rt + kc));
      const float2 kv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(kt + kc));
      const float2 uu = *reinterpret_cast<const float2*>(su + kc);
      acc0 += rr.x * uu.x * kv.x;
      acc1 += rr.y * uu.y * kv.y;
    }
    sdg[lane * kT + lane] = acc0 + acc1;
  }

  // columns of earlier sub-chunks through the reference point rho = csum
  // at the token before the warp's sub-chunk: A[t,s] = (r_t exp(excl_t -
  // rho)) . (k_s exp(rho - csum_s))
  float att[8][4] = {};
  if (warp > 0) {
    const float* rho = scs + (r0 - 1) * kF;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + g + (i & 1) * 8, kc = 8 * kk + q + (i >> 1) * 4;
        const Split a = split_tf32(ldf(sr + t * kP + kc) *
                                   __expf(scs[(t - 1) * kF + kc] - rho[kc]));
        ahi[i] = a.hi;
        alo[i] = a.lo;
      }
      const int kc = 8 * kk + q;
#pragma unroll
      for (int ns = 0; ns < 2 * (kQ / kSub - 1); ++ns) {
        if (ns >= 2 * warp) continue;
        const int s = 8 * ns + g;
        const Split b0 = split_tf32(ldf(sk + s * kP + kc) *
                                    __expf(rho[kc] - scs[s * kF + kc]));
        const Split b1 = split_tf32(ldf(sk + s * kP + kc + 4) *
                                    __expf(rho[kc + 4] -
                                           scs[s * kF + kc + 4]));
        mma_split_ab(att[ns], ahi, alo, b0, b1);
      }
    }
  }
  __syncwarp();

  // o += A V over the column tiles at or left of the diagonal
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j > 2 * warp + 1) continue;
    float blk[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = g + (e >> 1) * 8, s = 8 * (j & 1) + 2 * q + (e & 1);
      blk[e] = j < 2 * warp ? att[j][e] : (s <= t ? sdg[t * kT + s] : 0.f);
    }
    uint32_t ahi[4], alo[4];
    acc_to_a(ahi, alo, blk);
    const bf16* v0 = sv + (8 * j + 2 * q) * kP + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      mma_split_a(oacc[n], ahi, alo, exact_tf32(ldf(v0 + 8 * n)),
                  exact_tf32(ldf(v0 + kP + 8 * n)));
  }
  float* obh = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r0 + g + half * 8;
    if (t >= nt) continue;
    float* row = obh + (long long)(t0 + t) * st.os;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * q;
      if (col < hd) row[col] = oacc[n][2 * half];
      if (col + 1 < hd) row[col + 1] = oacc[n][2 * half + 1];
    }
  }
}

template <int D>
int launch_tc(const void* r, const void* k, const void* v, const void* logw,
              const void* u, void* o, void* state, void* states,
              void* totals, int B, int H, int S, int hd,
              const WkvStrides& st, cudaStream_t stream) {
  static size_t configured_state[kMaxDevices], configured_out[kMaxDevices];
  cudaError_t e = allow_smem(wkv_state_tc<D>, StateTile<D>::bytes,
                             configured_state);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(wkv_out_tc<D>, OutTile<D>::bytes, configured_out);
  if (e != cudaSuccess) return (int)e;
  const int nc = (S + kQ - 1) / kQ;
  const int rbytes = copy_bytes(r, 2, st.rb, st.rh, st.rs, hd);
  const int kbytes = copy_bytes(k, 2, st.kb, st.kh, st.ks, hd);
  const int vbytes = copy_bytes(v, 2, st.vb, st.vh, st.vs, hd);
  const int wbytes = copy_bytes(logw, 4, st.wb, st.wh, st.ws, hd);
  const int sbytes = copy_bytes(states, 4, (long long)hd * hd, hd, 0, hd);
  const dim3 chunks(nc, H, B);
  wkv_state_tc<D><<<chunks, kScanThreads, StateTile<D>::bytes, stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(logw), static_cast<float*>(states),
      static_cast<float*>(totals), H, S, hd, nc, st, kbytes, vbytes, wbytes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv_pass_states<<<dim3((hd * hd + 255) / 256, H, B), 256, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(totals),
      static_cast<float*>(state), H, hd, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv_out_tc<D><<<chunks, kScanThreads, OutTile<D>::bytes, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<const float*>(states), H, S, hd, nc, st, rbytes, kbytes,
      vbytes, wbytes, sbytes);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the recurrence token by token
// ---------------------------------------------------------------------------

constexpr int kStep = 32;      // tokens staged per step
constexpr int kColsMax = 32;   // columns of v per block
constexpr int kPerThread = 8;  // state values of a column per thread (max)

__global__ void rwkv6_wkv_fp32(const float* __restrict__ r,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ logw,
                               const float* __restrict__ u,
                               float* __restrict__ o,
                               float* __restrict__ state_out, int H, int S,
                               int hd, int cols, int ng, WkvStrides st) {
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

  extern __shared__ __align__(16) float smem_f[];
  float* sr = smem_f;                 // kStep x hd  r rows
  float* sk = sr + kStep * hd;       // kStep x hd  k rows
  float* sw = sk + kStep * hd;       // kStep x hd  w = exp(logw) rows
  float* sv = sw + kStep * hd;       // kStep x cols  v columns
  float* so = sv + kStep * cols;     // kStep x cols  o columns
  float* su = so + kStep * cols;     // hd  bonus u of this head

  const float* rbh = r + b * st.rb + h * st.rh;
  const float* kbh = k + b * st.kb + h * st.kh;
  const float* vbh = v + b * st.vb + h * st.vh;
  const float* wbh = logw + b * st.wb + h * st.wh;
  float* obh = o + b * st.ob + h * st.oh;
  for (int i = tid; i < hd; i += nthreads) su[i] = u[(size_t)h * hd + i];

  float ss[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) ss[j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kStep) {
    const int nt = min(kStep, S - s0);
    __syncthreads();  // the previous chunk's readers are done (and su set)
    for (int i = tid; i < nt * hd; i += nthreads) {
      const int t = i / hd, c = i - t * hd;
      const long long s = s0 + t;
      sr[i] = rbh[s * st.rs + c];
      sk[i] = kbh[s * st.ks + c];
      sw[i] = expf(wbh[s * st.ws + c]);
    }
    for (int i = tid; i < nt * cols; i += nthreads) {
      const int t = i / cols, c = i - t * cols;
      sv[i] = c0 + c < hd ? vbh[(long long)(s0 + t) * st.vs + c0 + c] : 0.f;
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

int launch_fp32(const void* r, const void* k, const void* v,
                const void* logw, const void* u, void* o, void* state, int B,
                int H, int S, int hd, const WkvStrides& st,
                cudaStream_t stream) {
  // lane groups per column: a power of two with ng * kPerThread >= hd
  int ng = 1;
  while (ng * kPerThread < hd) ng <<= 1;
  const int cols = hd < kColsMax ? hd : kColsMax;
  if (ng > 32 || cols * ng > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (3 * (size_t)kStep * hd +
                                       2 * (size_t)kStep * cols + hd);
  static size_t configured[kMaxDevices];
  cudaError_t e = allow_smem(rwkv6_wkv_fp32, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((hd + cols - 1) / cols, H, B);
  rwkv6_wkv_fp32<<<grid, cols * ng, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<float*>(state), H, S, hd, cols, ng, st);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v (B, H, S, hd) in `dtype` (0 = bfloat16, 1 = float32); logw
// (B, H, S, hd) float32; u (H, hd) float32 contiguous; o (B, H, S, hd) and
// state (B, H, hd, hd) float32, state contiguous and indexed [k][v].
// `strides` points to 15 int64 element strides in the order of
// `WkvStrides`.  bfloat16 takes hd <= 128 and two float32 scratch
// buffers, `states` of B H ceil(S / 64) hd hd and `totals` of B H
// ceil(S / 64) hd elements (unused for float32).  Returns
// cudaGetLastError().
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, void* o, void* state,
                         void* states, void* totals, int B, int H, int S,
                         int hd, const long long* strides, int dtype,
                         void* stream) {
  WkvStrides st;
  memcpy(&st, strides, sizeof(st));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fp32(r, k, v, logw, u, o, state, B, H, S, hd, st, s);
  if (hd <= 16)
    return launch_tc<16>(r, k, v, logw, u, o, state, states, totals, B, H, S,
                         hd, st, s);
  if (hd <= 32)
    return launch_tc<32>(r, k, v, logw, u, o, state, states, totals, B, H, S,
                         hd, st, s);
  if (hd <= 64)
    return launch_tc<64>(r, k, v, logw, u, o, state, states, totals, B, H, S,
                         hd, st, s);
  if (hd <= 128)
    return launch_tc<128>(r, k, v, logw, u, o, state, states, totals, B, H,
                          S, hd, st, s);
  return (int)cudaErrorInvalidValue;
}
