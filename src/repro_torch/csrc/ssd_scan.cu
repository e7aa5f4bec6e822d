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
// What bounds it on the H100: bytes (5 operations per state element and
// token; in the chunked form below the products run on the tensor cores,
// and the inputs and y are read and written once).  A recurrence stepped
// token by token is instead bound by its dependent chain: the first
// design did that, ~1400 cycles a token, 0.68 ms for 1000 tokens.
//
// The design (bf16 inputs, every model call): the chunked matrix form of
// the Pallas kernel, cut into chunks of kQ = 64 tokens and three launches,
// so that all (chunk, head) pairs run in parallel and only a short pass
// over the chunks' states is sequential.  Splitting P across blocks
// instead would keep the chunks sequential inside each block (80 heads x
// 2 halves of P = 160 blocks stepping 16 chunks in turn); the chunk-
// parallel form gives 1280 blocks a launch at zamba2's shape and pays for
// it with one (P x N) fp32 state per chunk in device memory (21 MB
// there), written, passed and read once each.
//   1. ssd_state_tc, one block per (chunk, head, batch): csum = the
//      inclusive sum of a over the chunk (one thread, in order); the
//      chunk's own state dS = X^T Bd, Bd = B dt exp(total - csum) (3xTF32
//      `mma.m16n8k8`, Bd split), and its log-decay total, into the
//      scratch.
//   2. ssd_pass_states, one thread per state element: h = exp(total) h +
//      dS over the chunks in order, leaving in each chunk's slot the state
//      before it; the last h is the final state.
//   3. ssd_out_tc, one block per (chunk, head, batch): y = exp(csum_t)
//      (C h_prev^T)[t] (h_prev split) + W X, with G = C B^T on bf16
//      `mma16816` and W = G exp(csum_t - csum_s) dt_s for s <= t, 0 above
//      the diagonal (W split); y is written once.
// Every exponent is <= 0 by construction, and nothing is clamped: a <= 0
// (the model's a = -exp(a_log) dt), csum is summed in order so it never
// increases, and each exponent is csum_t - csum_s with s <= t (W; exp is
// taken only where s <= t), total - csum_s (dS), csum_t (3) or total (2).
// A ragged tail is zero-filled: dt = a = 0 past S leave the state as it
// is, so the final state is the state after exactly S tokens.  The
// wrapper counts the three launches as one.
//
// fp32 inputs keep the first design, the recurrence stepped token by token
// in fp32 (ssd_scan_fp32): one block per (32 columns of P, head, batch),
// each thread holding 8 of its row's N state values in registers, tokens
// staged 32 at a time in shared memory.

#include "chunked_scan.cuh"

#include <string.h>

namespace {

// Element strides: x, dt, a, y as (batch, head, seq); b, c as (batch, seq).
// The last dim of x, b, c and y is contiguous.
struct SsdStrides {
  long long xb, xh, xs, db, dh, ds, ab, ah, as, bb, bs, cb, cs, yb, yh, ys;
};

// ---------------------------------------------------------------------------
// bf16: the chunked form on the tensor cores
// ---------------------------------------------------------------------------

// shared memory of ssd_state_tc, byte offsets
template <int D>
struct StateTile {
  static constexpr int kP = kPitch<D>;  // bf16 rows of B, X
  static constexpr int kF = D + 8;      // fp32 rows of Bd (8 mod 32 words)
  static constexpr size_t b = 0, x = b + 2 * kQ * kP, bd = x + 2 * kQ * kP,
                          dt = bd + 4 * kQ * kF, a = dt + 4 * kQ,
                          cs = a + 4 * kQ, bytes = cs + 4 * kQ;
};

// shared memory of ssd_out_tc, byte offsets
template <int D>
struct OutTile {
  static constexpr int kP = kPitch<D>;  // bf16 rows of C, B, X
  static constexpr int kH = D + 4;      // fp32 rows of h (4 mod 32 words)
  static constexpr size_t c = 0, b = c + 2 * kQ * kP, x = b + 2 * kQ * kP,
                          h = x + 2 * kQ * kP, dt = h + 4 * D * kH,
                          a = dt + 4 * kQ, cs = a + 4 * kQ,
                          bytes = cs + 4 * kQ;
};

// dt and a over the block's chunk into sdt and sa (zeros past S), then the
// inclusive sum of a in order into scs (thread 0, from registers)
__device__ __forceinline__ void chunk_csum(float* sdt, float* sa, float* scs,
                                           const float* dbh, long long ds,
                                           const float* abh, long long as,
                                           int t0, int nt) {
  for (int i = threadIdx.x; i < kQ; i += kScanThreads) {
    const bool ok = i < nt;
    sdt[i] = ok ? dbh[(long long)(t0 + i) * ds] : 0.f;
    sa[i] = ok ? abh[(long long)(t0 + i) * as] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) v[i] = sa[i];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      run += v[i];
      scs[i] = run;
    }
  }
  __syncthreads();
}

// 1. the chunk's own state dS = X^T Bd (P x N), Bd = B dt exp(total -
// csum), and its log-decay total
template <int D>
__global__ void __launch_bounds__(kScanThreads)
    ssd_state_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const bf16* __restrict__ bm,
                 float* __restrict__ states, float* __restrict__ totals,
                 int H, int S, int P, int N, int nc, SsdStrides st,
                 int xbytes, int bbytes) {
  using L = StateTile<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sb = reinterpret_cast<bf16*>(smem + L::b);
  bf16* sx = reinterpret_cast<bf16*>(smem + L::x);
  float* sbd = reinterpret_cast<float*>(smem + L::bd);
  float* sdt = reinterpret_cast<float*>(smem + L::dt);
  float* sa = reinterpret_cast<float*>(smem + L::a);
  float* scs = reinterpret_cast<float*>(smem + L::cs);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, nt = min(kQ, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  stage<kQ, D>(sb, L::kP, bm + b * st.bb + t0 * st.bs, st.bs, nt, N, bbytes);
  stage<kQ, D>(sx, L::kP, x + b * st.xb + h * st.xh + t0 * st.xs, st.xs, nt, P,
               xbytes);
  cp_async_commit();
  chunk_csum(sdt, sa, scs, dt + b * st.db + h * st.dh, st.ds,
             a + b * st.ab + h * st.ah, st.as, t0, nt);
  cp_async_wait<0>();
  __syncthreads();
  const float total = scs[kQ - 1];
  for (int i = tid; i < kQ * D; i += kScanThreads) {
    const int s = i / D, n = i - s * D;
    sbd[s * L::kF + n] =
        ldf(sb + s * L::kP + n) * (sdt[s] * __expf(total - scs[s]));
  }
  __syncthreads();

  // 16 rows of P a warp
  float* ds = states + ((size_t)(b * H + h) * nc + c) * P * N;
  for (int p0 = 16 * warp; p0 < D; p0 += 64) {
    float sacc[D / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const bf16* x0 = sx + (8 * ks + q) * L::kP + p0 + g;
      const uint32_t af[4] = {exact_tf32(ldf(x0)), exact_tf32(ldf(x0 + 8)),
                              exact_tf32(ldf(x0 + 4 * L::kP)),
                              exact_tf32(ldf(x0 + 4 * L::kP + 8))};
      const float* b0 = sbd + (8 * ks + q) * L::kF + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_split_b(sacc[n], af, split_tf32(b0[8 * n]),
                    split_tf32(b0[4 * L::kF + 8 * n]));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + g + half * 8;
      if (p >= P) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int nn = 8 * n + 2 * q;
        if (nn < N) ds[p * N + nn] = sacc[n][2 * half];
        if (nn + 1 < N) ds[p * N + nn + 1] = sacc[n][2 * half + 1];
      }
    }
  }
  if (tid == 0) totals[(size_t)(b * H + h) * nc + c] = total;
}

// 2. the states in chunk order
__global__ void ssd_pass_states(float* __restrict__ states,
                                const float* __restrict__ totals,
                                float* __restrict__ state_out, int H, int P,
                                int N, int nc) {
  pass_states(states, totals, state_out, H, P, N, nc, false);
}

// 3. y = exp(csum_t) (C h_prev^T)[t] + W X, W = (C B^T) exp(csum_t -
// csum_s) dt_s for s <= t
template <int D>
__global__ void __launch_bounds__(kScanThreads)
    ssd_out_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, float* __restrict__ y,
               const float* __restrict__ states, int H, int S, int P, int N,
               int nc, SsdStrides st, int xbytes, int bbytes, int cbytes,
               int hbytes) {
  using L = OutTile<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sc = reinterpret_cast<bf16*>(smem + L::c);
  bf16* sb = reinterpret_cast<bf16*>(smem + L::b);
  bf16* sx = reinterpret_cast<bf16*>(smem + L::x);
  float* sh = reinterpret_cast<float*>(smem + L::h);
  float* sdt = reinterpret_cast<float*>(smem + L::dt);
  float* sa = reinterpret_cast<float*>(smem + L::a);
  float* scs = reinterpret_cast<float*>(smem + L::cs);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ, nt = min(kQ, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  stage<kQ, D>(sc, L::kP, cm + b * st.cb + t0 * st.cs, st.cs, nt, N, cbytes);
  stage<kQ, D>(sb, L::kP, bm + b * st.bb + t0 * st.bs, st.bs, nt, N, bbytes);
  stage<kQ, D>(sx, L::kP, x + b * st.xb + h * st.xh + t0 * st.xs, st.xs, nt, P,
               xbytes);
  if (c > 0)  // the state before the chunk (zero before the first)
    stage<D, D>(sh, L::kH, states + ((size_t)(b * H + h) * nc + c) * P * N,
                N, P, N, hbytes);
  cp_async_commit();
  chunk_csum(sdt, sa, scs, dt + b * st.db + h * st.dh, st.ds,
             a + b * st.ab + h * st.ah, st.as, t0, nt);
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16;
  float yacc[D / 8][4] = {};
  if (c > 0) {
    // C h_prev^T for the warp's 16 rows, over N in steps of 8, then each
    // row t decayed by exp(csum_t)
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const bf16* c0 = sc + (r0 + g) * L::kP + 8 * kk + q;
      const uint32_t af[4] = {exact_tf32(ldf(c0)),
                              exact_tf32(ldf(c0 + 8 * L::kP)),
                              exact_tf32(ldf(c0 + 4)),
                              exact_tf32(ldf(c0 + 8 * L::kP + 4))};
      const float* h0 = sh + g * L::kH + 8 * kk + q;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_split_b(yacc[n], af, split_tf32(h0[8 * n * L::kH]),
                    split_tf32(h0[8 * n * L::kH + 4]));
    }
    const float d0 = __expf(scs[r0 + g]), d1 = __expf(scs[r0 + g + 8]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      yacc[n][0] *= d0, yacc[n][1] *= d0;
      yacc[n][2] *= d1, yacc[n][3] *= d1;
    }
  }

  // G = C B^T for the warp's 16 rows, then W and y += W X, column tiles at
  // or left of the diagonal only
  float acc[8][4] = {};
  mma_abt<D, 8>(acc, sc + r0 * L::kP, sb, lane);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j > 2 * warp + 1) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = r0 + g + (e >> 1) * 8, s = 8 * j + 2 * q + (e & 1);
      const float arg = s <= t ? scs[t] - scs[s] : 0.f;  // never above 0
      acc[j][e] = s <= t ? acc[j][e] * __expf(arg) * sdt[s] : 0.f;
    }
    uint32_t ahi[4], alo[4];
    acc_to_a(ahi, alo, acc[j]);
    const bf16* x0 = sx + (8 * j + 2 * q) * L::kP + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      mma_split_a(yacc[n], ahi, alo, exact_tf32(ldf(x0 + 8 * n)),
                  exact_tf32(ldf(x0 + L::kP + 8 * n)));
  }
  float* ybh = y + b * st.yb + h * st.yh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r0 + g + half * 8;
    if (t >= nt) continue;
    float* row = ybh + (long long)(t0 + t) * st.ys;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int p = 8 * n + 2 * q;
      if (p < P) row[p] = yacc[n][2 * half];
      if (p + 1 < P) row[p + 1] = yacc[n][2 * half + 1];
    }
  }
}

template <int D>
int launch_tc(const void* x, const void* dt, const void* a, const void* bm,
              const void* cm, void* y, void* state, void* states,
              void* totals, int B, int H, int S, int P, int N,
              const SsdStrides& st, cudaStream_t stream) {
  static size_t configured_state[kMaxDevices], configured_out[kMaxDevices];
  cudaError_t e = allow_smem(ssd_state_tc<D>, StateTile<D>::bytes,
                             configured_state);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(ssd_out_tc<D>, OutTile<D>::bytes, configured_out);
  if (e != cudaSuccess) return (int)e;
  const int nc = (S + kQ - 1) / kQ;
  const int xbytes = copy_bytes(x, 2, st.xb, st.xh, st.xs, P);
  const int bbytes = copy_bytes(bm, 2, st.bb, st.bs, 0, N);
  const int cbytes = copy_bytes(cm, 2, st.cb, st.cs, 0, N);
  const int hbytes = copy_bytes(states, 4, (long long)P * N, N, 0, N);
  const dim3 chunks(nc, H, B);
  ssd_state_tc<D><<<chunks, kScanThreads, StateTile<D>::bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm),
      static_cast<float*>(states), static_cast<float*>(totals), H, S, P, N,
      nc, st, xbytes, bbytes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_pass_states<<<dim3((P * N + 255) / 256, H, B), 256, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(totals),
      static_cast<float*>(state), H, P, N, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_out_tc<D><<<chunks, kScanThreads, OutTile<D>::bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<float*>(y),
      static_cast<const float*>(states), H, S, P, N, nc, st, xbytes, bbytes,
      cbytes, hbytes);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the recurrence token by token
// ---------------------------------------------------------------------------

constexpr int kStep = 32;      // tokens staged per step
constexpr int kColsMax = 32;   // columns of P per block
constexpr int kPerThread = 8;  // state values of a row per thread (max)

__global__ void ssd_scan_fp32(const float* __restrict__ x,
                              const float* __restrict__ dt,
                              const float* __restrict__ a,
                              const float* __restrict__ bm,
                              const float* __restrict__ cm,
                              float* __restrict__ y,
                              float* __restrict__ state_out, int H, int S,
                              int P, int N, int cols, int ng, SsdStrides st) {
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

  extern __shared__ __align__(16) float smem_f[];
  float* sb = smem_f;                // kStep x N   B rows
  float* sc = sb + kStep * N;      // kStep x N   C rows
  float* sx = sc + kStep * N;      // kStep x cols  x columns
  float* sy = sx + kStep * cols;   // kStep x cols  y columns
  float* sdt = sy + kStep * cols;  // kStep
  float* sda = sdt + kStep;        // kStep  exp(a_t)

  const float* xbh = x + b * st.xb + h * st.xh;
  const float* dbh = dt + b * st.db + h * st.dh;
  const float* abh = a + b * st.ab + h * st.ah;
  const float* bb = bm + b * st.bb;
  const float* cb = cm + b * st.cb;
  float* ybh = y + b * st.yb + h * st.yh;

  float hs[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) hs[j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kStep) {
    const int nt = min(kStep, S - s0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < nt * N; i += nthreads) {
      const int t = i / N, n = i - t * N;
      sb[i] = bb[(long long)(s0 + t) * st.bs + n];
      sc[i] = cb[(long long)(s0 + t) * st.cs + n];
    }
    for (int i = tid; i < nt * cols; i += nthreads) {
      const int t = i / cols, c = i - t * cols;
      sx[i] = p0 + c < P ? xbh[(long long)(s0 + t) * st.xs + p0 + c] : 0.f;
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

int launch_fp32(const void* x, const void* dt, const void* a, const void* bm,
                const void* cm, void* y, void* state, int B, int H, int S,
                int P, int N, const SsdStrides& st, cudaStream_t stream) {
  // lane groups per column: a power of two with ng * kPerThread >= N
  int ng = 1;
  while (ng * kPerThread < N) ng <<= 1;
  const int cols = P < kColsMax ? P : kColsMax;
  if (ng > 32 || cols * ng > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * (size_t)kStep * N +
                                       2 * (size_t)kStep * cols + 2 * kStep);
  static size_t configured[kMaxDevices];
  cudaError_t e = allow_smem(ssd_scan_fp32, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + cols - 1) / cols, H, B);
  ssd_scan_fp32<<<grid, cols * ng, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y),
      static_cast<float*>(state), H, S, P, N, cols, ng, st);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, S, P) and b, c (B, S, N) in `dtype` (0 = bfloat16, 1 =
// float32); dt, a (B, H, S) float32; y (B, H, S, P) and state (B, H, P, N)
// float32, state contiguous.  `strides` points to 16 int64 element strides
// in the order of `SsdStrides`.  bfloat16 takes max(P, N) <= 128 and two
// float32 scratch buffers, `states` of B H ceil(S / 64) P N and `totals`
// of B H ceil(S / 64) elements (unused for float32).  Returns
// cudaGetLastError().
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* bm, const void* cm, void* y, void* state,
                        void* states, void* totals, int B, int H, int S,
                        int P, int N, const long long* strides, int dtype,
                        void* stream) {
  SsdStrides st;
  memcpy(&st, strides, sizeof(st));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fp32(x, dt, a, bm, cm, y, state, B, H, S, P, N, st, s);
  const int d = P > N ? P : N;
  if (d <= 16)
    return launch_tc<16>(x, dt, a, bm, cm, y, state, states, totals, B, H, S,
                         P, N, st, s);
  if (d <= 32)
    return launch_tc<32>(x, dt, a, bm, cm, y, state, states, totals, B, H, S,
                         P, N, st, s);
  if (d <= 64)
    return launch_tc<64>(x, dt, a, bm, cm, y, state, states, totals, B, H, S,
                         P, N, st, s);
  if (d <= 128)
    return launch_tc<128>(x, dt, a, bm, cm, y, state, states, totals, B, H,
                          S, P, N, st, s);
  return (int)cudaErrorInvalidValue;
}
