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
// So it stays on the SIMT cores in fp32, and the design is about keeping
// enough bytes in flight.
//
// What the design does about it ("flash decoding"): the lane's table is
// cut into splits of `pages_per_split` entries, chosen on the host from
// the table width and the SM count, and the grid is (lane, KV head,
// split), so a few lanes still spread over all 132 SMs.  A split past a
// linear lane's valid length, or whose entries are all -1, writes an empty
// partial and exits at once.  Inside a split, one block of 4 warps holds
// all G query rows of its KV head, so each K/V row is read from device
// memory once for the whole group.  K and V are staged in shared memory
// in tiles of 64 tokens with `cp.async`, double-buffered: the next tile
// of the split's live pages loads while this one is scored.  A token is
// scored by D / 8 lanes (16 bytes of bf16 K each), which hold q for all G
// rows in registers and sum their dot products with `__shfl_xor_sync`; a
// warp scores 32 / (D / 8) tokens at once.  Each lane keeps the running
// max, sum and fp32 accumulator of its tokens in registers; the lanes of
// a warp merge theirs with shuffles, the warps through shared memory, and
// the split writes its partial (m, l, acc) in fp32 to a workspace the
// wrapper allocates.  A second small kernel combines the splits of each
// (lane, query head) and writes o; a split that saw no live token has
// m = -inf and l = 0 and adds nothing.  The combine and the softmax-state
// helpers are shared with the contiguous-cache decode (K4) in
// split_decode.cuh.
//
// Head dim 256 (gemma3-12b) in bf16: 32 lanes score a token (kTok = 1),
// each holding 8 of its dims; the staged K/V tiles are 32 tokens
// (`kChunkOf`), 4 x 32 x 264 bf16 = 66 KB of shared memory, and `red` 4 x
// 2 x 258 floats at gemma3's G = 2, so three blocks fit an SM.  In fp32 a
// token would need 64 lanes of 16 bytes, more than a warp: that
// instantiation is not built, and the wrapper refuses fp32 pages at 256
// (the pages are bf16 on every path).

#include "split_decode.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
// tokens of a staged K / V tile: 64, and 32 at head dim 256, where a
// 64-token tile pair would hold one block an SM
template <int D>
constexpr int kChunkOf = D > 128 ? 32 : 64;

__device__ __forceinline__ int positive_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

// One split of one (lane, KV head): GT query rows at a time (G > GT loops
// over groups of GT rows; rows past G are zeros and never written).
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q,        // (B, H, D)
                   const T* __restrict__ k_pages,  // (P, page, KV, D)
                   const T* __restrict__ v_pages,  // (P, page, KV, D)
                   const int* __restrict__ table,  // (B, maxp)
                   const int* __restrict__ valid_len,  // (B,)
                   float* __restrict__ ws_ml,      // (B, H, splits, 2)
                   float* __restrict__ ws_acc,     // (B, H, splits, D)
                   int H, int KV, int page, int maxp, int pps, int window,
                   int ring, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements of 16 bytes
  constexpr int kLanes = D / kVec;      // lanes that score one token
  constexpr int kTok = 32 / kLanes;     // tokens a warp scores at once
  static_assert(kLanes <= 32, "a token's 16-byte vectors must fit a warp");
  constexpr int kLd = D + kVec;         // padded shared row, in elements
  constexpr int kRed = D + 2;           // a row's acc, m, l in `red`
  constexpr int kChunk = kChunkOf<D>;
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % kLanes, grp = lane / kLanes;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);             // 2 x kChunk x kLd
  T* vs = ks + 2 * kChunk * kLd;                  // 2 x kChunk x kLd
  float* red = reinterpret_cast<float*>(vs + 2 * kChunk * kLd);  // warps x GT

  const int vlen = valid_len[b];
  const int last = vlen - 1;
  const int ring_tokens = maxp * page;
  const int* tb = table + (size_t)b * maxp;
  // units: (table entry, 64-token tile of its page) pairs of this split;
  // a linear table holds nothing at or past the valid length, a ring page
  // can hold live tokens whatever its index
  const int cpp = (page + kChunk - 1) / kChunk;
  int e_end = min(maxp, (split + 1) * pps);
  if (!ring) e_end = min(e_end, vlen > 0 ? (vlen + page - 1) / page : 0);
  const int u_end = e_end * cpp;
  auto next_live = [&](int u) {
    while (u < u_end && tb[u / cpp] < 0) u = (u / cpp + 1) * cpp;
    return u;
  };
  const int u_first = next_live(split * pps * cpp);
  const size_t row_base = (size_t)b * H + (size_t)kvh * G;  // (b, h) of g 0

  if (u_first >= u_end) {  // no live entry: an empty partial
    for (int g = threadIdx.x; g < G; g += kThreads) {
      const size_t row = (row_base + g) * splits + split;
      ws_ml[2 * row] = -INFINITY;
      ws_ml[2 * row + 1] = 0.f;
    }
    return;
  }

  auto issue = [&](int u, int buf) {
    const int pid = tb[u / cpp];
    const int t0 = (u % cpp) * kChunk;
    const int rows = min(kChunk, page - t0);
    T* kd = ks + buf * kChunk * kLd;
    T* vd = vs + buf * kChunk * kLd;
    for (int i = threadIdx.x; i < kChunk * kLanes; i += kThreads) {
      const int r = i / kLanes, c = (i % kLanes) * kVec;
      const bool ok = r < rows;
      const size_t off =
          ok ? (((size_t)pid * page + t0 + r) * KV + kvh) * D + c : 0;
      cp_async16(kd + r * kLd + c, k_pages + off, ok);
      cp_async16(vd + r * kLd + c, v_pages + off, ok);
    }
  };

  for (int g0 = 0; g0 < G; g0 += GT) {
    float qv[GT][kVec];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        qv[g][j] = g0 + g < G
                       ? to_float(q[(row_base + g0 + g) * D + sub * kVec + j])
                       : 0.f;
    float m[GT], l[GT], acc[GT][kVec];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[g][j] = 0.f;
    }

    int u = u_first;
    issue(u, 0);
    cp_async_commit();
    for (int it = 0; u < u_end; ++it) {
      const int nxt = next_live(u + 1);
      cp_async_wait<0>();
      __syncthreads();  // tile `it` landed; all are done with tile it - 1
      if (nxt < u_end) issue(nxt, (it + 1) & 1);
      cp_async_commit();
      const T* kt = ks + (it & 1) * kChunk * kLd;
      const T* vt = vs + (it & 1) * kChunk * kLd;
      const int t0 = (u % cpp) * kChunk;
      const int slot0 = (u / cpp) * page + t0;
      const int rows = min(kChunk, page - t0);
      for (int r0 = warp * kTok; r0 < kChunk; r0 += kWarps * kTok) {
        const int r = r0 + grp;
        float kf[kVec];
        load16(kf, kt + r * kLd + sub * kVec);
        float sc[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < kVec; ++j) dot = fmaf(qv[g][j], kf[j], dot);
#pragma unroll
          for (int o = 1; o < kLanes; o <<= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          sc[g] = dot * scale;
        }
        const int slot = slot0 + r;
        const int pos =
            ring ? last - positive_mod(last - slot, ring_tokens) : slot;
        const bool ok = r < rows && pos >= 0 && pos <= last &&
                        (window <= 0 || pos > last - window);
        if (ok) {
          float vf[kVec];
          load16(vf, vt + r * kLd + sub * kVec);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float mn = fmaxf(m[g], sc[g]);
            const float alpha = expf(m[g] - mn);  // 0 when m was -inf
            const float p = expf(sc[g] - mn);
            l[g] = l[g] * alpha + p;
#pragma unroll
            for (int j = 0; j < kVec; ++j)
              acc[g][j] = fmaf(acc[g][j], alpha, p * vf[j]);
            m[g] = mn;
          }
        }
      }
      u = nxt;
    }
    cp_async_wait<0>();

    // the warp's token groups (lanes kLanes apart hold the same dims)
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float ao[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          ao[j] = __shfl_xor_sync(0xffffffffu, acc[g][j], o);
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        merge<kVec>(m[g], l[g], acc[g], mo, lo, ao);
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float* rw = red + (warp * GT + g) * kRed;
#pragma unroll
        for (int j = 0; j < kVec; ++j) rw[sub * kVec + j] = acc[g][j];
        if (sub == 0) {
          rw[D] = m[g];
          rw[D + 1] = l[g];
        }
      }
    }
    __syncthreads();
    // the warps, one (row, dim) a thread -> the split's partial
    for (int i = threadIdx.x; i < GT * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      if (g0 + g >= G) continue;
      float mm = -INFINITY, ll = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* rw = red + (w * GT + g) * kRed;
        merge<1>(mm, ll, &a, rw[D], rw[D + 1], rw + d);
      }
      const size_t row = (row_base + g0 + g) * splits + split;
      ws_acc[row * D + d] = a;
      if (d == 0) {
        ws_ml[2 * row] = mm;
        ws_ml[2 * row + 1] = ll;
      }
    }
    __syncthreads();  // `red` and the tiles are free for the next rows
  }
}

struct Args {
  const void *q, *k_pages, *v_pages, *table, *valid_len;
  void *out, *ws_ml, *ws_acc;
  int B, H, KV, D, page, maxp, pps, splits, window, ring;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GT>
int launch_split(const Args& a) {
  constexpr int kLd = D + 16 / (int)sizeof(T);
  const size_t smem = 4 * (size_t)kChunkOf<D> * kLd * sizeof(T) +
                      sizeof(float) * kWarps * GT * (D + 2);
  static size_t configured[kMaxDevices];
  cudaError_t e = allow_smem(paged_split_kernel<T, D, GT>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B, a.KV, a.splits);
  paged_split_kernel<T, D, GT><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), static_cast<const int*>(a.table),
      static_cast<const int*>(a.valid_len), static_cast<float*>(a.ws_ml),
      static_cast<float*>(a.ws_acc), a.H, a.KV, a.page, a.maxp, a.pps,
      a.window, a.ring, a.scale);
  return (int)cudaGetLastError();
}

// GQA groups of up to 2 query rows a KV head (gemma3's 16 / 8) take the
// 2-row kernel, up to 4 the 4-row kernel, larger ones the 8-row kernel (in
// groups of 8)
template <typename T, int D>
int launch_rows(const Args& a) {
  const int G = a.H / a.KV;
  if (G <= 2) return launch_split<T, D, 2>(a);
  return G <= 4 ? launch_split<T, D, 4>(a) : launch_split<T, D, 8>(a);
}

template <typename T>
int launch(const Args& a) {
  int code;
  switch (a.D) {
    case 16: code = launch_rows<T, 16>(a); break;
    case 32: code = launch_rows<T, 32>(a); break;
    case 64: code = launch_rows<T, 64>(a); break;
    case 128: code = launch_rows<T, 128>(a); break;
    case 256:  // gemma3-12b; bf16 only (see the note at the top)
      if constexpr (sizeof(T) == 2) {
        code = launch_rows<T, 256>(a);
        break;
      } else {
        return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
  if (code != 0) return code;
  return launch_combine<T>(a.ws_ml, a.ws_acc, a.out, nullptr, a.B * a.H,
                           a.D, a.splits, a.stream);
}

}  // namespace

// The split kernel and then the combine kernel, on `stream`.  `ws_ml`
// (B, H, splits, 2) and `ws_acc` (B, H, splits, D) are fp32 workspaces of
// the caller; splits = ceil(maxp / pages_per_split).  dtype: 0 =
// bfloat16, 1 = float32.  Returns cudaGetLastError().
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* valid_len, void* out, void* ws_ml,
    void* ws_acc, int B, int H, int KV, int D, int page, int maxp,
    int pages_per_split, int splits, int window, int ring, float scale,
    int dtype, void* stream) {
  const Args a{q, k_pages, v_pages, table, valid_len, out, ws_ml, ws_acc,
               B, H, KV, D, page, maxp, pages_per_split, splits, window,
               ring, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<__nv_bfloat16>(a);
  return launch<float>(a);
}
