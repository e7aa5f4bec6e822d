// Decode attention for Hopper (sm_90a): one query token per lane,
// attending over that lane's contiguous KV cache up to its valid length.
//
// Replaces: src/repro/kernels/decode_attention.py, function
// `decode_attention` (Pallas body `_decode_kernel`).  Same semantics: GQA
// with the G = H / KV query heads of one KV head sharing its keys, fp32
// online softmax, keys at positions >= the lane's valid length masked, and
// a lane with valid length 0 returns zeros (the l clamp).  Unlike the
// Pallas wrapper, which drops a ragged tail of the cache by integer
// division, any cache length S is taken; a valid length above S reads S
// keys.
//
// What bounds it on the H100: bytes.  Decode reads every valid K and V row
// of the lane once and does 4 operations per (query head, key, dim): with
// G = 1 (zamba2's shared attention) that is 1 operation per byte of bf16
// KV, with G = 8 (tinyllama) 8 -- both far below the ~295 operations per
// byte at which the tensor cores would become the limit.  So it stays on
// the SIMT cores in fp32, and the design is about keeping enough bytes in
// flight on every SM.
//
// What the design does about it ("flash decoding", as K1):
// - The grid is (lane, KV head, split).  Each lane's cache is cut into
//   splits of `keys_per_split` keys, chosen on the host from S and the SM
//   count alone (`split_keys`), never from the valid lengths, so the launch
//   needs no host read and can be captured in a CUDA graph.  A split is a
//   whole number of 128 keys, so each warp has a load in flight behind its
//   first step.  At zamba2's decode shape (8 lanes x 32 KV heads, S 2048)
//   that is 6 splits of 384 keys, 1536 blocks, where one block per (lane,
//   KV head) gave 256.  A
//   split that starts at or past the lane's valid length writes an empty
//   partial (m = -inf, l = 0) and exits.
// - Inside a split, one block of 4 warps holds the G query rows of its KV
//   head (q in shared memory as fp32), so each K/V row is read from device
//   memory once for the whole group.  The four warps run independently:
//   warp w takes the split's keys in steps of 16, steps w, w + 4, ...,
//   each staged by `cp.async` into the warp's own ring of 2-3 buffers, so
//   the next steps' K and V are in flight while this one is scored, with
//   no block-wide barrier in the loop (`__syncwarp` only).
// - Scores: two lanes a key, each half of its dims (16-byte shared loads;
//   rows padded so the 8 lanes of a load phase hit 8 bank groups), summed
//   by one shuffle; every lane works at G = 1.  Softmax: the warp's running
//   max and sum per query row, in fp32, by warp shuffles.
// - P.V: each lane owns pairs of dims (`bf16x2` loads of the V row) and
//   walks the step's 16 keys with p broadcast by shuffle, so all 32 lanes
//   of all 4 warps work where the old loop gave one thread per (row, dim).
// - The four warps' (m, l, acc) are merged once through shared memory and
//   the split's partial goes in fp32 to the wrapper's workspace; the
//   combine kernel of split_decode.cuh (shared with K1) merges the splits,
//   launched as a programmatic dependent so that its launch overlaps the
//   split kernel's tail.
// - Deterministic: no atomics, a fixed order of every sum.
//
// Head dim 256 (gemma3-12b's dense ring) in bf16: a row is 32 units of 16
// bytes at a pitch of 34, a warp's step buffer 2 x 16 x 272 bf16 = 17 KB,
// so `kStages` is 2 (136 KB for the four warps' rings, plus q and `red`:
// ~146 KB at gemma3's G = 2, one block an SM); each lane scores 16 units
// of its key and owns 4 pairs of dims in P.V.  fp32 at 256 would need 264
// KB of rings: it is not built, and the wrapper refuses it.

#include "split_decode.cuh"

namespace {

constexpr int kDecThreads = 128;  // 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kStep = 16;         // keys a warp stages and scores at once

// Shared layout of one (T, D): a staged row is padded to a pitch of 2 mod 4
// 16-byte units, so the lanes of a 16-byte load phase (4 keys x 2 halves)
// fall in distinct bank groups.  Each warp owns `kStages` buffers of K and
// V for kStep keys: 3 where four warps' rings fit in 72 KB, else 2.
template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kUnits = D / kVec;
  static constexpr int kPitch = (kUnits + ((2 - kUnits % 4) + 4) % 4) * kVec;
  static constexpr int kBuf = 2 * kStep * kPitch;  // K then V, elements
  static constexpr int kStages =
      3 * kDecWarps * kBuf * (int)sizeof(T) <= 72 * 1024 ? 3 : 2;
};

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// One split of one (lane, KV head): GT query rows at a time (G > GT loops
// over groups of GT rows; rows past G are zeros and never written).
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kDecThreads)
decode_split_kernel(const T* __restrict__ q,            // (B, H, D)
                    const T* __restrict__ k,            // (B, KV, S, D)
                    const T* __restrict__ v,            // (B, KV, S, D)
                    const int* __restrict__ valid_len,  // (B,)
                    float* __restrict__ ws_ml,          // (B, H, splits, 2)
                    float* __restrict__ ws_acc,         // (B, H, splits, D)
                    int H, int KV, int S, int kps, float scale) {
  using L = Layout<T, D>;
  constexpr int kVec = L::kVec;
  constexpr int kHalf = L::kUnits / 2;  // 16-byte units a lane scores
  constexpr int kPairs = D / 2;
  constexpr int kPairsPerLane = (kPairs + 31) / 32;
  constexpr int kRed = D + 2;  // a warp's acc, m, l of one row in `red`
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int key_lane = lane >> 1, half = lane & 1;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem) + warp * L::kStages * L::kBuf;
  float* qs = reinterpret_cast<float*>(reinterpret_cast<T*>(smem) +
                                       kDecWarps * L::kStages * L::kBuf);
  float* red = qs + GT * D;  // warps x GT x kRed

  const int vlen = min(max(valid_len[b], 0), S);
  const int k0 = split * kps;
  const int k1 = min(k0 + kps, vlen);
  const size_t row_base = (size_t)b * H + (size_t)kvh * G;  // (b, h) of g 0

  if (k0 >= k1) {  // the split starts at or past the valid length
    for (int g = threadIdx.x; g < G; g += kDecThreads) {
      const size_t row = (row_base + g) * splits + split;
      ws_ml[2 * row] = -INFINITY;
      ws_ml[2 * row + 1] = 0.f;
    }
    return;
  }

  const size_t kv_base = ((size_t)b * KV + kvh) * (size_t)S * D;
  // this warp's steps: keys k0 + (i * kDecWarps + warp) * kStep + [0, kStep)
  // for every i whose first key is live (so a step has >= 1 live key)
  const int first = k0 + warp * kStep;
  const int n_steps =
      first < k1 ? (k1 - first + kDecWarps * kStep - 1) / (kDecWarps * kStep)
                 : 0;
  auto issue = [&](int i) {
    const int s0 = first + i * kDecWarps * kStep;
    T* kd = ring + (i % L::kStages) * L::kBuf;
    T* vd = kd + kStep * L::kPitch;
    for (int u = lane; u < kStep * L::kUnits; u += 32) {
      const int r = u / L::kUnits, c = (u - r * L::kUnits) * kVec;
      const bool ok = s0 + r < k1;  // rows past the split: zeros, unread
      const size_t off = ok ? kv_base + (size_t)(s0 + r) * D + c : kv_base;
      cp_async16(kd + r * L::kPitch + c, k + off, ok);
      cp_async16(vd + r * L::kPitch + c, v + off, ok);
    }
  };

  for (int g0 = 0; g0 < G; g0 += GT) {
    __syncthreads();  // the last group's reads of `qs` and `red` are done
    for (int i = threadIdx.x; i < GT * D; i += kDecThreads)
      qs[i] = g0 + i / D < G ? to_float(q[(row_base + g0) * D + i]) : 0.f;
    __syncthreads();

    float m[GT], l[GT], acc[GT][kPairsPerLane][2];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kPairsPerLane; ++j) acc[g][j][0] = acc[g][j][1] = 0.f;
    }

#pragma unroll
    for (int s = 0; s < L::kStages - 1; ++s) {
      if (s < n_steps) issue(s);
      cp_async_commit();
    }
    for (int i = 0; i < n_steps; ++i) {
      cp_async_wait<L::kStages - 2>();
      __syncwarp();  // step i landed for all lanes; all are done with i - 1
      if (i + L::kStages - 1 < n_steps) issue(i + L::kStages - 1);
      cp_async_commit();
      const T* kt = ring + (i % L::kStages) * L::kBuf;
      const T* vt = kt + kStep * L::kPitch;
      const bool live = first + i * kDecWarps * kStep + key_lane < k1;

      // scores: this lane's half of its key's dims, every row
      float sc[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) sc[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const int c = (2 * j + half) * kVec;
        float kf[kVec];
        load16(kf, kt + key_lane * L::kPitch + c);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 qf = *reinterpret_cast<const float4*>(qs + g * D + c + e);
            sc[g] = fmaf(qf.x, kf[e], sc[g]);
            sc[g] = fmaf(qf.y, kf[e + 1], sc[g]);
            sc[g] = fmaf(qf.z, kf[e + 2], sc[g]);
            sc[g] = fmaf(qf.w, kf[e + 3], sc[g]);
          }
      }

      // online softmax over the step's keys (key 0 of a step is live, so
      // the new max is finite)
      float p[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float dot = sc[g] + __shfl_xor_sync(0xffffffffu, sc[g], 1);
        const float s = live ? dot * scale : -INFINITY;
        const float mn = fmaxf(m[g], warp_max(s));
        const float alpha = expf(m[g] - mn);  // 0 while m is -inf
        p[g] = live ? expf(s - mn) : 0.f;
        l[g] = l[g] * alpha + warp_sum(half ? 0.f : p[g]);
#pragma unroll
        for (int j = 0; j < kPairsPerLane; ++j) {
          acc[g][j][0] *= alpha;
          acc[g][j][1] *= alpha;
        }
        m[g] = mn;
      }

      // P.V: each lane its pairs of dims, the step's keys in order
#pragma unroll 4
      for (int r = 0; r < kStep; ++r) {
        float pr[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g)
          pr[g] = __shfl_sync(0xffffffffu, p[g], 2 * r);
#pragma unroll
        for (int j = 0; j < kPairsPerLane; ++j) {
          const int pi = lane + 32 * j;
          if (pi < kPairs) {
            const float2 vv = load_pair(vt + r * L::kPitch + 2 * pi);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
              acc[g][j][0] = fmaf(pr[g], vv.x, acc[g][j][0]);
              acc[g][j][1] = fmaf(pr[g], vv.y, acc[g][j][1]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();

    // the combine may launch now (it waits for this grid to finish)
    asm volatile("griddepcontrol.launch_dependents;");
    // the warps' states through shared memory -> the split's partial
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float* rw = red + (warp * GT + g) * kRed;
#pragma unroll
      for (int j = 0; j < kPairsPerLane; ++j) {
        const int pi = lane + 32 * j;
        if (pi < kPairs) {
          rw[2 * pi] = acc[g][j][0];
          rw[2 * pi + 1] = acc[g][j][1];
        }
      }
      if (lane == 0) {
        rw[D] = m[g];
        rw[D + 1] = l[g];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < GT * D; i += kDecThreads) {
      const int g = i / D, d = i - g * D;
      if (g0 + g >= G) continue;
      float mm = -INFINITY, ll = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
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
  }
}

struct Args {
  const void *q, *k, *v, *valid_len;
  void *out, *ws_ml, *ws_acc;
  int B, H, KV, S, D, kps, splits;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GT>
int launch_split(const Args& a) {
  using L = Layout<T, D>;
  const size_t smem = sizeof(T) * (size_t)kDecWarps * L::kStages * L::kBuf +
                      sizeof(float) * ((size_t)GT * D +
                                       (size_t)kDecWarps * GT * (D + 2));
  static size_t configured[kMaxDevices];
  cudaError_t e = allow_smem(decode_split_kernel<T, D, GT>, smem, configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B, a.KV, a.splits);
  decode_split_kernel<T, D, GT><<<grid, kDecThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.valid_len),
      static_cast<float*>(a.ws_ml), static_cast<float*>(a.ws_acc), a.H, a.KV,
      a.S, a.kps, a.scale);
  return (int)cudaGetLastError();
}

// G = 1 (zamba2) takes the one-row kernel, G = 2 (gemma3) the 2-row
// kernel, G <= 4 the 4-row kernel, larger groups the 8-row kernel (in
// groups of 8)
template <typename T, int D>
int launch_rows(const Args& a) {
  const int G = a.H / a.KV;
  if (G == 1) return launch_split<T, D, 1>(a);
  if (G == 2) return launch_split<T, D, 2>(a);
  return G <= 4 ? launch_split<T, D, 4>(a) : launch_split<T, D, 8>(a);
}

template <typename T>
int launch(const Args& a) {
  int code;
  switch (a.D) {
    case 16: code = launch_rows<T, 16>(a); break;
    case 32: code = launch_rows<T, 32>(a); break;
    case 64: code = launch_rows<T, 64>(a); break;
    case 80: code = launch_rows<T, 80>(a); break;
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
  return launch_combine<T>(a.ws_ml, a.ws_acc, a.out, a.B * a.H, a.D,
                           a.splits, a.stream);
}

}  // namespace

// The split kernel and then the combine kernel, on `stream`.  q (B, H, D),
// k and v (B, KV, S, D) and out (B, H, D) contiguous and 16-byte aligned;
// valid_len (B,) int32; `ws_ml` (B, H, splits, 2) and `ws_acc` (B, H,
// splits, D) fp32 workspaces of the caller, splits = ceil(S /
// keys_per_split).  dtype: 0 = bfloat16, 1 = float32.  Returns
// cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid_len, void* out, void* ws_ml,
                                void* ws_acc, int B, int H, int KV, int S,
                                int D, int keys_per_split, int splits,
                                float scale, int dtype, void* stream) {
  const Args a{q, k, v, valid_len, out, ws_ml, ws_acc, B, H, KV, S, D,
               keys_per_split, splits, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<__nv_bfloat16>(a);
  return launch<float>(a);
}
