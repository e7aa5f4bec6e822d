// Shared device helpers of the chunked scan kernels (ssd_scan.cu,
// rwkv6_scan.cu) for Hopper (sm_90a).
//
// Both kernels cut the sequence into chunks of kQ = 64 tokens and run a
// chunk's products on the tensor cores with `mma.sync`: 128 threads a
// block, 4 warps of 16 of the chunk's rows each.  Where both operands are
// bf16 inputs the product is bf16 (`mma16816`, exact products, fp32 sums).
// Where an operand is fp32 (a row scaled by a decay, the carried state) it
// is split into a TF32 high part and a TF32 remainder and the product is
// taken as hi.b + lo.b (the other operand a bf16 input, exact in TF32) or
// lo.hi + hi.lo + hi.hi (both fp32): "3xTF32", about 2^-21 relative per
// product, so the sums keep fp32 accuracy.
//
// TF32 fragments of `mma.m16n8k8` are built from shared memory with scalar
// loads.  An m16n8 fp32 accumulator becomes the A operand of the next
// product in registers: lane (g, q) holds columns 2q and 2q + 1 of rows g
// and g + 8, which the A fragment takes as k = q and k = q + 4; the B
// fragment then reads rows 2q and 2q + 1 of its 8-row step for k = q and
// q + 4 (`acc_to_a`).

#pragma once

#include "mma_bf16.cuh"

namespace {

constexpr int kQ = 64;           // tokens a chunk
constexpr int kScanThreads = 128;

__device__ __forceinline__ float ldf(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (lo rounds the remainder x - hi)
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = tf32_bits(x);
  return {hi, tf32_bits(x - __uint_as_float(hi))};
}

// a value exact in TF32 (a bf16 input), as the operand's bits
__device__ __forceinline__ uint32_t exact_tf32(float x) {
  return __float_as_uint(x);
}

// c (16 x 8 fp32) += a (16 x 8 tf32) . b (8 x 8 tf32)
__device__ __forceinline__ void mma1688(float c[4], const uint32_t a[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fp32 (split), B exact: c += a_lo b + a_hi b
__device__ __forceinline__ void mma_split_a(float c[4], const uint32_t ahi[4],
                                            const uint32_t alo[4], uint32_t b0,
                                            uint32_t b1) {
  mma1688(c, alo, b0, b1);
  mma1688(c, ahi, b0, b1);
}

// A exact, B fp32 (split): c += a b_lo + a b_hi
__device__ __forceinline__ void mma_split_b(float c[4], const uint32_t a[4],
                                            Split b0, Split b1) {
  mma1688(c, a, b0.lo, b1.lo);
  mma1688(c, a, b0.hi, b1.hi);
}

// both fp32 (split): c += a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma_split_ab(float c[4], const uint32_t ahi[4],
                                             const uint32_t alo[4], Split b0,
                                             Split b1) {
  mma1688(c, alo, b0.hi, b1.hi);
  mma1688(c, ahi, b0.lo, b1.lo);
  mma1688(c, ahi, b0.hi, b1.hi);
}

// the A fragments (split) of a 16 x 8 block held as an m16n8 accumulator,
// with k permuted as the file note says
__device__ __forceinline__ void acc_to_a(uint32_t hi[4], uint32_t lo[4],
                                         const float c[4]) {
  const Split s0 = split_tf32(c[0]), s1 = split_tf32(c[2]),
              s2 = split_tf32(c[1]), s3 = split_tf32(c[3]);
  hi[0] = s0.hi, hi[1] = s1.hi, hi[2] = s2.hi, hi[3] = s3.hi;
  lo[0] = s0.lo, lo[1] = s1.lo, lo[2] = s2.lo, lo[3] = s3.lo;
}

// Widest copy (16, 4 or the element's own bytes) that every row of an
// operand allows: the base, each stride (elements) and the row's `cols`
// valid elements all multiples of it.
inline int copy_bytes(const void* p, int elem, long long s0, long long s1,
                      long long s2, int cols) {
  const int widths[2] = {16, 4};
  for (int w : widths) {
    if (reinterpret_cast<uintptr_t>(p) % w == 0 && (s0 * elem) % w == 0 &&
        (s1 * elem) % w == 0 && (s2 * elem) % w == 0 && (cols * elem) % w == 0)
      return w;
  }
  return elem;
}

// Rows [0, ROWS) x columns [0, D) of one operand into dst (row pitch
// `pitch` elements): rows < `rows` and columns < `cols` from src (row
// stride `stride`), zeros elsewhere.  16- and 4-byte pieces go by
// `cp.async` (commit and wait follow); 2-byte ones by plain loads.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src,
                                      long long stride, int rows, int cols,
                                      int bytes) {
  const int per = bytes / (int)sizeof(T);  // elements a piece
  const int pieces = D / per;              // pieces a row
  for (int i = threadIdx.x; i < ROWS * pieces; i += kScanThreads) {
    const int r = i / pieces, c = (i - r * pieces) * per;
    const bool ok = r < rows && c < cols;
    const T* s = src + (ok ? r * stride + c : 0);
    T* d = dst + r * pitch + c;
    if (bytes == 16)
      cp_async16(d, s, ok);
    else if (bytes == 4)
      cp_async4(d, s, ok);
    else
      *d = ok ? *s : T(0.f);
  }
}

// The states in chunk order, one thread an element of a (rows x cols)
// state: each chunk's slot holds its own state dS and becomes the state
// before that chunk, h = exp(total) h + dS; the state after the last chunk
// is the final state.  `totals` holds a log-decay per chunk, or per chunk
// and row when `per_row`.  The slots are read 8 chunks ahead of the chain.
__device__ __forceinline__ void pass_states(float* __restrict__ states,
                                            const float* __restrict__ totals,
                                            float* __restrict__ state_out,
                                            int H, int rows, int cols, int nc,
                                            bool per_row) {
  constexpr int kAhead = 8;
  const int pn = rows * cols;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pn) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  float* slot = states + bh * nc * pn + e;
  const float* tot = per_row ? totals + bh * nc * rows + e / cols
                             : totals + bh * nc;
  const int tstride = per_row ? rows : 1;
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float d[kAhead], decay[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        d[i] = slot[(size_t)(c0 + i) * pn];
        decay[i] = expf(tot[(size_t)(c0 + i) * tstride]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        slot[(size_t)(c0 + i) * pn] = run;
        run = run * decay[i] + d[i];
      }
    }
  }
  state_out[bh * pn + e] = run;
}

}  // namespace
