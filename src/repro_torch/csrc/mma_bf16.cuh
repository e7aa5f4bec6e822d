// Shared device helpers of the bf16 tensor-core attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) for Hopper (sm_90a);
// paged_attention.cu takes its `cp.async` copies and `allow_smem` from here
// too.
//
// The kernels run FlashAttention-2 shaped tiles on `mma.sync.m16n8k16`
// (bf16 operands, fp32 accumulators): 128 threads a block, 4 warps of 16
// rows each.  Tiles sit in shared memory as bf16, rows padded by 8
// elements (16 bytes) so that the 8 row addresses of every `ldmatrix` fall
// in distinct bank groups; `ldmatrix` reads an operand in its stored
// orientation and `ldmatrix.trans` transposed.  Tiles are copied with
// `cp.async` (16 bytes a thread, zero-fill past the ragged tail).  The
// accumulators of two adjacent m16n8 tiles are exactly the A fragment of
// one m16n8k16, so a score tile becomes the next product's A operand in
// registers (`to_a_frags`), never through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps, 16 of the block's 64 rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

template <int D>
constexpr int kPitch = D + 8;  // bf16 a shared row: 16 bytes of pad

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

// every pair of queries [q0, q0 + nq) x keys [k0, k0 + nk) visible: the
// tile needs no mask
__device__ __forceinline__ bool tile_full(const Mask& m, int q0, int nq,
                                          int k0, int nk) {
  if (q0 + nq > m.Sq || k0 + nk > m.Sk) return false;
  const int qpos = m.q_offset + q0;
  if (m.causal && k0 + nk - 1 > qpos) return false;
  if (m.window > 0 && k0 <= qpos + nq - 1 - m.window) return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !ok (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.  Without .trans lane l receives row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of each matrix; with .trans, the
// same of the transposed matrix.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8 fp32) += a (16 x 16 bf16) . b (16 x 8 bf16)
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of one (S, D) bf16 matrix -> dst (ROWS x pitch),
// zeros past `rows`
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async16(dst + r * kPitch<D> + c, src + (ok ? row : 0) * stride + c,
               ok);
  }
}

// the A fragments of a warp's 16 rows (rows x D row-major in shared memory)
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (*a)[4], const bf16* p,
                                             int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldsm4(a[kc], p + (lane & 15) * kPitch<D> + kc * 16 + (lane >> 4) * 8);
}

// acc (16 x 8 NT) += a . b^T over D for one 16-column k step: a is the A
// fragment of that step, b is 8 NT rows x D row-major in shared memory,
// read as stored
template <int D, int NT>
__device__ __forceinline__ void mma_abt_step(float (*acc)[4],
                                             const uint32_t a[4],
                                             const bf16* b, int kc,
                                             int lane) {
  constexpr int P = kPitch<D>;
#pragma unroll
  for (int n = 0; n < NT / 2; ++n) {
    uint32_t bf[4];
    ldsm4(bf, b + (n * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kc * 16 +
                  ((lane >> 3) & 1) * 8);
    mma16816(acc[2 * n], a, bf[0], bf[1]);
    mma16816(acc[2 * n + 1], a, bf[2], bf[3]);
  }
}

// acc (16 x 8 NT) += a . b^T over D: a is 16 rows, b is 8 NT rows, both
// (rows x D) row-major in shared memory, read as stored
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const bf16* a,
                                        const bf16* b, int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t af[4];
    ldsm4(af, a + (lane & 15) * kPitch<D> + kc * 16 + (lane >> 4) * 8);
    mma_abt_step<D, NT>(acc, af, b, kc, lane);
  }
}

// acc (16 x D) += a . b: a is 16 x 16 KC as A fragments in registers, b
// is 16 KC rows x D row-major in shared memory, read transposed
template <int D, int KC>
__device__ __forceinline__ void mma_ab(float (*acc)[4], uint32_t (*a)[4],
                                       const bf16* b, int lane) {
  constexpr int P = kPitch<D>;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t bf[4];
      ldsm4_t(bf, b + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                      n * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * n], a[kc], bf[0], bf[1]);
      mma16816(acc[2 * n + 1], a[kc], bf[2], bf[3]);
    }
  }
}

// a 16 x 16 KC fp32 accumulator (2 KC tiles of 16 x 8) rounded to bf16 A
// fragments: tiles 2j and 2j + 1 hold columns [16 j, 16 j + 16) in exactly
// the places of each lane that the A operand of one m16n8k16 takes them
template <int KC>
__device__ __forceinline__ void to_a_frags(uint32_t (*a)[4], float (*c)[4]) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// a warp's 16 x D fp32 accumulator -> rows row0 + lane / 4 and row0 +
// lane / 4 + 8 of `out` (row stride `stride`), rows past `rows` dropped
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long stride,
                                           float (*acc)[4], int row0,
                                           int rows, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + half * 8;
    if (row >= rows) continue;
    bf16* dst = out + row * stride + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
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

}  // namespace
