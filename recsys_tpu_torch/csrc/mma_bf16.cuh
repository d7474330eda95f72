// The bf16 tensor-core building blocks that the mma.sync kernels of
// flash_ce.cu and blockmax.cu share: cp.async copies into shared memory,
// ldmatrix fragment loads and the m16n8k16 bf16 product with fp32 sums.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l holds, with
// gq = l / 4 and t4 = l % 4, accumulator c[0..1] at row gq, columns
// 2*t4 and 2*t4 + 1, and c[2..3] at row gq + 8; an A fragment a[0..3] the
// (row gq, k 2*t4..), (row gq + 8, k 2*t4..), (row gq, k 2*t4 + 8..) and
// (row gq + 8, k 2*t4 + 8..) pairs, so two neighbouring m16n8
// accumulators packed to bf16 are one m16k16 A fragment.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// rows [row0, row0 + rows) of src [n_rows, d] bf16 -> dst [rows][ld],
// columns [0, DP), zero past n_rows and past d, by the NTHREADS threads of
// the block: cp.async 16 bytes at a time when rows start on 16 bytes
// (vec), element by element otherwise
template <int DP, int NTHREADS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* __restrict__ src, int row0,
                                           int n_rows, int rows, int d, bool vec) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CPR; e += NTHREADS) {
    const int r = e / CPR, c8 = (e % CPR) * 8;
    const int gr = row0 + r;
    __nv_bfloat16* out = dst + r * ld + c8;
    if (vec) {
      const bool ok = gr < n_rows && c8 < d;
      cp_async16(out, ok ? src + static_cast<long long>(gr) * d + c8 : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[j] = (gr < n_rows && c8 + j < d) ? src[static_cast<long long>(gr) * d + c8 + j]
                                             : __float2bfloat16_rn(0.f);
    }
  }
}

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace
