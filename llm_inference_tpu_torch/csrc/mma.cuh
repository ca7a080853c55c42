// Tensor-core, fragment-load and async-copy primitives shared by K8
// (quant_matmul_tiled.cu) and K9/K11 (flash_attention.cu).
//
// mma_16816 is one warp's mma.sync.m16n8k16 with bf16 inputs and float32
// accumulation. Its register layout is the one the PTX ISA documents, which
// lets a kernel apply per-column scales and per-row softmax statistics in
// registers. With g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), four .b32 registers of two bf16 each:
//     a0 = A[g][2t, 2t+1]     a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]   a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, k by n), two registers:
//     b0 = B[2t, 2t+1][g]     b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8 float32), four floats:
//     c0, c1 = C[g][2t, 2t+1]     c2, c3 = C[g+8][2t, 2t+1]
// The lower-indexed element of a pair sits in the low 16 bits.
// mma_1688 (m16n8k8) takes the k-halves of those fragments: A is (a0, a1)
// of columns 0-7 or (a2, a3) of columns 8-15, B is b0 or b1; C and D are
// laid out as above.
// ldmatrix_x4 loads four 8 x 8 bf16 matrices from shared memory: lanes
// 8i..8i+7 give the addresses of matrix i's eight rows (16 bytes each,
// 16-byte aligned), and register i of lane l receives row l / 4, elements
// 2(l % 4) and 2(l % 4) + 1 of matrix i, which is an A or B register above.
// ldmatrix_x4_trans delivers each matrix transposed: register i of lane l
// holds rows 2(l % 4) and 2(l % 4) + 1 of column l / 4, so a row-major
// [k][n] tile in shared memory yields the B registers of B = that tile.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// two floats → one register of two bf16 (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16 bits of a float that bf16 holds exactly (a small integer code)
__device__ __forceinline__ uint32_t exact_bf16_bits(float f) {
  return __float_as_uint(f) >> 16;
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// a generic pointer into shared memory → its shared-window address
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global → shared; with src_bytes 0 the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 4 bytes global → shared (through L1); with src_bytes 0 a zero is written
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace mma
