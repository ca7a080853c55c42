// The int4 widening of K8's mma.sync kernel (quant_matmul_tiled.cu,
// qmm_tiled), kept from the CUDA-core int4 GEMV it was written for (K1's
// M <= 8 branch until that moved to the weight ring, qmm4_gemv.cu).
//
// Weight layout (ops/quantization.py): codes of one layer are [N][K/2]
// bytes, byte j of a column holding code 2j in its low nibble and code
// 2j+1 in its high nibble (two's complement).
//
// Nibble → float without an int→float conversion (a quarter-rate
// instruction): xor 8 makes every nibble u = code + 8 in [0, 15]; a byte
// permute places u in the mantissa of 2^23 (0x4B0000uu), and subtracting
// 2^23 + 8 leaves the code exactly.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int4g {

// The 8 codes of one 32-bit word of packed codes, in K order.
__device__ __forceinline__ void unpack8(uint32_t w, float (&c)[8]) {
  const uint32_t v = w ^ 0x88888888u;
  const uint32_t lo = v & 0x0F0F0F0Fu;          // codes 0, 2, 4, 6 (+8)
  const uint32_t hi = (v >> 4) & 0x0F0F0F0Fu;   // codes 1, 3, 5, 7 (+8)
  const uint32_t magic = 0x4B000000u;           // 2^23
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // result bytes: [byte j of lo/hi, 0, 0, 0x4B]
    c[2 * j] = __uint_as_float(__byte_perm(lo, magic, 0x7440u | j)) -
               8388616.0f;
    c[2 * j + 1] = __uint_as_float(__byte_perm(hi, magic, 0x7440u | j)) -
                   8388616.0f;
  }
}

}  // namespace int4g
