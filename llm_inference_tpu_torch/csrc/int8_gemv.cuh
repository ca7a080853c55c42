// The int8 GEMV core shared by K1 (quant_matmul.cu, M <= 8) and K12
// (layer_fused.cu): one warp computes kCols output columns of
//   y[m][n] = sum_k x[m][k] * code[n][k]                  (per channel)
//   y[m][n] = sum_g scale[n][g] * sum_{k in g} x[m][k] * code[n][k]
//                                                          (grouped)
// with bf16 x, exact int8 codes and float32 accumulation; the caller
// reduces the lanes (warp_sum) and applies a per-channel column scale.
// Grouped scales hit each 16-code chunk's partial dot (a group is a
// multiple of 16 codes), the TPU kernel's per-group partial dots
// (quant_matmul.py:313-320) summed in another order.
//
// Weight layout (ops/quantization.py): codes of one layer are [N][K] int8,
// one K-contiguous row per output column. A lane streams 16 codes of each
// of the warp's columns with one 16-byte load, lanes splitting K, so a warp
// reads each column coalesced; the matching 16 bf16 of x come from shared
// memory as two 16-byte loads and widen to exact floats by a shift.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace int8g {

constexpr int kCols = 4;   // output columns per warp

// acc[c][m] += this lane's share of y[m][n0 + c] for m < M <= MT.
// x: bf16 rows at stride ldx in shared memory; w: the layer's codes.
// GRP: scale [N][G] of groups of gs codes (a multiple of 16) on each
// chunk's partial dot. Requires K % 16 == 0.
template <int MT, bool GRP = false>
__device__ __forceinline__ void gemv_cols(const __nv_bfloat16* x, int ldx,
                                          int M, const int8_t* __restrict__ w,
                                          int K, int n0, int lane,
                                          float (&acc)[kCols][MT],
                                          const float* __restrict__ scale =
                                              nullptr,
                                          int G = 1, int gs = 0) {
  const int chunks = K / 16;  // 16 codes per lane per step
#pragma unroll 2
  for (int ch = lane; ch < chunks; ch += 32) {
    int4 wv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      wv[c] = __ldg(reinterpret_cast<const int4*>(
          w + (size_t)(n0 + c) * K + (size_t)ch * 16));
    float sc[kCols];
    if constexpr (GRP) {
      const int g = ch * 16 / gs;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        sc[c] = __ldg(scale + (size_t)(n0 + c) * G + g);
    }
    // the 16 codes of each column as signed bytes of four 32-bit words
    uint32_t words[kCols][4];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      words[c][0] = (uint32_t)wv[c].x;
      words[c][1] = (uint32_t)wv[c].y;
      words[c][2] = (uint32_t)wv[c].z;
      words[c][3] = (uint32_t)wv[c].w;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const uint4* xp = reinterpret_cast<const uint4*>(
            x + (size_t)m * ldx + ch * 16);
        const uint4 xa = xp[0], xb = xp[1];
        const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w,
                                xb.x, xb.y, xb.z, xb.w};
        float xf[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {      // bf16 pair → two exact floats
          xf[2 * j] = __uint_as_float(xw[j] << 16);
          xf[2 * j + 1] = __uint_as_float(xw[j] & 0xffff0000u);
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float a = GRP ? 0.f : acc[c][m];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int code =
                (int)(words[c][j >> 2] << (24 - 8 * (j & 3))) >> 24;
            a = fmaf(xf[j], (float)code, a);
          }
          acc[c][m] = GRP ? fmaf(a, sc[c], acc[c][m]) : a;
        }
      }
    }
  }
}

}  // namespace int8g
