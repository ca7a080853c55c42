// The int4 GEMV core shared by K1 (quant_matmul.cu, M <= 8), K6 and K7
// (layer_tail.cu) and K12 (layer_fused.cu): one warp computes kCols
// output columns of
//   y[m][n] = sum_g scale[n][g] * sum_{k in group g} x[m][k] * code[n][k]
// with float32 x and float32 accumulation.
//
// Weight layout (ops/quantization.py): codes of one layer are [N][K/2]
// bytes, byte j of a column holding code 2j in its low nibble and code
// 2j+1 in its high nibble (two's complement); scales are float32 [N][G],
// one column's G group scales contiguous. A lane streams a 16-byte chunk
// (32 consecutive codes), lanes split K, so a warp reads a column
// coalesced. Groups of a multiple of 32 codes: a chunk never straddles a
// group, so the chunk's partial dot takes one scale (the lanes of a
// group read the same one). Groups of 8 or 16 codes (the TPU kernels take
// any group size of at least 8): a chunk's four 32-bit words are 8 codes
// each, so every group ends at a word boundary; the words of one group
// sum into a partial that takes the group's scale when the group ends,
// and the groups' scaled partials are summed, as on the TPU.
//
// Nibble → float without an int→float conversion (a quarter-rate
// instruction): xor 8 makes every nibble u = code + 8 in [0, 15]; a byte
// permute places u in the mantissa of 2^23 (0x4B0000uu), and subtracting
// 2^23 + 8 leaves the code exactly.
//
// The rows x live in shared memory SWIZZLED (swz): a lane's 32 floats of
// x sit 128 bytes after its neighbour's, so unswizzled every float4 read
// of a warp hits the same four banks (an 8-way conflict on each read,
// which measured as a time per code independent of the code width). The
// 16-byte slot of each float4 inside its 32-float chunk is xor-ed with the
// chunk's index, so the 8 lanes of a shared-memory phase read 8 distinct
// slots.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int4g {

constexpr int kCols = 4;   // output columns per warp

// Position of element k of an x row in shared memory (rows start at a
// multiple of 32 elements): the 16-byte slot (bits 2-4) xor the chunk
// index (bits 5-7), a permutation inside each 32-float chunk.
__device__ __forceinline__ int swz(int k) {
  return k ^ (((k >> 5) & 7) << 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// The codes and scales of one lane's chunk ch for kCols columns: NS = 1
// scale a column (groups of 32k codes) or one for each of the chunk's four
// 8-code words (groups of 8 or 16 codes; a 16-code group's scale is read
// twice).
template <int NS>
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ w,
                                           const float* __restrict__ s,
                                           size_t row_bytes, int G,
                                           int gsize, int n0, int ch,
                                           uint4 (&wv)[kCols],
                                           float (&sc)[kCols][NS]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    wv[c] = __ldg(reinterpret_cast<const uint4*>(
        w + (size_t)(n0 + c) * row_bytes + (size_t)ch * 16));
#pragma unroll
    for (int j = 0; j < NS; ++j)
      sc[c][j] = __ldg(s + (size_t)(n0 + c) * G + (ch * 32 + j * 8) / gsize);
  }
}

// acc[c][m] += this lane's share of y[m][n0 + c] for m < M <= MT.
// x: float rows at stride ldx in shared memory, each laid out by swz.
// w: the layer's codes, s: its scales. The loads of the lane's next chunk
// are issued before the current one is computed, so a warp keeps its
// loads in flight while it unpacks. WORD: groups of 8 or 16 codes, whose
// partials take their scale at the group's last word.
template <int MT, bool WORD>
__device__ __forceinline__ void gemv_cols_t(const float* x, int ldx, int M,
                                            const uint8_t* __restrict__ w,
                                            const float* __restrict__ s,
                                            int K, int G, int n0, int lane,
                                            float (&acc)[kCols][MT]) {
  constexpr int NS = WORD ? 4 : 1;
  const int chunks = K / 32;
  const int gsize = K / G;
  const size_t row_bytes = (size_t)K / 2;
  uint4 wn[kCols];
  float sn[kCols][NS];
  if (lane < chunks)
    load_chunk<NS>(w, s, row_bytes, G, gsize, n0, lane, wn, sn);
#pragma unroll 1
  for (int ch = lane; ch < chunks; ch += 32) {
    uint4 wv[kCols];
    float sc[kCols][NS];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      wv[c] = wn[c];
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[c][j] = sn[c][j];
    }
    if (ch + 32 < chunks)
      load_chunk<NS>(w, s, row_bytes, G, gsize, n0, ch + 32, wn, sn);
    float part[kCols][MT];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int m = 0; m < MT; ++m) part[c][m] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {           // 8 codes per 32-bit word
      float cf[kCols][8];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t word = q == 0   ? (uint32_t)wv[c].x
                              : q == 1 ? (uint32_t)wv[c].y
                              : q == 2 ? (uint32_t)wv[c].z
                                       : (uint32_t)wv[c].w;
        unpack8(word, cf[c]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          // float4 slots 2q and 2q + 1 of chunk ch, swizzled (swz)
          const float4* xp = reinterpret_cast<const float4*>(
              x + (size_t)m * ldx + (size_t)ch * 32);
          const float4 xa = xp[(2 * q) ^ (ch & 7)];
          const float4 xb = xp[(2 * q + 1) ^ (ch & 7)];
          const float xf[8] = {xa.x, xa.y, xa.z, xa.w,
                               xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float p = part[c][m];
#pragma unroll
            for (int j = 0; j < 8; ++j) p = fmaf(xf[j], cf[c][j], p);
            part[c][m] = p;
          }
        }
      }
      if constexpr (WORD) {
        if (((q + 1) * 8) % gsize == 0) {   // a group ends with this word
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              acc[c][m] = fmaf(part[c][m], sc[c][q], acc[c][m]);
              part[c][m] = 0.f;
            }
        }
      }
    }
    if constexpr (!WORD) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[c][m] = fmaf(part[c][m], sc[c][0], acc[c][m]);
    }
  }
}

// Whether the core takes groups of K / G codes: a multiple of 32, or 8
// or 16 (G must divide K, and K be a multiple of 32).
__host__ __device__ __forceinline__ bool groups_ok(int K, int G) {
  if (G < 1 || K % 32 || K % G) return false;
  const int gsize = K / G;
  return gsize % 32 == 0 || gsize == 8 || gsize == 16;
}

template <int MT>
__device__ __forceinline__ void gemv_cols(const float* x, int ldx, int M,
                                          const uint8_t* __restrict__ w,
                                          const float* __restrict__ s,
                                          int K, int G, int n0, int lane,
                                          float (&acc)[kCols][MT]) {
  if (K / G < 32)
    gemv_cols_t<MT, true>(x, ldx, M, w, s, K, G, n0, lane, acc);
  else
    gemv_cols_t<MT, false>(x, ldx, M, w, s, K, G, n0, lane, acc);
}

}  // namespace int4g
