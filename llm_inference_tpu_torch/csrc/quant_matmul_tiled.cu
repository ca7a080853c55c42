// K8: the prefill GEMM for M > 128 rows, int8 per-channel or int4 grouped
// weight-only quantized weights.
//
// Replaces llm_inference_tpu/ops/pallas/quant_matmul.py:_quant_matmul_tiled
// (_tiled_kernel). Same function and rounding points: the rows enter as
// bf16 (the prologue ran before, qmm_prologue_launch), the codes widen to
// bf16 exactly (they are small integers), the products accumulate in
// float32 and
//   int8:  y[m][n] = bf16( scale[n] * sum_k x[m][k] * code[n][k] )
//   int4:  y[m][n] = bf16( sum_g scale[n][g] * sum_{k in g} x[m][k] * code[n][k] )
// Weight layout (ops/quantization.py): int8 codes [N][K], int4 codes
// [N][K/2] (code 2j in the low nibble of byte j, 2j+1 in the high one),
// scales float32 [N] or [N][G].
//
// Bound on the H100 SXM: operations. One 2048-row prefill chunk of
// LLaMA-2-7B takes 2 x 2048 x 202.4M = 829 GFLOP per layer (wqkv, wo,
// gate-up, down), 0.84 ms at 989 TFLOP/s of bf16; the int8 codes of a layer
// (202 MB) take 0.06 ms to read.
//
// Design. The TPU kernel keeps a weight block's widened codes in VMEM and
// runs every 256-row m tile against them, so weights cross HBM once. A
// block here has 227 KB of shared memory, which cannot hold a useful
// N tile's codes for all of K (K x 128 x 2 bytes is 1 MB at K = 4096), so
// the trade is made in two levels instead:
// - a block owns a 128 x 128 output tile; per 32-deep K chunk it widens
//   the weight chunk to bf16 in shared memory ONCE and all 8 warps (128
//   rows) reuse it on tensor cores (mma.sync m16n8k16, bf16 in, float32
//   accumulate);
// - blocks are numbered m-tile fastest, so the m tiles of one N tile run
//   side by side and the later ones find the weight chunk in L2: the codes
//   cross HBM about once, the rows (x) once per N tile, as on the TPU.
// The x chunk arrives by cp.async into a double buffer; the next weight
// chunk is loaded into registers while the current one is multiplied.
// int4: the documented mma.sync accumulator layout (mma.cuh) says which
// column each register holds, so each group's partial sums take their
// column scales in registers (a second set of accumulators) instead of
// going through shared memory as K1's wmma path must. A group of 32k
// codes folds after its last chunk; a group of 16 codes after each
// 16-deep product; a group of 8 codes splits each product into its two
// m16n8k8 halves and folds after each (the TPU kernel takes any group of
// at least 8 codes). Rows past M are zero-filled and not stored; N must
// be a multiple of 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int4_gemv.cuh"
#include "mma.cuh"

namespace {

constexpr int TM = 128, TN = 128, TK = 32;
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N
constexpr int LDS = TK + 8;         // bf16 per shared row (80 bytes)

// SUB: 0 for int8 and for int4 groups of 32k codes, else the int4 group
// size (16 or 8).
template <bool INT4, int SUB>
__global__ void __launch_bounds__(kThreads, 1)
qmm_tiled(const __nv_bfloat16* __restrict__ a,   // [M, K] bf16 rows
          const uint8_t* __restrict__ w,         // this layer's codes
          const float* __restrict__ scale,       // [N] or [N, G]
          __nv_bfloat16* __restrict__ out,       // [M, N]
          int M, int K, int N, int G) {
  __shared__ __align__(16) __nv_bfloat16 As[2][TM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][TN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;   // warp tile 64 x 32
  const int gr = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int nk = K / TK;
  const int chunks_per_group = INT4 && SUB == 0 ? (K / G) / TK : nk;

  // this thread's share of a weight chunk: 16 codes of column bcol
  const int bcol = tid >> 1, bhalf = tid & 1;
  const uint8_t* wsrc =
      w + (size_t)(n0 + bcol) * (INT4 ? K / 2 : K) + bhalf * (INT4 ? 8 : 16);

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = part[i][j][c] = 0.f;

  auto load_a = [&](int kt, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {            // 128 rows x 4 vectors of 16 B
      const int v = tid + i * kThreads;
      const int r = v >> 2, c = (v & 3) * 8;
      const int row = m0 + r;
      const __nv_bfloat16* src =
          a + (size_t)(row < M ? row : M - 1) * K + (size_t)kt * TK + c;
      mma::cp_async16(&As[buf][r * LDS + c], src, row < M ? 16 : 0);
    }
  };
  uint4 wraw;                                 // int8: 16 codes; int4: 8 bytes
  auto load_w = [&](int kt) {
    if constexpr (INT4) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(wsrc + kt * 16));
      wraw = make_uint4(v.x, v.y, 0u, 0u);
    } else {
      wraw = __ldg(reinterpret_cast<const uint4*>(wsrc + kt * 32));
    }
  };
  auto store_w = [&](int buf) {              // 16 codes → 16 exact bf16
    uint32_t p[8];
    if constexpr (INT4) {
      float c0[8], c1[8];
      int4g::unpack8(wraw.x, c0);
      int4g::unpack8(wraw.y, c1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = mma::exact_bf16_bits(c0[2 * j]) |
               (mma::exact_bf16_bits(c0[2 * j + 1]) << 16);
        p[4 + j] = mma::exact_bf16_bits(c1[2 * j]) |
                   (mma::exact_bf16_bits(c1[2 * j + 1]) << 16);
      }
    } else {
      const uint32_t words[4] = {wraw.x, wraw.y, wraw.z, wraw.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t wd = words[j >> 1];
        const int b0 = 2 * (j & 1);
        const float lo = (float)(int8_t)(wd >> (8 * b0));
        const float hi = (float)(int8_t)(wd >> (8 * b0 + 8));
        p[j] = mma::exact_bf16_bits(lo) | (mma::exact_bf16_bits(hi) << 16);
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(&Bs[buf][bcol * LDS + bhalf * 16]);
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
  };

  // acc += part * (group g's column scales), then part = 0
  auto fold = [&](int g) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + tg * 2;
      const float s0 = __ldg(scale + (size_t)col * G + g);
      const float s1 = __ldg(scale + (size_t)(col + 1) * G + g);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        acc[mi][ni][0] = fmaf(part[mi][ni][0], s0, acc[mi][ni][0]);
        acc[mi][ni][1] = fmaf(part[mi][ni][1], s1, acc[mi][ni][1]);
        acc[mi][ni][2] = fmaf(part[mi][ni][2], s0, acc[mi][ni][2]);
        acc[mi][ni][3] = fmaf(part[mi][ni][3], s1, acc[mi][ni][3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) part[mi][ni][c] = 0.f;
      }
    }
  };

  load_a(0, 0);
  mma::cp_async_commit();
  load_w(0);
  store_w(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_a(kt + 1, buf ^ 1);
      load_w(kt + 1);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();                 // chunk kt's rows have landed
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks) {
      const int c = ks * 16 + tg * 2;
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* r0 = &As[buf][(wm + mi * 16 + gr) * LDS + c];
        const __nv_bfloat16* r1 = r0 + 8 * LDS;
        af[mi][0] = mma::lds32(r0);
        af[mi][1] = mma::lds32(r1);
        af[mi][2] = mma::lds32(r0 + 8);
        af[mi][3] = mma::lds32(r1 + 8);
      }
      if constexpr (INT4 && SUB == 8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {        // the product's two k-halves
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const uint32_t b = mma::lds32(
                &Bs[buf][(wn + ni * 8 + gr) * LDS + c + 8 * h]);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
              mma::mma_1688(part[mi][ni], af[mi][2 * h], af[mi][2 * h + 1],
                            b);
          }
          fold(kt * 4 + ks * 2 + h);
        }
      } else {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* bp = &Bs[buf][(wn + ni * 8 + gr) * LDS + c];
          const uint32_t b0 = mma::lds32(bp), b1 = mma::lds32(bp + 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            if constexpr (INT4)
              mma::mma_16816(part[mi][ni], af[mi], b0, b1);
            else
              mma::mma_16816(acc[mi][ni], af[mi], b0, b1);
          }
        }
        if constexpr (INT4 && SUB == 16) fold(kt * 2 + ks);
      }
    }
    if constexpr (INT4 && SUB == 0) {
      if ((kt + 1) % chunks_per_group == 0)  // the group is complete
        fold(kt / chunks_per_group);
    }
    // the other buffer was last read before this iteration's barrier
    if (kt + 1 < nk) store_w(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + tg * 2;
    float s0 = 1.f, s1 = 1.f;
    if constexpr (!INT4) {
      s0 = __ldg(scale + col);
      s1 = __ldg(scale + col + 1);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = m0 + wm + mi * 16 + gr;
      if (row < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
            mma::pack_bf16(acc[mi][ni][0] * s0, acc[mi][ni][1] * s1);
      if (row + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * N + col) =
            mma::pack_bf16(acc[mi][ni][2] * s0, acc[mi][ni][3] * s1);
    }
  }
}

}  // namespace

// a: bf16 rows [M, K]; w: ONE layer's codes (int8 [N, K] when bits == 8,
// packed int4 [N, K/2] when bits == 4); scale: float32 [N] (int8) or
// [N, G] (int4); out: bf16 [M, N]. Requires K % 32 == 0, N % 128 == 0 and,
// for int4, groups of K / G codes a multiple of 32, or 16 or 8.
extern "C" int qmm_tiled_launch(const void* a, const void* w,
                                const void* scale, void* out, int M, int K,
                                int N, int G, int bits, void* stream) {
  if (M < 1 || K % TK != 0 || N % TN != 0 || (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const int gsize = bits == 4 && G >= 1 && K % G == 0 ? K / G : 0;
  if (bits == 4 && gsize % TK != 0 && gsize != 16 && gsize != 8)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + TM - 1) / TM, N / TN);
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* ap = (const __nv_bfloat16*)a;
  const uint8_t* wp = (const uint8_t*)w;
  const float* sp = (const float*)scale;
  __nv_bfloat16* op = (__nv_bfloat16*)out;
  if (bits == 8)
    qmm_tiled<false, 0><<<grid, kThreads, 0, st>>>(ap, wp, sp, op, M, K, N,
                                                   1);
  else if (gsize == 8)
    qmm_tiled<true, 8><<<grid, kThreads, 0, st>>>(ap, wp, sp, op, M, K, N, G);
  else if (gsize == 16)
    qmm_tiled<true, 16><<<grid, kThreads, 0, st>>>(ap, wp, sp, op, M, K, N,
                                                   G);
  else
    qmm_tiled<true, 0><<<grid, kThreads, 0, st>>>(ap, wp, sp, op, M, K, N, G);
  return (int)cudaGetLastError();
}
