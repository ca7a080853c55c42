// K1: int8 / int4 weight-only matmul with the fused residual + RMSNorm
// prologue.
//
// Replaces llm_inference_tpu/ops/pallas/quant_matmul.py:_quant_matmul_blocked
// (_kernel), int8 per-channel symmetric weights. Same function and the
// same rounding points:
//   x32   = float(x_bf16) (+ float(residual_bf16))        (prologue, f32)
//   x_out = bf16(x32)                                      (optional)
//   xn    = x32 * rsqrt(mean(x32^2) + eps) * float(gamma)  (when gamma)
//   y     = bf16( (bf16(xn) . float(code)) * scale[n] )    (f32 accumulation)
// The weight is [N, K] int8 (one K-contiguous row per output column) and is
// stacked over layers; the caller selects a layer by pointer offset.
//
// Design. The TPU grid runs in order, so its kernel normalises x once at
// grid step 0 into VMEM scratch. CUDA blocks run in any order, so:
// - M <= 8 (decode): qmm_gemv. Every block recomputes the norm of its M
//   rows (a read of M x K activations from L2, small beside the weights)
//   into shared memory as bf16; block 0 alone writes x_out. Each warp owns
//   4 output columns and streams their codes with 16-byte loads, lanes
//   splitting K (the int8 core, int8_gemv.cuh, also K12's), and reduces
//   with shuffles at the end. Each weight byte is read once from HBM.
// - 8 < M <= 128 (prefill): a tiny pre-pass (qmm_rows_prologue, one block
//   per row) writes the normalised bf16 rows and x_out once; then qmm_mma
//   computes a 128 x 64 output tile per block, so a weight tile is read
//   once for all M rows, as the TPU kernel keeps x whole in VMEM
//   (quant_matmul.py:522). bf16 tensor-core products (wmma 16x16x16, f32
//   accumulate) on tiles staged in shared memory with 16-byte loads. (A
//   row-by-row GEMV would read the weights M times.)
// - M > 128 is the TPU's tiled prefill kernel (K8), quant_matmul_tiled.cu;
//   it takes its rows from qmm_prologue_launch below.
//
// Bound on the H100 SXM (3.35 TB/s HBM): at M = 1 the call must read the
// layer's int8 weight once. LLaMA-2-7B: wqkv 50.3 MB -> 15.0 us; w_gateup
// 90.2 MB -> 26.9 us; w_down 45.1 MB -> 13.5 us; wo 16.8 MB -> 5.0 us;
// lm_head 131 MB -> 39.1 us. One decode step streams about 6.61 GB of
// weights, a bound of about 2.0 ms per token. The GEMV's answer to that
// bound is full-width coalesced 16-byte loads, several in flight per lane,
// and enough blocks (N / 32) to cover the SMs; it does not yet use TMA or
// split K for the narrow (N = 4096) weights.
//
// The int4 branch (qmm4_launch) replaces the same TPU kernel's N-pair
// int4 branch (grouped symmetric scales: groups of 64k codes, or 8, 16 or
// 32, as the TPU kernel takes any group of at least 8): codes [N, K/2] with two
// K-adjacent nibbles per byte, float32 scales [N, G]. Its rounding points
// differ from int8's: the normed rows stay float32 (the TPU branch dots
// float32 rows) and each group's scale hits its partial dot. M <= 8 runs
// qmm4_gemv on the shared int4 core (int4_gemv.cuh, also K6's); larger M
// runs qmm4_mma. At M = 1 the bound is half of int8's: LLaMA-2-7B wqkv
// 25.2 MB codes + 1.6 MB scales -> 8.0 us, lm_head 65.5 + 4.1 MB -> 21 us.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "int4_gemv.cuh"
#include "int8_gemv.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of squares of x32 = x (+ res) over one row, by the whole block,
// which also writes x_out when `write`. Returns the sum to every thread.
__device__ float row_prologue(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ res,
                              __nv_bfloat16* __restrict__ xout, bool write,
                              int K, float* red) {
  float ss = 0.f;
  write = write && xout != nullptr;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float v = bf(x[k]);
    if (res) v += bf(res[k]);
    if (write) xout[k] = __float2bfloat16(v);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from the previous row
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += red[w];
  return tot;
}

// ---------------------------------------------------------------- GEMV
constexpr int kColsPerWarp = int8g::kCols;
constexpr int kColsPerBlock = kWarps * kColsPerWarp;   // 32

template <int MT>
__global__ void __launch_bounds__(kThreads)
qmm_gemv(const __nv_bfloat16* __restrict__ x,      // [M, K]
         const __nv_bfloat16* __restrict__ res,    // [M, K] or null
         const __nv_bfloat16* __restrict__ gamma,  // [K] or null
         const int8_t* __restrict__ w,             // [N, K] (this layer)
         const float* __restrict__ scale,          // [N]
         __nv_bfloat16* __restrict__ out,          // [M, N]
         __nv_bfloat16* __restrict__ xout,         // [M, K] or null
         int M, int K, int N, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [M][K]
  __shared__ float red[kWarps];

  for (int m = 0; m < M; ++m) {
    const __nv_bfloat16* xr = x + (size_t)m * K;
    const __nv_bfloat16* rr = res ? res + (size_t)m * K : nullptr;
    float rstd = 1.f;
    if (gamma || res || xout) {
      // every block normalises; block 0 alone writes x_out
      const float ss = row_prologue(xr, rr, xout ? xout + (size_t)m * K
                                                  : nullptr,
                                    blockIdx.x == 0, K, red);
      if (gamma) rstd = rsqrtf(ss / (float)K + eps);
    }
    for (int k = threadIdx.x; k < K; k += kThreads) {
      float v = bf(xr[k]);
      if (rr) v += bf(rr[k]);
      if (gamma) v = v * rstd * bf(gamma[k]);
      xs[(size_t)m * K + k] = __float2bfloat16(v);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kColsPerBlock + warp * kColsPerWarp;
  float acc[kColsPerWarp][MT];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;
  int8g::gemv_cols<MT>(xs, K, M, w, K, n0, lane, acc);

#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const float s = scale[n0 + c];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const float tot = warp_sum(acc[c][m]);
        if (lane == 0)
          out[(size_t)m * N + n0 + c] = __float2bfloat16(tot * s);
      }
    }
  }
}

// ----------------------------------------------------------------- MMA
constexpr int BM = 128, BN = 64, BK = 64;
constexpr int LDA = BK + 8, LDB = BK + 8, LDC = BN + 4;
constexpr int kStageBytes = (BM * LDA + BN * LDB) * 2;
constexpr int kCBytes = BM * LDC * 4;
constexpr int kMmaSmem = kStageBytes > kCBytes ? kStageBytes : kCBytes;

// Prefill prologue, one block per row: xn = bf16(rms_norm(x + res) * gamma)
// and x_out = bf16(x + res), so the MMA kernel streams ready bf16 rows.
__global__ void __launch_bounds__(kThreads)
qmm_rows_prologue(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ res,
                  const __nv_bfloat16* __restrict__ gamma,
                  __nv_bfloat16* __restrict__ xn,
                  __nv_bfloat16* __restrict__ xout, int K, float eps) {
  __shared__ float red[kWarps];
  const size_t row = (size_t)blockIdx.x * K;
  const __nv_bfloat16* rr = res ? res + row : nullptr;
  const float ss = row_prologue(x + row, rr, xout ? xout + row : nullptr,
                                true, K, red);
  const float rstd = gamma ? rsqrtf(ss / (float)K + eps) : 1.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float v = bf(x[row + k]);
    if (rr) v += bf(rr[k]);
    if (gamma) v = v * rstd * bf(gamma[k]);
    xn[row + k] = __float2bfloat16(v);
  }
}

// bf16 bits of a small integer code (exact: |code| <= 128 fits bf16)
__device__ __forceinline__ uint32_t code_bf16_bits(uint32_t word, int byte) {
  const int code = (int)(word << (24 - 8 * byte)) >> 24;
  return __float_as_uint((float)code) >> 16;
}

__global__ void __launch_bounds__(kThreads)
qmm_mma(const __nv_bfloat16* __restrict__ a,   // [M, K] bf16 rows
        const int8_t* __restrict__ w, const float* __restrict__ scale,
        __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem_raw[kMmaSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem_raw);

  const int warp = threadIdx.x / 32;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps, 32 x 32 each
  const int n0 = blockIdx.x * BN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile [BM, BK]: 8 bf16 per 16-byte load, rows >= M zero
    for (int i = threadIdx.x; i < BM * (BK / 8); i += kThreads) {
      const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < M)
        v = *reinterpret_cast<const uint4*>(a + (size_t)r * K + k0 + c8);
      *reinterpret_cast<uint4*>(As + r * LDA + c8) = v;
    }
    // weight tile [BN, BK]: 16 codes per 16-byte load, widened to bf16
    for (int i = threadIdx.x; i < BN * (BK / 16); i += kThreads) {
      const int n = i / (BK / 16), c16 = (i % (BK / 16)) * 16;
      const int4 wv = __ldg(reinterpret_cast<const int4*>(
          w + (size_t)(n0 + n) * K + k0 + c16));
      const uint32_t words[4] = {(uint32_t)wv.x, (uint32_t)wv.y,
                                 (uint32_t)wv.z, (uint32_t)wv.w};
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        packed[j] = code_bf16_bits(words[j >> 1], 2 * (j & 1)) |
                    (code_bf16_bits(words[j >> 1], 2 * (j & 1) + 1) << 16);
      uint4* dst = reinterpret_cast<uint4*>(Bs + n * LDB + c16);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn * 32 + j * 16) * LDB + kk, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], af[i], bfr[j], c[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              c[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, cc = i % BN;
    if (r < M)
      out[(size_t)r * N + n0 + cc] =
          __float2bfloat16(Cs[r * LDC + cc] * scale[n0 + cc]);
  }
}

template <int MT>
int launch_gemv(const void* x, const void* res, const void* gamma,
                const void* w, const void* scale, void* out, void* xout,
                int M, int K, int N, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)M * K * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        qmm_gemv<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  qmm_gemv<MT><<<N / kColsPerBlock, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)res,
      (const __nv_bfloat16*)gamma, (const int8_t*)w, (const float*)scale,
      (__nv_bfloat16*)out, (__nv_bfloat16*)xout, M, K, N, eps);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ int4 GEMV
// As qmm_gemv, but the rows stay float32 in shared memory (the TPU
// kernel's N-pair branch dots float32 normed rows) and the int4 core
// (int4_gemv.cuh) applies each group's scale to its partial dot.
template <int MT>
__global__ void __launch_bounds__(kThreads)
qmm4_gemv(const __nv_bfloat16* __restrict__ x,      // [M, K]
          const __nv_bfloat16* __restrict__ res,    // [M, K] or null
          const __nv_bfloat16* __restrict__ gamma,  // [K] or null
          const uint8_t* __restrict__ w,            // [N, K/2] (this layer)
          const float* __restrict__ scale,          // [N, G]
          __nv_bfloat16* __restrict__ out,          // [M, N]
          __nv_bfloat16* __restrict__ xout,         // [M, K] or null
          int M, int K, int N, int G, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);    // [M][K], swizzled
  __shared__ float red[kWarps];

  for (int m = 0; m < M; ++m) {
    const __nv_bfloat16* xr = x + (size_t)m * K;
    const __nv_bfloat16* rr = res ? res + (size_t)m * K : nullptr;
    float rstd = 1.f;
    if (gamma || res || xout) {
      const float ss = row_prologue(xr, rr, xout ? xout + (size_t)m * K
                                                  : nullptr,
                                    blockIdx.x == 0, K, red);
      if (gamma) rstd = rsqrtf(ss / (float)K + eps);
    }
    for (int k = threadIdx.x; k < K; k += kThreads) {
      float v = bf(xr[k]);
      if (rr) v += bf(rr[k]);
      if (gamma) v = v * rstd * bf(gamma[k]);
      xs[(size_t)m * K + int4g::swz(k)] = v;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kColsPerBlock + warp * int4g::kCols;
  float acc[int4g::kCols][MT];
#pragma unroll
  for (int c = 0; c < int4g::kCols; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;
  int4g::gemv_cols<MT>(xs, K, M, w, scale, K, G, n0, lane, acc);
#pragma unroll
  for (int c = 0; c < int4g::kCols; ++c) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const float tot = int4g::warp_sum(acc[c][m]);
        if (lane == 0) out[(size_t)m * N + n0 + c] = __float2bfloat16(tot);
      }
    }
  }
}

template <int MT>
int launch_gemv4(const void* x, const void* res, const void* gamma,
                 const void* w, const void* scale, void* out, void* xout,
                 int M, int K, int N, int G, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)M * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        qmm4_gemv<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  qmm4_gemv<MT><<<N / kColsPerBlock, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)res,
      (const __nv_bfloat16*)gamma, (const uint8_t*)w, (const float*)scale,
      (__nv_bfloat16*)out, (__nv_bfloat16*)xout, M, K, N, G, eps);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- int4 MMA
// 8 < M <= 128: as qmm_mma, with the codes widened to bf16 tiles (exact)
// and the group scales applied output-side. A wmma accumulator fragment
// has no documented element -> column map, so each group's product goes
// through shared memory: the block computes the group's 128 x 64 tile in
// fresh fragments, stores it over the (then idle) staging tiles, and each
// thread folds its 32 elements times their column's scale (the group's
// 64 column scales staged in shared memory once) into its own float32
// accumulators. A group of 64k codes is staged BK = 64 deep at a time; a
// group of 8, 16 or 32 codes is staged whole (8 codes a 4-byte word below
// 32), and a group of 8 is padded with 8 zero columns to the product's
// depth of 16. The rows enter as bf16 (the prologue pre-pass rounds the
// normed rows), where the TPU kernel dots float32 rows: the difference is
// one bf16 rounding of each input, stated with the tolerance in
// chip_smoke.py.
constexpr int kAccPerThread = BM * BN / kThreads;   // 32

__global__ void __launch_bounds__(kThreads)
qmm4_mma(const __nv_bfloat16* __restrict__ a,   // [M, K] bf16 rows
         const uint8_t* __restrict__ w, const float* __restrict__ scale,
         __nv_bfloat16* __restrict__ out, int M, int K, int N, int G) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem_raw[kMmaSmem];
  __shared__ float s_group[BN];             // this group's column scales
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem_raw);

  const int warp = threadIdx.x / 32;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps, 32 x 32 each
  const int n0 = blockIdx.x * BN;
  const int gsize = K / G;
  const int bk = gsize < BK ? gsize : BK;   // codes staged per step
  const int depth = bk < 16 ? 16 : bk;      // staged columns (zero-padded)
  const size_t row_bytes = (size_t)K / 2;
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
    for (int k0 = g * gsize; k0 < (g + 1) * gsize; k0 += bk) {
      for (int i = threadIdx.x; i < BM * (depth / 8); i += kThreads) {
        const int r = i / (depth / 8), c8 = (i % (depth / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < M && c8 < bk)
          v = *reinterpret_cast<const uint4*>(a + (size_t)r * K + k0 + c8);
        *reinterpret_cast<uint4*>(As + r * LDA + c8) = v;
      }
      if (bk >= 32) {
        // weight tile [BN, bk]: 32 codes per 16-byte load, widened to bf16
        for (int i = threadIdx.x; i < BN * (bk / 32); i += kThreads) {
          const int n = i / (bk / 32), c32 = (i % (bk / 32)) * 32;
          const uint4 wv = __ldg(reinterpret_cast<const uint4*>(
              w + (size_t)(n0 + n) * row_bytes + (k0 + c32) / 2));
          const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
          uint4* dst = reinterpret_cast<uint4*>(Bs + n * LDB + c32);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float cf[8];
            int4g::unpack8(words[q], cf);
            uint32_t packed[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)     // codes are exact in bf16
              packed[j] = (__float_as_uint(cf[2 * j]) >> 16) |
                          (__float_as_uint(cf[2 * j + 1]) & 0xffff0000u);
            dst[q] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
          }
        }
      } else {
        // weight tile [BN, depth]: 8 codes per 4-byte word, zero past bk
        for (int i = threadIdx.x; i < BN * (depth / 8); i += kThreads) {
          const int n = i / (depth / 8), c8 = (i % (depth / 8)) * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (c8 < bk) {
            float cf[8];
            int4g::unpack8(__ldg(reinterpret_cast<const uint32_t*>(
                               w + (size_t)(n0 + n) * row_bytes +
                               (k0 + c8) / 2)),
                           cf);
            uint32_t packed[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              packed[j] = (__float_as_uint(cf[2 * j]) >> 16) |
                          (__float_as_uint(cf[2 * j + 1]) & 0xffff0000u);
            v = make_uint4(packed[0], packed[1], packed[2], packed[3]);
          }
          *reinterpret_cast<uint4*>(Bs + n * LDB + c8) = v;
        }
      }
      __syncthreads();
      for (int kk = 0; kk < depth; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bfr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * LDA + kk,
                                 LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bfr[j], Bs + (wn * 32 + j * 16) * LDB + kk,
                                 LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(c[i][j], af[i], bfr[j], c[i][j]);
      }
      __syncthreads();
    }
    // the group's tile through shared memory, scaled per column
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, c[i][j], LDC,
            wmma::mem_row_major);
    if (threadIdx.x < BN)
      s_group[threadIdx.x] = __ldg(scale + (size_t)(n0 + threadIdx.x) * G + g);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kAccPerThread; ++t) {
      const int e = threadIdx.x + t * kThreads;
      const int r = e / BN, cc = e % BN;
      if (r < M) acc[t] = fmaf(Cs[r * LDC + cc], s_group[cc], acc[t]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < kAccPerThread; ++t) {
    const int e = threadIdx.x + t * kThreads;
    const int r = e / BN, cc = e % BN;
    if (r < M) out[(size_t)r * N + n0 + cc] = __float2bfloat16(acc[t]);
  }
}

}  // namespace

// Largest M * K * 2 bytes of activations the GEMV keeps in shared memory.
#define QMM_GEMV_MAX_SMEM (200 * 1024)

// x/res/out/xout bf16 row-major; gamma bf16 [K] or null (no norm); res and
// xout may be null; w int8 [N, K] and scale f32 [N] of ONE layer (the
// caller offsets the stacked pointers); xn a bf16 [M, K] scratch, needed
// on the MMA path (M > 8, or M * K * 2 > QMM_GEMV_MAX_SMEM) when there is a
// prologue, and ignored (may be null) on the GEMV path. Requires
// K % 64 == 0, N % 64 == 0, 1 <= M <= 128.
extern "C" int qmm_launch(const void* x, const void* res, const void* gamma,
                          const void* w, const void* scale, void* out,
                          void* xout, void* xn, int M, int K, int N,
                          float eps, void* stream) {
  if (M < 1 || M > BM || K % BK != 0 || N % BN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t gemv_smem = (size_t)M * K * sizeof(__nv_bfloat16);
  if (M <= 8 && gemv_smem <= QMM_GEMV_MAX_SMEM) {
    if (M == 1)
      return launch_gemv<1>(x, res, gamma, w, scale, out, xout, M, K, N,
                            eps, st);
    if (M == 2)
      return launch_gemv<2>(x, res, gamma, w, scale, out, xout, M, K, N,
                            eps, st);
    if (M <= 4)
      return launch_gemv<4>(x, res, gamma, w, scale, out, xout, M, K, N,
                            eps, st);
    return launch_gemv<8>(x, res, gamma, w, scale, out, xout, M, K, N, eps,
                          st);
  }
  const void* a = x;
  if (gamma || res || xout) {
    if (!xn) return (int)cudaErrorInvalidValue;
    qmm_rows_prologue<<<M, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)res,
        (const __nv_bfloat16*)gamma, (__nv_bfloat16*)xn,
        (__nv_bfloat16*)xout, K, eps);
    a = xn;
  }
  qmm_mma<<<N / BN, kThreads, 0, st>>>(
      (const __nv_bfloat16*)a, (const int8_t*)w, (const float*)scale,
      (__nv_bfloat16*)out, M, K, N);
  return (int)cudaGetLastError();
}

// The prologue alone, for K8 (quant_matmul_tiled.cu), whose GEMM takes
// ready bf16 rows as the TPU package's tiled path takes them from its jnp
// prologue: xn = bf16(rms_norm(x + res) * gamma), xout = bf16(x + res)
// (xout may be null, res and gamma may be null). One block per row.
extern "C" int qmm_prologue_launch(const void* x, const void* res,
                                   const void* gamma, void* xn, void* xout,
                                   int M, int K, float eps, void* stream) {
  if (M < 1 || !xn) return (int)cudaErrorInvalidValue;
  qmm_rows_prologue<<<M, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)res,
      (const __nv_bfloat16*)gamma, (__nv_bfloat16*)xn, (__nv_bfloat16*)xout,
      K, eps);
  return (int)cudaGetLastError();
}

// The int4 branch: w packed int4 [N, K/2] and scale f32 [N, G] of ONE
// layer (ops/quantization.py); the other arguments as qmm_launch. The
// GEMV path (M <= 8, M * K * 4 <= QMM_GEMV_MAX_SMEM) keeps float32 rows.
// Requires K % 64 == 0, N % 64 == 0, groups of K / G codes a multiple of
// 64 or 8, 16 or 32, and 1 <= M <= 128.
extern "C" int qmm4_launch(const void* x, const void* res, const void* gamma,
                           const void* w, const void* scale, void* out,
                           void* xout, void* xn, int M, int K, int N, int G,
                           float eps, void* stream) {
  if (M < 1 || M > BM || K % BK != 0 || N % BN != 0 || G < 1 || K % G != 0)
    return (int)cudaErrorInvalidValue;
  const int gsize = K / G;
  if (gsize % BK != 0 && gsize != 8 && gsize != 16 && gsize != 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t gemv_smem = (size_t)M * K * sizeof(float);
  if (M <= 8 && gemv_smem <= QMM_GEMV_MAX_SMEM) {
    if (M == 1)
      return launch_gemv4<1>(x, res, gamma, w, scale, out, xout, M, K, N, G,
                             eps, st);
    if (M == 2)
      return launch_gemv4<2>(x, res, gamma, w, scale, out, xout, M, K, N, G,
                             eps, st);
    if (M <= 4)
      return launch_gemv4<4>(x, res, gamma, w, scale, out, xout, M, K, N, G,
                             eps, st);
    return launch_gemv4<8>(x, res, gamma, w, scale, out, xout, M, K, N, G,
                           eps, st);
  }
  const void* a = x;
  if (gamma || res || xout) {
    if (!xn) return (int)cudaErrorInvalidValue;
    qmm_rows_prologue<<<M, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)res,
        (const __nv_bfloat16*)gamma, (__nv_bfloat16*)xn,
        (__nv_bfloat16*)xout, K, eps);
    a = xn;
  }
  qmm4_mma<<<N / BN, kThreads, 0, st>>>(
      (const __nv_bfloat16*)a, (const uint8_t*)w, (const float*)scale,
      (__nv_bfloat16*)out, M, K, N, G);
  return (int)cudaGetLastError();
}
