// K1: int8 weight-only matmul with the fused residual + RMSNorm prologue.
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
//   splitting K, and reduces with shuffles at the end. Each weight byte is
//   read once from HBM.
// - 8 < M <= 128 (prefill): a tiny pre-pass (qmm_rows_prologue, one block
//   per row) writes the normalised bf16 rows and x_out once; then qmm_mma
//   computes a 128 x 64 output tile per block, so a weight tile is read
//   once for all M rows, as the TPU kernel keeps x whole in VMEM
//   (quant_matmul.py:522). bf16 tensor-core products (wmma 16x16x16, f32
//   accumulate) on tiles staged in shared memory with 16-byte loads. (A
//   row-by-row GEMV would read the weights M times.)
// - M > 128 is the TPU's tiled prefill kernel (K8), not ported here.
//
// Bound on the H100 SXM (3.35 TB/s HBM): at M = 1 the call must read the
// layer's int8 weight once. LLaMA-2-7B: wqkv 50.3 MB -> 15.0 us; w_gateup
// 90.2 MB -> 26.9 us; w_down 45.1 MB -> 13.5 us; wo 16.8 MB -> 5.0 us;
// lm_head 131 MB -> 39.1 us. One decode step streams about 6.61 GB of
// weights, a bound of about 2.0 ms per token. The GEMV's answer to that
// bound is full-width coalesced 16-byte loads, several in flight per lane,
// and enough blocks (N / 32) to cover the SMs; it does not yet use TMA or
// split K for the narrow (N = 4096) weights.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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
constexpr int kColsPerWarp = 4;
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

  const int chunks = K / 16;  // 16 codes per lane per step
#pragma unroll 2
  for (int ch = lane; ch < chunks; ch += 32) {
    int4 wv[kColsPerWarp];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
      wv[c] = __ldg(reinterpret_cast<const int4*>(
          w + (size_t)(n0 + c) * K + (size_t)ch * 16));
    // the 16 codes of each column as signed bytes of four 32-bit words
    uint32_t words[kColsPerWarp][4];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      words[c][0] = (uint32_t)wv[c].x;
      words[c][1] = (uint32_t)wv[c].y;
      words[c][2] = (uint32_t)wv[c].z;
      words[c][3] = (uint32_t)wv[c].w;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const uint4* xp =
            reinterpret_cast<const uint4*>(xs + (size_t)m * K + ch * 16);
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
        for (int c = 0; c < kColsPerWarp; ++c) {
          float a = acc[c][m];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int code =
                (int)(words[c][j >> 2] << (24 - 8 * (j & 3))) >> 24;
            a = fmaf(xf[j], (float)code, a);
          }
          acc[c][m] = a;
        }
      }
    }
  }

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
