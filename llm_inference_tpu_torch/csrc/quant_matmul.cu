// K1: int8 / int4 weight-only matmul with the fused residual + RMSNorm
// prologue.
//
// Replaces llm_inference_tpu/ops/pallas/quant_matmul.py:_quant_matmul_blocked
// (_kernel), its int8 branches: per-channel or grouped scales, symmetric
// or with zero points (z_ref). Same function and the same rounding points:
//   x32   = float(x_bf16) (+ float(residual_bf16))        (prologue, f32)
//   x_out = bf16(x32)                                      (optional)
//   xn    = x32 * rsqrt(mean(x32^2) + eps) * float(gamma)  (when gamma)
//   y     = bf16( (bf16(xn) . float(code)) * scale[n]      (per channel)
//                 + sum_k xn[k] * zbias[n] )               (zero points)
//   y     = bf16( sum_g scale[n][g] * (bf16(xn_g) . float(code_g))
//                 + sum_g (sum_k bf16(xn_g)[k]) * zbias[n][g] )  (grouped)
// with f32 accumulation: the per-channel zero point takes the float32 rows
// before their rounding, a group's the bf16 rows its dot takes, as the TPU
// kernel's two sums do (quant_matmul.py:309-323). The weight is [N, K]
// int8 (one K-contiguous row per output column), scales [N] or [N, G] and
// zero points in their shape, stacked over layers; the caller selects a
// layer by pointer offset.
//
// Design. The TPU grid runs in order, so its kernel normalises x once at
// grid step 0 into VMEM scratch. CUDA blocks run in any order, so:
// - M <= 8 (decode): qmm_gemv. Every block recomputes the norm of its M
//   rows (a read of M x K activations from L2, small beside the weights)
//   into shared memory as bf16; block 0 alone writes x_out. Each warp owns
//   4 output columns and streams their codes with 16-byte loads, lanes
//   splitting K (the int8 core, int8_gemv.cuh, also K12's), and reduces
//   with shuffles at the end. Each weight byte is read once from HBM.
// - 8 < M <= 128 (prefill; and M <= 8 where the GEMV's rows overflow its
//   shared memory): qmm_mma_launch in quant_matmul_tiled.cu. A pre-pass
//   (qmm_rows_prologue below, one block per row) writes the normalised
//   bf16 rows and x_out once; then K8's wgmma machinery (the codes widened
//   into register A fragments, the rows as B by TMA, a TMA + mbarrier
//   ring) runs with a row tile fitted to M (16, 32, 64 or 128 rows) over
//   one persistent block an SM that cuts tiles x k steps evenly (stream-K;
//   the tiles two blocks share are summed in a fixed order). A weight tile
//   is read once for all M rows, as the TPU kernel keeps x whole in VMEM
//   (quant_matmul.py:522). int4 groups of 8, 16 or 32 codes take K8's
//   mma.sync kernel. (A row-by-row GEMV would read the weights M times.)
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
// 32, as the TPU kernel takes any group of at least 8): codes [N, K/2] with
// two K-adjacent nibbles per byte, float32 scales [N, G]. Its rounding
// points differ from int8's: each group's scale hits its partial dot, and
// M <= 8 (qmm4_gemv.cu, the weight ring of K6 in a one-phase instance)
// keeps more than bf16 of the rows (the TPU branch dots float32 rows):
// x32 times gamma as a bf16 hi plus a bf16 remainder, about 16 bits of
// mantissa, with rstd taken on the float32 sums and, in groups of 32k
// codes, 136 * sum(x) of each chunk off its dot (the codes enter as
// bf16(136 + code)); qmm4_gemv.cu states them in full. Larger M runs
// qmm_mma_launch on bf16 rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// Sum of v over the block, returned to every thread (red: kWarps floats;
// the block's threads meet before and after).
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from the previous use
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += red[w];
  return tot;
}

// The zero points' sums of bf16 rows xs [M][ldx] in groups of gs codes:
// xsum[m * G + g], a warp a (row, group), the lanes in a fixed order.
__device__ void group_sums(const __nv_bfloat16* xs, int ldx, int M, int G,
                          int gs, float* xsum) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < M * G; i += kWarps) {
    const int m = i / G, g = i - m * G;
    const __nv_bfloat16* r = xs + (size_t)m * ldx + (size_t)g * gs;
    float v = 0.f;
    for (int k = lane; k < gs; k += 32) v += bf(r[k]);
    v = warp_sum(v);
    if (lane == 0) xsum[i] = v;
  }
}

// ---------------------------------------------------------------- GEMV
constexpr int kColsPerWarp = int8g::kCols;
constexpr int kColsPerBlock = kWarps * kColsPerWarp;   // 32

// GRP: scales [N, G] (G > 1) on each group's partial dot, else [N] on the
// column's sum. zbias (null: symmetric) in the scales' shape: the rows'
// sums, per channel the float32 rows' before their rounding, grouped each
// group's bf16 rows' (as the TPU kernel, quant_matmul.py:309-323), in
// shared memory after the rows (xsum [M][G]), times zbias join the
// column's sum.
template <int MT, bool GRP>
__global__ void __launch_bounds__(kThreads)
qmm_gemv(const __nv_bfloat16* __restrict__ x,      // [M, K]
         const __nv_bfloat16* __restrict__ res,    // [M, K] or null
         const __nv_bfloat16* __restrict__ gamma,  // [K] or null
         const int8_t* __restrict__ w,             // [N, K] (this layer)
         const float* __restrict__ scale,          // [N] or [N, G]
         const float* __restrict__ zbias,          // as scale, or null
         __nv_bfloat16* __restrict__ out,          // [M, N]
         __nv_bfloat16* __restrict__ xout,         // [M, K] or null
         int M, int K, int N, int G, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [M][K]
  float* xsum = reinterpret_cast<float*>(xs + (size_t)M * K);      // [M][G]
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
    float part = 0.f;
    for (int k = threadIdx.x; k < K; k += kThreads) {
      float v = bf(xr[k]);
      if (rr) v += bf(rr[k]);
      if (gamma) v = v * rstd * bf(gamma[k]);
      part += v;
      xs[(size_t)m * K + k] = __float2bfloat16(v);
    }
    if (!GRP && zbias != nullptr) {
      const float tot = block_sum(part, red);
      if (threadIdx.x == 0) xsum[m] = tot;
    }
  }
  __syncthreads();
  if (GRP && zbias != nullptr) {
    group_sums(xs, K, M, G, K / G, xsum);
    __syncthreads();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kColsPerBlock + warp * kColsPerWarp;
  float acc[kColsPerWarp][MT];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;
  int8g::gemv_cols<MT, GRP>(xs, K, M, w, K, n0, lane, acc, scale, G, K / G);
  if (GRP && zbias != nullptr) {
    // sum_g xsum[m][g] * zbias[n][g], the lanes' groups in the warp's sum
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
      for (int g = lane; g < G; g += 32) {
        const float z = __ldg(zbias + (size_t)(n0 + c) * G + g);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (m < M) acc[c][m] = fmaf(xsum[m * G + g], z, acc[c][m]);
      }
  }

#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const float s = GRP ? 1.f : scale[n0 + c];
    const float z = !GRP && zbias != nullptr ? zbias[n0 + c] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const float tot = warp_sum(acc[c][m]);
        if (lane == 0)
          out[(size_t)m * N + n0 + c] = __float2bfloat16(
              GRP ? tot : (zbias != nullptr ? tot * s + xsum[m] * z
                                            : tot * s));
      }
    }
  }
}

// ------------------------------------------------------------ prologue
// Prefill prologue, one block per row: xn = bf16(rms_norm(x + res) * gamma)
// and x_out = bf16(x + res), so the MMA kernel streams ready bf16 rows;
// with xsum the zero points' sums of the row, xsum[row][g] over groups of
// K / G: of the bf16 rows (mode 0) or of the float32 rows before their
// rounding (mode 1). xn null: the sums alone (rows without a prologue).
__global__ void __launch_bounds__(kThreads)
qmm_rows_prologue(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ res,
                  const __nv_bfloat16* __restrict__ gamma,
                  __nv_bfloat16* __restrict__ xn,
                  __nv_bfloat16* __restrict__ xout,
                  float* __restrict__ xsum, int K, int G, int mode,
                  float eps) {
  // the GEMM behind it (a dependent launch) may start now: it streams its
  // codes and waits for this grid's end before it reads xn
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float red[kWarps];
  const size_t row = (size_t)blockIdx.x * K;
  const __nv_bfloat16* rr = res ? res + row : nullptr;
  float rstd = 1.f;
  if (gamma || res || xout) {
    const float ss = row_prologue(x + row, rr, xout ? xout + row : nullptr,
                                  true, K, red);
    if (gamma) rstd = rsqrtf(ss / (float)K + eps);
  }
  auto value = [&](int k) {
    float v = bf(x[row + k]);
    if (rr) v += bf(rr[k]);
    if (gamma) v = v * rstd * bf(gamma[k]);
    return v;
  };
  if (xn != nullptr)
    for (int k = threadIdx.x; k < K; k += kThreads)
      xn[row + k] = __float2bfloat16(value(k));
  if (xsum == nullptr) return;
  // a warp a group, the lanes and then the warps' groups in a fixed order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gs = K / G;
  for (int g = warp; g < G; g += kWarps) {
    float v = 0.f;
    for (int k = g * gs + lane; k < (g + 1) * gs; k += 32) {
      const float u = value(k);
      v += mode ? u : bf(__float2bfloat16(u));
    }
    v = warp_sum(v);
    if (lane == 0) xsum[(size_t)blockIdx.x * G + g] = v;
  }
}

template <int MT, bool GRP>
int launch_gemv(const void* x, const void* res, const void* gamma,
                const void* w, const void* scale, const void* zbias,
                void* out, void* xout, int M, int K, int N, int G, float eps,
                cudaStream_t stream) {
  const size_t smem = (size_t)M * K * sizeof(__nv_bfloat16) +
                      (zbias ? (size_t)M * G * sizeof(float) : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        qmm_gemv<MT, GRP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  qmm_gemv<MT, GRP><<<N / kColsPerBlock, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)res,
      (const __nv_bfloat16*)gamma, (const int8_t*)w, (const float*)scale,
      (const float*)zbias, (__nv_bfloat16*)out, (__nv_bfloat16*)xout, M, K,
      N, G, eps);
  return (int)cudaGetLastError();
}

template <bool GRP>
int launch_gemv_rows(const void* x, const void* res, const void* gamma,
                     const void* w, const void* scale, const void* zbias,
                     void* out, void* xout, int M, int K, int N, int G,
                     float eps, cudaStream_t st) {
  if (M == 1)
    return launch_gemv<1, GRP>(x, res, gamma, w, scale, zbias, out, xout, M,
                               K, N, G, eps, st);
  if (M == 2)
    return launch_gemv<2, GRP>(x, res, gamma, w, scale, zbias, out, xout, M,
                               K, N, G, eps, st);
  if (M <= 4)
    return launch_gemv<4, GRP>(x, res, gamma, w, scale, zbias, out, xout, M,
                               K, N, G, eps, st);
  return launch_gemv<8, GRP>(x, res, gamma, w, scale, zbias, out, xout, M,
                             K, N, G, eps, st);
}

}  // namespace

// Largest M * K * 2 bytes of activations the GEMV keeps in shared memory.
#define QMM_GEMV_MAX_SMEM (200 * 1024)

// x/res/out/xout bf16 row-major; gamma bf16 [K] or null (no norm); res and
// xout may be null; w int8 [N, K], scale f32 [N] (G = 1, per channel) or
// [N, G] (groups of K / G codes, a multiple of 64) and zbias (null:
// symmetric) in the scale's shape, of ONE layer (the caller offsets the
// stacked pointers). The GEMV: requires 1 <= M <= 8, M * K * 2 <=
// QMM_GEMV_MAX_SMEM, K % 64 == 0 and N % 64 == 0; more rows take
// qmm_mma_launch (quant_matmul_tiled.cu).
extern "C" int qmm_launch(const void* x, const void* res, const void* gamma,
                          const void* w, const void* scale,
                          const void* zbias, void* out, void* xout, int M,
                          int K, int N, int G, float eps, void* stream) {
  const size_t gemv_smem = (size_t)M * K * sizeof(__nv_bfloat16);
  if (M < 1 || M > 8 || gemv_smem > QMM_GEMV_MAX_SMEM || K % 64 != 0 ||
      N % 64 != 0 || G < 1 || K % G != 0 || (G > 1 && (K / G) % 64 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (G > 1)
    return launch_gemv_rows<true>(x, res, gamma, w, scale, zbias, out, xout,
                                  M, K, N, G, eps, st);
  return launch_gemv_rows<false>(x, res, gamma, w, scale, zbias, out, xout,
                                 M, K, N, G, eps, st);
}

// The prologue alone, for K8 and K1's MMA branch (quant_matmul_tiled.cu),
// whose GEMMs take ready bf16 rows as the TPU package's tiled path takes
// them from its jnp prologue: xn = bf16(rms_norm(x + res) * gamma), xout =
// bf16(x + res) (xout may be null, res and gamma may be null); and with
// xsum (float32 [M, G], or null) an asymmetric weight's sums of the rows
// in groups of K / G codes: of the bf16 rows (mode 0) or of the float32
// rows before their rounding (mode 1). xn may be null when xsum is not
// (the rows need no prologue, their sums do). One block per row.
extern "C" int qmm_prologue_launch(const void* x, const void* res,
                                   const void* gamma, void* xn, void* xout,
                                   void* xsum, int M, int K, int G, int mode,
                                   float eps, void* stream) {
  if (M < 1 || (!xn && !xsum) || G < 1 || K % G != 0)
    return (int)cudaErrorInvalidValue;
  qmm_rows_prologue<<<M, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)res,
      (const __nv_bfloat16*)gamma, (__nv_bfloat16*)xn, (__nv_bfloat16*)xout,
      (float*)xsum, K, G, mode, eps);
  return (int)cudaGetLastError();
}
