// K6: the decode layer tail in one launch, grouped int4 weights:
//   wo_out = attn . wo                                  (float32)
//   h2     = bf16(h + wo_out)
//   xn     = (h + wo_out) * rsqrt(mean((h + wo_out)^2) + eps) * gamma
//   act    = silu(xn . w_gate) * (xn . w_up)           (float32)
//   y      = bf16(act . w_down)
// nothing rounded between the phases.
// K7: the FFN block of a tensor-parallel layer, the same tail without its
// wo phase (the wo partials are summed across ranks before the residual):
//   x32 = float(bf16(x)) + float(residual),  h2 = bf16(x32)
//   xn, act, y as above from x32.
//
// K6 replaces llm_inference_tpu/ops/pallas/quant_matmul.py:
// layer_tail_fused (_layer_tail_kernel), K7 quant_matmul.py:ffn_fused
// (_ffn_kernel). Each TPU kernel is one grid walked in order over its
// weights' column blocks, its float32 intermediates in VMEM scratch. CUDA
// blocks run in no order, so both are one cooperative kernel template: the
// grid is sized so every block is resident at once (occupancy x SMs) and
// grid.sync() separates the phases
//   [wo (K6 only)] | norm + gate-up + SwiGLU | down.
// Every warp of the grid walks the output columns of a phase, kCols at a
// time, with the int4 GEMV core of K1 (int4_gemv.cuh), whose rows sit in
// shared memory. The float32 intermediates wo_out [M, H] and act [M, I]
// live in a scratch in global memory (L2-resident: 64 KB and 172 KB at
// M = 4), read back through L2 (__ldcg) into every block's shared memory:
// the normed rows (recomputed by every block, a read of M x H, small
// beside the weights; block 0 alone writes h2) and the act rows of the
// down phase. Each warp computes a gate column and its up column
// together, so SwiGLU runs in the gate-up epilogue and gate||up never
// leaves registers. Rows are processed MT at a time (M <= 32), in the down
// phase kDownRows at a time (an act row is I floats of shared memory).
//
// Bound on the H100 SXM (3.35 TB/s): the call must read the layer's int4
// weights and their scales once. LLaMA-2-7B, g = 128, M = 1, K6: wo 8.4 +
// 0.5 MB, gate-up 45.1 + 2.8 MB, down 22.5 + 1.4 MB = 80.8 MB -> 24.1 us.
// K7 at tp = 2 (one rank's shard: gate-up [11008, 4096], down [4096,
// 5504]): gate-up 22.5 + 1.4 MB, down 11.3 + 0.7 MB = 35.9 MB -> 10.7 us.
// Each also removes kernel boundaries per layer (three for K6, two for
// K7), each about 24 us of host launch time in the eager decode step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int4_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using int4g::kCols;
using int4g::swz;

template <int MT>
constexpr int kDownRows = MT < 2 ? MT : 2;   // act rows per down pass

struct Tail {
  const __nv_bfloat16* h;      // [M, H] (K6: the residual stream; K7: x)
  const __nv_bfloat16* attn;   // [M, Ko] (K6)
  const __nv_bfloat16* res;    // [M, H] (K7: added to x)
  const __nv_bfloat16* gamma;  // [H]
  const uint8_t* wo;           // [H, Ko/2], scales so [H, Go] (K6)
  const float* so;
  const uint8_t* wgu;          // [2I, H/2], scales sgu [2I, Gg]
  const float* sgu;
  const uint8_t* wd;           // [H, I/2], scales sd [H, Gd]
  const float* sd;
  float* wo_out;               // scratch [M, H] (K6)
  float* act;                  // scratch [M, I]
  __nv_bfloat16* h2;           // [M, H]
  __nv_bfloat16* y;            // [M, H]
  int M, H, Ko, I, Go, Gg, Gd;
  float eps;
};

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[kCols][MT]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;
}

// WO: K6 (the wo phase, the residual from wo_out); else K7 (no wo phase,
// the residual from res).
template <int MT, bool WO>
__global__ void __launch_bounds__(kThreads, 2) layer_tail_kernel(Tail t) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [MT][max(Ko, H)] or [kDownRows][I] floats, rows swizzled (swz)
  float* xs = reinterpret_cast<float*>(smem_raw);
  __shared__ float red[kWarps][MT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int stride = gridDim.x * kWarps * kCols;
  const int H = t.H, I = t.I, Ko = t.Ko;

  // ---- phase 1 (K6): wo_out = attn . wo
  if constexpr (WO) {
    for (int r0 = 0; r0 < t.M; r0 += MT) {
      const int P = min(MT, t.M - r0);
      for (int i = threadIdx.x; i < P * Ko; i += kThreads)
        xs[(i / Ko) * Ko + swz(i % Ko)] =
            __bfloat162float(t.attn[(size_t)r0 * Ko + i]);
      __syncthreads();
      for (int n0 = gwarp * kCols; n0 < H; n0 += stride) {
        float acc[kCols][MT];
        zero(acc);
        int4g::gemv_cols<MT>(xs, Ko, P, t.wo, t.so, Ko, t.Go, n0, lane, acc);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (m < P) {
              const float tot = int4g::warp_sum(acc[c][m]);
              if (lane == 0) t.wo_out[(size_t)(r0 + m) * H + n0 + c] = tot;
            }
      }
      __syncthreads();
    }
    grid.sync();
  }

  // ---- phase 2: norm, gate-up, SwiGLU
  for (int r0 = 0; r0 < t.M; r0 += MT) {
    const int P = min(MT, t.M - r0);
    float ss[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      ss[m] = 0.f;
      if (m < P) {
        const size_t row = (size_t)(r0 + m) * H;
        for (int k = threadIdx.x; k < H; k += kThreads) {
          const float v = __bfloat162float(t.h[row + k]) +
                          (WO ? __ldcg(t.wo_out + row + k)
                              : __bfloat162float(t.res[row + k]));
          xs[m * H + swz(k)] = v;
          if (blockIdx.x == 0) t.h2[row + k] = __float2bfloat16(v);
          ss[m] = fmaf(v, v, ss[m]);
        }
        ss[m] = int4g::warp_sum(ss[m]);
        if (lane == 0) red[warp][m] = ss[m];
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < P) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) tot += red[w][m];
        const float rstd = rsqrtf(tot / (float)H + t.eps);
        for (int k = threadIdx.x; k < H; k += kThreads)
          xs[m * H + swz(k)] =
              xs[m * H + swz(k)] * rstd * __bfloat162float(t.gamma[k]);
      }
    }
    __syncthreads();
    for (int n0 = gwarp * kCols; n0 < I; n0 += stride) {
      float ga[kCols][MT], ua[kCols][MT];
      zero(ga);
      zero(ua);
      int4g::gemv_cols<MT>(xs, H, P, t.wgu, t.sgu, H, t.Gg, n0, lane, ga);
      int4g::gemv_cols<MT>(xs, H, P, t.wgu, t.sgu, H, t.Gg, I + n0, lane,
                           ua);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (m < P) {
            const float g = int4g::warp_sum(ga[c][m]);
            const float u = int4g::warp_sum(ua[c][m]);
            if (lane == 0)
              t.act[(size_t)(r0 + m) * I + n0 + c] =
                  g * (1.f / (1.f + expf(-g))) * u;
          }
    }
    __syncthreads();   // xs and red are rewritten by the next pass
  }
  grid.sync();

  // ---- phase 3: y = act . w_down
  for (int r0 = 0; r0 < t.M; r0 += kDownRows<MT>) {
    const int P = min(kDownRows<MT>, t.M - r0);
    for (int i = threadIdx.x; i < P * I; i += kThreads)
      xs[(i / I) * I + swz(i % I)] = __ldcg(t.act + (size_t)r0 * I + i);
    __syncthreads();
    for (int n0 = gwarp * kCols; n0 < H; n0 += stride) {
      float acc[kCols][MT];
      zero(acc);
      int4g::gemv_cols<MT>(xs, I, P, t.wd, t.sd, I, t.Gd, n0, lane, acc);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (m < P) {
            const float tot = int4g::warp_sum(acc[c][m]);
            if (lane == 0)
              t.y[(size_t)(r0 + m) * H + n0 + c] = __float2bfloat16(tot);
          }
    }
    __syncthreads();   // xs is rewritten by the next pass
  }
}

// Resident blocks of the whole grid for this kernel and shared memory
// (the cooperative launch needs every block resident), once per size.
template <int MT, bool WO>
int launch(const Tail& t, cudaStream_t stream) {
  static int cached_grid = 0;
  static size_t cached_smem = 0;
  const size_t rows = (size_t)MT * (WO && t.Ko > t.H ? t.Ko : t.H);
  const size_t act_rows = (size_t)kDownRows<MT> * t.I;
  const size_t smem = (rows > act_rows ? rows : act_rows) * sizeof(float);
  auto kernel = layer_tail_kernel<MT, WO>;
  if (smem != cached_smem) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_grid = per_sm * sms;
    cached_smem = smem;
  }
  Tail arg = t;
  void* args[] = {&arg};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(cached_grid), dim3(kThreads), args, smem,
      stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool WO>
int launch_rows(const Tail& t, cudaStream_t stream) {
  if (t.M == 1) return launch<1, WO>(t, stream);
  if (t.M == 2) return launch<2, WO>(t, stream);
  return launch<4, WO>(t, stream);
}

}  // namespace

// h/attn/gamma/h2/y bf16; w* packed int4 codes [N, K/2] and s* float32
// scales [N, G] of ONE layer (ops/quantization.py); wo_out [M, H] and act
// [M, I] float32 scratch. Requires 1 <= M <= 32, H, Ko and I multiples of
// 32 and every group size a multiple of 32, or 8 or 16 (int4_gemv.cuh).
extern "C" int layer_tail_launch(const void* h, const void* attn,
                                 const void* gamma, const void* wo,
                                 const void* so, const void* wgu,
                                 const void* sgu, const void* wd,
                                 const void* sd, void* wo_out, void* act,
                                 void* h2, void* y, int M, int H, int Ko,
                                 int I, int Go, int Gg, int Gd, float eps,
                                 void* stream) {
  if (M < 1 || M > 32 || H % 32 || Ko % 32 || I % 32 ||
      !int4g::groups_ok(Ko, Go) || !int4g::groups_ok(H, Gg) ||
      !int4g::groups_ok(I, Gd))
    return (int)cudaErrorInvalidValue;
  Tail t{(const __nv_bfloat16*)h, (const __nv_bfloat16*)attn, nullptr,
         (const __nv_bfloat16*)gamma, (const uint8_t*)wo, (const float*)so,
         (const uint8_t*)wgu, (const float*)sgu, (const uint8_t*)wd,
         (const float*)sd, (float*)wo_out, (float*)act,
         (__nv_bfloat16*)h2, (__nv_bfloat16*)y, M, H, Ko, I, Go, Gg, Gd,
         eps};
  return launch_rows<true>(t, (cudaStream_t)stream);
}

// K7: x/res/gamma/h2/y bf16 [M, H] ([H] for gamma); wgu/sgu, wd/sd one
// layer's codes and scales as above; act [M, I] float32 scratch. Requires
// 1 <= M <= 32, H and I multiples of 32 and both group sizes a multiple of
// 32, or 8 or 16.
extern "C" int ffn_fused_launch(const void* x, const void* res,
                                const void* gamma, const void* wgu,
                                const void* sgu, const void* wd,
                                const void* sd, void* act, void* h2, void* y,
                                int M, int H, int I, int Gg, int Gd,
                                float eps, void* stream) {
  if (M < 1 || M > 32 || H % 32 || I % 32 || !int4g::groups_ok(H, Gg) ||
      !int4g::groups_ok(I, Gd))
    return (int)cudaErrorInvalidValue;
  Tail t{(const __nv_bfloat16*)x, nullptr, (const __nv_bfloat16*)res,
         (const __nv_bfloat16*)gamma, nullptr, nullptr,
         (const uint8_t*)wgu, (const float*)sgu, (const uint8_t*)wd,
         (const float*)sd, nullptr, (float*)act, (__nv_bfloat16*)h2,
         (__nv_bfloat16*)y, M, H, H, I, 1, Gg, Gd, eps};
  return launch_rows<false>(t, (cudaStream_t)stream);
}
