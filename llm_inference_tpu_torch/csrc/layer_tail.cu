// K6: the decode layer tail in one launch, grouped int4 weights:
//   wo_out = attn . wo                                  (float32)
//   h2     = bf16(h + wo_out)
//   xn     = (h + wo_out) * rsqrt(mean((h + wo_out)^2) + eps) * gamma
//   act    = silu(xn . w_gate) * (xn . w_up)           (float32)
//   y      = bf16(act . w_down)
// nothing rounded between the phases. K7: the FFN block of a
// tensor-parallel layer, the same tail without its wo phase (the wo
// partials are summed across ranks before the residual):
//   x32 = float(bf16(x)) + float(residual),  h2 = bf16(x32)
//   xn, act, y as above from x32.
//
// K6 replaces llm_inference_tpu/ops/pallas/quant_matmul.py:
// layer_tail_fused (_layer_tail_kernel), K7 quant_matmul.py:ffn_fused
// (_ffn_kernel). Each TPU kernel is one grid walked in order over its
// weights' column blocks, so Mosaic's pipeline fetches the next phase's
// weights while the last blocks of a phase compute.
//
// Bound on the H100 SXM (3.35 TB/s): the call must read the layer's int4
// weights and their scales once. LLaMA-2-7B, g = 128, K6: wo 8.4 + 0.5 MB,
// gate-up 45.1 + 2.8 MB, down 22.5 + 1.4 MB = 80.8 MB -> 24.1 us at any
// M <= 8. K7 at tp = 2 (one rank's shard: gate-up [11008, 4096], down
// [4096, 5504]): 35.9 MB -> 10.7 us.
//
// The design: one persistent block an SM (a cooperative launch, so that
// every block is resident) on the weight ring of weight_ring.cuh: a weight
// producer warp streams the phases' codes by TMA, an activation producer
// warp their rows, eight consumer warps multiply them on the tensor cores
// (int4 codes, bf16 hi + lo activations). The phases [wo (K6) or the
// norm's prologue (K7)] | gate-up + SwiGLU | down are separated by a grid
// barrier of the consumers alone (a counter in the scratch whose top bit
// flips when every block has arrived), which the producers never wait for:
// the weight producer runs on into the next phase's stages until the ring
// is full.
//
// No whole-row work at a phase head: the wo epilogue writes x32 = h +
// wo_out, h2 and a per-block partial sum of squares; after the barrier
// every block sums the nblk partials in block order (rstd), and the
// activations arrive by K-tile beside the weights. Every sum is taken in a
// fixed order, so two calls on the same inputs give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "weight_ring.cuh"

namespace {

using namespace ring;

struct Args {
  Ring r;
  const __nv_bfloat16* h;       // [M, H]: K6 the residual stream, K7 x
  const __nv_bfloat16* res;     // [M, H] (K7)
  float* x32;                   // [M, H] scratch
  float* act;                   // [M, I] scratch
  float* ss;                    // [nblk, 32] partial sums of squares
  unsigned* gbar;               // grid barrier counter
  __nv_bfloat16* h2;            // [M, H]
  __nv_bfloat16* y;             // [M, H]
  int M, H, I;
  float eps;
};

// The phases' epilogues (phase 0 wo, 1 gate-up + SwiGLU, 2 down): a
// batch's sums (the consumer warps' partials added in warp order), thread
// (col group, row) = (tid / 8, tid % 8).
struct Epi {
  const Args& a;
  const Smem& S;

  template <int PI>
  __device__ void pre(int, int m0, int ua, int nu) const {
    if (PI != 0) return;
    // the epilogue's h, into L2 meanwhile
    const int m = m0 + (threadIdx.x & 7);
    if (m < a.M)
      for (int i = threadIdx.x >> 3; i < nu; i += kColGroups)
        sm90::prefetch_l2(a.h + (size_t)m * a.H + ua + i);
  }

  template <int PI>
  __device__ void out(int, int m0, int ua, int nu, int cols) const {
    const Phase& p = a.r.pl.ph[PI];
    const int row = threadIdx.x & 7, cgp = threadIdx.x >> 3;
    const int m = m0 + row, rc = a.r.pl.red_cols;
    const bool live = m < a.M;
    float sq = 0.f;
    const int nout = PI == 1 ? nu : cols;
    for (int i = cgp; i < nout; i += kColGroups) {
      const float v = col_sum(S, rc, i, row);
      if (!live) continue;
      if constexpr (PI == 0) {
        const size_t at = (size_t)m * a.H + ua + i;
        const float x = __bfloat162float(a.h[at]) + v;
        a.x32[at] = x;
        a.h2[at] = __float2bfloat16(x);
        sq = fmaf(x, x, sq);
      } else if constexpr (PI == 1) {
        const float u = col_sum(S, rc, p.ncp / 2 + i, row);
        a.act[(size_t)m * a.I + ua + i] = v * (1.f / (1.f + expf(-v))) * u;
      } else {
        a.y[(size_t)m * a.H + ua + i] = __float2bfloat16(v);
      }
    }
    if constexpr (PI == 0) sum_squares(S, sq, m0);
  }
};

// K7's first phase: x32 = x + res, h2 and the sums of squares of the
// block's columns
__device__ __forceinline__ void k7_prologue(const Args& a, const Smem& S) {
  int u0, u1;
  units_of(a.r.pl.ph[0], u0, u1);
  const int row = threadIdx.x & 7, cgp = threadIdx.x >> 3;
  for (int m0 = 0; m0 < a.M; m0 += kRows) {
    const int m = m0 + row;
    float sq = 0.f;
    if (m < a.M)
      for (int n = u0 + cgp; n < u1; n += kColGroups) {
        const size_t at = (size_t)m * a.H + n;
        const float x = __bfloat162float(a.h[at]) + __bfloat162float(a.res[at]);
        a.x32[at] = x;
        a.h2[at] = __float2bfloat16(x);
        sq = fmaf(x, x, sq);
      }
    sum_squares(S, sq, m0);
    named_sync();
  }
}

template <bool WO>
__device__ __forceinline__ void consume(const Args& a, const Smem& S) {
  Cursor cur;
  const Epi epi{a, S};
  if constexpr (WO)
    run_phase<0, kFormBf16, 4>(a.r, 0, S, cur, epi);
  else
    k7_prologue(a, S);
  if (threadIdx.x < a.M) a.ss[blockIdx.x * kMaxM + threadIdx.x] =
      S.ssacc[threadIdx.x];
  grid_barrier(a.gbar, S, 1);
  rstd_of_rows(a.ss, a.M, a.H, a.eps, S);
  run_phase<1, kFormNorm, 4>(a.r, 1, S, cur, epi);
  grid_barrier(a.gbar, S, 2);
  run_phase<2, kFormF32, 4>(a.r, 2, S, cur, epi);
}

// WO: K6 (the wo phase); else K7 (the residual from res).
template <bool WO>
__global__ void __launch_bounds__(kThreads, 1)
    layer_tail_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Smem S = smem_of(sm, a.r.pl);
  init_block(S, a.r.pl);
  __syncthreads();
  if (!produce<WO ? 0 : 1, 3, 4>(a.r, S)) consume<WO>(a, S);
}

// Phases: wo (K6 only; its rows bf16 attn), gate-up (the norm's: x32 and
// gamma, after the first barrier), down (act, after the second).
void set_tail(Plan& pl, const void* wo, const void* so, const void* attn,
              const void* wgu, const void* sgu, const void* wd,
              const void* sd, const void* gamma, int H, int Ko, int I,
              int Go, int Gg, int Gd) {
  pl.ph0 = wo ? 0 : 1;
  pl.nph = 3;
  pl.ph[0].units = H;
  if (wo) set_phase(pl.ph[0], wo, so, H, 0, 0, Ko, Go, 4, 2, attn, nullptr, 0);
  set_phase(pl.ph[1], wgu, sgu, I, 1, I, H, Gg, 4, 4, nullptr, gamma, 1);
  set_phase(pl.ph[2], wd, sd, H, 0, 0, I, Gd, 4, 4, nullptr, nullptr, 2);
}

// The card's SM count, once per device; then the plan for that many
// blocks, the tensor maps and the launch.
template <bool WO>
int launch(Args& a, float* scratch, cudaStream_t stream) {
  static int sms[kMaxDevices];
  int nblk = 0;
  int code = card_blocks(layer_tail_kernel<WO>, sms, nblk);
  if (code) return code;
  a.r.M = a.M;
  code = make_plan(a.r.pl, a.M, nblk, 0, 0);
  if (code) return code;
  if (!encode_plan(a.r.pl)) return (int)cudaErrorInvalidValue;
  set_masks(a.r);
  a.gbar = reinterpret_cast<unsigned*>(scratch);
  a.ss = scratch + kHeader;
  a.act = a.ss + nblk * kMaxM;
  if (!WO) a.x32 = a.act + (size_t)a.M * a.I;
  a.r.pl.ph[1].src = a.x32;
  a.r.pl.ph[2].src = a.act;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)layer_tail_kernel<WO>, dim3(nblk), dim3(kThreads), args,
      a.r.pl.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// h/attn/gamma/h2/y bf16; w* packed int4 codes [N, K/2] and s* float32
// scales [N, G] of ONE layer (ops/quantization.py), the codes 16-byte
// aligned, as attn and gamma. wo_out: float32 [M, H] scratch (x32 = h +
// wo_out); act: the float32 scratch [64 | nblk x 32 | M x I] (its first
// word the grid barrier's counter, zero before the first launch, left so
// by each), nblk being the card's SM count. Requires 1 <= M <= 32, H, Ko
// and I multiples of 32 and every group size a multiple of 32, or 8 or 16
// (16: K a multiple of 64).
extern "C" int layer_tail_launch(const void* h, const void* attn,
                                 const void* gamma, const void* wo,
                                 const void* so, const void* wgu,
                                 const void* sgu, const void* wd,
                                 const void* sd, void* wo_out, void* act,
                                 void* h2, void* y, int M, int H, int Ko,
                                 int I, int Go, int Gg, int Gd, float eps,
                                 void* stream) {
  if (M < 1 || M > kMaxM || H % 32 || Ko % 32 || I % 32 ||
      !groups_ok(Ko, Go) || !groups_ok(H, Gg) || !groups_ok(I, Gd))
    return (int)cudaErrorInvalidValue;
  Args a{};
  set_tail(a.r.pl, wo, so, attn, wgu, sgu, wd, sd, gamma, H, Ko, I, Go, Gg,
           Gd);
  a.h = (const __nv_bfloat16*)h;
  a.x32 = (float*)wo_out;
  a.h2 = (__nv_bfloat16*)h2;
  a.y = (__nv_bfloat16*)y;
  a.M = M;
  a.H = H;
  a.I = I;
  a.eps = eps;
  return launch<true>(a, (float*)act, (cudaStream_t)stream);
}

// K7: x/res/gamma/h2/y bf16 [M, H] ([H] for gamma); wgu/sgu, wd/sd one
// layer's codes and scales as above; act the float32 scratch [64 | nblk x
// 32 | M x I | M x H] (x32 last). Requires 1 <= M <= 32, H and I
// multiples of 32 and both group sizes a multiple of 32, or 8 or 16 (16: K a
// multiple of 64).
extern "C" int ffn_fused_launch(const void* x, const void* res,
                                const void* gamma, const void* wgu,
                                const void* sgu, const void* wd,
                                const void* sd, void* act, void* h2, void* y,
                                int M, int H, int I, int Gg, int Gd,
                                float eps, void* stream) {
  if (M < 1 || M > kMaxM || H % 32 || I % 32 || !groups_ok(H, Gg) ||
      !groups_ok(I, Gd))
    return (int)cudaErrorInvalidValue;
  Args a{};
  set_tail(a.r.pl, nullptr, nullptr, nullptr, wgu, sgu, wd, sd, gamma, H, 0,
           I, 1, Gg, Gd);
  a.h = (const __nv_bfloat16*)x;
  a.res = (const __nv_bfloat16*)res;
  a.h2 = (__nv_bfloat16*)h2;
  a.y = (__nv_bfloat16*)y;
  a.M = M;
  a.H = H;
  a.I = I;
  a.eps = eps;
  return launch<false>(a, (float*)act, (cudaStream_t)stream);
}

// The ring plan of a launch on nblk blocks (wo: K6, else K7), for the
// tests: out[0..3] = slots, slot bytes, shared memory, passes over the
// weights; then for each phase (wo, gate-up, down; zeros for K7's first)
// q, units a batch, columns a batch, their shared-memory rows, the rows of
// a slab, and the fewest and the most units a block takes. Returns 0 or
// cudaErrorInvalidValue.
extern "C" int layer_tail_plan(int M, int H, int Ko, int I, int Go, int Gg,
                               int Gd, int nblk, int wo, int* out) {
  if (M < 1 || M > kMaxM || nblk < 1 || H % 32 || Ko % 32 || I % 32 ||
      (wo && !groups_ok(Ko, Go)) || !groups_ok(H, Gg) || !groups_ok(I, Gd))
    return (int)cudaErrorInvalidValue;
  Plan pl{};
  // any non-null pointer marks the wo phase
  set_tail(pl, wo ? &pl : nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, &pl, H, Ko, I, wo ? Go : 1, Gg, Gd);
  const int code = make_plan(pl, M, nblk, 0, 0);
  if (code) return code;
  out[0] = pl.R;
  out[1] = pl.slot;
  out[2] = pl.smem;
  out[3] = row_passes(M);
  for (int i = 0; i < 3; ++i) {
    const Phase& p = pl.ph[i];
    int lo = p.units, hi = 0;
    for (int b = 0; b < nblk; ++b) {
      const int n = cut(p.units, b + 1, nblk) - cut(p.units, b, nblk);
      lo = n < lo ? n : lo;
      hi = n > hi ? n : hi;
    }
    const int v[7] = {p.q, p.ub, p.cols, p.ncp, p.rows, lo, hi};
    for (int j = 0; j < 7; ++j) out[4 + 7 * i + j] = wo || i > 0 ? v[j] : 0;
  }
  return 0;
}
