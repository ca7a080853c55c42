// K12: one whole decode layer at B = T = 1 in one launch.
//
// Replaces llm_inference_tpu/ops/pallas/layer_fused.py:_call (_kernel,
// entry layer_decode_fused). Same function and rounding points:
//   x32  = h + res                                          (float32)
//   qkv  = rms_norm(x32) * ga . Wqkv                        (float32)
//   q    = rope(q) * D^-0.5,  k = rope(k)   (x cos + rot sin, float32)
//   k16, v16 = bf16(k), bf16(v)             (outputs k_new, v_new)
//   seed = the new token itself: s = bf16(q) . kd, acc = vd, where kd, vd
//          are k16, v16, or their int8 quantize-dequantize (bf16) over an
//          int8 cache
//   attention over the cache slots strictly below pos (float32 softmax;
//          int8: scores times k_scale, l sums p before the V scale, p *
//          v_scale rounded to bf16 against the codes; bf16: p rounded to
//          bf16), attn = acc / l
//   x32' = x32 + attn . Wo,  h2 = bf16(x32')
//   act  = silu(g) * u,  (g | u) = rms_norm(x32') * gf . Wgate_up
//   dn   = bf16(act . Wdown)
// nothing rounded between phases except where named. The GEMVs dot bf16(x)
// against int8 per-channel codes (the column scale on the float32 sum) or
// float32 x against grouped int4 codes (bf16 hi + lo, each group's scale on
// its partial), as the TPU kernel's two weight branches do.
//
// Bound on the H100 SXM (3.35 TB/s): the call must read the layer's weights
// and scales and the live K and V rows once. LLaMA-2-7B, one layer:
//   int8 per-channel: 202.4 MB codes + 0.17 MB scales, plus bf16 KV of
//     3.1 MB at pos 191 (61.4 us) or 50.1 MB at pos 3060 (75.4 us);
//   int4 g = 128: 101.2 MB codes + 6.3 MB scales, plus int8 KV of 1.6 MB
//     at pos 191 (32.6 us).
// A step's launches drop from about 17 a layer (K1 qkv, the RoPE ops, the
// KV write, K2, K1 wo, K1 gate-up, SwiGLU, K1 down, or K6) to two.
//
// Design: K6's (layer_tail.cu) with two more phases in front, on the same
// weight ring (weight_ring.cuh): one persistent block an SM (a cooperative
// launch), a weight producer warp streaming qkv, wo, gate-up and down as
// 2-D TMA boxes into one mbarrier ring without ever waiting for a phase
// (it fills the ring with wo's first stages while the consumers attend),
// an activation producer warp and eight mma.sync consumer warps; every
// phase's columns cut evenly over the SMs. The consumers' phases:
//   A  x = h + res and its rstd, by every block over H from L2 while the
//      ring fills (no barrier before it); xn = x rstd ga into shared memory
//      (Smem::xs, float32), the A rows of the qkv GEMV; qkv to the scratch.
//   -- grid barrier 1
//   B  attention, split by the card: each kv head's history in nsplit
//      shares (at least two tiles a share, at most nblk / Hkv), a block a
//      (head, share), walked by decode_tile.cuh's tile walk (a cp.async
//      ring of tiles, a softmax step per tile) in a shared-memory area
//      carved beside the weight ring's fixed part. The head's first share
//      applies RoPE, writes k_new and v_new and seeds its state with the
//      new token (which the cache does not hold yet: the caller writes the
//      rows afterwards, ops/kernels/kv_write.write_rows or
//      quantize_write_rows); the last share of a head to finish (an
//      acq_rel counter) merges the shares into attn, so no merge phase.
//   -- grid barrier 2
//   D  wo over attn (float32 by K-tile beside the weights; int4: hi + lo,
//      int8: bf16(attn)); the epilogue writes x32' = x32 + wo_out, h2 and
//      a partial sum of squares per block.
//   -- grid barrier 3; rstd from the partials in block order
//   E  gate-up over x32' rstd gf (by K-tile beside the weights) + SwiGLU.
//   -- grid barrier 4
//   F  down over act.
// Two kernels, by the weights' width; the cache's kind and G = 1 (LLaMA-2-
// 7B) or G <= 8 pick the attention phase's instantiation at run time, so
// the GEMV phases are compiled twice, not eight times. Every function is
// inlined: a called phase spilled its registers.
// float32 intermediates (qkv, the share states, attn, x32', act) live in
// the wrapper's per-device scratch and are read back through L2; its
// first word is the grid barrier's counter and then come the heads' merge
// counters (zero when allocated, left so by each launch). Every sum is
// taken in a fixed order (the merge is the one order-free step: it takes
// the shares in share order once they are all written), so two calls on
// the same inputs give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "decode_tile.cuh"
#include "kv_addr.cuh"
#include "weight_ring.cuh"

namespace {

using namespace ring;
using dtile::kBf16;
using dtile::kInt8;

constexpr int kD = 128;
constexpr int kMaxG = dtile::kMaxG;
static_assert(dtile::kThreads == kConsumerThreads,
              "the attention walk runs on the consumer warps");

struct Args {
  Ring r;
  const __nv_bfloat16* h;     // [H] residual stream
  const __nv_bfloat16* res;   // [H] the previous layer's down output
  const __nv_bfloat16* ga;    // [H] attention norm
  const float* cos;           // [D] at this position
  const float* sin;
  const void* kc;             // this layer's cache [Hkv, S, D]
  const void* vc;
  const float* ks;            // its scales [S, Hkv] (int8 cache)
  const float* vs;
  const int* pos;             // [1]
  unsigned* gbar;             // scratch: the grid barrier's counter,
  int* done;                  // the heads' merge counters [Hkv],
  float* ss;                  // partial sums of squares [nblk][32],
  float* qkv;                 // [(Hq + 2 Hkv) D],
  float* part;                // [Hkv][max_split][G][D + 2],
  float* attn;                // [Hq D],
  float* x32;                 // [H],
  float* act;                 // [I]
  __nv_bfloat16* k_new;       // [Hkv, D]
  __nv_bfloat16* v_new;
  __nv_bfloat16* h2;          // [H]
  __nv_bfloat16* dn;          // [H]
  int H, Hq, Hkv, S, I, max_split;
  float eps, scale;
};

// The float32 scratch: offsets of its parts (each a multiple of 32
// floats) for nblk blocks.
struct Layout {
  size_t done, ss, qkv, part, attn, x32, act, total;
  int max_split;
};

size_t r32(size_t n) { return (n + 31) / 32 * 32; }

Layout layout(int H, int Hq, int Hkv, int I, int nblk) {
  Layout L;
  L.max_split = nblk / Hkv > 1 ? nblk / Hkv : 1;
  size_t o = kHeader;
  L.done = o;
  o += r32(Hkv);
  L.ss = o;
  o += r32((size_t)nblk * kMaxM);
  L.qkv = o;
  o += r32((size_t)(Hq + 2 * Hkv) * kD);
  L.part = o;
  o += r32((size_t)Hkv * L.max_split * (Hq / Hkv) * (kD + 2));
  L.attn = o;
  o += r32((size_t)Hq * kD);
  L.x32 = o;
  o += r32(H);
  L.act = o;
  o += r32(I);
  L.total = o;
  return L;
}

// The attention phase's shared memory: the tile walk's, then kd and vd.
template <int KIND, int GM>
int att_bytes(int G) {
  return dtile::shared_bytes<kD, KIND, GM>(G) + 2 * kD * 4;
}

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Dim d of rope(row), row a float32 head row of the qkv scratch: x cos +
// rot sin with rot = (-x[D/2:], x[:D/2]), each product and the sum rounded
// as the plain version rounds them.
__device__ __forceinline__ float rope_at(const float* row, const float* cs,
                                         const float* sn, int d) {
  const float x = __ldcg(row + d);
  const float xr = __ldcg(row + (d ^ (kD / 2)));
  const float rot = d < kD / 2 ? -xr : xr;
  return __fadd_rn(__fmul_rn(x, __ldg(cs + d)), __fmul_rn(rot, __ldg(sn + d)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// int8 quantize-dequantize of a bf16 row held 4 dims a lane (the caller's
// row write quantizes the same way, kv_write.cu's K4).
__device__ __forceinline__ void quant_dq(const float (&x)[4],
                                         float (&out)[4]) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(x[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(amax / 127.0f, 1e-8f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float q = fminf(fmaxf(rintf(x[j] / s), -128.f), 127.f);
    out[j] = bf_round(q * s);
  }
}

// The float4 of a head's q row (dtile::q_dim order) that holds dims d..d+3
template <int KIND>
__device__ __forceinline__ int q_quad(int d) {
  constexpr int per = KIND == kBf16 ? 8 : 16;
  return (d % per) / 4 * dtile::Geometry<kD, KIND>::CPR + d / per;
}

// The new token of kv head hk, by one warp (4 dims a lane): its rows out,
// kd and vd into kv[2][D], and the seed score of each query head into m.
template <int KIND>
__device__ __forceinline__ void new_token(const Args& a, int hk, int G,
                                          const dtile::Shared& sh,
                                          float* kv) {
  const int lane = threadIdx.x & 31, d0 = 4 * lane;
  const float* krow = a.qkv + (size_t)(a.Hq + hk) * kD;
  const float* vrow = a.qkv + (size_t)(a.Hq + a.Hkv + hk) * kD;
  float k16[4], v16[4], kd[4], vd[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    k16[j] = bf_round(rope_at(krow, a.cos, a.sin, d0 + j));
    v16[j] = bf_round(__ldcg(vrow + d0 + j));
    a.k_new[(size_t)hk * kD + d0 + j] = __float2bfloat16(k16[j]);
    a.v_new[(size_t)hk * kD + d0 + j] = __float2bfloat16(v16[j]);
  }
  if constexpr (KIND == kInt8) {
    quant_dq(k16, kd);
    quant_dq(v16, vd);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kd[j] = k16[j];
      vd[j] = v16[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    kv[d0 + j] = kd[j];
    kv[kD + d0 + j] = vd[j];
  }
  for (int g = 0; g < G; ++g) {
    const float4 q = reinterpret_cast<const float4*>(sh.q)[
        g * (kD / 4) + q_quad<KIND>(d0)];
    float p = q.x * kd[0];
    p = fmaf(q.y, kd[1], p);
    p = fmaf(q.z, kd[2], p);
    p = fmaf(q.w, kd[3], p);
    p = warp_sum(p);
    if (lane == 0) sh.m[g] = p;
  }
}

// Phase B on the consumer warps: the blocks take the (kv head, share)
// items in turn; attn gets each head's merged acc / l (float32).
template <int KIND, int GM>
__device__ __forceinline__ void attend(const Args& a, const Smem& S) {
  using C = dtile::Geometry<kD, KIND, GM>;
  const int G = a.Hq / a.Hkv, tid = threadIdx.x;
  unsigned char* area = reinterpret_cast<unsigned char*>(S.red);
  const dtile::Shared sh = dtile::shared_of<kD, KIND, GM>(area, G);
  float* kv = reinterpret_cast<float*>(
      area + dtile::shared_bytes<kD, KIND, GM>(G));
  // the history: slots strictly below pos, in nsplit shares of at least
  // two tiles (at most max_split)
  const int hist = min(max(*a.pos, 0), a.S);
  int nsplit = (hist + 2 * C::T - 1) / (2 * C::T);
  nsplit = max(1, min(nsplit, a.max_split));
  const int share = (hist + nsplit - 1) / nsplit;
  const DenseAddr addr{a.Hkv, a.S};
  for (int item = blockIdx.x; item < a.Hkv * nsplit; item += gridDim.x) {
    const int hk = item / nsplit, z = item % nsplit;
    const int lo = z * share, hi = min(hist, lo + share) - 1;
    // the group's query rows: RoPE, the score scale, then bf16
    for (int i = tid; i < G * kD / 4; i += kConsumerThreads) {
      const int g = i / (kD / 4);
      const int c = i % C::CPR;
      const int j = i % (kD / 4) / C::CPR;
      const int d0 = dtile::q_dim<kD, KIND>(c, j);
      const float* row = a.qkv + (size_t)(hk * G + g) * kD;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = bf_round(rope_at(row, a.cos, a.sin, d0 + e) * a.scale);
      reinterpret_cast<float4*>(sh.q)[i] = make_float4(f[0], f[1], f[2], f[3]);
    }
    if (tid < kMaxG) {
      sh.m[tid] = dtile::kNegInf;
      sh.tmax[tid] = dtile::ordered(dtile::kNegInf);
    }
    float acc[GM][C::DPW], lsum[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      lsum[g] = 0.f;
#pragma unroll
      for (int j = 0; j < C::DPW; ++j) acc[g][j] = 0.f;
    }
    if (z == 0) {
      // the new token seeds the state: m = its score, l = 1, acc = vd in
      // the first slot group's threads
      named_sync();
      if (tid < 32) new_token<KIND>(a, hk, G, sh, kv);
      named_sync();
      const int pw = tid % C::WPR, pg = tid / C::WPR;
      if (pg == 0) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          lsum[g] = 1.f;
#pragma unroll
          for (int j = 0; j < C::DPW; ++j)
            acc[g][j] = kv[kD + dtile::piece_dim<kD, KIND, C::PB>(pw, j)];
        }
      }
    }
    dtile::walk<kD, KIND, GM, 1>(
        sh, static_cast<const uint8_t*>(a.kc),
        static_cast<const uint8_t*>(a.vc), a.ks, a.vs, addr, 0, hk, lo, hi, G,
        1.f, 0.f, acc, lsum);
    dtile::finish<kD, KIND, GM, 1>(sh, acc, lsum, G, nsplit, z, hk, a.part,
                                   a.done, a.attn);
    named_sync();   // the area is free for the next item
  }
}

// Phase B's instantiation: the cache's codes (bf16 or int8), G = 1 (the
// loops over heads vanish, LLaMA-2-7B's case) or G <= 8.
__device__ __forceinline__ void attention(const Args& a, const Smem& S) {
  const bool one = a.Hq == a.Hkv;
  if (a.ks == nullptr) {
    if (one)
      attend<kBf16, 1>(a, S);
    else
      attend<kBf16, kMaxG>(a, S);
  } else {
    if (one)
      attend<kInt8, 1>(a, S);
    else
      attend<kInt8, kMaxG>(a, S);
  }
}

// Phase A's row: x = h + res (16-byte loads), its rstd (the threads'
// partials in a fixed order: a shuffle tree, then the warps in order),
// xs = x rstd ga.
__device__ __forceinline__ void norm_row(const Args& a, const Smem& S) {
  const int tid = threadIdx.x;
  float sq = 0.f;
  for (int k = 8 * tid; k < a.H; k += 8 * kConsumerThreads) {
    const uint4 hv = *reinterpret_cast<const uint4*>(a.h + k);
    const uint4 rv = *reinterpret_cast<const uint4*>(a.res + k);
    const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
    const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
    float x[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = bf_lo(hw[j]) + bf_lo(rw[j]);
      x[2 * j + 1] = bf_hi(hw[j]) + bf_hi(rw[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sq = fmaf(x[j], x[j], sq);
    float4* xo = reinterpret_cast<float4*>(S.xs + k);
    xo[0] = make_float4(x[0], x[1], x[2], x[3]);
    xo[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
  sq = warp_sum(sq);
  if ((tid & 31) == 0) S.ssr[tid >> 5] = sq;
  named_sync();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) tot += S.ssr[w];
  const float rs = rsqrtf(tot / (float)a.H + a.eps);
  for (int k = tid; k < a.H; k += kConsumerThreads)
    S.xs[k] = S.xs[k] * rs * __bfloat162float(a.ga[k]);
  named_sync();
}

// The GEMV phases' epilogues (0 qkv, 1 wo, 2 gate-up + SwiGLU, 3 down) at
// M = 1: a column a thread of row 0, its sum the consumer warps' partials
// in warp order, times the column's scale for int8.
template <int WBITS>
struct Epi {
  const Args& a;
  const Smem& S;

  // (PI is -1: the phase is pi.) No prefetch of wo's h and res: every
  // block read them in phase A, and the prefetch cost the int4 kernel a
  // spilled register.
  template <int PI>
  __device__ void pre(int, int, int, int) const {}

  template <int PI>
  __device__ void out(int pi, int m0, int ua, int nu, int cols) const {
    const Phase& p = a.r.pl.ph[pi];
    const int rc = a.r.pl.red_cols;
    float sq = 0.f;
    if ((threadIdx.x & 7) == 0)
      for (int i = threadIdx.x >> 3; i < (p.pairs ? nu : cols);
           i += kColGroups) {
        const int n = ua + i;
        float v = col_sum(S, rc, i, 0);
        if constexpr (WBITS == 8) v *= __ldg(p.s + n);
        if (pi == 0) {
          a.qkv[n] = v;
        } else if (pi == 1) {
          const float x = __bfloat162float(a.h[n]) +
                          __bfloat162float(a.res[n]) + v;
          a.x32[n] = x;
          a.h2[n] = __float2bfloat16(x);
          sq = fmaf(x, x, sq);
        } else if (pi == 2) {
          float u = col_sum(S, rc, p.ncp / 2 + i, 0);
          if constexpr (WBITS == 8) u *= __ldg(p.s + p.up + n);
          a.act[n] = v * (1.f / (1.f + expf(-v))) * u;
        } else {
          a.dn[n] = __float2bfloat16(v);
        }
      }
    if (pi == 1) sum_squares(S, sq, m0);
  }
};

// The consumers' phases in one loop of the two GEMV forms (named phases,
// inlined four times, spilled a register): A qkv | barrier 1, B attention
// | barrier 2, D wo | barrier 3, rstd | E gate-up | barrier 4, F down.
template <int WBITS>
__device__ __forceinline__ void consume(const Args& a, const Smem& S) {
  Cursor cur;
  const Epi<WBITS> epi{a, S};
  norm_row(a, S);
#pragma unroll 1
  for (int pi = 0; pi < 4; ++pi) {
    if (pi == 1) {
      grid_barrier(a.gbar, S, 1);
      attention(a, S);
      grid_barrier(a.gbar, S, 2);
    } else if (pi == 2) {
      if (threadIdx.x == 0) a.ss[blockIdx.x * kMaxM] = S.ssacc[0];
      grid_barrier(a.gbar, S, 3);
      rstd_of_rows(a.ss, 1, a.H, a.eps, S);
    } else if (pi == 3) {
      grid_barrier(a.gbar, S, 4);
    }
    if (pi == 2)
      run_phase<-1, kFormNorm, WBITS, true>(a.r, pi, S, cur, epi);
    else
      run_phase<-1, kFormF32, WBITS, true>(a.r, pi, S, cur, epi);
  }
}

// WBITS: 8 (per channel) or 4 (grouped). The cache's kind and the query
// heads a kv head pick the attention phase's instantiation at run time.
template <int WBITS>
__global__ void __launch_bounds__(kThreads, 1)
    layer_fused_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Smem S = smem_of(sm, a.r.pl);
  init_block(S, a.r.pl);
  __syncthreads();
  if (!produce<0, 4, WBITS>(a.r, S)) consume<WBITS>(a, S);
}

// The phases qkv | wo | gate-up | down of one layer's weights w*/s*
// (groups G*; int8: 1) with their rows: qkv's the consumers' xs, wo's
// attn (after barrier 2), gate-up's x32' and gf (3), down's act (4).
void set_layer(Args& a, const void* const (&w)[4], const void* const (&s)[4],
               const int (&G)[4], int bits, const void* gf) {
  Plan& pl = a.r.pl;
  pl.ph0 = 0;
  pl.nph = 4;
  const int H = a.H, I = a.I, Hq = a.Hq, Hkv = a.Hkv;
  set_phase(pl.ph[0], w[0], s[0], (Hq + 2 * Hkv) * kD, 0, 0, H, G[0], bits,
            0, nullptr, nullptr, 0);
  set_phase(pl.ph[1], w[1], s[1], H, 0, 0, Hq * kD, G[1], bits, 4, a.attn,
            nullptr, 2);
  set_phase(pl.ph[2], w[2], s[2], I, 1, I, H, G[2], bits, 4, a.x32, gf, 3);
  set_phase(pl.ph[3], w[3], s[3], H, 0, 0, I, G[3], bits, 4, a.act, nullptr,
            4);
}

template <int WBITS>
int launch(Args& a, const void* const (&w)[4], const void* const (&s)[4],
           const int (&G)[4], const void* gf, float* scratch,
           size_t scratch_floats, cudaStream_t stream) {
  static int sms[kMaxDevices];
  int nblk = 0;
  int code = card_blocks(layer_fused_kernel<WBITS>, sms, nblk);
  if (code) return code;
  const Layout L = layout(a.H, a.Hq, a.Hkv, a.I, nblk);
  if (scratch_floats < L.total) return (int)cudaErrorInvalidValue;
  a.gbar = reinterpret_cast<unsigned*>(scratch);
  a.done = reinterpret_cast<int*>(scratch + L.done);
  a.ss = scratch + L.ss;
  a.qkv = scratch + L.qkv;
  a.part = scratch + L.part;
  a.attn = scratch + L.attn;
  a.x32 = scratch + L.x32;
  a.act = scratch + L.act;
  a.max_split = L.max_split;
  a.r.M = 1;
  set_masks(a.r);
  set_layer(a, w, s, G, WBITS, gf);
  const int g = a.Hq / a.Hkv;
  const int att =
      a.ks == nullptr
          ? (g == 1 ? att_bytes<kBf16, 1>(g) : att_bytes<kBf16, kMaxG>(g))
          : (g == 1 ? att_bytes<kInt8, 1>(g) : att_bytes<kInt8, kMaxG>(g));
  code = make_plan(a.r.pl, 1, nblk, a.H * 4, att);
  if (code) return code;
  if (!encode_plan(a.r.pl)) return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)layer_fused_kernel<WBITS>, dim3(nblk), dim3(kThreads),
      args, a.r.pl.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One decode layer at B = 1. h/res/ga/gf/h2/dn bf16 [H] (h, res and gf
// 16-byte aligned); cos/sin float32 [D] at this position; w* one layer's
// codes (int8 [N, K], or packed int4 [N, K/2]; 16-byte aligned) and s* its
// float32 scales ([N], or [N, G*] groups); kc/vc the layer's cache [Hkv,
// S, D] (bf16, or int8 codes with ks/vs its float32 scales [S, Hkv]; null
// for bf16); pos int32 [1] on the device; scratch a float32 buffer of
// scratch_floats floats, at least layout()'s (zeros when allocated, left so
// for the next launch: its counters); k_new/v_new bf16 [Hkv, D]. D = 128,
// Hq / Hkv <= 8, H and I multiples of 32, wbits 8 (per channel, G* = 1) or
// 4 (groups of a multiple of 32 codes, or of 8, or of 16 with K a multiple
// of 64).
extern "C" int layer_fused_launch(
    const void* h, const void* res, const void* ga, const void* gf,
    const void* cos, const void* sin, const void* wq, const void* sq,
    const void* wo, const void* so, const void* wg, const void* sg,
    const void* wd, const void* sd, const void* kc, const void* vc,
    const void* ks, const void* vs, const void* pos, void* scratch,
    void* k_new, void* v_new, void* h2, void* dn, int H, int Hq, int Hkv,
    int S, int I, int scratch_floats, int Gq, int Go, int Gg, int Gd,
    int wbits, float eps, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv || Hq / Hkv > kMaxG || H % 32 || I % 32 ||
      S < 1 || (wbits != 8 && wbits != 4) ||
      (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (wbits == 4 ? !(groups_ok(H, Gq) && groups_ok(Hq * kD, Go) &&
                     groups_ok(H, Gg) && groups_ok(I, Gd))
                 : (Gq != 1 || Go != 1 || Gg != 1 || Gd != 1))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.h = (const __nv_bfloat16*)h;
  a.res = (const __nv_bfloat16*)res;
  a.ga = (const __nv_bfloat16*)ga;
  a.cos = (const float*)cos;
  a.sin = (const float*)sin;
  a.kc = kc;
  a.vc = vc;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.pos = (const int*)pos;
  a.k_new = (__nv_bfloat16*)k_new;
  a.v_new = (__nv_bfloat16*)v_new;
  a.h2 = (__nv_bfloat16*)h2;
  a.dn = (__nv_bfloat16*)dn;
  a.H = H;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.I = I;
  a.eps = eps;
  a.scale = scale;
  const void* const w[4] = {wq, wo, wg, wd};
  const void* const s[4] = {sq, so, sg, sd};
  const int G[4] = {Gq, Go, Gg, Gd};
  float* f = (float*)scratch;
  const size_t n = (size_t)scratch_floats;
  cudaStream_t st = (cudaStream_t)stream;
  if (wbits == 8) return launch<8>(a, w, s, G, gf, f, n, st);
  return launch<4>(a, w, s, G, gf, f, n, st);
}
