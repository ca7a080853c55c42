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
//   attention over the cache slots strictly below pos (float32 online
//          softmax; int8: scores times k_scale, l sums p before the V
//          scale, p * v_scale rounded to bf16 against the codes; bf16: p
//          rounded to bf16), attn = acc / l
//   x32' = x32 + attn . Wo,  h2 = bf16(x32')
//   act  = silu(g) * u,  (g | u) = rms_norm(x32') * gf . Wgate_up
//   dn   = bf16(act . Wdown)
// nothing rounded between phases except where named. The GEMVs dot bf16
// rows against int8 per-channel codes (column scale on the float32 sum,
// the int8 core of K1, int8_gemv.cuh) or float32 rows against grouped int4
// codes (each group's scale on its partial dot, the int4 core of K1 and K6,
// int4_gemv.cuh), as the TPU kernel's two weight branches do.
//
// Design. The TPU kernel is one grid walked in order (qkv blocks, head
// assembly, slot blocks, wo, norm, gate-up, SwiGLU, down blocks) with its
// intermediates in VMEM. CUDA blocks run in no order, so this is a
// cooperative kernel, as K6 (layer_tail.cu): the grid is sized so every
// block is resident (occupancy x SMs) and grid.sync() separates
//   A  norm + qkv | B+C  RoPE, seed, attention items | merge | D  wo |
//   E  norm + gate-up + SwiGLU | F  down.
// Every block recomputes a norm into its shared memory (a read of H
// activations from L2, small beside the weights); block 0 alone writes h2.
// The GEMV phases hand every warp of the grid kCols output columns at a
// time. The attention phase splits each kv head's history into items of
// at least 64 slots, one warp an item (as K2's warps walk slots: each lane
// holds 4 dims, q.k reduces by shuffles, a running max, sum and
// accumulator per query head of the group); the first item of a head also
// applies RoPE to the new k, writes k_new and v_new, and seeds its state
// with the new token, which the cache does not hold yet (the caller writes
// the rows afterwards, ops/kernels/kv_write.write_rows or
// quantize_write_rows). The merge phase combines a head's items, one warp
// per query head. float32 intermediates (qkv, item states, attention rows,
// wo out, act) live in one global scratch from the wrapper and are read
// back through L2 (__ldcg). The kernel allocates nothing and keeps no
// state between calls.
//
// Bound on the H100 SXM (3.35 TB/s): the call must read the layer's weights
// and scales and the live K and V rows once. LLaMA-2-7B, one layer:
//   int8 per-channel: 202.4 MB codes + 0.17 MB scales, plus bf16 KV of
//     3.1 MB at pos 191 (61.4 us) or 50.1 MB at pos 3060 (75.4 us);
//   int4 g = 128: 101.2 MB codes + 6.3 MB scales, plus int8 KV of 1.6 MB
//     at pos 191 (32.6 us).
// The step's launches also drop from about 17 a layer (K1 qkv, the RoPE
// ops, the KV write, K2, K1 wo, K1 gate-up, SwiGLU, K1 down, or K6) to two.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int4_gemv.cuh"
#include "int8_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;
static_assert(int4g::kCols == kCols && int8g::kCols == kCols,
              "both GEMV cores give a warp kCols columns");
constexpr int D = 128;
constexpr int PL = D / 32;         // dims per lane
constexpr int kMaxG = 8;
constexpr int kUnroll = 4;
constexpr int kItemSlots = 64;     // least history slots of an attention item
constexpr float kNegInf = -1e30f;

struct Layer {
  const __nv_bfloat16* h;     // [H] residual stream
  const __nv_bfloat16* res;   // [H] the previous layer's down output
  const __nv_bfloat16* ga;    // [H] attention norm
  const __nv_bfloat16* gf;    // [H] FFN norm
  const float* cos;           // [D] at this position
  const float* sin;
  const void* wq;             // this layer's codes and scales
  const float* sq;
  const void* wo;
  const float* so;
  const void* wg;
  const float* sg;
  const void* wd;
  const float* sd;
  const void* kc;             // this layer's cache [Hkv, S, D]
  const void* vc;
  const float* ks;            // its scales [S, Hkv] (int8 cache)
  const float* vs;
  const int* pos;             // [1]
  float* qkv;                 // scratch [(Hq + 2 Hkv) D]
  float* part;                // scratch [Hkv][max_split][G][D + 2]
  float* attn;                // scratch [Hq D]
  float* wout;                // scratch [H]
  float* act;                 // scratch [I]
  __nv_bfloat16* k_new;       // [Hkv, D]
  __nv_bfloat16* v_new;
  __nv_bfloat16* h2;          // [H]
  __nv_bfloat16* dn;          // [H]
  int H, Hq, Hkv, S, I, max_split;
  int Gq, Go, Gg, Gd;         // int4 scale groups of each weight
  float eps, scale;
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Element k of a GEMV input row in shared memory: bf16 for the int8 core,
// float32 at its swizzled place for the int4 core.
template <int WBITS>
__device__ __forceinline__ void put_x(void* xs, int k, float v) {
  if constexpr (WBITS == 8)
    reinterpret_cast<__nv_bfloat16*>(xs)[k] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(xs)[int4g::swz(k)] = v;
}

// xs = rms_norm(a + b (+ c)) * gamma over H, by the whole block; x_out (if
// not null) gets bf16(a + b (+ c)). c is a float32 scratch row of this
// launch, read through L2.
template <int WBITS>
__device__ void norm_x(void* xs, const __nv_bfloat16* a,
                       const __nv_bfloat16* b, const float* c,
                       const __nv_bfloat16* gamma, int H, float eps,
                       __nv_bfloat16* x_out, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float ss = 0.f;
  for (int k = threadIdx.x; k < H; k += kThreads) {
    float v = bf(a[k]) + bf(b[k]);
    if (c) v += __ldcg(c + k);
    if (x_out) x_out[k] = __float2bfloat16(v);
    ss = fmaf(v, v, ss);
  }
  ss = int4g::warp_sum(ss);
  __syncthreads();   // red and xs may still be read from the last phase
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += red[w];
  const float rstd = rsqrtf(tot / (float)H + eps);
  for (int k = threadIdx.x; k < H; k += kThreads) {
    float v = bf(a[k]) + bf(b[k]);
    if (c) v += __ldcg(c + k);
    put_x<WBITS>(xs, k, v * rstd * bf(gamma[k]));
  }
  __syncthreads();
}

// xs = a float32 scratch row of this launch (K elements).
template <int WBITS>
__device__ void load_x(void* xs, const float* src, int K) {
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads)
    put_x<WBITS>(xs, k, __ldcg(src + k));
  __syncthreads();
}

// The totals of columns n0 .. n0 + kCols - 1 of x . W with their scales,
// in every lane of the warp.
template <int WBITS>
__device__ __forceinline__ void col_dots(const void* xs, int K, const void* w,
                                         const float* s, int G, int n0,
                                         int lane, float (&tot)[kCols]) {
  float acc[kCols][1];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c][0] = 0.f;
  if constexpr (WBITS == 8) {
    int8g::gemv_cols<1>(reinterpret_cast<const __nv_bfloat16*>(xs), K, 1,
                        reinterpret_cast<const int8_t*>(w), K, n0, lane, acc);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      tot[c] = int4g::warp_sum(acc[c][0]) * __ldg(s + n0 + c);
  } else {
    int4g::gemv_cols<1>(reinterpret_cast<const float*>(xs), K, 1,
                        reinterpret_cast<const uint8_t*>(w), s, K, G, n0,
                        lane, acc);
#pragma unroll
    for (int c = 0; c < kCols; ++c) tot[c] = int4g::warp_sum(acc[c][0]);
  }
}

// out(n, y_n) for every column n < N of x . W, the columns spread over
// every warp of the grid.
template <int WBITS, typename Out>
__device__ void gemv_phase(const void* xs, int K, const void* w,
                           const float* s, int G, int N, Out out) {
  const int lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int stride = gridDim.x * kWarps * kCols;
  for (int n0 = gwarp * kCols; n0 < N; n0 += stride) {
    float tot[kCols];
    col_dots<WBITS>(xs, K, w, s, G, n0, lane, tot);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) out(n0 + c, tot[c]);
    }
  }
}

// This lane's PL dims of rope(row), row a float32 head row of the qkv
// scratch: x cos + rot sin with rot = (-x[D/2:], x[:D/2]), each product
// and the sum rounded as the plain version rounds them.
__device__ __forceinline__ void rope_lane(const float* row, const float* cs,
                                          const float* sn, int d0,
                                          float (&out)[PL]) {
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int d = d0 + j;
    const float x = __ldcg(row + d);
    const float xr = __ldcg(row + (d ^ (D / 2)));
    const float rot = d < D / 2 ? -xr : xr;
    out[j] = __fadd_rn(__fmul_rn(x, cs[j]), __fmul_rn(rot, sn[j]));
  }
}

// int8 quantize-dequantize of a bf16 row held PL dims a lane (the caller's
// row write quantizes the same way, kv_write.cu's K4).
__device__ __forceinline__ void quant_dq(const float (&x)[PL],
                                         float (&out)[PL]) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) amax = fmaxf(amax, fabsf(x[j]));
  amax = warp_max(amax);
  const float s = fmaxf(amax / 127.0f, 1e-8f);
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const float q = fminf(fmaxf(rintf(x[j] / s), -128.f), 127.f);
    out[j] = bf_round(q * s);
  }
}

template <bool KV8>
__device__ __forceinline__ void load_slot(const uint8_t* p, float (&out)[PL]) {
  if constexpr (KV8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < PL; ++j) out[j] = (float)(int8_t)(w >> (8 * j));
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xffff0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// One attention item (kv head hk, share z of its history [0, hist)), by
// one warp: its softmax state per query head of the group goes to the
// part scratch.
template <bool KV8>
__device__ void attend_item(const Layer& t, int hk, int z, int nsplit,
                            int hist, int lane) {
  constexpr int ROW = KV8 ? D : 2 * D;          // bytes of a cache row
  constexpr int LANE_BYTES = KV8 ? PL : 2 * PL;
  const int G = t.Hq / t.Hkv;
  const int d0 = lane * PL;
  float cs[PL], sn[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    cs[j] = __ldg(t.cos + d0 + j);
    sn[j] = __ldg(t.sin + d0 + j);
  }
  // the group's query rows: RoPE, the score scale, then bf16 for the dots
  float qb[kMaxG][PL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      float r[PL];
      rope_lane(t.qkv + (size_t)(hk * G + g) * D, cs, sn, d0, r);
#pragma unroll
      for (int j = 0; j < PL; ++j) qb[g][j] = bf_round(r[j] * t.scale);
    }
  }
  float m[kMaxG], l[kMaxG], acc[kMaxG][PL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j) acc[g][j] = 0.f;
  }
  if (z == 0) {
    // the new token: its rows out, and the seed of every query head
    float kr[PL], k16[PL], v16[PL], kd[PL], vd[PL];
    rope_lane(t.qkv + (size_t)(t.Hq + hk) * D, cs, sn, d0, kr);
    const float* vrow = t.qkv + (size_t)(t.Hq + t.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      k16[j] = bf_round(kr[j]);
      v16[j] = bf_round(__ldcg(vrow + d0 + j));
      t.k_new[(size_t)hk * D + d0 + j] = __float2bfloat16(k16[j]);
      t.v_new[(size_t)hk * D + d0 + j] = __float2bfloat16(v16[j]);
    }
    if constexpr (KV8) {
      quant_dq(k16, kd);
      quant_dq(v16, vd);
    } else {
#pragma unroll
      for (int j = 0; j < PL; ++j) {
        kd[j] = k16[j];
        vd[j] = v16[j];
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < PL; ++j) p = fmaf(qb[g][j], kd[j], p);
        m[g] = int4g::warp_sum(p);
        l[g] = 1.f;
#pragma unroll
        for (int j = 0; j < PL; ++j) acc[g][j] = vd[j];
      }
    }
  }
  // the cached history of this share, slots [lo, hi)
  const int share = (hist + nsplit - 1) / nsplit;
  const int lo = z * share;
  const int hi = min(hist, lo + share);
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(t.kc) +
                      (size_t)hk * t.S * ROW + lane * LANE_BYTES;
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(t.vc) +
                      (size_t)hk * t.S * ROW + lane * LANE_BYTES;
  for (int s0 = lo; s0 < hi; s0 += kUnroll) {
    float kf[kUnroll][PL], vf[kUnroll][PL], ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ksc[u] = vsc[u] = 1.f;
      if (s0 + u < hi) {
        load_slot<KV8>(kb + (size_t)(s0 + u) * ROW, kf[u]);
        load_slot<KV8>(vb + (size_t)(s0 + u) * ROW, vf[u]);
        if constexpr (KV8) {
          ksc[u] = __ldg(t.ks + (size_t)(s0 + u) * t.Hkv + hk);
          vsc[u] = __ldg(t.vs + (size_t)(s0 + u) * t.Hkv + hk);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u >= hi) break;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < PL; ++j) p = fmaf(qb[g][j], kf[u][j], p);
        float sc = int4g::warp_sum(p);            // the scale is in q
        if constexpr (KV8) sc *= ksc[u];
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float pe = expf(sc - m_new);
        l[g] = l[g] * alpha + pe;                  // before the V scale
        const float pb = bf_round(KV8 ? pe * vsc[u] : pe);
#pragma unroll
        for (int j = 0; j < PL; ++j)
          acc[g][j] = fmaf(pb, vf[u][j], acc[g][j] * alpha);
        m[g] = m_new;
      }
    }
  }
  // the item's state: [G][D] accumulators, [G] maxima, [G] sums (an
  // empty share leaves m = -1e30 and l = 0, weight 0 in the merge)
  float* pz = t.part + ((size_t)hk * t.max_split + z) * G * (D + 2);
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
#pragma unroll
      for (int j = 0; j < PL; ++j) pz[g * D + d0 + j] = acc[g][j];
      if (lane == 0) {
        pz[G * D + g] = m[g];
        pz[G * D + G + g] = l[g];
      }
    }
  }
}

// attn[hq] = the merged state of query head hq's items, acc / l.
__device__ void merge_head(const Layer& t, int hq, int nsplit, int lane) {
  const int G = t.Hq / t.Hkv;
  const int hk = hq / G, g = hq % G;
  const int stride = G * (D + 2);
  const float* ph = t.part + (size_t)hk * t.max_split * stride;
  float mm = kNegInf;
  for (int z = 0; z < nsplit; ++z)
    mm = fmaxf(mm, __ldcg(ph + z * stride + G * D + g));
  float ll = 0.f, aa[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) aa[j] = 0.f;
  for (int z = 0; z < nsplit; ++z) {
    const float* pz = ph + z * stride;
    const float f = expf(__ldcg(pz + G * D + g) - mm);
    ll += __ldcg(pz + G * D + G + g) * f;
#pragma unroll
    for (int j = 0; j < PL; ++j)
      aa[j] += __ldcg(pz + g * D + lane * PL + j) * f;
  }
#pragma unroll
  for (int j = 0; j < PL; ++j)
    t.attn[(size_t)hq * D + lane * PL + j] = aa[j] / ll;
}

template <int WBITS, bool KV8>
__global__ void __launch_bounds__(kThreads, 2)
layer_fused_kernel(const __grid_constant__ Layer t) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  void* xs = smem_raw;    // one GEMV input row (put_x)
  __shared__ float red[kWarps];
  const int lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int W = gridDim.x * kWarps;
  const int Nqkv = (t.Hq + 2 * t.Hkv) * D;

  // ---- A: residual + attention norm, qkv into the scratch
  norm_x<WBITS>(xs, t.h, t.res, nullptr, t.ga, t.H, t.eps, nullptr, red);
  float* qkv = t.qkv;
  gemv_phase<WBITS>(xs, t.H, t.wq, t.sq, t.Gq, Nqkv,
                    [qkv](int n, float y) { qkv[n] = y; });
  grid.sync();

  // ---- B + C: RoPE, the new rows and seed, attention items
  const int hist = min(max(*t.pos, 0), t.S);   // slots strictly below pos
  int nsplit = (hist + kItemSlots - 1) / kItemSlots;
  nsplit = max(1, min(nsplit, min(t.max_split, W / t.Hkv)));
  for (int item = gwarp; item < t.Hkv * nsplit; item += W)
    attend_item<KV8>(t, item / nsplit, item % nsplit, nsplit, hist, lane);
  grid.sync();

  // ---- merge the items of each query head
  for (int hq = gwarp; hq < t.Hq; hq += W) merge_head(t, hq, nsplit, lane);
  grid.sync();

  // ---- D: wo over the attention rows
  load_x<WBITS>(xs, t.attn, t.Hq * D);
  float* wout = t.wout;
  gemv_phase<WBITS>(xs, t.Hq * D, t.wo, t.so, t.Go, t.H,
                    [wout](int n, float y) { wout[n] = y; });
  grid.sync();

  // ---- E: residual + FFN norm (block 0 writes h2), gate-up, SwiGLU
  norm_x<WBITS>(xs, t.h, t.res, t.wout, t.gf, t.H, t.eps,
                blockIdx.x == 0 ? t.h2 : nullptr, red);
  {
    const int stride = W * kCols;
    for (int n0 = gwarp * kCols; n0 < t.I; n0 += stride) {
      float g[kCols], u[kCols];
      col_dots<WBITS>(xs, t.H, t.wg, t.sg, t.Gg, n0, lane, g);
      col_dots<WBITS>(xs, t.H, t.wg, t.sg, t.Gg, t.I + n0, lane, u);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          t.act[n0 + c] = g[c] * (1.f / (1.f + expf(-g[c]))) * u[c];
      }
    }
  }
  grid.sync();

  // ---- F: down
  load_x<WBITS>(xs, t.act, t.I);
  __nv_bfloat16* dn = t.dn;
  gemv_phase<WBITS>(xs, t.I, t.wd, t.sd, t.Gd, t.H,
                    [dn](int n, float y) { dn[n] = __float2bfloat16(y); });
}

// Resident blocks of the whole grid for this instantiation and shared
// memory (the cooperative launch needs every block resident), once per
// size.
template <int WBITS, bool KV8>
int launch(const Layer& t, cudaStream_t stream) {
  static int cached_grid = 0;
  static size_t cached_smem = 0;
  int kmax = t.H > t.I ? t.H : t.I;
  kmax = kmax > t.Hq * D ? kmax : t.Hq * D;
  const size_t smem = (size_t)kmax * (WBITS == 8 ? 2 : 4);
  auto kernel = layer_fused_kernel<WBITS, KV8>;
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
  Layer arg = t;
  void* args[] = {&arg};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(cached_grid), dim3(kThreads), args, smem,
      stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One decode layer at B = 1. h/res/ga/gf/h2/dn bf16 [H]; cos/sin float32
// [D] at this position; w* one layer's codes (int8 [N, K], or packed int4
// [N, K/2]) and s* its float32 scales ([N], or [N, G*] groups); kc/vc the
// layer's cache [Hkv, S, D] (bf16, or int8 codes with ks/vs its float32
// scales [S, Hkv]; null for bf16); pos int32 [1] on the device; scratch a
// float32 buffer of (Hq + 2 Hkv) D + Hkv max_split (Hq / Hkv) (D + 2)
// + Hq D + H + I; k_new/v_new bf16 [Hkv, D]. D = 128, Hq / Hkv <= 8,
// H and I multiples of 32, wbits 8 (per-channel) or 4 (groups of a
// multiple of 32 codes, or of 8 or 16: int4_gemv.cuh), max_split >= 1.
extern "C" int layer_fused_launch(
    const void* h, const void* res, const void* ga, const void* gf,
    const void* cos, const void* sin, const void* wq, const void* sq,
    const void* wo, const void* so, const void* wg, const void* sg,
    const void* wd, const void* sd, const void* kc, const void* vc,
    const void* ks, const void* vs, const void* pos, void* scratch,
    void* k_new, void* v_new, void* h2, void* dn, int H, int Hq, int Hkv,
    int S, int I, int max_split, int Gq, int Go, int Gg, int Gd, int wbits,
    float eps, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv || Hq / Hkv > kMaxG || H % 32 || I % 32 ||
      S < 1 || max_split < 1 || (wbits != 8 && wbits != 4) ||
      (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (wbits == 4 &&
      !(int4g::groups_ok(H, Gq) && int4g::groups_ok(Hq * D, Go) &&
        int4g::groups_ok(H, Gg) && int4g::groups_ok(I, Gd)))
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  float* f = (float*)scratch;
  float* qkv = f;
  float* part = qkv + (size_t)(Hq + 2 * Hkv) * D;
  float* attn = part + (size_t)Hkv * max_split * G * (D + 2);
  float* wout = attn + (size_t)Hq * D;
  float* act = wout + H;
  Layer t{(const __nv_bfloat16*)h, (const __nv_bfloat16*)res,
          (const __nv_bfloat16*)ga, (const __nv_bfloat16*)gf,
          (const float*)cos, (const float*)sin,
          wq, (const float*)sq, wo, (const float*)so,
          wg, (const float*)sg, wd, (const float*)sd,
          kc, vc, (const float*)ks, (const float*)vs, (const int*)pos,
          qkv, part, attn, wout, act,
          (__nv_bfloat16*)k_new, (__nv_bfloat16*)v_new,
          (__nv_bfloat16*)h2, (__nv_bfloat16*)dn,
          H, Hq, Hkv, S, I, max_split, Gq, Go, Gg, Gd, eps, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const bool kv8 = ks != nullptr;
  if (wbits == 8)
    return kv8 ? launch<8, true>(t, st) : launch<8, false>(t, st);
  return kv8 ? launch<4, true>(t, st) : launch<4, false>(t, st);
}
