// K1's int4 GEMV: the decode projections at M <= 8 rows (wqkv and lm_head
// on the int4 split route and the serving batch, wqkv and wo of a tensor-
// parallel shard).
//
// Replaces the N-pair int4 branch of
// llm_inference_tpu/ops/pallas/quant_matmul.py:_quant_matmul_blocked
// (_kernel; its pallas_call at :553) at those row counts. The function of
// quant_matmul_ref (ops/kernels/quant_matmul.py), with these rounding
// points:
//   x32   = float(x_bf16) (+ float(residual_bf16))        (float32)
//   x_out = bf16(x32)                                      (optional)
//   xg    = x32 * float(gamma)                             (with gamma)
//           entering the products as bf16(xg) + bf16(xg - bf16(xg)),
//           about 16 bits of mantissa, not float32's 24
//   rstd  = rsqrt(mean(x32^2) + eps)                       (1 without gamma)
//   y     = bf16( rstd * sum_g scale[n][g] * (xg_g . code_g)[n]
//                 + rstd * sum_g zbias[n][g] * sum(xg_g) )  (zero points)
// with the partial dots in float32; zero points (the TPU kernel's z_ref,
// quant_matmul.py:291) in groups of 32k codes, each segment's sum(xg) the
// hi + lo sums of its chunks that the 136 offset takes; in groups of 16
// or 8, each group's float32 sum(xg) in the ring's chunk_small (ZB).
// Groups of 32k codes take the codes as bf16(136 + code) and 136 * sum(xg)
// of each 32-code chunk (the sum of the bf16 hi and lo parts, float32) off
// the chunk's dot; groups of 16 or 8 widen each code exactly.
// quant_matmul_ref applies rstd to the rows before the dots and keeps them
// float32: the two agree within K1's tolerance, not in their bits.
// The codes of one layer are [N, K/2] bytes, two K-adjacent nibbles a byte
// (ops/quantization.py), the scales float32 [N, G]; groups of a multiple
// of 64 codes, or of 8, 16 or 32.
//
// Bound on the H100 SXM (3.35 TB/s): the codes and scales once, at any
// M <= 8. LLaMA-2-7B g = 128: wqkv 25.2 + 1.6 MB -> 8.0 us, lm_head
// 65.5 + 4.1 MB -> 20.8 us.
//
// Design: K6's weight ring (weight_ring.cuh) in a one-phase instance,
// without a grid barrier, so an ordinary launch. One persistent block an
// SM; the N columns are cut into ranges that differ by at most one.
// - The weight producer warp issues the block's first TMA boxes into the
//   ring as soon as its barriers exist and the kernel ahead has ended.
//   Meanwhile the eight consumer warps read the block's M rows (and the
//   residual) from L2 in one pass, take their sums of squares, and write
//   the rows times gamma into shared memory (Smem::xs, a row pitch 16
//   bytes past a multiple of 128, so the rows of an mma fragment read
//   distinct banks); rstd, a row's factor, is taken on the sums at the
//   end. Each block writes its own slice of x_out. No block waits for the
//   norm before its first weight byte, and the norm is done once a block,
//   not once for each 32 columns.
// - Products on the tensor cores (consume32): mma.sync.m16n8k16 with the
//   codes as A, widened exactly to bf16 in registers, and the rows as B,
//   bf16 hi plus bf16 remainder, so they keep 16 bits of mantissa: a
//   product covers 16 columns for 4 rows, two for 8 rows. A group's
//   chunks add up in the mma's accumulator and take the group's scale
//   once. Groups of 16 or 8 codes run the ring's own consumers.
// - Every sum in a fixed order (a segment's products, the segments in
//   order within a warp, then the warps' parts in order; a row's squares
//   by thread, a shuffle tree, then the warps in order): two launches on
//   the same inputs give the same bits.
// The launch is a dependent one (programmatic stream serialization): the
// blocks are placed and set up while the kernel ahead ends, and every
// thread waits for it before its first access to global memory.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "weight_ring.cuh"

namespace {

using namespace ring;

// the wrapper's _GEMV_MAX_SMEM: M * K * 4 bytes of float32 rows at most
constexpr int kMaxRowBytes = 200 * 1024;
// The plan's search (make_gemv_plan): stages of kQw[i] chunks a warp
// (1024, 512 or 256 codes a column; a slot's fixed costs, its barriers
// and its copies' issue, spread over more bytes, and its codes two or
// four adjacent 128-byte boxes of a column), the deepest that leaves
// kMinStages stages of K and kMinSlots slots in the ring (at M = 8 three
// slots of 512 codes beat five of 256 by 15-25 %); batches of even sizes
// (weight_ring.cuh, Phase::cap), at most the ring's limit (kCapRows2 at
// M > 4) or, where the rows leave the ring fewer than kMinSlots slots
// (wide N with long rows), these units: smaller batches, smaller slots.
constexpr int kQw[] = {4, 2, 1};
constexpr int kCaps[] = {kMaxCols, 96, 64, 32, 16, 8};
constexpr int kMinSlots = 3;
constexpr int kCapRows2 = 96;
constexpr int kMinStages = 4;

struct Args {
  Ring r;
  const float* z;               // zero points [N, G] or null (symmetric)
  const __nv_bfloat16* x;       // [M, K]
  const __nv_bfloat16* res;     // [M, K] or null
  const __nv_bfloat16* gamma;   // [K] or null
  __nv_bfloat16* out;           // [M, N]
  __nv_bfloat16* xout;          // [M, K] or null
  int M, K, N;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void widen(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = bf_lo(w[j]);
    f[2 * j + 1] = bf_hi(w[j]);
  }
}

// The block's M rows into Smem::xs in one pass: x32 = x (+ res), x_out =
// bf16(x32) for the block's slice of K (the 8-element groups cut over the
// blocks as the columns are), with gamma xg = x32 * gamma (else x32) and
// each warp's sums of squares of x32 in Smem::ssr [warp][row]. rstd does
// not enter the rows: it is a row's factor, and the epilogues take it on
// the sums (rstd_of). A thread takes 8 elements of every row at a time,
// all its 16-byte loads issued before its first store. PACK (groups of
// 32k codes): xg leaves as the consumers' B fragments (consume32), 32
// bytes for elements 8j.. of a row at byte 32j: the bf16 hi of the pairs
// (0, 4), (1, 5), (2, 6), (3, 7), then their remainders; and each
// 32-element chunk's sum of hi + lo after the M rows (xsum [M][K / 32]).
// Else xg stays float32 (the ring's own consumers, groups of 16 or 8).
template <bool PACK>
__device__ __forceinline__ void norm_rows(const Args& a, const Smem& S) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M, K8 = a.K / 8;
  const int pitch = a.r.pl.ph[0].ap / 4;
  const int j0 = cut(K8, blockIdx.x, gridDim.x);
  const int j1 = cut(K8, blockIdx.x + 1, gridDim.x);
  float* xsum = S.xs + M * pitch;
  // the four lanes of a 32-element chunk (K8 is a multiple of 8)
  const unsigned quad = 0xFu << (lane & ~3);
  float sq[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) sq[m] = 0.f;
  for (int j = tid; j < K8; j += kConsumerThreads) {
    uint4 xv[kRows], rv[kRows], gv;
    if (a.gamma != nullptr)
      gv = __ldg(reinterpret_cast<const uint4*>(a.gamma + 8 * j));
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (m < M) {
        const size_t at = (size_t)m * a.K + 8 * j;
        xv[m] = __ldg(reinterpret_cast<const uint4*>(a.x + at));
        if (a.res != nullptr)
          rv[m] = __ldg(reinterpret_cast<const uint4*>(a.res + at));
      }
    }
    const bool wr = a.xout != nullptr && j >= j0 && j < j1;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (m < M) {
        float v[8];
        widen(xv[m], v);
        if (a.res != nullptr) {
          float r[8];
          widen(rv[m], r);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] += r[i];
        }
        if (wr)
          *reinterpret_cast<uint4*>(a.xout + (size_t)m * a.K + 8 * j) =
              make_uint4(mma::pack_bf16(v[0], v[1]),
                         mma::pack_bf16(v[2], v[3]),
                         mma::pack_bf16(v[4], v[5]),
                         mma::pack_bf16(v[6], v[7]));
#pragma unroll
        for (int i = 0; i < 8; ++i) sq[m] = fmaf(v[i], v[i], sq[m]);
        if (a.gamma != nullptr) {
          float g[8];
          widen(gv, g);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] *= g[i];
        }
        float4* xs = reinterpret_cast<float4*>(S.xs + m * pitch + 8 * j);
        if constexpr (PACK) {
          uint32_t hi[4], lo[4];
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split2(v[i], v[i + 4], hi[i], lo[i]);
            sum += (bf_lo(hi[i]) + bf_lo(lo[i])) +
                   (bf_hi(hi[i]) + bf_hi(lo[i]));
          }
          sum += __shfl_xor_sync(quad, sum, 1);
          sum += __shfl_xor_sync(quad, sum, 2);
          if ((lane & 3) == 0) xsum[m * (a.K / 32) + j / 4] = sum;
          xs[0] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                              __uint_as_float(hi[2]), __uint_as_float(hi[3]));
          xs[1] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                              __uint_as_float(lo[2]), __uint_as_float(lo[3]));
        } else {
          xs[0] = make_float4(v[0], v[1], v[2], v[3]);
          xs[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
  }
  if (a.gamma != nullptr)
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float s = warp_sum(sq[m]);
      if (lane == 0) S.ssr[warp * kRows + m] = s;
    }
  named_sync();
}

// rstd of row m (1 without a norm): its sums of squares from Smem::ssr,
// the warps in order (after norm_rows).
__device__ __forceinline__ float rstd_of(const Args& a, const Smem& S,
                                         int m) {
  if (a.gamma == nullptr) return 1.f;
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) tot += S.ssr[w * kRows + m];
  return rsqrtf(tot / (float)a.K + a.eps);
}

// Consumers of groups of 32k codes: mma.sync.m16n8k16 with the codes as A
// (16 columns x 16 k, widened exactly to bf16 in registers) and the rows
// as B (n: the bf16 hi of 4 rows, then their remainders; NB such blocks
// for M <= 4 or 8), so a product covers 16 columns and at M <= 4 a code
// is widened once and multiplied once. Lane (g, t) takes word t of the
// chunk's 16-byte slot of columns g and g + 8 (codes 8t..8t + 7, nibbles
// (0, 4), (1, 5) for the first product, (2, 6), (3, 7) for the second:
// the same permutation of k in A and B). The codes enter as bf16(136 +
// code) (one lop3 a pair: the nibble xor 8 in the mantissa of 128), and
// each row's 136 * sum(x) over the chunks comes off the hi sums before
// the scale (xsum: the hi + lo sums of norm_rows). The eight warps split
// a stage's chunks in kChunkWarps parts (kh) and the batch's tiles of 16
// columns in kTileWarps parts (tq): consecutive chunks of one group meet
// in one warp and add up in the mma's own accumulator, the group's scale
// taken once a segment. A chunk's B fragments and codes are loaded one
// chunk ahead.
constexpr int kChunkWarps = 4;
constexpr int kTileWarps = kConsumers / kChunkWarps;

// x / n for n a power of two (lg its log), else by division
__device__ __forceinline__ int div_by(int x, int n, int lg) {
  return lg >= 0 ? x >> lg : x / n;
}

// NT tiles of 16 columns a warp, NB blocks of 4 rows; ZB: zero points,
// sum(xg_g) z[n][g] of each segment (the hi + lo sums of its chunks) added
// where its scale is
template <int NT, int NB, bool ZB>
__device__ __forceinline__ void consume32(const Args& a, const Smem& S) {
  const Ring& r = a.r;
  const Phase& p = r.pl.ph[0];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, R = r.pl.R;
  const int kh = warp / kTileWarps, tq = warp % kTileWarps;
  const uint32_t mask = r.nib_mask, bias = r.nib_bias;
  const int K32 = p.K / 32;
  // lane (g, t)'s B rows (hi for g < 4, else lo; rows past M repeat the
  // last) and the two rows whose sums its hi outputs correct (t < 2)
  const uint8_t* xb[NB];
  const float* xs0[NB];
  const float* xs1[NB];
  const float* xsum = S.xs + a.M * (p.ap / 4);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int rb = min(4 * b + (g & 3), a.M - 1);
    xb[b] = reinterpret_cast<const uint8_t*>(S.xs) + rb * p.ap + t * 32 +
            (g < 4 ? 0 : 16);
    xs0[b] = xsum + min(4 * b + 2 * (t & 1), a.M - 1) * K32;
    xs1[b] = xsum + min(4 * b + 2 * (t & 1) + 1, a.M - 1) * K32;
  }
  const float c136 = t < 2 ? 136.f : 0.f;
  const float zt = t < 2 ? 1.f : 0.f;   // the hi lanes take a row's sum
  const int rc = r.pl.red_cols;
  int u0, u1;
  units_of(p, u0, u1);
  const int kt = kStageCodes * p.q;
  const int cpg = p.gs >> 5;                  // chunks a group
  const int lg = (cpg & (cpg - 1)) ? -1 : __ffs(cpg) - 1;
  const int col0 = tq * NT * 16 + g;          // the lane's first column
  Cursor cur;
  for (int ua = u0; ua < u1; ua += p.ub) {
    const int nu = min(p.ub, u1 - ua);
    float acc[NT][NB][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        acc[i][b][0] = acc[i][b][1] = acc[i][b][2] = acc[i][b][3] = 0.f;
    for (int k0 = 0; k0 < p.K; k0 += kt, cur.next(R)) {
      sm90::mbar_wait(S.full + cur.slot, cur.par);
      sm90::mbar_wait(S.afull + cur.slot, cur.par);
      const unsigned char* base = S.ring + (size_t)cur.slot * r.pl.slot;
      const int nch = min(kt, p.K - k0) >> 5;
      int c = nch * kh / kChunkWarps;
      const int c1 = nch * (kh + 1) / kChunkWarps;
      // the part's chunks in segments of one group: the first ends where
      // its group does, the rest hold cpg chunks (the last maybe fewer)
      const int cb = k0 >> 5;                 // the slot's first chunk
      const int q0 = div_by(cb + c, cpg, lg);
      int left = cpg * (q0 + 1) - (cb + c);
      int gq = q0;                            // the segment's group
      const float* sp = reinterpret_cast<const float*>(base + p.off_sc) +
                        (q0 - div_by(cb, cpg, lg)) * p.ncp + col0;
      const uint8_t* cbase = base + col0 * kSlab + 4 * t;
      // chunk cc's rows and codes into (Bo, Wo)
      auto fetch = [&](int cc, uint32_t (&Bo)[NB][4], uint32_t (&Wo)[NT][2]) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const uint4 f = *reinterpret_cast<const uint4*>(xb[b] +
                                                          (cb + cc) * 128);
          Bo[b][0] = f.x;
          Bo[b][1] = f.y;
          Bo[b][2] = f.z;
          Bo[b][3] = f.w;
        }
        const uint8_t* cw =
            cbase + (cc >> 3) * p.rows * kSlab + (((cc & 7) ^ g) << 4);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          Wo[i][0] = *reinterpret_cast<const uint32_t*>(cw + i * 16 * kSlab);
          Wo[i][1] = *reinterpret_cast<const uint32_t*>(cw + (i * 16 + 8) *
                                                                 kSlab);
        }
      };
      float d[NT][NB][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          d[i][b][0] = d[i][b][1] = d[i][b][2] = d[i][b][3] = 0.f;
      float s0[NB], s1[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) s0[b] = s1[b] = 0.f;
      // chunk cc's products from (B, W); at a segment's end the group's
      // scale on it, less 136 sum(x) off the hi (and with zero points
      // sum(x) z[n][g] on the hi)
      auto product = [&](int cc, const uint32_t (&B)[NB][4],
                         const uint32_t (&W)[NT][2]) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          s0[b] += xs0[b][cb + cc];
          s1[b] += xs1[b][cb + cc];
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const uint32_t w0 = W[i][0], w1 = W[i][1];
          // codes of columns g (rows 0-7 of A) and g + 8 (rows 8-15)
          const uint32_t A0[4] = {(w0 & mask) ^ bias, (w1 & mask) ^ bias,
                                  ((w0 >> 4) & mask) ^ bias,
                                  ((w1 >> 4) & mask) ^ bias};
          const uint32_t A1[4] = {((w0 >> 8) & mask) ^ bias,
                                  ((w1 >> 8) & mask) ^ bias,
                                  ((w0 >> 12) & mask) ^ bias,
                                  ((w1 >> 12) & mask) ^ bias};
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            mma::mma_16816(d[i][b], A0, B[b][0], B[b][1]);
            mma::mma_16816(d[i][b], A1, B[b][2], B[b][3]);
          }
        }
        if (--left == 0 || cc + 1 == c1) {
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            const float sa = sp[i * 16], sb = sp[i * 16 + 8];
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const float e0 = c136 * s0[b], e1 = c136 * s1[b];
              acc[i][b][0] = fmaf(d[i][b][0] - e0, sa, acc[i][b][0]);
              acc[i][b][1] = fmaf(d[i][b][1] - e1, sa, acc[i][b][1]);
              acc[i][b][2] = fmaf(d[i][b][2] - e0, sb, acc[i][b][2]);
              acc[i][b][3] = fmaf(d[i][b][3] - e1, sb, acc[i][b][3]);
              d[i][b][0] = d[i][b][1] = d[i][b][2] = d[i][b][3] = 0.f;
            }
          }
          if constexpr (ZB) {
#pragma unroll
            for (int i = 0; i < NT; ++i) {
              // columns past N read a valid zero point, unused
              const int n = ua + col0 + i * 16;
              const float za = __ldg(a.z + (size_t)min(n, a.N - 1) * p.G +
                                     gq);
              const float zb = __ldg(a.z + (size_t)min(n + 8, a.N - 1) *
                                     p.G + gq);
#pragma unroll
              for (int b = 0; b < NB; ++b) {
                const float e0 = zt * s0[b], e1 = zt * s1[b];
                acc[i][b][0] = fmaf(e0, za, acc[i][b][0]);
                acc[i][b][1] = fmaf(e1, za, acc[i][b][1]);
                acc[i][b][2] = fmaf(e0, zb, acc[i][b][2]);
                acc[i][b][3] = fmaf(e1, zb, acc[i][b][3]);
              }
            }
          }
#pragma unroll
          for (int b = 0; b < NB; ++b) s0[b] = s1[b] = 0.f;
          sp += p.ncp;
          ++gq;
          left = cpg;
        }
      };
      // two register sets in turn: a chunk's loads go one chunk ahead of
      // its products, without copies between the sets
      uint32_t Bx[NB][4], Wx[NT][2], By[NB][4], Wy[NT][2];
      if (c < c1) fetch(c, Bx, Wx);
      while (c < c1) {
        if (c + 1 < c1) fetch(c + 1, By, Wy);
        product(c, Bx, Wx);
        if (++c == c1) break;
        if (c + 1 < c1) fetch(c + 1, Bx, Wx);
        product(c, By, Wy);
        ++c;
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(S.empty + cur.slot);
    }
    // a row's hi + lo (lanes t and t + 2), then the parts' partials
    // [part][block][column][4 rows], then a row's column: the parts in
    // order
    constexpr int kR4 = kRows / 2;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][b][j] += __shfl_down_sync(0xffffffffu, acc[i][b][j], 2);
        float* red = S.red + ((kh * NB + b) * rc + col0 + i * 16) * kR4 +
                     2 * t;
        if (t < 2 && col0 + i * 16 < rc) {
          red[0] = acc[i][b][0];
          red[1] = acc[i][b][1];
        }
        if (t < 2 && col0 + i * 16 + 8 < rc) {
          red[8 * kR4] = acc[i][b][2];
          red[8 * kR4 + 1] = acc[i][b][3];
        }
      }
    named_sync();
    const int m = threadIdx.x & 7;
    if (m < a.M) {
      const float rs = rstd_of(a, S, m);
      const int b = m >> 2, rr = m & 3;
      for (int i = threadIdx.x >> 3; i < nu; i += kColGroups) {
        float v = 0.f;
#pragma unroll
        for (int h = 0; h < kChunkWarps; ++h)
          v += S.red[((h * NB + b) * rc + i) * kR4 + rr];
        a.out[(size_t)m * a.N + ua + i] = __float2bfloat16(v * rs);
      }
    }
    named_sync();
  }
}

// A batch's columns out (groups of 16 or 8, the ring's consumers): thread
// (column group, row) = (tid / 8, tid % 8), a column's sum the consumer
// warps' partials in warp order, times the row's rstd.
struct Epi {
  const Args& a;
  const Smem& S;

  template <int PI>
  __device__ void pre(int, int, int, int) const {}

  template <int PI>
  __device__ void out(int, int m0, int ua, int, int cols) const {
    const int row = threadIdx.x & 7, m = m0 + row;
    if (m >= a.M) return;
    const float rs = rstd_of(a, S, m);
    const int rc = a.r.pl.red_cols;
    for (int i = threadIdx.x >> 3; i < cols; i += kColGroups)
      a.out[(size_t)m * a.N + ua + i] =
          __float2bfloat16(col_sum(S, rc, i, row) * rs);
  }
};

// consume32 for the batch's tiles of 8 columns (ncp / 8; the slab holds
// 4, 8, 12, 16 or 24, make_plan's tiles_of): NT of 16 columns a warp.
// At M > 4 (NB = 2) batches hold at most 96 columns (kCapRows2): 6 tiles
// of 16 a warp spilled there.
template <int NB, bool ZB>
__device__ __forceinline__ void consume_tiles(const Args& a, const Smem& S) {
  constexpr int kT = 2 * kTileWarps;   // 8-column tiles a 16-column one,
                                       // over the warps that split them
  const int n = a.r.pl.ph[0].ncp >> 3;
  if (n <= 4)
    consume32<4 / kT, NB, ZB>(a, S);
  else if (n <= 8)
    consume32<8 / kT, NB, ZB>(a, S);
  else if constexpr (NB == 2)
    consume32<12 / kT, NB, ZB>(a, S);
  else if (n <= 12)
    consume32<12 / kT, NB, ZB>(a, S);
  else if (n <= 16)
    consume32<16 / kT, NB, ZB>(a, S);
  else
    consume32<24 / kT, NB, ZB>(a, S);
}

// SMALL: groups of 16 or 8 codes (the ring's consumers on float32 rows);
// else groups of 32k codes (consume32 on ready A fragments), ZB with zero
// points.
template <bool SMALL, bool ZB>
__global__ void __launch_bounds__(kThreads, 1)
    qmm4_gemv(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Smem S = smem_of(sm, a.r.pl);
  init_block(S, a.r.pl);
  __syncthreads();
  // a dependent launch: the block is placed and its barriers are set up
  // while the kernel ahead ends; nothing of global memory is touched
  // before that kernel's writes are visible (it may write x, the
  // residual or even the codes, and read what this one writes)
  sm90::grid_dependency_wait();
  if (produce<0, 1, 4>(a.r, S)) return;
  norm_rows<!SMALL>(a, S);
  if constexpr (SMALL) {
    Cursor cur;
    const Epi epi{a, S};
    run_phase<0, kFormF32, 4, true, false, ZB>(a.r, 0, S, cur, epi);
  } else if (a.M <= 4) {
    consume_tiles<1, ZB>(a, S);
  } else {
    consume_tiles<2, ZB>(a, S);
  }
}

// The one phase (N columns of K codes, rows in Smem::xs) on nblk blocks:
// the ring's plan with the rows' shared memory beside it (and, for groups
// of 32k codes, the chunks' sums, and Smem::red as consume32 lays it
// out), the first of the search (kQw within kCaps) that keeps
// kMinSlots slots, else the last that keeps two.
int make_gemv_plan(Plan& pl, const void* w, const void* s, int M, int K,
                   int N, int G, int nblk) {
  pl.ph0 = 0;
  pl.nph = 1;
  const bool small = (K / G) % 32 != 0;
  // consume32's partials: 4 rows a block a column a part, in kRows-float
  // units
  const int nb = M > 4 ? 2 : 1;
  pl.red_warps = small ? 0 : kChunkWarps * nb / 2;
  const int pitch = K * 4 + 16;
  const int xs_bytes = M * pitch + (small ? 0 : M * (K / 32) * 4);
  int code = (int)cudaErrorInvalidValue;
  for (const int cap : kCaps)
    for (const int qw : kQw) {
      if (!small && M > 4 && cap > kCapRows2) continue;
      if (qw > 1 && K < kMinStages * kStageCodes * qw) continue;
      Phase& p = pl.ph[0];
      set_phase(p, w, s, N, 0, 0, K, G, 4, 0, nullptr, nullptr, 0);
      p.cap = cap;
      p.qw = qw;
      code = make_plan(pl, M, nblk, xs_bytes, 0);
      if (code == 0 && pl.R >= kMinSlots) {
        pl.ph[0].ap = pitch;
        return 0;
      }
    }
  if (code) return code;
  pl.ph[0].ap = pitch;
  return 0;
}

bool shape_ok(int M, int K, int N, int G) {
  if (M < 1 || M > kRows || (size_t)M * K * 4 > kMaxRowBytes || K % 64 ||
      N % 64 || G < 1 || K % G)
    return false;
  const int gs = K / G;
  return gs % 64 == 0 || gs == 8 || gs == 16 || gs == 32;
}

template <bool SMALL, bool ZB>
int launch(Args& a, const void* w, const void* s, int G, cudaStream_t st) {
  static int sms[kMaxDevices];
  int nblk = 0;
  int code = card_blocks(qmm4_gemv<SMALL, ZB>, sms, nblk);
  if (code) return code;
  a.r.M = a.M;
  code = make_gemv_plan(a.r.pl, w, s, a.M, a.K, a.N, G, nblk);
  if (code) return code;
  a.r.pl.ph[0].z = a.z;
  if (!encode_plan(a.r.pl)) return (int)cudaErrorInvalidValue;
  set_masks(a.r);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.r.pl.smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, qmm4_gemv<SMALL, ZB>, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// x/res/out/xout bf16 row-major, gamma bf16 [K] or null (no norm), res and
// xout may be null, all 16-byte aligned; w packed int4 codes [N, K/2]
// (16-byte aligned), scale float32 [N, G] and zbias (null: symmetric) in
// its shape, of ONE layer (the caller offsets the stacked pointers).
// Requires 1 <= M <= 8, M * K * 4 <= 200 KiB, K % 64 == 0, N % 64 == 0
// and groups of K / G codes a multiple of 64 or 8, 16 or 32; more rows
// take qmm_mma_launch
// (quant_matmul_tiled.cu).
extern "C" int qmm4_launch(const void* x, const void* res, const void* gamma,
                           const void* w, const void* scale,
                           const void* zbias, void* out, void* xout, int M,
                           int K, int N, int G, float eps, void* stream) {
  if (!shape_ok(M, K, N, G)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.z = (const float*)zbias;
  a.x = (const __nv_bfloat16*)x;
  a.res = (const __nv_bfloat16*)res;
  a.gamma = (const __nv_bfloat16*)gamma;
  a.out = (__nv_bfloat16*)out;
  a.xout = (__nv_bfloat16*)xout;
  a.M = M;
  a.K = K;
  a.N = N;
  a.eps = eps;
  cudaStream_t st = (cudaStream_t)stream;
  if ((K / G) % 32)
    return zbias ? launch<true, true>(a, w, scale, G, st)
                 : launch<true, false>(a, w, scale, G, st);
  if (zbias) return launch<false, true>(a, w, scale, G, st);
  return launch<false, false>(a, w, scale, G, st);
}

// The plan of a launch on nblk blocks, for the tests: out[0..9] = slots,
// slot bytes, shared memory, passes over the weights, q, units a batch,
// their shared-memory rows, the rows of a slab, and the fewest and the
// most columns a block takes. Returns 0 or cudaErrorInvalidValue.
extern "C" int qmm4_gemv_plan(int M, int K, int N, int G, int nblk,
                              int* out) {
  if (!shape_ok(M, K, N, G) || nblk < 1) return (int)cudaErrorInvalidValue;
  Plan pl{};
  const int code = make_gemv_plan(pl, nullptr, nullptr, M, K, N, G, nblk);
  if (code) return code;
  const Phase& p = pl.ph[0];
  int lo = N, hi = 0;
  for (int b = 0; b < nblk; ++b) {
    const int n = cut(N, b + 1, nblk) - cut(N, b, nblk);
    lo = n < lo ? n : lo;
    hi = n > hi ? n : hi;
  }
  const int v[10] = {pl.R, pl.slot, pl.smem, row_passes(M), p.q, p.ub,
                     p.ncp, p.rows, lo, hi};
  for (int j = 0; j < 10; ++j) out[j] = v[j];
  return 0;
}
