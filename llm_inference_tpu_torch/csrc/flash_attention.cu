// K9: blockwise (flash) causal prefill attention over the dense KV cache,
// bf16, int8 codes or packed int4 codes, with GQA, a sliding window and a
// logit softcap.
//
// Replaces llm_inference_tpu/ops/pallas/flash_attention.py:_flash
// (_flash_body, _flash_body4). Same function: query row t of sequence b,
// head h, at absolute position pos[b][t] attends the slots s of kv head
// h / G with s <= pos and, with a window w > 0, s > pos - w:
//   score = (q . k_s) * scale [* k_scale[s]] [-> tanh(score / c) * c]
//   online softmax over 64-slot blocks: m, l (sum of the unnormalised p)
//   p [* v_scale[s]] multiplies v_s; out = acc / l (0 where l == 0), bf16.
// Rounding points as the TPU kernel's: bf16 and int8 caches dot bf16 q
// against bf16 K (int8 codes are exact in bf16) and round p (after the V
// scale) to bf16 for the P.V product (flash_attention.py:142-160). The int4
// body (flash_attention.py:170-236) keeps q and p in float32: here q is
// bf16 already and the nibbles are exact, so Q.K^T on bf16 tensor cores is
// exact to float32 accumulation, and p is split into a bf16 high part and a
// bf16 remainder, two P.V products that carry 16 bits of p's mantissa
// (float32 p has 24: a relative error near 2^-17 per term, far below the
// bf16 output's 2^-9). The int4 codes unpack to their signed values (low
// nibble - 8, high nibble arithmetic-shifted) before the products, which is
// the TPU kernel's -8 row-sum fold written out. The softmax runs in base 2:
// a score is scaled by scale * k_scale[s] * log2(e) in one product (with a
// softcap: tanh in natural units, then the log2(e) factor) and p = exp2(x -
// m); every sum is float32.
//
// Bound on the H100 SXM: operations. A chunk does 4 * Hq * D flops per
// visible (row, slot) pair on the tensor cores (Q.K^T and P.V; the int4
// body's second P.V is not counted): a causal 2048-row chunk over the 32
// heads of LLaMA-2-7B (D = 128) is 4 x 32 x 128 x 2,098,176 = 34.4 GFLOP a
// layer, 0.035 ms at 989 TFLOP/s, while its K/V rows (2 x 32 x 2048 x 256
// bytes = 34 MB, 0.01 ms) come once from HBM.
//
// Design (mma.sync m16n8k16, bf16 in, float32 accumulate; cp.async and
// ldmatrix from mma.cuh). One block of 8 warps per (128-row query tile, q
// head, sequence), one block an SM; each warp owns 16 query rows. The tile
// reads its causal frontier off its last row's position and the window
// start off its first (rows are non-decreasing; rows past T take the last
// row's position, the TPU kernel's edge padding) and walks only the 64-slot
// blocks in between (the TPU kernel's _live clamp). The grid's slowest
// dimension runs the query tiles last to first, so the tiles with the most
// live blocks start first and the short ones fill the tail.
// - K/V ring: the tile walks its blocks in steps of PER (2 for bf16 at
//   D <= 128; 1 for the quantized bodies and at D = 256, whose registers do
//   not hold two blocks' products back to back), one __syncthreads a step,
//   over a ring of 2 PER stages filled by cp.async: the next step's copies
//   go out a block at a time, each once a block's Q.K^T products are
//   issued, and land while the step computes. bf16 rows land in row-padded
//   tiles; int8 and int4 codes land raw, with their k and v scales in the
//   same stage, and after they land the block widens them to padded bf16
//   tiles in shared memory (a second barrier), exactly, by byte-permute
//   tricks instead of int-to-float conversions. The K11 pages of the next
//   step are looked up a step ahead. Slots past the tile's frontier are
//   zero-filled by the copy (src-size 0), never read, so NaN in a retired
//   slot or an unwritten page cannot reach the P.V product; a step past the
//   last block attends a zero block that every row masks.
// - Fragments: Q's A fragments are loaded once with ldmatrix.x4 and stay in
//   registers for the whole slot loop (D = 256: reloaded from shared memory
//   per block, which the register file cannot hold); K's B fragments come by
//   ldmatrix.x4 and V's by ldmatrix.x4.trans from rows padded by 16 bytes,
//   so the eight row addresses of each 8 x 8 matrix hit distinct banks. The
//   score fragment of Q.K^T is, register for register, the A operand of P.V
//   (mma.cuh), so p never leaves registers.
// - Masking and the softcap are compile-time per step (the softcap a kernel
//   template argument, the mask a step not visible to every row of the
//   tile, _fully_visible), so a step's blocks are straight-line code and
//   the second block's loads and products issue beside the first's softmax.
//   Masked scores are selected to -1e30, so a NaN score cannot survive.
// What still holds it back (measured on the H100 by removing one cost at
// a time, PERF.md): with two warps a scheduler, Q.K^T waits on its K fragment
// loads right after each step's barrier, and the barrier drains the
// pipeline; each tile's first copies (3 %) are exposed; mma.sync runs well
// below the wgmma rate; each warp's 16 rows reload every K and V fragment
// from shared memory (one ldmatrix per two products); the quantized bodies
// widen behind a second barrier.
//
// K11 replaces llm_inference_tpu/ops/pallas/paged_flash.py:_paged_flash
// (which shares _flash_body/_flash_body4 with K9): the same function over
// a paged pool, for prefix-cache suffixes and the later chunks of a long
// paged admission. It is this kernel with the paged address policy
// (kv_addr.cuh PagedAddr): a 64-slot K/V block lies inside one page (the
// page size is a multiple of 64), so the page is looked up once per block
// and the block's rows are contiguous in the pool, as a dense head's are.
// The slot count is NB x page size.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "kv_addr.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 8;                      // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int BT = 16 * kWarps, BS = 64;       // query rows, slots per block
constexpr int kBf16 = 0, kInt8 = 1, kInt4 = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes: the Q tile, the widened K and V
// tiles of PER blocks (quantized kinds), then the ring's 2 PER stages, each
// K then V (padded bf16 tiles, or raw code rows), then the quantized kinds'
// k and v scales.
template <int D, int KIND>
struct Smem {
  static constexpr bool kQuant = KIND != kBf16;
  static constexpr int LD = D + 8;             // bf16 per padded row
  static constexpr int ROWB =                  // bytes of one cache row
      KIND == kBf16 ? 2 * D : KIND == kInt8 ? D : D / 2;
  // slot blocks a barrier: two where the registers hold two blocks'
  // products back to back without spilling (bf16 at D <= 128)
  static constexpr int PER = D == 256 || KIND != kBf16 ? 1 : 2;
  static constexpr bool QREG = D <= 128;       // Q fragments in registers
  static constexpr int TILE = BS * LD * 2;     // one padded K or V tile
  static constexpr int CODES = kQuant ? BS * ROWB : TILE;
  static constexpr int STAGE = 2 * CODES + (kQuant ? 2 * BS * 4 : 0);
  static constexpr int Q = BT * LD * 2;
  static constexpr int WORK = kQuant ? PER * 2 * TILE : 0;
  static constexpr size_t BYTES = (size_t)Q + WORK + (size_t)2 * PER * STAGE;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (e^2x + 1), on the special-function unit (relative
// error near 2^-21 away from 0, absolute near 2^-23 at 0; the softcap
// multiplies it by c)
__device__ __forceinline__ float tanh_fast(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;"
      : "=f"(r) : "f"(ex2(x * (2.f * kLog2e)) + 1.f));
  return 1.f - 2.f * r;
}

// int8 codes k, k+1 of u = word ^ 0x80808080 (biased bytes) → two exact
// bf16: the float with bits 0x4B0000uu is 2^23 + uu
__device__ __forceinline__ uint32_t int8_pair(uint32_t u, int k) {
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | k)) - 8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 | k)) - 8388736.f;
  return mma::pack_bf16(f0, f1);
}

// 16 int8 codes of one cache row → bf16 at dst (exact)
__device__ __forceinline__ void store_int8(__nv_bfloat16* dst, uint4 w) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t u = words[j] ^ 0x80808080u;
    p[2 * j] = int8_pair(u, 0);
    p[2 * j + 1] = int8_pair(u, 2);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(p[0], p[1], p[2], p[3]);
  d[1] = make_uint4(p[4], p[5], p[6], p[7]);
}

// four nibbles n (one a byte, 0..15) → bf16 pairs of n - 8 (exact): the
// bf16 with bits 0x430n is 128 + n, less 136
__device__ __forceinline__ void nibbles_bf16(uint32_t n, uint32_t& lo,
                                             uint32_t& hi) {
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t a = __byte_perm(n, 0x43434343u, 0x4140);
  uint32_t b = __byte_perm(n, 0x43434343u, 0x4342);
  const __nv_bfloat162 x =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a), off);
  const __nv_bfloat162 y =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), off);
  lo = *reinterpret_cast<const uint32_t*>(&x);
  hi = *reinterpret_cast<const uint32_t*>(&y);
}

// 16 packed int4 bytes (offset-lo split halves: byte j holds dim j in its
// low nibble, biased by 8, and dim j + D/2 in its high nibble, signed) →
// the 16 low-half dims at lo and the 16 high-half dims at hi, exact bf16
__device__ __forceinline__ void store_int4(__nv_bfloat16* lo,
                                           __nv_bfloat16* hi, uint4 w) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t pl[8], ph[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    nibbles_bf16(words[j] & 0x0F0F0F0Fu, pl[2 * j], pl[2 * j + 1]);
    nibbles_bf16(((words[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, ph[2 * j],
                 ph[2 * j + 1]);
  }
  uint4* dl = reinterpret_cast<uint4*>(lo);
  uint4* dh = reinterpret_cast<uint4*>(hi);
  dl[0] = make_uint4(pl[0], pl[1], pl[2], pl[3]);
  dl[1] = make_uint4(pl[4], pl[5], pl[6], pl[7]);
  dh[0] = make_uint4(ph[0], ph[1], ph[2], ph[3]);
  dh[1] = make_uint4(ph[4], ph[5], ph[6], ph[7]);
}

// a stage's raw K and V codes → the padded bf16 tiles at work
template <int D, int KIND>
__device__ __forceinline__ void widen(unsigned char* work,
                                      const unsigned char* st, int tid) {
  using G = Smem<D, KIND>;
  constexpr int VPR = G::ROWB / 16;            // 16-byte code vectors a row
  constexpr int N = 2 * BS * VPR;              // a multiple of kThreads
#pragma unroll
  for (int it = 0; it < N / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int kv = i / (BS * VPR);             // 0: K, 1: V
    const int r = (i / VPR) % BS, c = (i % VPR) * 16;   // byte in the row
    const uint4 w = *reinterpret_cast<const uint4*>(st + kv * G::CODES +
                                                    r * G::ROWB + c);
    __nv_bfloat16* row =
        reinterpret_cast<__nv_bfloat16*>(work + kv * G::TILE) + r * G::LD;
    if constexpr (KIND == kInt8)
      store_int8(row + c, w);
    else
      store_int4(row + c, row + D / 2 + c, w);
  }
}

// Scores of this warp's 16 query rows against a block's 64 slots: Q.K^T
// with Q's A fragments from registers (qf) or from shared memory (q_s), and
// K's B fragments by ldmatrix from the padded tile at k_s (this lane's row
// address).
template <int D, bool QREG>
__device__ __forceinline__ void qk_block(
    float (&s)[8][4], const uint32_t (&qf)[QREG ? D / 16 : 1][4],
    uint32_t q_s, uint32_t k_s) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4];
    if constexpr (QREG) {
#pragma unroll
      for (int c = 0; c < 4; ++c) qa[c] = qf[kk][c];
    } else {
      mma::ldmatrix_x4(qa, q_s + kk * 32);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {           // slot tiles 2np, 2np + 1
      uint32_t kb[4];
      mma::ldmatrix_x4(kb, k_s + (np * 16 * LD + kk * 16) * 2);
      mma::mma_16816(s[2 * np], qa, kb[0], kb[1]);
      mma::mma_16816(s[2 * np + 1], qa, kb[2], kb[3]);
    }
  }
}

// Scale a block's scores in place (k scale, softcap, base 2) and mask them
// to -1e30 where the row may not see the slot (MASKED: a block not visible
// to every row of the tile); the two rows' maxima into mx0, mx1. kss: the
// block's k scales.
template <bool QUANT, bool CAP, bool MASKED>
__device__ __forceinline__ void scale_block(float (&s)[8][4], float& mx0,
                                            float& mx1, const float* kss,
                                            int sbase, int tg, float qk,
                                            float cap_inv, float cap_log2,
                                            int p0, int p1, int window) {
  mx0 = mx1 = kNegInf;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + tg * 2;
    float c0 = qk, c1 = qk;
    if constexpr (QUANT) {
      const float2 f = *reinterpret_cast<const float2*>(kss + col);
      c0 *= f.x;
      c1 *= f.y;
    }
    float x[4] = {s[nt][0] * c0, s[nt][1] * c1, s[nt][2] * c0,
                  s[nt][3] * c1};
    if constexpr (CAP) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = tanh_fast(x[e] * cap_inv) * cap_log2;
    }
    if constexpr (MASKED) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = sbase + col + (e & 1);
        const int p = e < 2 ? p0 : p1;
        if (!(slot <= p && (window <= 0 || slot > p - window)))
          x[e] = kNegInf;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = x[e];
    mx0 = fmaxf(mx0, fmaxf(x[0], x[1]));
    mx1 = fmaxf(mx1, fmaxf(x[2], x[3]));
  }
}

// The online-softmax step over a block: its scores become p (times
// v_scale[s] for a quantized cache, vss the block's v scales), l sums p
// before the V scale, and o takes the rescale of the new running max.
template <int D, bool QUANT>
__device__ __forceinline__ void softmax_block(float (&s)[8][4], float mx0,
                                              float mx1, const float* vss,
                                              int tg, float& m0, float& m1,
                                              float& l0, float& l1,
                                              float (&o)[D / 8][4]) {
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float e0 = ex2(s[nt][0] - mn0), e1 = ex2(s[nt][1] - mn0);
    float e2 = ex2(s[nt][2] - mn1), e3 = ex2(s[nt][3] - mn1);
    rs0 += e0 + e1;
    rs1 += e2 + e3;
    if constexpr (QUANT) {
      const float2 f =
          *reinterpret_cast<const float2*>(vss + nt * 8 + tg * 2);
      e0 *= f.x;
      e1 *= f.y;
      e2 *= f.x;
      e3 *= f.y;
    }
    s[nt][0] = e0;
    s[nt][1] = e1;
    s[nt][2] = e2;
    s[nt][3] = e3;
  }
  l0 = l0 * al0 + quad_sum(rs0);
  l1 = l1 * al1 + quad_sum(rs1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    o[nd][0] *= al0;
    o[nd][1] *= al0;
    o[nd][2] *= al1;
    o[nd][3] *= al1;
  }
}

// o += p . V over a block: the score fragment is, register for register,
// the A operand of the product (mma.cuh); V's B fragments come by
// ldmatrix.trans from the padded tile at v_s. The int4 body adds the
// product of the remainder p - bf16(p).
template <int D, int KIND>
__device__ __forceinline__ void pv_block(const float (&p)[8][4],
                                         float (&o)[D / 8][4], uint32_t v_s) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk) {
    const float* f0 = p[2 * kk];
    const float* f1 = p[2 * kk + 1];
    const uint32_t ph[4] = {mma::pack_bf16(f0[0], f0[1]),
                            mma::pack_bf16(f0[2], f0[3]),
                            mma::pack_bf16(f1[0], f1[1]),
                            mma::pack_bf16(f1[2], f1[3])};
    uint32_t pl[4];
    if constexpr (KIND == kInt4) {
      const float* f[2] = {f0, f1};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* fr = f[r >> 1] + 2 * (r & 1);
        const __nv_bfloat162 hp =
            *reinterpret_cast<const __nv_bfloat162*>(&ph[r]);
        pl[r] = mma::pack_bf16(fr[0] - __low2float(hp),
                               fr[1] - __high2float(hp));
      }
    }
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {      // dim tiles 2np, 2np + 1
      uint32_t vb[4];
      mma::ldmatrix_x4_trans(vb, v_s + (kk * 16 * LD + np * 16) * 2);
      mma::mma_16816(o[2 * np], ph, vb[0], vb[1]);
      mma::mma_16816(o[2 * np + 1], ph, vb[2], vb[3]);
      if constexpr (KIND == kInt4) {
        mma::mma_16816(o[2 * np], pl, vb[0], vb[1]);
        mma::mma_16816(o[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
  }
}

// One slot block of the tile for this warp's 16 rows: scores, their scale
// and mask, the online-softmax step, the P.V product. kv_s: the block's
// bf16 K tile (V follows it); kss: its k scales (v scales follow them);
// mid() runs after the Q.K^T products are issued.
template <int D, int KIND, bool QREG, bool CAP, bool MASKED, typename Mid>
__device__ __forceinline__ void attend_block(
    const uint32_t (&qf)[QREG ? D / 16 : 1][4], uint32_t q_s, uint32_t kv_s,
    uint32_t k_lane, uint32_t v_lane, const float* kss, int sbase, int tg,
    float qk, float cap_inv, float cap_log2, int p0, int p1, int window,
    float& m0, float& m1, float& l0, float& l1, float (&o)[D / 8][4],
    Mid mid) {
  constexpr bool QUANT = KIND != kBf16;
  float sc[8][4], mx0, mx1;
  qk_block<D, QREG>(sc, qf, q_s, kv_s + k_lane);
  mid();                        // issued once the products are under way
  scale_block<QUANT, CAP, MASKED>(sc, mx0, mx1, kss, sbase, tg, qk, cap_inv,
                                  cap_log2, p0, p1, window);
  softmax_block<D, QUANT>(sc, mx0, mx1, kss + BS, tg, m0, m1, l0, l1, o);
  pv_block<D, KIND>(sc, o, kv_s + (BS * (D + 8) * 2) + v_lane);
}

template <int D, int KIND, bool CAP, typename Addr>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __nv_bfloat16* __restrict__ q,   // [B, T, Hq, D]
             const void* __restrict__ k,     // one layer's codes, as addr
             const void* __restrict__ v,
             const float* __restrict__ ks,   // one layer's scales, as addr,
             const float* __restrict__ vs,   //   or null (bf16)
             const int* __restrict__ pos,           // [B, T]
             __nv_bfloat16* __restrict__ out,       // [B, T, Hq, D]
             Addr addr, int T, int Hq, int Hkv, int S, float scale,
             float softcap, int window) {
  using G = Smem<D, KIND>;
  constexpr int LD = G::LD, ROWB = G::ROWB, PER = G::PER;
  constexpr int STAGES = 2 * PER;
  constexpr bool kQuant = G::kQuant;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* work = smem + G::Q;
  unsigned char* ring = work + G::WORK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * BT;   // longest tiles first
  const int hk = h / (Hq / Hkv);
  const int* prow = pos + (size_t)b * T;
  const int lo_pos = prow[t0];
  const int hi_pos = prow[min(t0 + BT, T) - 1];
  // this thread's two rows (fragment rows gr and gr + 8 of its warp)
  const int r0 = warp * 16 + gr, r1 = r0 + 8;
  const int p0 = prow[min(t0 + r0, T - 1)], p1 = prow[min(t0 + r1, T - 1)];

#pragma unroll
  for (int it = 0; it < BT * (D / 8) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int t = t0 + r;
    mma::cp_async16(Qs + (r * LD + c) * 2,
                    q + (((size_t)b * T + min(t, T - 1)) * Hq + h) * D + c,
                    t < T ? 16 : 0);
  }

  const int s_first = window > 0 ? max(lo_pos - window + 1, 0) / BS : 0;
  const int s_last = hi_pos < 0 ? -1 : min(hi_pos, S - 1) / BS;
  const int nblk = s_last - s_first + 1;      // live slot blocks (or <= 0)

  // where the next PER blocks to copy lie (K11: their pages, looked up a
  // step ahead of their copy); a block past the last takes the last's
  // address, and its copy reads nothing
  // (as 32-bit row and scale indices: a layer on the card holds fewer than
  // 2^32 rows of at least 32 bytes)
  uint32_t row_at[PER], scale_at[PER];
  auto locate = [&](int j0) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int sbase = (s_first + max(min(j0 + u, nblk - 1), 0)) * BS;
      row_at[u] = (uint32_t)addr.row(b, hk, sbase);
      if constexpr (kQuant) scale_at[u] = (uint32_t)addr.scale(b, hk, sbase);
    }
  };
  // block j (located in row_at[u]) and its scales into its stage, zero
  // past hi_pos, all zero past the last block (a step's padding)
  auto load = [&](int j, int u) {
    const int sbase = (s_first + j) * BS;
    const int live = j < nblk ? hi_pos : sbase - 1;
    unsigned char* st = ring + (j % STAGES) * G::STAGE;
    const size_t at = (size_t)row_at[u] * ROWB;
    const uint8_t* kt = static_cast<const uint8_t*>(k) + at;
    const uint8_t* vt = static_cast<const uint8_t*>(v) + at;
    constexpr int VPR = ROWB / 16;
    constexpr int N = BS * VPR;                // int4 at D = 64: 128 vectors
#pragma unroll
    for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      if (N % kThreads != 0 && i >= N) break;
      const int r = i / VPR, c = (i % VPR) * 16;
      const int n = sbase + r <= live ? 16 : 0;
      const int dst = kQuant ? r * ROWB + c : r * LD * 2 + c;
      mma::cp_async16(st + dst, kt + (size_t)r * ROWB + c, n);
      mma::cp_async16(st + G::CODES + dst, vt + (size_t)r * ROWB + c, n);
    }
    if constexpr (kQuant) {
      if (tid < 2 * BS) {                      // one thread a k or v scale
        const int r = tid % BS, isv = tid / BS;
        const float* src = (isv ? vs : ks) + scale_at[u] + (size_t)r * Hkv;
        mma::cp_async4(st + 2 * G::CODES + (isv * BS + r) * 4, src,
                       sbase + r <= live ? 4 : 0);
      }
    }
  };

  // the first PER blocks in flight (Q rides in the same group)
  locate(0);
#pragma unroll
  for (int u = 0; u < PER; ++u) load(u, u);
  mma::cp_async_commit();
  locate(PER);

  // per-lane byte offsets of the ldmatrix row addresses
  const uint32_t q_s = mma::smem_u32(Qs) +
      ((warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8) * 2;
  const uint32_t k_lane =
      (((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t v_lane =
      (((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8) * 2;

  // with a softcap the scores stay in natural units until after the tanh
  const float qk = CAP ? scale : scale * kLog2e;
  const float cap_inv = CAP ? 1.f / softcap : 0.f;
  const float cap_log2 = softcap * kLog2e;

  uint32_t qf[G::QREG ? D / 16 : 1][4];
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // PER blocks a step: their copies landed at the top of the step; the
  // next step's go out a block at a time, each once a block's Q.K^T
  // products are issued. A step past the last block attends a zero block
  // that every row masks (p = 0).
  for (int j = 0; j < nblk; j += PER) {
    mma::cp_async_wait<0>();                   // blocks j.. (and Q) landed
    __syncthreads();                           // ... for every thread; and
                                               // the last step's are read
    if constexpr (G::QREG) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma::ldmatrix_x4(qf[kk], q_s + kk * 32);
      }
    }
    // the next step's copies, one block's after each block's Q.K^T
    auto next = [&](int u) {
      load(j + PER + u, u);
      if (u == PER - 1) {
        mma::cp_async_commit();
        locate(j + 2 * PER);
      }
    };
    if constexpr (kQuant) {
#pragma unroll
      for (int u = 0; u < PER; ++u)
        widen<D, KIND>(work + u * 2 * G::TILE,
                       ring + ((j + u) % STAGES) * G::STAGE, tid);
      __syncthreads();
    }
    // the step's blocks visible to every row of the tile: no mask
    const int s0 = (s_first + j) * BS, s1 = s0 + PER * BS - 1;
    const bool open = s1 <= lo_pos && (window <= 0 || s0 > hi_pos - window);
    auto step = [&](auto masked) {
      auto block = [&](int u, auto mid) {
        const unsigned char* st = ring + ((j + u) % STAGES) * G::STAGE;
        attend_block<D, KIND, G::QREG, CAP, decltype(masked)::value>(
            qf, q_s, mma::smem_u32(kQuant ? work + u * 2 * G::TILE : st),
            k_lane, v_lane, reinterpret_cast<const float*>(st + 2 * G::CODES),
            s0 + u * BS, tg, qk, cap_inv, cap_log2, p0, p1, window, m0, m1,
            l0, l1, o, mid);
      };
      block(0, [&] { next(0); });
      if constexpr (PER == 2) block(1, [&] { next(1); });
    };
    if (open)
      step(std::false_type{});
    else
      step(std::true_type{});
  }

  mma::cp_async_wait<0>();            // Q's copy, when no block was live
  // rows with no live slot block have l == 0 and emit zeros
  const float i0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float i1 = l1 == 0.f ? 1.f : 1.f / l1;
  const int ta = t0 + r0, tb = t0 + r1;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + tg * 2;
    if (ta < T)
      *reinterpret_cast<uint32_t*>(
          out + (((size_t)b * T + ta) * Hq + h) * D + c) =
          mma::pack_bf16(o[nd][0] * i0, o[nd][1] * i0);
    if (tb < T)
      *reinterpret_cast<uint32_t*>(
          out + (((size_t)b * T + tb) * Hq + h) * D + c) =
          mma::pack_bf16(o[nd][2] * i1, o[nd][3] * i1);
  }
}

template <int D, int KIND, bool CAP, typename Addr>
int launch_t(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, Addr addr, int B,
             int T, int Hq, int Hkv, int S, float scale, float softcap,
             int window, cudaStream_t stream) {
  constexpr size_t smem = Smem<D, KIND>::BYTES;  // 45-198 KB
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<D, KIND, CAP, Addr>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hq, B, (T + BT - 1) / BT);
  flash_kernel<D, KIND, CAP, Addr><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, k, v, (const float*)ks, (const float*)vs,
      (const int*)pos, (__nv_bfloat16*)out, addr, T, Hq, Hkv, S, scale,
      softcap, window);
  return (int)cudaGetLastError();
}

template <int D, int KIND, typename Addr>
int launch_k(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, Addr addr, int B,
             int T, int Hq, int Hkv, int S, float scale, float softcap,
             int window, cudaStream_t st) {
  if (softcap > 0.f)
    return launch_t<D, KIND, true>(q, k, v, ks, vs, pos, out, addr, B, T, Hq,
                                   Hkv, S, scale, softcap, window, st);
  return launch_t<D, KIND, false>(q, k, v, ks, vs, pos, out, addr, B, T, Hq,
                                  Hkv, S, scale, softcap, window, st);
}

template <int D, typename Addr>
int launch(int kind, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* pos, void* out,
           Addr addr, int B, int T, int Hq, int Hkv, int S, float scale,
           float softcap, int window, cudaStream_t st) {
  if (kind == kInt8)
    return launch_k<D, kInt8>(q, k, v, ks, vs, pos, out, addr, B, T, Hq, Hkv,
                              S, scale, softcap, window, st);
  if (kind == kInt4)
    return launch_k<D, kInt4>(q, k, v, ks, vs, pos, out, addr, B, T, Hq, Hkv,
                              S, scale, softcap, window, st);
  return launch_k<D, kBf16>(q, k, v, ks, vs, pos, out, addr, B, T, Hq, Hkv,
                            S, scale, softcap, window, st);
}

template <typename Addr>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, Addr addr, int B,
             int T, int Hq, int Hkv, int S, int D, int kind, float scale,
             float softcap, int window, cudaStream_t st) {
  if (B < 1 || B > 65535 || T < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      S % BS != 0 || kind < kBf16 || kind > kInt4 ||
      (kind != kBf16) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(kind, q, k, v, ks, vs, pos, out, addr, B, T, Hq, Hkv,
                        S, scale, softcap, window, st);
    case 128:
      return launch<128>(kind, q, k, v, ks, vs, pos, out, addr, B, T, Hq,
                         Hkv, S, scale, softcap, window, st);
    case 256:
      return launch<256>(kind, q, k, v, ks, vs, pos, out, addr, B, T, Hq,
                         Hkv, S, scale, softcap, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, T, Hq, D] bf16; k/v point at one layer [B, Hkv, S, Dc] of the
// cache: kind 0 bf16 (Dc = D, ks/vs null), kind 1 int8 codes (Dc = D),
// kind 2 packed int4 codes (Dc = D / 2), the quantized kinds with ks/vs
// pointing at the layer's float32 scales [B, S, Hkv]; pos int32 [B, T],
// each row non-decreasing; out [B, T, Hq, D] bf16. D in {64, 128, 256},
// S % 64 == 0, Hq % Hkv == 0.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* pos, void* out, int B, int T,
                                 int Hq, int Hkv, int S, int D, int kind,
                                 float scale, float softcap, int window,
                                 void* stream) {
  return dispatch(q, k, v, ks, vs, pos, out, DenseAddr{Hkv, S}, B, T, Hq,
                  Hkv, S, D, kind, scale, softcap, window,
                  (cudaStream_t)stream);
}

// K11: as flash_attn_launch, over one layer of a paged pool: k/v point at
// the layer's codes [P, Hkv, ps, Dc], ks/vs at its float32 scales
// [P, ps, Hkv] (or null), pt at the page table [B, NB] int32, ps % 64 ==
// 0; the slot count is NB * ps.
extern "C" int paged_flash_attn_launch(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* pt,
                                       const void* pos, void* out, int B,
                                       int T, int Hq, int Hkv, int NB, int ps,
                                       int D, int kind, float scale,
                                       float softcap, int window,
                                       void* stream) {
  if (NB < 1 || ps < BS || ps % BS != 0 || !pt)
    return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, ks, vs, pos, out,
                  PagedAddr{Hkv, NB, ps, (const int*)pt}, B, T, Hq, Hkv,
                  NB * ps, D, kind, scale, softcap, window,
                  (cudaStream_t)stream);
}
