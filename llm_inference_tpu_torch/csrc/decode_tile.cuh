// The decode-attention tile walk shared by K2/K5/K10a/K10b
// (decode_attention.cu) and K12's attention phase (layer_fused.cu): 256
// threads take one share [lo, hi] of a kv head's live slots, its G query
// heads in shared memory, and leave one softmax state (a running max per
// head in shared memory, accumulators and sums in registers); `finish`
// adds the threads' parts up and, with several shares a head, writes the
// state for the last share of the head to finish to merge.
//
// The walk goes over the share in tiles of T slots (about 8 KB of K rows:
// 32 of bf16 at D = 128, 64 of int8 and int4) through a ring of two tiles
// in shared memory: every row of a tile (and its two scales) is copied by
// 16-byte (4-byte) cp.async, row addresses from the address policy
// (kv_addr.cuh), the next tile's while this one is computed. Slots past
// the share are neither copied nor read: a stale row or a null page may
// hold NaN. A tile is computed in three steps between barriers, none with
// a chain per slot:
//   scores  TPS threads a slot (4 or 8: one pass over the tile where the
//           row allows) read its row as 16-byte chunks (a quarter warp
//           reads 128 contiguous bytes), widen int8/int4 codes by the 2^23
//           mantissa trick, dot them with q (float32 in shared memory, laid
//           out so that a slot's lanes read consecutive 16-byte words) for
//           each head and add up in log2(TPS) shuffles; scale, K scale and
//           softcap in the plain version's order. The tile's max of each
//           head: a shuffle max over a warp's slots and one shared-memory
//           atomicMax a warp;
//   softmax a (head, slot) a thread: alpha = exp(m - m_new) once a tile,
//           p = exp(s - m_new); p (bf16 cache) or p * v_scale (int8)
//           rounded to bf16, p * v_scale kept float32 (int4), and p itself
//           for the sum l (before the V scale);
//   P.V     each thread owns a piece of a V row (8 bytes for one head, 4 of
//           packed int4; 4 and 2 for up to 8 heads) for every head and a
//           group of the tile's slots, two slots at a time, and rescales
//           its accumulators and its part of l by alpha once a tile.
// At the end the slot groups' accumulators and sums add up through shared
// memory (one softmax state a share, no merge of exponentials). With
// NSPLIT > 1 shares a head each leaves its state in a scratch buffer and
// the last share of the head to finish (an acq_rel atomic count, reset by
// it) merges the NSPLIT states into the output. GM = 1 (G = 1, LLaMA-2-7B's
// case: the loops over heads and their registers vanish) or kMaxG.
// BAR names the barrier of the 256 threads: 0 (__syncthreads, a block of
// its own) or a named barrier (K12's consumer warps).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace dtile {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kBf16 = 0, kInt8 = 1, kInt4 = 2;   // cache kinds
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

template <int D, int KIND, int GM = kMaxG>
struct Geometry {
  // bytes of a cache row, slots of a tile
  static constexpr int ROW = KIND == kBf16 ? 2 * D : KIND == kInt8 ? D : D / 2;
  static constexpr int T = 8192 / ROW < 32 ? 32 : 8192 / ROW > 64 ? 64
                                                   : 8192 / ROW;
  // scores: 16-byte chunks of a row, threads a slot, chunks a thread,
  // slots a pass of the block
  static constexpr int CPR = ROW / 16;
  static constexpr int TPS = CPR < kThreads / T ? CPR : kThreads / T;
  static constexpr int CPT = CPR / TPS;
  static constexpr int SPP = kThreads / TPS;
  // P.V: bytes of a row a thread owns (one head: 8 of bf16 or int8, 4 of
  // packed int4, the fastest on the H100; 8 heads' accumulators: 4, and 2
  // of packed int4), pieces of a row, slot groups, dims a piece
  static constexpr int PB = GM == 1 ? (KIND == kInt4 ? 4 : 8)
                                    : (KIND == kInt4 ? 2 : 4);
  static constexpr int WPR = ROW / PB;
  static constexpr int NGRP = kThreads / WPR;
  static constexpr int DPW = KIND == kBf16 ? PB / 2 : KIND == kInt8 ? PB
                                                                    : 2 * PB;
  // one stage of the ring: K rows, V rows, then (quantized) K and V scales
  static constexpr int CODES = T * ROW;
  static constexpr int STAGE = 2 * CODES + (KIND == kBf16 ? 0 : 2 * T * 4);
  static_assert(CPR % TPS == 0 && 32 % TPS == 0, "score mapping");
  static_assert(kThreads % WPR == 0 && T % 32 == 0, "P.V mapping");
  static_assert(NGRP * (D + 1) * 4 <= kStages * STAGE,
                "the P.V sums fit the ring");
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Exact widening without I2F (a quarter-rate instruction): a value u in
// [0, 255] placed in the low bits of 2^23's mantissa is the float 2^23 + u.
// Four signed int8 codes of w (code + 128 after the xor; the byte permute's
// selector nibbles are all below 8, so no sign replication is asked for).
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540u | j)) -
           8388736.f;                       // 2^23 + 128
}

// NB packed int4 bytes of w (NB = 2 or 4): low-half values (byte & 15) - 8
// into lo, high-half values byte >> 4 (arithmetic) into hi. The low nibbles
// hold value + 8 as stored; the high ones after flipping their top bit;
// both then widen a byte at a time as above.
template <int NB>
__device__ __forceinline__ void i4x2n(uint32_t w, float* lo, float* hi) {
  const uint32_t l = w & 0x0f0f0f0fu;
  const uint32_t h = ((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    lo[j] = __uint_as_float(__byte_perm(l, 0x4b000000u, 0x7540u | j)) -
            8388616.f;                      // 2^23 + 8
    hi[j] = __uint_as_float(__byte_perm(h, 0x4b000000u, 0x7540u | j)) -
            8388616.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// q in shared memory as float32, laid out for the score step: the four
// dims that chunk c's j-th FMA quad needs are float4 j * CPR + c of the
// head's row, so the lanes of a slot, which take consecutive chunks, read
// consecutive 16-byte words (a chunk-major row would put them 32-64 bytes
// apart, a 2- to 4-way bank conflict on every read). The first dim of that
// float4: bf16 chunks hold 8 dims (j < 2), int8 16 (j < 4), packed int4
// bytes 16 low-half and 16 high-half dims (j < 4, then 4 <= j < 8).
template <int D, int KIND>
__device__ __forceinline__ int q_dim(int c, int j) {
  if constexpr (KIND == kBf16) return 8 * c + 4 * j;
  else if constexpr (KIND == kInt8) return 16 * c + 4 * j;
  else return (j < 4 ? 16 * c + 4 * j : D / 2 + 16 * c + 4 * (j - 4));
}

// q . k over one 16-byte chunk c of a K row (qg: head g's q as above), two
// sums for two FMA chains
template <int D, int KIND>
__device__ __forceinline__ void chunk_dot(const float* qg, int c, uint4 kc,
                                          float& d0, float& d1) {
  constexpr int CPR = Geometry<D, KIND>::CPR;
  const uint32_t w[4] = {kc.x, kc.y, kc.z, kc.w};
  if constexpr (KIND == kBf16) {             // dims 8c .. 8c + 7
#pragma unroll
    for (int u = 0; u < 4; u += 2) {
      const float4 qa = ld4(qg + 4 * ((u / 2) * CPR + c));
      d0 = fmaf(qa.x, __uint_as_float(w[u] << 16), d0);
      d1 = fmaf(qa.y, __uint_as_float(w[u] & 0xffff0000u), d1);
      d0 = fmaf(qa.z, __uint_as_float(w[u + 1] << 16), d0);
      d1 = fmaf(qa.w, __uint_as_float(w[u + 1] & 0xffff0000u), d1);
    }
  } else if constexpr (KIND == kInt8) {      // dims 16c .. 16c + 15
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float f[4];
      i8x4(w[u], f);
      const float4 qa = ld4(qg + 4 * (u * CPR + c));
      d0 = fmaf(qa.x, f[0], d0);
      d1 = fmaf(qa.y, f[1], d1);
      d0 = fmaf(qa.z, f[2], d0);
      d1 = fmaf(qa.w, f[3], d1);
    }
  } else {              // bytes 16c .. 16c + 15: dims 16c.. and D/2 + 16c..
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float lo[4], hi[4];
      i4x2n<4>(w[u], lo, hi);
      const float4 ql = ld4(qg + 4 * (u * CPR + c));
      const float4 qh = ld4(qg + 4 * ((4 + u) * CPR + c));
      d0 = fmaf(ql.x, lo[0], d0);
      d1 = fmaf(ql.y, lo[1], d1);
      d0 = fmaf(ql.z, lo[2], d0);
      d1 = fmaf(ql.w, lo[3], d1);
      d0 = fmaf(qh.x, hi[0], d0);
      d1 = fmaf(qh.y, hi[1], d1);
      d0 = fmaf(qh.z, hi[2], d0);
      d1 = fmaf(qh.w, hi[3], d1);
    }
  }
}

// P.V's unit, piece w of a row (PB bytes), widened to its values: bf16
// pairs, int8 codes, or packed int4 bytes' low-half values then their
// high-half ones; and the dim of each value
template <int KIND, int PB>
__device__ __forceinline__ void widen_piece(const unsigned char* row, int w,
                                            float* f) {
  if constexpr (PB == 2) {                  // int4 only
    i4x2n<2>(reinterpret_cast<const uint16_t*>(row)[w], f, f + 2);
  } else {
    uint32_t x[PB / 4];
    if constexpr (PB == 4) {
      x[0] = reinterpret_cast<const uint32_t*>(row)[w];
    } else {
      const uint2 v = reinterpret_cast<const uint2*>(row)[w];
      x[0] = v.x;
      x[1] = v.y;
    }
#pragma unroll
    for (int u = 0; u < PB / 4; ++u) {
      if constexpr (KIND == kBf16) {
        f[2 * u] = __uint_as_float(x[u] << 16);
        f[2 * u + 1] = __uint_as_float(x[u] & 0xffff0000u);
      } else if constexpr (KIND == kInt8) {
        i8x4(x[u], f + 4 * u);
      } else {
        i4x2n<4>(x[u], f + 4 * u, f + PB + 4 * u);
      }
    }
  }
}

template <int D, int KIND, int PB>
__device__ __forceinline__ int piece_dim(int w, int j) {
  if constexpr (KIND == kBf16) return PB / 2 * w + j;
  else if constexpr (KIND == kInt8) return PB * w + j;
  else return (j < PB ? 0 : D / 2 - PB) + PB * w + j;
}

// a float's order as an int (the tile max by atomicMax in shared memory)
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_ordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// atomicAdd with release and acquire semantics at device scope: the
// block's writes before the barrier that precedes it are visible to the
// block that reads the count it leaves, and that block (after a barrier)
// sees every write released before the counts it read (the fence-free
// form of __threadfence, atomicAdd, __threadfence)
__device__ __forceinline__ int add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// an output element: bf16 (K2/K5/K10) or float32 (K12)
__device__ __forceinline__ void put(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);
}
__device__ __forceinline__ void put(float* o, float v) { *o = v; }

// Merge a head's NSPLIT states ph[zz * stride], each [G][D] accumulators,
// [G] maxima and [G] sums, written by other SMs (so read through L2), into
// out [G][D]: MW states at a time with all their loads in flight. The
// loads of 8 cost no more registers than the bf16 one-head kernel has to
// spare, and push the others past 128 into spills: 4 there, 2 for 8
// heads (their accumulators).
template <int MW, typename OutT>
__device__ __forceinline__ void merge_states(const float* ph, int stride,
                                             int nsplit, int G, int D,
                                             int tid, OutT* out) {
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mm = kNegInf, ll = 0.f, aa = 0.f;
    for (int z0 = 0; z0 < nsplit; z0 += MW) {
      float mz[MW], lz[MW], az[MW];
#pragma unroll
      for (int u = 0; u < MW; ++u) {
        mz[u] = kNegInf;
        lz[u] = az[u] = 0.f;
        if (z0 + u < nsplit) {
          const float* st = ph + (size_t)(z0 + u) * stride;
          mz[u] = __ldcg(st + G * D + g);
          lz[u] = __ldcg(st + G * D + G + g);
          az[u] = __ldcg(st + i);
        }
      }
      float mc = mm;
#pragma unroll
      for (int u = 0; u < MW; ++u) mc = fmaxf(mc, mz[u]);
      const float rescale = expf(mm - mc);
      ll *= rescale;
      aa *= rescale;
#pragma unroll
      for (int u = 0; u < MW; ++u) {
        const float f = expf(mz[u] - mc);
        ll = fmaf(lz[u], f, ll);
        aa = fmaf(az[u], f, aa);
      }
      mm = mc;
    }
    put(out + i, aa / ll);
  }
}

template <int BAR>
__device__ __forceinline__ void sync() {
  if constexpr (BAR == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" :: "n"(BAR), "n"(kThreads) : "memory");
}

// The walk's shared memory: [kStages][STAGE] ring, then q [G][D] (q_dim
// order), scores then p [G][T], p before the V scale [G][T], and per head:
// alpha, the running max, the tile's max (ordered int); the last-arriver
// flag.
struct Shared {
  unsigned char* ring;
  float* q;
  float* s;
  float* pe;
  float* alpha;
  float* m;
  int* tmax;
  int* last;
};

template <int D, int KIND, int GM>
__host__ __device__ constexpr int shared_bytes(int G) {
  using C = Geometry<D, KIND, GM>;
  return kStages * C::STAGE + 4 * (G * (D + 2 * C::T) + 3 * kMaxG + 4);
}

template <int D, int KIND, int GM>
__device__ __forceinline__ Shared shared_of(unsigned char* smem, int G) {
  using C = Geometry<D, KIND, GM>;
  Shared sh;
  sh.ring = smem;
  sh.q = reinterpret_cast<float*>(smem + kStages * C::STAGE);
  sh.s = sh.q + G * D;
  sh.pe = sh.s + G * C::T;
  sh.alpha = sh.pe + G * C::T;
  sh.m = sh.alpha + kMaxG;
  sh.tmax = reinterpret_cast<int*>(sh.m + kMaxG);
  sh.last = sh.tmax + kMaxG;
  return sh;
}

// Walks slots [lo, hi] of (sequence b, kv head h) (none when hi < lo) into
// acc/lsum (per head: DPW values of this thread's piece, its part of l)
// and sh.m. The caller has written sh.q, sh.m (the running max to start
// from) and sh.tmax (ordered -inf), and set acc and lsum.
template <int D, int KIND, int GM, int BAR, typename Addr>
__device__ __forceinline__ void walk(
    const Shared& sh, const uint8_t* kb, const uint8_t* vb, const float* ks,
    const float* vs, const Addr& addr, int b, int h, int lo, int hi, int G,
    float scale, float softcap,
    float (&acc)[GM][Geometry<D, KIND, GM>::DPW], float (&lsum)[GM]) {
  using C = Geometry<D, KIND, GM>;
  constexpr int T = C::T;
  constexpr bool kQuant = KIND != kBf16;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int ntiles = hi >= lo ? (hi - lo + T) / T : 0;
  unsigned char* ring = sh.ring;
  const float* s_q = sh.q;
  float* s_s = sh.s;
  float* s_pe = sh.pe;
  float* s_alpha = sh.alpha;
  float* s_m = sh.m;
  int* s_tmax = sh.tmax;

  // tile t of the share into stage t % kStages: only its live rows
  auto issue = [&](int t) {
    unsigned char* st = ring + (t % kStages) * C::STAGE;
    const int s0 = lo + t * T;
    const int n = min(T, hi - s0 + 1);
#pragma unroll
    for (int i = 0; i < (T * C::CPR + kThreads - 1) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / C::CPR;
      const int col = (c % C::CPR) * 16;
      if (r < n) {                          // (r < T: n <= T)
        const size_t src = addr.row(b, h, s0 + r) * C::ROW + col;
        mma::cp_async16(st + r * C::ROW + col, kb + src, 16);
        mma::cp_async16(st + C::CODES + r * C::ROW + col, vb + src, 16);
      }
    }
    if constexpr (kQuant) {
      float* sc = reinterpret_cast<float*>(st + 2 * C::CODES);
      if (tid < n) {
        const size_t si = addr.scale(b, h, s0 + tid);
        mma::cp_async4(sc + tid, ks + si, 4);
        mma::cp_async4(sc + T + tid, vs + si, 4);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) issue(t);
    mma::cp_async_commit();
  }

  // this thread's P.V share: piece pw of the V rows of slots pg, pg + NGRP..
  const int pw = tid % C::WPR;
  const int pg = tid / C::WPR;
  // its score share: CPT chunks of the row of slot sr (+ SPP..)
  const int sp = tid % C::TPS;
  const int sr = tid / C::TPS;

  for (int t = 0; t < ntiles; ++t) {
    mma::cp_async_wait<kStages - 2>();      // tile t's rows (this thread's)
    sync<BAR>();                            // ... all landed; stage t - 1 free
    if (t + kStages - 1 < ntiles) issue(t + kStages - 1);
    mma::cp_async_commit();
    const unsigned char* st = ring + (t % kStages) * C::STAGE;
    const float* sks = reinterpret_cast<const float*>(st + 2 * C::CODES);
    const int n = min(T, hi - (lo + t * T) + 1);

    // scores of slots r < n for each head into s_s[g][r], the tile's max
    // into s_tmax[g]: a shuffle max over a warp's slots, an atomic a warp
#pragma unroll
    for (int pass = 0; pass < (T + C::SPP - 1) / C::SPP; ++pass) {
      if (pass * C::SPP >= n) break;        // uniform over the block
      const int r = pass * C::SPP + sr;
      const bool live = r < n;
      // chunk i of this lane: sp + TPS * ci, the slots of a quarter warp
      // starting at different ci so that it reads 128 bytes in one go
      uint4 kc[C::CPT];
      int ci[C::CPT];
#pragma unroll
      for (int i = 0; i < C::CPT; ++i) {
        ci[i] = sp + ((i + r) & (C::CPT - 1)) * C::TPS;
        kc[i] = make_uint4(0u, 0u, 0u, 0u);
        if (live)
          kc[i] = *reinterpret_cast<const uint4*>(st + r * C::ROW + ci[i] * 16);
      }
      float ksr = 1.f;
      if constexpr (kQuant) ksr = live ? sks[r] : 0.f;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int i = 0; i < C::CPT; ++i)
          chunk_dot<D, KIND>(s_q + g * D, ci[i], kc[i], d0, d1);
        float dot = d0 + d1;
#pragma unroll
        for (int o = C::TPS / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        float sc = dot * scale;
        if constexpr (kQuant) sc *= ksr;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        if (live && sp == 0) s_s[g * T + r] = sc;
        float mt = live ? sc : kNegInf;
#pragma unroll
        for (int o = C::TPS; o < 32; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        if (lane == 0) atomicMax(s_tmax + g, ordered(mt));
      }
    }
    sync<BAR>();

    // softmax of the tile, a (head, slot) a thread: alpha = exp(m - m_new)
    // once a tile, p = exp(s - m_new); p (bf16 cache) or p * v_scale (int8)
    // rounded to bf16, p * v_scale kept float32 (int4, the TPU kernel's
    // float32 PV dot); p itself for the sum l (before the V scale)
    for (int i = tid; i < G * T; i += kThreads) {
      const int g = i / T;
      const int r = i % T;
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, from_ordered(s_tmax[g]));
      if (r == 0) s_alpha[g] = expf(m_old - m_new);
      if (r < n) {
        const float pe = expf(s_s[i] - m_new);
        float ps = pe;
        if constexpr (kQuant) ps *= sks[T + r];
        s_pe[i] = pe;
        s_s[i] = KIND == kInt4 ? ps : bf16_round(ps);
      }
    }
    sync<BAR>();
    if (tid < G) {                          // read above; next used after 2
      s_m[tid] = fmaxf(s_m[tid], from_ordered(s_tmax[tid]));   // barriers
      s_tmax[tid] = ordered(kNegInf);
    }

    // P.V: rescale once a tile, then this thread's piece of its slots' rows,
    // two slots at a time (a loop that nvcc 12.8 unrolled by 4 itself gave
    // wrong sums: it stays rolled)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float a = s_alpha[g];
      lsum[g] *= a;
#pragma unroll
      for (int j = 0; j < C::DPW; ++j) acc[g][j] *= a;
    }
    const unsigned char* vt = st + C::CODES;
    int r = pg;
#pragma unroll 1
    for (; r + C::NGRP < n; r += 2 * C::NGRP) {
      float v0[C::DPW], v1[C::DPW];
      widen_piece<KIND, C::PB>(vt + r * C::ROW, pw, v0);
      widen_piece<KIND, C::PB>(vt + (r + C::NGRP) * C::ROW, pw, v1);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float p0 = s_s[g * T + r];
        const float p1 = s_s[g * T + r + C::NGRP];
        lsum[g] += s_pe[g * T + r] + s_pe[g * T + r + C::NGRP];
#pragma unroll
        for (int j = 0; j < C::DPW; ++j)
          acc[g][j] = fmaf(p1, v1[j], fmaf(p0, v0[j], acc[g][j]));
      }
    }
    if (r < n) {
      float v0[C::DPW];
      widen_piece<KIND, C::PB>(vt + r * C::ROW, pw, v0);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float p0 = s_s[g * T + r];
        lsum[g] += s_pe[g * T + r];
#pragma unroll
        for (int j = 0; j < C::DPW; ++j) acc[g][j] = fmaf(p0, v0[j], acc[g][j]);
      }
    }
  }
}

// Adds the threads' parts of the walk's state up through the drained ring
// and writes it: with one share a head, acc / l into out[head][G][D]; else
// the share's state ([G][D] accumulators, [G] maxima, [G] sums; an empty
// share leaves m = -1e30 and l = 0, weight 0 in the merge) into part
// [head][nsplit][G][D + 2], and the head's last share to finish merges
// them into out (done[head]: zero between launches, left so).
template <int D, int KIND, int GM, int BAR, typename OutT>
__device__ __forceinline__ void finish(
    const Shared& sh, float (&acc)[GM][Geometry<D, KIND, GM>::DPW],
    float (&lsum)[GM], int G, int nsplit, int z, size_t head, float* part,
    int* done, OutT* out) {
  using C = Geometry<D, KIND, GM>;
  const int tid = threadIdx.x;
  const int pw = tid % C::WPR;
  const int pg = tid / C::WPR;
  // [NGRP][D] accumulators, then [NGRP] sums
  mma::cp_async_wait<0>();
  float* red = reinterpret_cast<float*>(sh.ring);
  const int stride = G * (D + 2);
  float* pz = nsplit > 1 ? part + (head * nsplit + z) * stride : nullptr;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    sync<BAR>();                            // ring drained / red read
#pragma unroll
    for (int j = 0; j < C::DPW; ++j)
      red[pg * D + piece_dim<D, KIND, C::PB>(pw, j)] = acc[g][j];
    if (pw == 0) red[C::NGRP * D + pg] = lsum[g];
    sync<BAR>();
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < C::NGRP; ++i) l += red[C::NGRP * D + i];
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < C::NGRP; ++i) a += red[i * D + d];
      if (nsplit == 1)
        put(out + (head * G + g) * D + d, a / l);
      else
        pz[g * D + d] = a;
    }
    if (nsplit > 1 && tid == 0) {
      pz[G * D + g] = sh.m[g];
      pz[G * D + G + g] = l;
    }
  }
  if (nsplit == 1) return;
  sync<BAR>();                              // the share's state is written;
  if (tid == 0)                             // released to the head's other
    *sh.last = add_acq_rel(done + head, 1) == nsplit - 1;   // shares,
  sync<BAR>();                                      // theirs acquired
  if (!*sh.last) return;
  merge_states<(GM > 1 ? 2 : KIND == kBf16 ? 8 : 4)>(
      part + head * nsplit * stride, stride, nsplit, G, D, tid,
      out + head * G * D);
  if (tid == 0) done[head] = 0;             // ready for the next launch
}

}  // namespace dtile
