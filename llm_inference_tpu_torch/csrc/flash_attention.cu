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
// the TPU kernel's -8 row-sum fold written out.
//
// Bound on the H100 SXM: operations for a long prefill. A causal 2048-row
// chunk over 32 heads of LLaMA-2-7B (D = 128) does 4 x 32 x 2048 x 1024 x
// 128 = 34 GFLOP per layer on the tensor cores, 0.035 ms at 989 TFLOP/s;
// it reads each live K/V block once per 64-row query block from L2 and
// the cache rows (2 x 32 x 2048 x 256 bytes = 34 MB, 0.01 ms) once from
// HBM.
//
// Design. One block of 4 warps per (64-row query tile, q head, sequence);
// the kv head is h / G (GQA without repeated K/V). The block reads the
// tile's causal frontier off its last row's position and the window start
// off its first (rows are non-decreasing; rows past T take the last row's
// position, the TPU kernel's edge padding), and loops only over the
// 64-slot blocks in between (the TPU kernel's _live clamp). Q, then each
// K/V block, go through shared memory (cp.async for bf16; codes are
// widened to bf16 on the way in); each warp owns 16 query rows and keeps
// their running max, sum and [16, D] float32 accumulator in registers.
// Q.K^T and P.V run as mma.sync m16n8k16 (bf16 in, float32 accumulate);
// the score fragment of Q.K^T is, register for register, the A operand of
// P.V (mma.cuh), so p never leaves registers. The element mask is applied
// only to blocks that are not visible to every row of the tile
// (_fully_visible). Slots past the tile's frontier are zero-filled on the
// way in, so a NaN left in a retired slot cannot reach the product. Known
// weakness: one K/V buffer, so loads and products of a block do not
// overlap within a block (other resident blocks hide part of it).
//
// K11 replaces llm_inference_tpu/ops/pallas/paged_flash.py:_paged_flash
// (which shares _flash_body/_flash_body4 with K9): the same function over
// a paged pool, for prefix-cache suffixes and the later chunks of a long
// paged admission. It is this kernel with the paged address policy
// (kv_addr.cuh PagedAddr): a 64-slot K/V tile lies inside one page (the
// page size is a multiple of 64), so the page is looked up once per tile
// and the tile's rows are contiguous in the pool, as a dense head's are.
// The slot count is NB x page size.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "kv_addr.cuh"
#include "mma.cuh"

namespace {

constexpr int BT = 64, BS = 64;               // query rows, slots per block
constexpr int kThreads = 128;                 // 4 warps x 16 query rows
constexpr int kBf16 = 0, kInt8 = 1, kInt4 = 2;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BT + 2 * BS) * (D + 8) * 2 + 2 * BS * sizeof(float);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 codes (int8) of one cache row → bf16 at dst (exact)
__device__ __forceinline__ void store_int8(__nv_bfloat16* dst, uint4 w) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t wd = words[j >> 1];
    const int b0 = 2 * (j & 1);
    p[j] = mma::exact_bf16_bits((float)(int8_t)(wd >> (8 * b0))) |
           (mma::exact_bf16_bits((float)(int8_t)(wd >> (8 * b0 + 8))) << 16);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(p[0], p[1], p[2], p[3]);
  d[1] = make_uint4(p[4], p[5], p[6], p[7]);
}

// 16 packed int4 bytes (offset-lo split halves) → the 16 low-half dims at
// lo and the 16 high-half dims at hi, as exact bf16
__device__ __forceinline__ void store_int4(__nv_bfloat16* lo,
                                           __nv_bfloat16* hi, uint4 w) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t pl[8], ph[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t wd = words[j >> 1];
    const int b0 = 2 * (j & 1);
    const int x0 = (int)(int8_t)(wd >> (8 * b0));
    const int x1 = (int)(int8_t)(wd >> (8 * b0 + 8));
    pl[j] = mma::exact_bf16_bits((float)((x0 & 15) - 8)) |
            (mma::exact_bf16_bits((float)((x1 & 15) - 8)) << 16);
    ph[j] = mma::exact_bf16_bits((float)(x0 >> 4)) |
            (mma::exact_bf16_bits((float)(x1 >> 4)) << 16);
  }
  uint4* dl = reinterpret_cast<uint4*>(lo);
  uint4* dh = reinterpret_cast<uint4*>(hi);
  dl[0] = make_uint4(pl[0], pl[1], pl[2], pl[3]);
  dl[1] = make_uint4(pl[4], pl[5], pl[6], pl[7]);
  dh[0] = make_uint4(ph[0], ph[1], ph[2], ph[3]);
  dh[1] = make_uint4(ph[4], ph[5], ph[6], ph[7]);
}

template <int D, int KIND, typename Addr>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __nv_bfloat16* __restrict__ q,   // [B, T, Hq, D]
             const void* __restrict__ k,     // one layer's codes, as addr
             const void* __restrict__ v,
             const float* __restrict__ ks,   // one layer's scales, as addr,
             const float* __restrict__ vs,   //   or null (bf16)
             const int* __restrict__ pos,           // [B, T]
             __nv_bfloat16* __restrict__ out,       // [B, T, Hq, D]
             Addr addr, int T, int Hq, int Hkv, int S, float scale,
             float softcap, int window) {
  constexpr int LD = D + 8;                          // bf16 per shared row
  constexpr bool kQuant = KIND != kBf16;
  constexpr int ROWB = KIND == kBf16 ? 2 * D : KIND == kInt8 ? D : D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BT * LD;
  __nv_bfloat16* Vs = Ks + BS * LD;
  float* kss = reinterpret_cast<float*>(Vs + BS * LD);
  float* vss = kss + BS;
  const unsigned short* Vh = reinterpret_cast<const unsigned short*>(Vs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int t0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int* prow = pos + (size_t)b * T;
  const int lo_pos = prow[t0];
  const int hi_pos = prow[min(t0 + BT, T) - 1];
  // this thread's two rows (fragment rows gr and gr + 8 of its warp)
  const int r0 = warp * 16 + gr, r1 = r0 + 8;
  const int p0 = prow[min(t0 + r0, T - 1)], p1 = prow[min(t0 + r1, T - 1)];

  for (int i = tid; i < BT * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int t = t0 + r;
    mma::cp_async16(Qs + r * LD + c,
                    q + (((size_t)b * T + min(t, T - 1)) * Hq + h) * D + c,
                    t < T ? 16 : 0);
  }
  mma::cp_async_commit();

  const int s_first = window > 0 ? max(lo_pos - window + 1, 0) / BS : 0;
  const int s_last = hi_pos < 0 ? -1 : min(hi_pos, S - 1) / BS;

  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int sb = s_first; sb <= s_last; ++sb) {
    const int sbase = sb * BS;
    // the tile's 64 rows are contiguous: one address (one page lookup)
    const size_t trow = addr.row(b, hk, sbase) * ROWB;
    const uint8_t* kt = static_cast<const uint8_t*>(k) + trow;
    const uint8_t* vt = static_cast<const uint8_t*>(v) + trow;
    __syncthreads();                   // the previous block's K/V are read
    if constexpr (KIND == kBf16) {
      for (int i = tid; i < BS * (D / 8); i += kThreads) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        const int slot = sbase + r;
        const int n = slot <= hi_pos ? 16 : 0;     // zero past the frontier
        mma::cp_async16(Ks + r * LD + c, kt + (size_t)r * ROWB + 2 * c, n);
        mma::cp_async16(Vs + r * LD + c, vt + (size_t)r * ROWB + 2 * c, n);
      }
    } else {
      constexpr int VPR = ROWB / 16;               // 16-byte vectors a row
      for (int i = tid; i < BS * VPR; i += kThreads) {
        const int r = i / VPR, c = (i % VPR) * 16;  // byte offset in the row
        const int slot = sbase + r;
        uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
        if (slot <= hi_pos) {
          kw = __ldg(reinterpret_cast<const uint4*>(kt + (size_t)r * ROWB + c));
          vw = __ldg(reinterpret_cast<const uint4*>(vt + (size_t)r * ROWB + c));
        }
        if constexpr (KIND == kInt8) {
          store_int8(Ks + r * LD + c, kw);
          store_int8(Vs + r * LD + c, vw);
        } else {
          store_int4(Ks + r * LD + c, Ks + r * LD + D / 2 + c, kw);
          store_int4(Vs + r * LD + c, Vs + r * LD + D / 2 + c, vw);
        }
      }
      if (tid < BS) {
        const int slot = sbase + tid;
        const size_t si = addr.scale(b, hk, sbase) + (size_t)tid * Hkv;
        kss[tid] = ks[si];
        vss[tid] = slot <= hi_pos ? vs[si] : 0.f;
      }
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();

    // scores of this warp's 16 rows against the block's 64 slots
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + r0 * LD + kk * 16 + tg * 2;
      const uint32_t a[4] = {mma::lds32(qa), mma::lds32(qa + 8 * LD),
                             mma::lds32(qa + 8), mma::lds32(qa + 8 * LD + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + gr) * LD + kk * 16 + tg * 2;
        mma::mma_16816(sc[nt], a, mma::lds32(kp), mma::lds32(kp + 8));
      }
    }

    const bool full = sbase + BS - 1 <= lo_pos &&
                      (window <= 0 || sbase > hi_pos - window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + tg * 2 + j;
        const int slot = sbase + col;
        float x0 = sc[nt][j] * scale, x1 = sc[nt][2 + j] * scale;
        if constexpr (kQuant) {
          x0 *= kss[col];
          x1 *= kss[col];
        }
        if (softcap > 0.f) {
          x0 = tanhf(x0 / softcap) * softcap;
          x1 = tanhf(x1 / softcap) * softcap;
        }
        if (!full) {
          if (!(slot <= p0 && (window <= 0 || slot > p0 - window))) x0 = kNegInf;
          if (!(slot <= p1 && (window <= 0 || slot > p1 - window))) x1 = kNegInf;
        }
        sc[nt][j] = x0;
        sc[nt][2 + j] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + tg * 2 + j;
        float e0 = expf(sc[nt][j] - mn0), e1 = expf(sc[nt][2 + j] - mn1);
        rs0 += e0;                     // l sums p before the V scale
        rs1 += e1;
        if constexpr (kQuant) {
          e0 *= vss[col];
          e1 *= vss[col];
        }
        sc[nt][j] = e0;
        sc[nt][2 + j] = e1;
      }
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

    // o += p . V: the score fragment is the A operand of the product
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk) {
      const float* f0 = sc[2 * kk];
      const float* f1 = sc[2 * kk + 1];
      const uint32_t ph[4] = {mma::pack_bf16(f0[0], f0[1]),
                              mma::pack_bf16(f0[2], f0[3]),
                              mma::pack_bf16(f1[0], f1[1]),
                              mma::pack_bf16(f1[2], f1[3])};
      uint32_t pl[4];
      if constexpr (KIND == kInt4) {   // the remainder p - bf16(p)
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
      const int vrow = kk * 16 + tg * 2;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const int col = nd * 8 + gr;
        const uint32_t b0 = Vh[vrow * LD + col] |
                            ((uint32_t)Vh[(vrow + 1) * LD + col] << 16);
        const uint32_t b1 = Vh[(vrow + 8) * LD + col] |
                            ((uint32_t)Vh[(vrow + 9) * LD + col] << 16);
        mma::mma_16816(o[nd], ph, b0, b1);
        if constexpr (KIND == kInt4) mma::mma_16816(o[nd], pl, b0, b1);
      }
    }
  }

  mma::cp_async_wait<0>();            // Q's copy, when no block was live
  // rows with no live slot block have l == 0 and emit zeros
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  const int ta = t0 + r0, tb = t0 + r1;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + tg * 2;
    if (ta < T)
      *reinterpret_cast<uint32_t*>(
          out + (((size_t)b * T + ta) * Hq + h) * D + c) =
          mma::pack_bf16(o[nd][0] / d0, o[nd][1] / d0);
    if (tb < T)
      *reinterpret_cast<uint32_t*>(
          out + (((size_t)b * T + tb) * Hq + h) * D + c) =
          mma::pack_bf16(o[nd][2] / d1, o[nd][3] / d1);
  }
}

template <int D, int KIND, typename Addr>
int launch_t(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, Addr addr, int B,
             int T, int Hq, int Hkv, int S, float scale, float softcap,
             int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D, KIND, Addr>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T + BT - 1) / BT, Hq, B);
  flash_kernel<D, KIND, Addr><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, k, v, (const float*)ks, (const float*)vs,
      (const int*)pos, (__nv_bfloat16*)out, addr, T, Hq, Hkv, S, scale,
      softcap, window);
  return (int)cudaGetLastError();
}

template <int D, typename Addr>
int launch(int kind, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* pos, void* out,
           Addr addr, int B, int T, int Hq, int Hkv, int S, float scale,
           float softcap, int window, cudaStream_t st) {
  if (kind == kInt8)
    return launch_t<D, kInt8>(q, k, v, ks, vs, pos, out, addr, B, T, Hq, Hkv,
                              S, scale, softcap, window, st);
  if (kind == kInt4)
    return launch_t<D, kInt4>(q, k, v, ks, vs, pos, out, addr, B, T, Hq, Hkv,
                              S, scale, softcap, window, st);
  return launch_t<D, kBf16>(q, k, v, ks, vs, pos, out, addr, B, T, Hq, Hkv,
                            S, scale, softcap, window, st);
}

template <typename Addr>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, Addr addr, int B,
             int T, int Hq, int Hkv, int S, int D, int kind, float scale,
             float softcap, int window, cudaStream_t st) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0 || S % BS != 0 ||
      kind < kBf16 || kind > kInt4 || (kind != kBf16) != (ks != nullptr) ||
      (ks == nullptr) != (vs == nullptr))
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
