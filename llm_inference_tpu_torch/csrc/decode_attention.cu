// K2: single-token (decode) GQA attention over the dense KV cache, bf16
// or int8 codes with per-(slot, head) float32 scales, and K5: the same
// over an int4 cache's packed codes.
//
// Replaces llm_inference_tpu/ops/pallas/decode_attention.py:_decode_attn
// (_kernel). Same function: for each sequence b and kv-head h, the G query
// heads of that group attend over slots (pos[b] - window, pos[b]] (all of
// [0, pos[b]] when window <= 0), scores = (q . k) * scale, optional
// softcap tanh(s / c) * c, float32 online softmax, p rounded to bf16
// before the P.V product (decode_attention.py:290-292), out = acc / l in
// bf16. An int8 cache (the TPU kernel's `quantized` branch,
// decode_attention.py:219-237, 259-263, 283-287) holds codes and slot-major
// scales [B, S, Hkv]: scores = (q . codes) * scale * k_scale[slot], l sums
// p BEFORE the V scale, and p * v_scale[slot] is rounded to bf16 before it
// multiplies the codes. The kernel is templated on the cache kind; the int8
// rows are a quarter of a lane's bf16 row (4 bytes at D = 128).
//
// K5 replaces decode_attention.py:_decode_attn4 (_kernel4): the int4 cache
// (quantization.quantize_kv4) holds rows of D/2 bytes, byte d carrying dim
// d in its low nibble as lo + 8 and dim d + D/2 in its high nibble as a
// signed value (the byte is 16 hi + lo + 8). The TPU kernel folds the -8 of
// the low half into one row-sum term of the score and of the output; here
// each lane unpacks its dims to their signed values directly (low-half
// lanes take (byte & 15) - 8, high-half lanes byte >> 4, arithmetic), which
// is the same sum. Scales fold as for int8, but p * v_scale stays float32
// (the TPU kernel's PV product is a float32 dot, decode_attention.py:409).
//
// Design. NSPLIT blocks per (kv-head, sequence): each block reads pos[b]
// itself and takes one NSPLIT-th of the live slots, which replaces the
// TPU kernel's dynamic grid (_dynamic_grid) and its index-map clamp. Eight
// warps split a block's slots; a warp takes UNROLL slots at a time, one
// slot row per lane-strided load (each lane holds D/32 contiguous
// dims, of a packed int4 row the bytes of its half), reduces q.k with
// shuffles and keeps its own running max, sum and accumulator for each of
// the G heads. The warps' partial softmax states merge through shared
// memory; with NSPLIT > 1 each block then leaves its merged state in a
// scratch buffer and the last block of the head to finish (an atomic
// count, reset by that block) merges the NSPLIT states into the output,
// so the whole step stays one launch. The wrapper takes NSPLIT from the
// cache length: one block a head per 512 slots, at most 16.
//
// K10a and K10b replace llm_inference_tpu/ops/pallas/paged_attention.py:
// _paged_attn (_kernel; bf16 and int8 pages) and _paged_attn4 (_kernel4;
// packed int4 pages): the same function over a paged pool. They are this
// template with the paged address policy (PagedAddr): slot s of sequence
// b lives in pool page page_table[b][s / ps] at row s % ps, codes
// [P, Hkv, ps, Dc], scales [P, ps, Hkv]. The page is looked up per slot;
// everything else (the per-kind bodies, the split over slots and its
// merge) is shared with K2/K5. The slot count is S = NB x ps and a
// position past it clamps to S - 1, so a retired row whose position ran
// past its table never reads beyond its own table row (the TPU kernel
// clamps the block only to pos / ps).
//
// Bound on the H100 SXM (3.35 TB/s): the kernel must read the live K and
// V rows once. At LLaMA-2-7B (Hkv = 32, D = 128, bf16), B = 1 and
// pos = 192 that is 2 x 32 x 193 x 256 bytes = 3.2 MB per layer, about
// 0.95 us; the flops (4 x 32 x 193 x 128) are negligible. An int8 cache
// halves the rows and adds 2 x 4 bytes of scales per slot and head: 1.6 MB,
// 0.48 us; an int4 cache at pos 3060 reads 2 x 32 x 3061 x (64 + 4) bytes
// = 13.3 MB, 4.0 us. Each slot costs a warp a chain of shuffles and
// exponentials, so a block's time follows its slot count: with one block
// a head, K5 took 0.25 ms at pos 3060 (32 of 132 SMs busy); the split
// spreads a long context over NSPLIT times as many blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "kv_addr.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBf16 = 0, kInt8 = 1, kInt4 = 2;   // cache kinds
constexpr int kMaxG = 8;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

// PER_LANE contiguous bf16 values (4, 8 or 16 bytes) → exact floats
template <int PER_LANE>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&out)[PER_LANE]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  uint32_t raw[PER_LANE / 2];
  if constexpr (PER_LANE == 2) {
    raw[0] = w[0];
  } else {
#pragma unroll
    for (int c = 0; c < PER_LANE / 4; ++c) {
      const uint2 v = reinterpret_cast<const uint2*>(w)[c];
      raw[2 * c] = v.x;
      raw[2 * c + 1] = v.y;
    }
  }
#pragma unroll
  for (int j = 0; j < PER_LANE / 2; ++j) {
    out[2 * j] = __uint_as_float(raw[j] << 16);
    out[2 * j + 1] = __uint_as_float(raw[j] & 0xffff0000u);
  }
}

// PER_LANE contiguous int8 codes (2, 4 or 8 bytes) → exact floats
template <int PER_LANE>
__device__ __forceinline__ void load_row(const int8_t* p,
                                         float (&out)[PER_LANE]) {
  if constexpr (PER_LANE == 2) {
    const uint32_t v = *reinterpret_cast<const uint16_t*>(p);
    out[0] = (float)(int8_t)(v & 0xffu);
    out[1] = (float)(int8_t)(v >> 8);
  } else {
#pragma unroll
    for (int c = 0; c < PER_LANE / 4; ++c) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(p)[c];
#pragma unroll
      for (int j = 0; j < 4; ++j) out[4 * c + j] = (float)(int8_t)(w >> (8 * j));
    }
  }
}

// PER_LANE signed int4 values of one packed row (offset-lo split halves):
// lanes 0-15 hold dims of the low half (low nibbles minus 8), lanes 16-31
// those of the high half (high nibbles), from the same PER_LANE bytes
template <int PER_LANE>
__device__ __forceinline__ void load_row4(const uint8_t* p, bool high,
                                          float (&out)[PER_LANE]) {
  uint32_t w[(PER_LANE + 3) / 4];
  if constexpr (PER_LANE == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
#pragma unroll
    for (int c = 0; c < PER_LANE / 4; ++c)
      w[c] = reinterpret_cast<const uint32_t*>(p)[c];
  }
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int byte = (int)(int8_t)(w[j / 4] >> (8 * (j % 4)));
    out[j] = high ? (float)(byte >> 4) : (float)((byte & 15) - 8);
  }
}

template <int PER_LANE, int KIND>
__device__ __forceinline__ void load_kv(const uint8_t* p, int lane,
                                        float (&out)[PER_LANE]) {
  if constexpr (KIND == kBf16)
    load_row<PER_LANE>(reinterpret_cast<const __nv_bfloat16*>(p), out);
  else if constexpr (KIND == kInt8)
    load_row<PER_LANE>(reinterpret_cast<const int8_t*>(p), out);
  else
    load_row4<PER_LANE>(p, lane >= 16, out);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, int KIND, typename Addr>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hkv, G, D]
                   const void* __restrict__ k,     // codes, laid out as addr
                   const void* __restrict__ v,
                   const float* __restrict__ ks,   // scales as addr, or
                   const float* __restrict__ vs,   // null (bf16)
                   const int* __restrict__ pos,           // [B]
                   __nv_bfloat16* __restrict__ out,       // [B, Hkv, G, D]
                   float* __restrict__ part,    // [B, Hkv, NSPLIT, G, D + 2]
                   int* __restrict__ done,      // [B, Hkv], zero between launches
                   Addr addr, int Hkv, int G, int S, float scale,
                   float softcap, int window, int nsplit) {
  constexpr int PER_LANE = D / 32;
  constexpr bool kQuant = KIND != kBf16;
  // bytes of a cache row, and of this lane's part of it
  constexpr int ROW = KIND == kBf16 ? 2 * D : KIND == kInt8 ? D : D / 2;
  constexpr int LANE_BYTES = KIND == kBf16 ? 2 * PER_LANE : PER_LANE;
  extern __shared__ float smem[];  // [kWarps][G][D] acc, then m, l
  float* s_acc = smem;
  float* s_m = smem + kWarps * G * D;
  float* s_l = s_m + kWarps * G;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int p = pos[b];
  p = p < S - 1 ? p : S - 1;
  int lo = 0;
  if (window > 0) {
    lo = p - window + 1;
    lo = lo > 0 ? lo : 0;
  }
  // this block's share [lo, hi] of the live slots (empty past the end)
  const int share = (p - lo + nsplit) / nsplit;
  lo += z * share;
  const int hi = min(p, lo + share - 1);

  const size_t head = (size_t)b * Hkv + h;
  const int lane_off = (KIND == kInt4 ? lane % 16 : lane) * LANE_BYTES;
  const uint8_t* kb = (const uint8_t*)k + lane_off;
  const uint8_t* vb = (const uint8_t*)v + lane_off;

  float qr[kMaxG][PER_LANE];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      load_row<PER_LANE>(q + (head * G + g) * D + lane * PER_LANE, qr[g]);
    }
  }
  float m[kMaxG], l[kMaxG], acc[kMaxG][PER_LANE];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) acc[g][j] = 0.f;
  }

  for (int s0 = lo + warp * kUnroll; s0 <= hi; s0 += kWarps * kUnroll) {
    float kf[kUnroll][PER_LANE], vf[kUnroll][PER_LANE];
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ksc[u] = vsc[u] = 1.f;
      if (s0 + u <= hi) {
        const size_t r = addr.row(b, h, s0 + u) * ROW;
        load_kv<PER_LANE, KIND>(kb + r, lane, kf[u]);
        load_kv<PER_LANE, KIND>(vb + r, lane, vf[u]);
        if constexpr (kQuant) {
          const size_t si = addr.scale(b, h, s0 + u);
          ksc[u] = ks[si];
          vsc[u] = vs[si];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u > hi) break;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j)
          part = fmaf(qr[g][j], kf[u][j], part);
        float sc = warp_sum(part) * scale;
        if constexpr (kQuant) sc *= ksc[u];
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float pe = expf(sc - m_new);
        l[g] = l[g] * alpha + pe;           // before the V scale
        const float ps = kQuant ? pe * vsc[u] : pe;
        // int4: the TPU kernel's PV dot is float32; else p rounds to bf16
        const float pb =
            KIND == kInt4 ? ps : __bfloat162float(__float2bfloat16(ps));
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j)
          acc[g][j] = fmaf(pb, vf[u][j], acc[g][j] * alpha);
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        s_acc[(warp * G + g) * D + lane * PER_LANE + j] = acc[g][j];
      if (lane == 0) {
        s_m[warp * G + g] = m[g];
        s_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  // with splits, this block's state: [G][D] accumulators, [G] maxima,
  // [G] sums (an empty share leaves m = -1e30 and l = 0, weight 0 below)
  const int stride = G * (D + 2);
  float* pz = nsplit > 1 ? part + (head * nsplit + z) * stride : nullptr;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i % D;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s_m[w * G + g]);
    float ll = 0.f, aa = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w * G + g] - mm);
      ll += s_l[w * G + g] * f;
      aa += s_acc[(w * G + g) * D + d] * f;
    }
    if (nsplit == 1) {
      out[(head * G + g) * D + d] = __float2bfloat16(aa / ll);
    } else {
      pz[i] = aa;
      if (d == 0) {
        pz[G * D + g] = mm;
        pz[G * D + G + g] = ll;
      }
    }
  }
  if (nsplit == 1) return;
  __shared__ int s_last;
  __syncthreads();                          // the block's state is written
  if (threadIdx.x == 0) {
    __threadfence();                        // ... and visible to the others
    s_last = atomicAdd(done + head, 1) == nsplit - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* ph = part + head * nsplit * stride;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i % D;
    float mm = kNegInf;
    for (int zz = 0; zz < nsplit; ++zz)
      mm = fmaxf(mm, __ldcg(ph + zz * stride + G * D + g));
    float ll = 0.f, aa = 0.f;
    for (int zz = 0; zz < nsplit; ++zz) {
      const float f = expf(__ldcg(ph + zz * stride + G * D + g) - mm);
      ll += __ldcg(ph + zz * stride + G * D + G + g) * f;
      aa += __ldcg(ph + zz * stride + i) * f;
    }
    out[(head * G + g) * D + d] = __float2bfloat16(aa / ll);
  }
  if (threadIdx.x == 0) done[head] = 0;     // ready for the next launch
}

template <int D, int KIND, typename Addr>
int launch_t(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, void* part,
             void* done, Addr addr, int B, int Hkv, int G, int S,
             float scale, float softcap, int window, int nsplit,
             cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kWarps * G * (D + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<D, KIND, Addr>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B, nsplit);
  decode_attn_kernel<D, KIND, Addr><<<grid, kWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, k, v, (const float*)ks, (const float*)vs,
      (const int*)pos, (__nv_bfloat16*)out, (float*)part, (int*)done, addr,
      Hkv, G, S, scale, softcap, window, nsplit);
  return (int)cudaGetLastError();
}

template <int D, typename Addr>
int launch(int kind, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* pos, void* out,
           void* part, void* done, Addr addr, int B, int Hkv, int G, int S,
           float scale, float softcap, int window, int nsplit,
           cudaStream_t stream) {
  if (kind == kInt8)
    return launch_t<D, kInt8>(q, k, v, ks, vs, pos, out, part, done, addr, B,
                              Hkv, G, S, scale, softcap, window, nsplit,
                              stream);
  if (kind == kInt4)
    return launch_t<D, kInt4>(q, k, v, ks, vs, pos, out, part, done, addr, B,
                              Hkv, G, S, scale, softcap, window, nsplit,
                              stream);
  return launch_t<D, kBf16>(q, k, v, ks, vs, pos, out, part, done, addr, B,
                            Hkv, G, S, scale, softcap, window, nsplit, stream);
}

template <typename Addr>
int dispatch(int kind, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* pos, void* out,
             void* part, void* done, Addr addr, int B, int Hkv, int G, int S,
             int D, float scale, float softcap, int window, int nsplit,
             cudaStream_t st) {
  if (G < 1 || G > kMaxG || kind < kBf16 || kind > kInt4 || nsplit < 1 ||
      (nsplit > 1 && (!part || !done)) ||
      (kind != kBf16) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(kind, q, k, v, ks, vs, pos, out, part, done, addr, B,
                        Hkv, G, S, scale, softcap, window, nsplit, st);
    case 128:
      return launch<128>(kind, q, k, v, ks, vs, pos, out, part, done, addr,
                         B, Hkv, G, S, scale, softcap, window, nsplit, st);
    case 256:
      return launch<256>(kind, q, k, v, ks, vs, pos, out, part, done, addr,
                         B, Hkv, G, S, scale, softcap, window, nsplit, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Hkv, G, D] bf16; k/v point at one layer [B, Hkv, S, Dc] of the
// cache: kind 0 bf16 (Dc = D, ks/vs null), kind 1 int8 codes (Dc = D),
// kind 2 packed int4 codes (Dc = D / 2), the quantized kinds with ks/vs
// pointing at the layer's float32 scales [B, S, Hkv]; pos int32 [B]; out
// [B, Hkv, G, D] bf16. D in {64, 128, 256}, G <= 8. With nsplit > 1, part
// is a float32 scratch of B * Hkv * nsplit * G * (D + 2) and done an int32
// [B * Hkv] that is zero before the launch (and is left zero after it);
// with nsplit == 1 both may be null.
extern "C" int decode_attn_launch(const void* q, const void* k,
                                  const void* v, const void* ks,
                                  const void* vs, const void* pos, void* out,
                                  void* part, void* done, int B, int Hkv,
                                  int G, int S, int D, int kind, int nsplit,
                                  float scale, float softcap, int window,
                                  void* stream) {
  return dispatch(kind, q, k, v, ks, vs, pos, out, part, done,
                  DenseAddr{Hkv, S}, B, Hkv, G, S, D, scale, softcap, window,
                  nsplit, (cudaStream_t)stream);
}

// K10a/K10b: as decode_attn_launch, over one layer of a paged pool: k/v
// point at the layer's codes [P, Hkv, ps, Dc], ks/vs at its float32 scales
// [P, ps, Hkv] (or null), pt at the page table [B, NB] int32; the slot
// count is NB * ps.
extern "C" int paged_decode_attn_launch(const void* q, const void* k,
                                        const void* v, const void* ks,
                                        const void* vs, const void* pt,
                                        const void* pos, void* out,
                                        void* part, void* done, int B,
                                        int Hkv, int G, int NB, int ps, int D,
                                        int kind, int nsplit, float scale,
                                        float softcap, int window,
                                        void* stream) {
  if (NB < 1 || ps < 1 || !pt) return (int)cudaErrorInvalidValue;
  return dispatch(kind, q, k, v, ks, vs, pos, out, part, done,
                  PagedAddr{Hkv, NB, ps, (const int*)pt}, B, Hkv, G, NB * ps,
                  D, scale, softcap, window, nsplit, (cudaStream_t)stream);
}
