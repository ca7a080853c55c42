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
// multiplies the codes.
//
// K5 replaces decode_attention.py:_decode_attn4 (_kernel4): the int4 cache
// (quantization.quantize_kv4) holds rows of D/2 bytes, byte d carrying dim
// d in its low nibble as lo + 8 and dim d + D/2 in its high nibble as a
// signed value (the byte is 16 hi + lo + 8). The TPU kernel folds the -8 of
// the low half into one row-sum term of the score and of the output; here
// each byte is unpacked to its two signed values directly ((byte & 15) - 8
// and byte >> 4, arithmetic), which is the same sum. Scales fold as for
// int8, but p * v_scale stays float32 (the TPU kernel's PV product is a
// float32 dot, decode_attention.py:409).
//
// K10a and K10b replace llm_inference_tpu/ops/pallas/paged_attention.py:
// _paged_attn (_kernel; bf16 and int8 pages) and _paged_attn4 (_kernel4;
// packed int4 pages): the same function over a paged pool. They are this
// template with the paged address policy (PagedAddr, kv_addr.cuh): slot s
// of sequence b lives in pool page page_table[b][s / ps] at row s % ps,
// codes [P, Hkv, ps, Dc], scales [P, ps, Hkv]. The slot count is S = NB x
// ps and a position past it clamps to S - 1, so a retired row whose
// position ran past its table never reads beyond its own table row (the
// TPU kernel clamps the block only to pos / ps).
//
// Bound on the H100 SXM (3.35 TB/s): the kernel must read the live K and
// V rows once; its flops (4 x G x live x D a head) are negligible. At
// LLaMA-2-7B (Hkv = 32, D = 128), B = 1 and pos 191 a bf16 cache is
// 2 x 32 x 192 x 256 bytes = 3.1 MB a layer, 0.95 us; at pos 3060 50 MB,
// 15 us; an int8 cache halves the rows and adds 8 bytes of scales a slot
// and head; an int4 cache at pos 3060 reads 2 x 32 x 3061 x (64 + 4)
// bytes = 13.3 MB, 4.0 us. So the work is to keep the bytes moving.
//
// What the first design lost. It gave each head S / 512 blocks (32 blocks
// of 8 warps for a 512-slot cache at B = 1, on 132 SMs); each warp walked
// its slots alone, four at a time, by plain loads of 4-8 bytes a lane with
// nothing else in flight, and ran the online softmax for every slot: a
// 5-step shuffle reduction of q . k, two exponentials and a rescale of its
// whole accumulator, a serial chain through the running max and sum. Its
// eight warps then merged at eight exponentials per output element.
//
// This design. The wrapper sizes the grid by the card: NSPLIT blocks a
// (kv-head, sequence), enough to fill one wave of two blocks on every SM
// without starting a second, at least enough that no block walks more
// than 512 slots, and no split shorter than two tiles
// (decode_attention.splits). Each block reads pos[b] itself and takes one
// NSPLIT-th of the live slots, which replaces the TPU kernel's dynamic
// grid (_dynamic_grid) and its index-map clamp. It walks its share in
// tiles through a cp.async ring, with a step per tile for the scores, the
// softmax and P.V and none with a chain per slot, and with NSPLIT > 1 the
// last block of the head to finish merges the NSPLIT states, so the whole
// step stays one launch: decode_tile.cuh, which K12's attention phase
// shares.
//
// On the H100 (PERF.md, section 6) at pos 3060 bf16 runs within 4 % of its
// copies alone and at 60 % of the HBM rate, int4 is held by the tile's
// instructions, and the merge (a fence-free release, an atomic and one
// more round trip to L2) costs 1.5-2.5 us a call, most of what separates a
// short context (pos 191) from the launch alone.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "decode_tile.cuh"
#include "kv_addr.cuh"

namespace {

using namespace dtile;

// GM: the heads a group's registers are sized for, 1 (G = 1, LLaMA-2-7B's
// case: the loops over heads vanish) or kMaxG
template <int D, int KIND, int GM, typename Addr>
__global__ void __launch_bounds__(kThreads, 2)
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
  using C = Geometry<D, KIND, GM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = shared_of<D, KIND, GM>(smem, G);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
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
  for (int i = tid; i < G * D / 4; i += kThreads) {
    const int g = i / (D / 4);
    const int c = i % C::CPR;
    const int j = i % (D / 4) / C::CPR;
    const uint2 raw = *reinterpret_cast<const uint2*>(
        q + (head * G + g) * D + q_dim<D, KIND>(c, j));
    reinterpret_cast<float4*>(sh.q)[i] = make_float4(
        __uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
        __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  }
  if (tid < kMaxG) {
    sh.m[tid] = kNegInf;
    sh.tmax[tid] = ordered(kNegInf);
  }
  // accumulators and the sum of p over this thread's slots, per head
  float acc[GM][C::DPW], lsum[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    lsum[g] = 0.f;
#pragma unroll
    for (int j = 0; j < C::DPW; ++j) acc[g][j] = 0.f;
  }
  walk<D, KIND, GM, 0>(sh, static_cast<const uint8_t*>(k),
                       static_cast<const uint8_t*>(v), ks, vs, addr, b, h, lo,
                       hi, G, scale, softcap, acc, lsum);
  finish<D, KIND, GM, 0>(sh, acc, lsum, G, nsplit, z, head, part, done, out);
}

template <int D, int KIND, int GM, typename Addr>
int launch_t(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, void* part,
             void* done, Addr addr, int B, int Hkv, int G, int S,
             float scale, float softcap, int window, int nsplit,
             cudaStream_t stream) {
  using C = Geometry<D, KIND, GM>;
  const size_t smem = shared_bytes<D, KIND, GM>(G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<D, KIND, GM, Addr>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B, nsplit);
  decode_attn_kernel<D, KIND, GM, Addr><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, k, v, (const float*)ks, (const float*)vs,
      (const int*)pos, (__nv_bfloat16*)out, (float*)part, (int*)done, addr,
      Hkv, G, S, scale, softcap, window, nsplit);
  return (int)cudaGetLastError();
}

template <int D, int KIND, typename Addr>
int launch_g(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, void* part,
             void* done, Addr addr, int B, int Hkv, int G, int S,
             float scale, float softcap, int window, int nsplit,
             cudaStream_t stream) {
  if (G == 1)
    return launch_t<D, KIND, 1>(q, k, v, ks, vs, pos, out, part, done, addr,
                                B, Hkv, G, S, scale, softcap, window, nsplit,
                                stream);
  return launch_t<D, KIND, kMaxG>(q, k, v, ks, vs, pos, out, part, done,
                                  addr, B, Hkv, G, S, scale, softcap, window,
                                  nsplit, stream);
}

template <int D, typename Addr>
int launch(int kind, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* pos, void* out,
           void* part, void* done, Addr addr, int B, int Hkv, int G, int S,
           float scale, float softcap, int window, int nsplit,
           cudaStream_t stream) {
  if (kind == kInt8)
    return launch_g<D, kInt8>(q, k, v, ks, vs, pos, out, part, done, addr, B,
                              Hkv, G, S, scale, softcap, window, nsplit,
                              stream);
  if (kind == kInt4)
    return launch_g<D, kInt4>(q, k, v, ks, vs, pos, out, part, done, addr, B,
                              Hkv, G, S, scale, softcap, window, nsplit,
                              stream);
  return launch_g<D, kBf16>(q, k, v, ks, vs, pos, out, part, done, addr, B,
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

// Slots of a tile of the kernel for head size D and cache kind (0 bf16,
// 1 int8, 2 packed int4), or 0 for a case it does not take: the split rule
// (ops/kernels/decode_attention.py, splits) reads it from here.
extern "C" int decode_attn_tile_slots(int D, int kind) {
  switch (D * 4 + kind) {
    case 64 * 4 + kBf16: return Geometry<64, kBf16>::T;
    case 64 * 4 + kInt8: return Geometry<64, kInt8>::T;
    case 64 * 4 + kInt4: return Geometry<64, kInt4>::T;
    case 128 * 4 + kBf16: return Geometry<128, kBf16>::T;
    case 128 * 4 + kInt8: return Geometry<128, kInt8>::T;
    case 128 * 4 + kInt4: return Geometry<128, kInt4>::T;
    case 256 * 4 + kBf16: return Geometry<256, kBf16>::T;
    case 256 * 4 + kInt8: return Geometry<256, kInt8>::T;
    case 256 * 4 + kInt4: return Geometry<256, kInt4>::T;
    default: return 0;
  }
}

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
