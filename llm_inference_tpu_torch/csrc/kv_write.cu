// K3 and K4, redesigned for Hopper as one kernel a layer: the RoPE on q
// and k, then K and V written into the dense cache in its kind.
//
// Replaces llm_inference_tpu/ops/pallas/kv_write.py:write_token (_kernel,
// K3) and quantize_write_token (_qkernel, K4), with what the JAX package
// leaves to XLA around them folded in: the split-form RoPE of q and k
// (llm_inference_tpu/ops/rope.py:165-190), the int4 quantizer
// (ops/quantization.py quantize_kv4) and the prefill's slice writes
// (ops/kvcache.py _write_pages). For every (sequence b, token t) and head
// row of the layer's projection output:
//   q, k:  x' = (x1 c1 - x2 s1, x2 c2 + x1 s2), x1/x2 the halves of the
//          row in float32, each product and sum rounded on its own, then
//          rounded to bf16; q' goes to a [B, T, H, D] output;
//   k', v: written at slot clamp(offsets[b], 0, S - T) + t of the layer's
//          [B, Hkv, S, Dc] cache (at T = 1 min(offsets[b], S - 1), the
//          clamp of kv_write.py:83; at T > 1 dynamic_update_slice's
//          window start): as bf16 rows; or as int8 codes, scale = max(
//          max|x| / 127, 1e-8), code = clip(rint(x / scale), -128, 127);
//          or as int4 codes, scale max|x| / 7, codes clipped to [-8, 7],
//          packed split-half with the offset-lo encoding (byte j holds dim
//          j + 8 in its low nibble, dim j + D/2 signed in its high one);
//          the scale to [b, slot, head] of the slot-major [B, S, Hkv]
//          float32 scales.
// The quantizers read the bf16-rounded k', as the plain path (RoPE, then
// update_cache_layer) does. Division is IEEE float32 and rintf rounds half
// to even; the build uses no fast math, and the RoPE's products and sums
// are __fmul_rn / __fsub_rn / __fadd_rn so that nvcc contracts none of
// them into an FMA: bit for bit the plain path's results.
//
// Bound on the H100 SXM (3.35 TB/s): at LLaMA-2-7B, B = 1, T = 1 a layer
// reads 96 head rows (24 KB) and 1 KB of cos/sin and writes 24 KB, about
// 15 ns of HBM time: the call is bound by its launch and one dependent
// load, as K3 and K4 were. A 2048-row prefill chunk moves about 50 MB in
// and 50 MB out a layer, 30 us at the memory's rate. So the design does
// the least per launch and needs no loop: one warp per head row, each
// lane D / 32 consecutive values in one vector load (8 bytes at D = 128),
// the RoPE's partner half from the lane 16 away by one shuffle, the row's
// max|x| by five shuffles, no shared memory and no block barrier; a grid
// over (token, group of four head rows) covers a 2048-row chunk at once.
// The launch is a programmatic dependent one: a block reads its offset,
// cos and sin (written before the layer began) while the projection ahead
// of it finishes, then waits for that grid before it reads the rows.
//
// The same template without the RoPE serves the entry points that take
// rows as they come: write_token (K3, a byte copy, which also moves an
// int4 cache's packed rows), quantize_write_token (K4, bf16 or float32
// rows) and the megakernel's two row writes (write_rows,
// quantize_write_rows). The rows are read through their strides (column
// slices of the fused qkv output), so no copy precedes the launch.
//
// Without the RoPE, k and v rows may differ in width: DeepSeek's latent
// cache holds k rows of 576 values ([c_kv | k_rot]) and v rows of 512
// (c_kv), or their packed int4 bytes, 288 and 256 (JAX kv_write.py:
// 160-161 takes the two widths). The copy moves each row's own bytes in
// 16-byte words. K4 at widths past 256 values or at two widths runs
// kv_quant_write_wide: lane l holds e = D / 32 values of its own row (18
// at 576: 36 bytes, no power-of-two vector), read one by one, since a
// call moves a few KB and is bound by its launch; the quantizer is the
// same, per (slot, head) over each row's own width, bit for bit the
// plain path's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kWarps = 4;              // head rows a block, one a warp
constexpr unsigned kFull = 0xffffffffu;

enum Kind : int { kCopy = 0, kBf16 = 1, kInt8 = 2, kInt4 = 3 };

struct Args {
  const void* q;          // [B, T, H, D] rows (RoPE instances), or null
  const void* k;          // [B, T, Hkv, D] rows, D contiguous
  const void* v;
  const float* cos;       // [B, T, D] float32, gathered at the positions
  const float* sin;
  const int* offsets;     // [B]
  __nv_bfloat16* q_out;   // [B, T, H, D]
  void* k_cache;          // one layer, [B, Hkv, S, Dc]
  void* v_cache;
  float* k_scale;         // one layer, [B, S, Hkv] (quantized kinds)
  float* v_scale;
  // strides of b, t and the head of q, k and v: elements (bytes for kCopy)
  long long sq[3], sk[3], sv[3];
  int B, T, H, Hkv, S;
  int D;                  // values of a k row (kCopy: bytes of a row)
  int Dv;                 // values (bytes) of a v row: D with the RoPE
};

// The widest power of two up to 16 that divides n.
__host__ __device__ constexpr int pow2_div(int n) {
  return n % 16 == 0 ? 16 : n % 8 == 0 ? 8 : n % 4 == 0 ? 4
       : n % 2 == 0 ? 2 : 1;
}

template <int W> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// N bytes from src to dst in the widest words both are aligned to (the
// wrapper checks the rows' addresses and strides against pow2_div(N)).
template <int N>
__device__ __forceinline__ void move(void* dst, const void* src) {
  constexpr int W = pow2_div(N);
  using T = typename Word<W>::T;
#pragma unroll
  for (int i = 0; i < N / W; ++i)
    static_cast<T*>(dst)[i] = static_cast<const T*>(src)[i];
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int E, typename Tin>
__device__ __forceinline__ void load_row(const Tin* src, float (&x)[E]) {
  alignas(16) Tin raw[E];
  move<E * (int)sizeof(Tin)>(raw, src);
#pragma unroll
  for (int i = 0; i < E; ++i) x[i] = to_f32(raw[i]);
}

// One warp a head row: r counts q's heads (RoPE instances), then k's,
// then v's; blockIdx.x is the token b * T + t. Lane l holds the row's
// values E l .. E l + E - 1, so lanes 0-15 hold the first half.
template <int E, int KIND, bool ROPE, typename Tin>
__global__ void __launch_bounds__(kWarps * 32) kv_rope_write(const Args a) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.y * kWarps + threadIdx.x / 32;
  const int nq = ROPE ? a.H : 0;
  if (r >= nq + 2 * a.Hkv) return;
  const int part = r < nq ? 0 : r < nq + a.Hkv ? 1 : 2;   // q, k, v
  const int h = part == 0 ? r : part == 1 ? r - nq : r - nq - a.Hkv;
  const int b = blockIdx.x / a.T, t = blockIdx.x - b * a.T;
  // written before the layer began: read ahead of the wait
  const int s = min(max(a.offsets[b], 0), a.S - a.T) + t;
  float c[E], sn[E];
#pragma unroll
  for (int i = 0; i < E; ++i) c[i] = sn[i] = 0.f;
  if (ROPE && part < 2) {
    const size_t o = (size_t)blockIdx.x * a.D + lane * E;
    load_row<E>(a.cos + o, c);
    load_row<E>(a.sin + o, sn);
  }
  sm90::grid_dependency_wait();

  const void* src = part == 0 ? a.q : part == 1 ? a.k : a.v;
  const long long so = part == 0 ? b * a.sq[0] + t * a.sq[1] + h * a.sq[2]
                     : part == 1 ? b * a.sk[0] + t * a.sk[1] + h * a.sk[2]
                                 : b * a.sv[0] + t * a.sv[1] + h * a.sv[2];
  void* cache = part == 1 ? a.k_cache : a.v_cache;
  const size_t slot = ((size_t)b * a.Hkv + h) * a.S + s;
  if constexpr (KIND == kCopy) {
    const int n = part == 1 ? a.D : a.Dv;
    const uint4* from = reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(src) + so);
    uint4* to = reinterpret_cast<uint4*>(static_cast<uint8_t*>(cache) +
                                         slot * n);
    for (int i = lane; i < n / 16; i += 32) to[i] = from[i];
    return;
  } else {
    float x[E];
    load_row<E>(static_cast<const Tin*>(src) + so + lane * E, x);
    if (ROPE && part < 2) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float p = __shfl_xor_sync(kFull, x[i], 16);
        x[i] = lane < 16
            ? __fsub_rn(__fmul_rn(x[i], c[i]), __fmul_rn(p, sn[i]))
            : __fadd_rn(__fmul_rn(x[i], c[i]), __fmul_rn(p, sn[i]));
      }
    }
    alignas(16) __nv_bfloat16 hb[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      hb[i] = __float2bfloat16_rn(x[i]);
      // the quantizers read what the plain path hands on: bf16 rows (a
      // float32 row of the no-RoPE instance stays as it is)
      if (sizeof(Tin) == 2) x[i] = __bfloat162float(hb[i]);
    }
    if (part == 0) {
      move<2 * E>(a.q_out + ((size_t)blockIdx.x * a.H + h) * a.D + lane * E,
                  hb);
      return;
    }
    if constexpr (KIND == kBf16) {
      move<2 * E>(static_cast<__nv_bfloat16*>(cache) + slot * a.D + lane * E,
                  hb);
    } else {
      constexpr float kMax = KIND == kInt8 ? 127.f : 7.f;
      constexpr float kMin = KIND == kInt8 ? -128.f : -8.f;
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
      const float scale = fmaxf(amax / kMax, 1e-8f);
      float code[E];
#pragma unroll
      for (int i = 0; i < E; ++i)
        code[i] = fminf(fmaxf(rintf(x[i] / scale), kMin), kMax);
      alignas(16) int8_t out[E];
      if constexpr (KIND == kInt8) {
#pragma unroll
        for (int i = 0; i < E; ++i) out[i] = (int8_t)code[i];
        move<E>(static_cast<int8_t*>(cache) + slot * a.D + lane * E, out);
      } else {
        // lane l < 16 packs its dims (low nibble, offset by 8) with those
        // D/2 further on, which lane l + 16 holds (high nibble, signed)
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const float hi = __shfl_xor_sync(kFull, code[i], 16);
          out[i] = (int8_t)((int)hi * 16 + (int)code[i] + 8);
        }
        if (lane < 16)
          move<E>(static_cast<int8_t*>(cache) + slot * (a.D / 2) + lane * E,
                  out);
      }
      if (lane == 0)
        (part == 1 ? a.k_scale : a.v_scale)[((size_t)b * a.S + s) * a.Hkv +
                                            h] = scale;
    }
  }
}

// K4 without the RoPE at rows wider than 256 values or at two widths (the
// header's note): one warp a row, k's heads then v's, lane l the e values
// l e .. l e + e - 1 of its row, e = D / 32 of the row's own width.
constexpr int kWideE = 18;              // 576 / 32, the widest row taken

template <typename Tin>
__global__ void __launch_bounds__(kWarps * 32) kv_quant_write_wide(
    const Args a) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.y * kWarps + threadIdx.x / 32;
  if (r >= 2 * a.Hkv) return;
  const bool is_k = r < a.Hkv;
  const int h = is_k ? r : r - a.Hkv;
  const int b = blockIdx.x / a.T, t = blockIdx.x - b * a.T;
  const int s = min(max(a.offsets[b], 0), a.S - a.T) + t;
  sm90::grid_dependency_wait();

  const int D = is_k ? a.D : a.Dv;
  const int e = D / 32;
  const long long* st = is_k ? a.sk : a.sv;
  const Tin* src = static_cast<const Tin*>(is_k ? a.k : a.v) + b * st[0] +
                   t * st[1] + h * st[2] + lane * e;
  float x[kWideE];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kWideE; ++i) {
    x[i] = i < e ? to_f32(src[i]) : 0.f;
    amax = fmaxf(amax, fabsf(x[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  const float scale = fmaxf(amax / 127.f, 1e-8f);
  int8_t* dst = static_cast<int8_t*>(is_k ? a.k_cache : a.v_cache) +
                (((size_t)b * a.Hkv + h) * a.S + s) * D + lane * e;
#pragma unroll
  for (int i = 0; i < kWideE; ++i)
    if (i < e) dst[i] = (int8_t)fminf(fmaxf(rintf(x[i] / scale), -128.f),
                                      127.f);
  if (lane == 0)
    (is_k ? a.k_scale : a.v_scale)[((size_t)b * a.S + s) * a.Hkv + h] =
        scale;
}

template <typename K>
int launch_grid(K kernel, const Args& a, int rows, cudaStream_t st) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.T, (rows + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int E, int KIND, bool ROPE, typename Tin>
int launch(const Args& a, cudaStream_t st) {
  return launch_grid(kv_rope_write<E, KIND, ROPE, Tin>, a,
                     (ROPE ? a.H : 0) + 2 * a.Hkv, st);
}

template <int KIND, bool ROPE, typename Tin>
int launch_d(const Args& a, cudaStream_t st) {
  switch (a.D / 32) {
    case 1: return launch<1, KIND, ROPE, Tin>(a, st);
    case 2: return launch<2, KIND, ROPE, Tin>(a, st);
    case 3: return launch<3, KIND, ROPE, Tin>(a, st);
    case 4: return launch<4, KIND, ROPE, Tin>(a, st);
    case 5: return launch<5, KIND, ROPE, Tin>(a, st);
    case 6: return launch<6, KIND, ROPE, Tin>(a, st);
    case 7: return launch<7, KIND, ROPE, Tin>(a, st);
    case 8: return launch<8, KIND, ROPE, Tin>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K4 without the RoPE: the template's instance where k and v rows are one
// width up to 256, else the wide kernel.
template <typename Tin>
int launch_quant(const Args& a, cudaStream_t st) {
  if (a.D == a.Dv && a.D <= 256) return launch_d<kInt8, false, Tin>(a, st);
  return launch_grid(kv_quant_write_wide<Tin>, a, 2 * a.Hkv, st);
}

// The decode-step scale write of an int4 cache: one token's per-head K and
// V scales into the slot-major [B, S, Hkv] float32 scale rows.
//
// Replaces llm_inference_tpu/ops/pallas/kv_write.py:write_token_scales
// (_skernel), which read-modify-writes an 8-slot block through a one-hot
// blend; here block b writes row min(offsets[b], S-1) of both scale arrays
// in place (the clamp of kv_write.py:348), thread i one scale. The packed
// codes go through write_token. The model's int4 cache writes through
// kv_rope_write, which quantizes and writes the scales itself; this kernel
// serves write_token_scales. Bound: 2 x Hkv x 4 bytes per sequence,
// launch-bound like K3.
__global__ void kv_scale_write_kernel(float* __restrict__ k_scale,
                                      float* __restrict__ v_scale,
                                      const float* __restrict__ k_new,
                                      const float* __restrict__ v_new,
                                      const int* __restrict__ offsets,
                                      int Hkv, int S) {
  const int b = blockIdx.x;
  int s = offsets[b];
  s = s < S - 1 ? s : S - 1;
  s = s > 0 ? s : 0;
  const size_t dst = ((size_t)b * S + s) * Hkv;
  for (int i = threadIdx.x; i < 2 * Hkv; i += blockDim.x) {
    if (i < Hkv)
      k_scale[dst + i] = k_new[(size_t)b * Hkv + i];
    else
      v_scale[dst + i - Hkv] = v_new[(size_t)b * Hkv + i - Hkv];
  }
}

}  // namespace

// k_scale/v_scale point at one layer's [B, S, Hkv] float32 scales; k_new,
// v_new are float32 [B, Hkv]; offsets int32 [B] on the device.
extern "C" int kv_scale_write_launch(void* k_scale, void* v_scale,
                                     const void* k_new, const void* v_new,
                                     const void* offsets, int B, int Hkv,
                                     int S, void* stream) {
  if (B < 1 || Hkv < 1) return (int)cudaErrorInvalidValue;
  int threads = 2 * Hkv;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  kv_scale_write_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (float*)k_scale, (float*)v_scale, (const float*)k_new,
      (const float*)v_new, (const int*)offsets, Hkv, S);
  return (int)cudaGetLastError();
}

// The RoPE and KV write of one layer (q non-null: the RoPE instances), or
// the write of rows as they come (q null). kind 0 copies k rows of D
// bytes and v rows of Dv (multiples of 16; strides in bytes; k_new/v_new
// in the cache's dtype), 1 writes bf16 rows, 2 int8 codes and scales, 3
// packed int4 codes and scales; for kinds 1-3 D (values) a multiple of 32
// up to 256 and Dv = D with the RoPE; without it (kind 2) D and Dv
// multiples of 32 up to 576. q, k, v are
// bf16 (k, v float32 when in_f32, int8 without the RoPE only), read at
// b * s*[0] + t * s*[1] + head * s*[2] elements; cos/sin float32 [B, T, D]
// and q_out bf16 [B, T, H, D] contiguous; k_cache/v_cache point at one
// layer [B, Hkv, S, Dc] (v_cache [B, Hkv, S, Dcv]), k_scale/v_scale at its
// [B, S, Hkv] float32 scales (kinds 2 and 3); offsets int32 [B] on the
// device; 1 <= T <= S.
extern "C" int kv_rope_write_launch(
    const void* q, const void* k, const void* v, const void* cos,
    const void* sin, const void* offsets, void* q_out, void* k_cache,
    void* v_cache, void* k_scale, void* v_scale, long long sqb,
    long long sqt, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh, int B,
    int T, int H, int Hkv, int S, int D, int Dv, int kind, int in_f32,
    void* stream) {
  const bool rope = q != nullptr;
  if (B < 1 || T < 1 || T > S || Hkv < 1 || (rope && H < 1) ||
      (long long)B * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (kind == kCopy ? D % 16 != 0 || Dv % 16 != 0 || rope || in_f32
                    : D % 32 != 0 || Dv % 32 != 0 || kind > kInt4 ||
                          (rope ? D > 256 || Dv != D || in_f32 || !cos ||
                                      !sin || !q_out
                                : kind != kInt8 || D > 32 * kWideE ||
                                      Dv > 32 * kWideE))
    return (int)cudaErrorInvalidValue;
  Args a = {q,       k,       v,       (const float*)cos,
            (const float*)sin, (const int*)offsets, (__nv_bfloat16*)q_out,
            k_cache, v_cache, (float*)k_scale,  (float*)v_scale,
            {sqb, sqt, sqh}, {skb, skt, skh}, {svb, svt, svh},
            B,       T,       rope ? H : 0, Hkv, S, D, Dv};
  const cudaStream_t st = (cudaStream_t)stream;
  if (kind == kCopy) return launch<1, kCopy, false, uint8_t>(a, st);
  if (!rope)
    return in_f32 ? launch_quant<float>(a, st)
                  : launch_quant<__nv_bfloat16>(a, st);
  switch (kind) {
    case kBf16: return launch_d<kBf16, true, __nv_bfloat16>(a, st);
    case kInt8: return launch_d<kInt8, true, __nv_bfloat16>(a, st);
    default: return launch_d<kInt4, true, __nv_bfloat16>(a, st);
  }
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
