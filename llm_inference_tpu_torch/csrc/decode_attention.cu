// K2: single-token (decode) GQA attention over the dense KV cache, bf16
// or int8 codes with per-(slot, head) float32 scales.
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
// multiplies the codes. The kernel is templated on the code type; the int8
// rows are a quarter of a lane's bf16 row (4 bytes at D = 128).
//
// Design. One block per (kv-head, sequence): the block reads pos[b]
// itself and loops only over the live slots, which replaces the TPU
// kernel's dynamic grid (_dynamic_grid) and its index-map clamp. Eight
// warps split the live slots; a warp takes UNROLL slots at a time, one
// slot row per lane-strided load (each lane holds D/32 contiguous
// elements), reduces q.k with shuffles and keeps its own running max,
// sum and accumulator for each of the G heads. The warps' partial
// softmax states merge once, through shared memory, at the end.
//
// Bound on the H100 SXM (3.35 TB/s): the kernel must read the live K and
// V rows once. At LLaMA-2-7B (Hkv = 32, D = 128, bf16), B = 1 and
// pos = 192 that is 2 x 32 x 193 x 256 bytes = 3.2 MB per layer, about
// 0.95 us; the flops (4 x 32 x 193 x 128) are negligible. An int8 cache
// halves the rows and adds 2 x 4 bytes of scales per slot and head: 1.6 MB,
// 0.48 us. Known weakness:
// at B = 1 the grid has 32 blocks, so 32 of the 132 SMs stream, each
// with one block's loads in flight; splitting the slots of a head over
// several blocks (a second merge pass) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hkv, G, D]
                   const T* __restrict__ k,               // [B, Hkv, S, D]
                   const T* __restrict__ v,
                   const float* __restrict__ ks,          // [B, S, Hkv] or
                   const float* __restrict__ vs,          // null (bf16)
                   const int* __restrict__ pos,           // [B]
                   __nv_bfloat16* __restrict__ out,       // [B, Hkv, G, D]
                   int Hkv, int G, int S, float scale, float softcap,
                   int window) {
  constexpr int PER_LANE = D / 32;
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ float smem[];  // [kWarps][G][D] acc, then m, l
  float* s_acc = smem;
  float* s_m = smem + kWarps * G * D;
  float* s_l = s_m + kWarps * G;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int p = pos[b];
  p = p < S - 1 ? p : S - 1;
  int lo = 0;
  if (window > 0) {
    lo = p - window + 1;
    lo = lo > 0 ? lo : 0;
  }

  const size_t head = (size_t)b * Hkv + h;
  const T* kh = k + head * S * D + lane * PER_LANE;
  const T* vh = v + head * S * D + lane * PER_LANE;
  // this sequence's scale column of head h: element s at [s * Hkv]
  const float* ksh = kQuant ? ks + (size_t)b * S * Hkv + h : nullptr;
  const float* vsh = kQuant ? vs + (size_t)b * S * Hkv + h : nullptr;

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

  for (int s0 = lo + warp * kUnroll; s0 <= p; s0 += kWarps * kUnroll) {
    float kf[kUnroll][PER_LANE], vf[kUnroll][PER_LANE];
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ksc[u] = vsc[u] = 1.f;
      if (s0 + u <= p) {
        load_row<PER_LANE>(kh + (size_t)(s0 + u) * D, kf[u]);
        load_row<PER_LANE>(vh + (size_t)(s0 + u) * D, vf[u]);
        if constexpr (kQuant) {
          ksc[u] = ksh[(size_t)(s0 + u) * Hkv];
          vsc[u] = vsh[(size_t)(s0 + u) * Hkv];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u > p) break;
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
        const float pb = __bfloat162float(
            __float2bfloat16(kQuant ? pe * vsc[u] : pe));
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
    out[(head * G + g) * D + d] = __float2bfloat16(aa / ll);
  }
}

template <int D, typename T>
int launch_t(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, int B, int Hkv,
             int G, int S, float scale, float softcap, int window,
             cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kWarps * G * (D + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B);
  decode_attn_kernel<D, T><<<grid, kWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const T*)k, (const T*)v, (const float*)ks,
      (const float*)vs, (const int*)pos, (__nv_bfloat16*)out, Hkv, G, S,
      scale, softcap, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, int B, int Hkv, int G,
           int S, float scale, float softcap, int window,
           cudaStream_t stream) {
  if (ks)
    return launch_t<D, int8_t>(q, k, v, ks, vs, pos, out, B, Hkv, G, S,
                               scale, softcap, window, stream);
  return launch_t<D, __nv_bfloat16>(q, k, v, ks, vs, pos, out, B, Hkv, G, S,
                                    scale, softcap, window, stream);
}

}  // namespace

// q [B, Hkv, G, D] bf16; k/v point at one layer [B, Hkv, S, D], bf16
// codes when ks/vs are null, else int8 codes with ks/vs pointing at the
// layer's float32 scales [B, S, Hkv]; pos int32 [B]; out [B, Hkv, G, D]
// bf16. D in {64, 128, 256}, G <= 8.
extern "C" int decode_attn_launch(const void* q, const void* k,
                                  const void* v, const void* ks,
                                  const void* vs, const void* pos, void* out,
                                  int B, int Hkv, int G, int S, int D,
                                  float scale, float softcap, int window,
                                  void* stream) {
  if (G < 1 || G > kMaxG || (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, ks, vs, pos, out, B, Hkv, G, S, scale,
                        softcap, window, st);
    case 128:
      return launch<128>(q, k, v, ks, vs, pos, out, B, Hkv, G, S, scale,
                         softcap, window, st);
    case 256:
      return launch<256>(q, k, v, ks, vs, pos, out, B, Hkv, G, S, scale,
                         softcap, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
