// K3: decode-step KV-cache write, one new K and V row per sequence.
//
// Replaces llm_inference_tpu/ops/pallas/kv_write.py:write_token (_kernel).
// The TPU kernel aliases the cache as input and output
// (input_output_aliases) and read-modify-writes an 8-slot sublane block;
// here the cache tensor is simply written in place: each block copies one
// (sequence, kv-head) row of K and of V to slot min(offsets[b], S-1),
// the clamp of kv_write.py:83. Nothing else of the cache is touched.
//
// Bound on the H100 SXM (3.35 TB/s): at LLaMA-2-7B, B=1 a layer moves
// 2 x 32 heads x 128 x 2 bytes = 16 KB in and 16 KB out, about 0.01 us of
// HBM time, so the call is bound by its launch (a few us), not by bytes.
// The design therefore does the least per launch: one 16-byte copy per
// thread, no shared memory, no synchronisation. Folding the write into the
// K1 epilogue or the K2 prologue would remove the launch; that is later work.
//
// The copy is by bytes, so it serves any cache dtype whose row is a
// multiple of 16 bytes: bf16 rows, and the packed rows of an int4 cache
// (D/2 = 64 bytes at D = 128).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__global__ void kv_write_kernel(uint4* __restrict__ k_cache,
                                uint4* __restrict__ v_cache,
                                const uint4* __restrict__ k_new,
                                const uint4* __restrict__ v_new,
                                const int* __restrict__ offsets,
                                int Hkv, int S, int row_vecs) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int s = offsets[b];
  s = s < S - 1 ? s : S - 1;
  s = s > 0 ? s : 0;
  const size_t src = ((size_t)b * Hkv + h) * row_vecs;
  const size_t dst = (((size_t)b * Hkv + h) * S + s) * row_vecs;
  for (int i = threadIdx.x; i < 2 * row_vecs; i += blockDim.x) {
    if (i < row_vecs) {
      k_cache[dst + i] = k_new[src + i];
    } else {
      v_cache[dst + i - row_vecs] = v_new[src + i - row_vecs];
    }
  }
}

// K4: decode-step int8 quantize + write, codes and slot-major scales.
//
// Replaces llm_inference_tpu/ops/pallas/kv_write.py:quantize_write_token
// (_qkernel): per (sequence, kv-head) row of the new K and V,
//   scale = max(max|x| / 127, 1e-8),  code = clip(rint(x / scale), -128, 127)
// (quantization.quantize_kv), codes to [b, h, min(off, S-1), :] of the
// layer's [B, Hkv, S, D] int8 cache and the scale to [b, min(off, S-1), h]
// of its slot-major [B, S, Hkv] float32 scales. The division is IEEE
// float32 and rintf rounds half to even, as the TPU kernel and the plain
// version do, so codes and scales are bit-exact (the build uses no fast
// math). The TPU kernel's identity dot at HIGHEST precision only moves a
// scale column into a lane row; nothing here needs it.
//
// Design: one block per (kv-head, sequence), warp 0 quantizes the K row and
// warp 1 the V row; the lanes split D and reduce max|x| with shuffles. Bound
// as K3: a few hundred bytes per row, launch-bound. The new rows are read
// through their strides (they are column slices of the fused qkv output),
// so no copy precedes the launch.
constexpr int kMaxPerLane = 8;   // D <= 256

__global__ void kv_quant_write_kernel(
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const void* __restrict__ k_new, const void* __restrict__ v_new,
    const int* __restrict__ offsets, int Hkv, int S, int D, int k_sb,
    int k_sh, int v_sb, int v_sh, int in_f32) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int s = offsets[b];
  s = s < S - 1 ? s : S - 1;
  s = s > 0 ? s : 0;
  const size_t src = warp ? (size_t)b * v_sb + (size_t)h * v_sh
                          : (size_t)b * k_sb + (size_t)h * k_sh;
  const void* row = warp ? v_new : k_new;
  float x[kMaxPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    x[i] = 0.f;
    if (d < D) {
      x[i] = in_f32 ? static_cast<const float*>(row)[src + d]
                    : __bfloat162float(
                          static_cast<const __nv_bfloat16*>(row)[src + d]);
      amax = fmaxf(amax, fabsf(x[i]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  int8_t* dst = (warp ? v_cache : k_cache) +
                (((size_t)b * Hkv + h) * S + s) * D;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      const float q = fminf(fmaxf(rintf(x[i] / scale), -128.f), 127.f);
      dst[d] = (int8_t)q;
    }
  }
  if (lane == 0) (warp ? v_scale : k_scale)[((size_t)b * S + s) * Hkv + h] =
      scale;
}

// The decode-step scale write of an int4 cache: one token's per-head K and
// V scales into the slot-major [B, S, Hkv] float32 scale rows.
//
// Replaces llm_inference_tpu/ops/pallas/kv_write.py:write_token_scales
// (_skernel), which read-modify-writes an 8-slot block through a one-hot
// blend; here block b writes row min(offsets[b], S-1) of both scale arrays
// in place (the clamp of kv_write.py:348), thread i one scale. The codes go
// through K3 (the packed rows are D/2 bytes). Bound: 2 x Hkv x 4 bytes per
// sequence, launch-bound like K3.
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

// K4. k_cache/v_cache point at one layer [B, Hkv, S, D] int8 and
// k_scale/v_scale at its [B, S, Hkv] float32 scales; k_new/v_new hold
// row (b, h) at element b * sb + h * sh (D contiguous), bf16, or float32
// when in_f32; offsets int32 [B] on the device. D % 32 == 0, D <= 256.
extern "C" int kv_quant_write_launch(void* k_cache, void* v_cache,
                                     void* k_scale, void* v_scale,
                                     const void* k_new, const void* v_new,
                                     const void* offsets, int B, int Hkv,
                                     int S, int D, int k_sb, int k_sh,
                                     int v_sb, int v_sh, int in_f32,
                                     void* stream) {
  if (D % 32 != 0 || D > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  dim3 grid(Hkv, B);
  kv_quant_write_kernel<<<grid, 64, 0, (cudaStream_t)stream>>>(
      (int8_t*)k_cache, (int8_t*)v_cache, (float*)k_scale, (float*)v_scale,
      k_new, v_new, (const int*)offsets, Hkv, S, D, k_sb, k_sh, v_sb, v_sh,
      in_f32);
  return (int)cudaGetLastError();
}

// k_cache/v_cache point at one layer [B, Hkv, S, row_bytes]; k_new/v_new
// are [B, Hkv, row_bytes]; offsets is int32 [B] on the device.
extern "C" int kv_write_launch(void* k_cache, void* v_cache,
                               const void* k_new, const void* v_new,
                               const void* offsets, int B, int Hkv, int S,
                               int row_bytes, void* stream) {
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  int threads = 2 * row_vecs;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  dim3 grid(Hkv, B);
  kv_write_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint4*)k_cache, (uint4*)v_cache, (const uint4*)k_new,
      (const uint4*)v_new, (const int*)offsets, Hkv, S, row_vecs);
  return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
