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
// multiple of 16 bytes.

#include <cuda_runtime.h>
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

}  // namespace

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
