// Where a KV cache keeps slot s of (sequence b, kv head h): the address
// policies shared by the dense kernels (K2/K5, K9) and their paged twins
// (K10a/K10b, K11). row() counts cache rows of one layer (a row is one
// slot of one head: D bf16 values, D int8 codes or D/2 packed int4
// bytes); scale() counts float32 scale elements of one layer. Within one
// page (or a dense head) consecutive slots are consecutive rows, and
// their scales lie Hkv elements apart.
#pragma once

#include <stddef.h>

// Dense: one layer's [B, Hkv, S, Dc] codes and [B, S, Hkv] scales.
struct DenseAddr {
  int Hkv, S;
  __device__ __forceinline__ size_t row(int b, int h, int s) const {
    return ((size_t)b * Hkv + h) * S + s;
  }
  __device__ __forceinline__ size_t scale(int b, int h, int s) const {
    return ((size_t)b * S + s) * Hkv + h;
  }
};

// Paged: one layer's pool [P, Hkv, ps, Dc] codes and [P, ps, Hkv] scales,
// page_table [B, NB] int32.
struct PagedAddr {
  int Hkv, NB, ps;
  const int* pt;
  __device__ __forceinline__ size_t row(int b, int h, int s) const {
    const int page = pt[(size_t)b * NB + s / ps];
    return ((size_t)page * Hkv + h) * ps + s % ps;
  }
  __device__ __forceinline__ size_t scale(int b, int h, int s) const {
    const int page = pt[(size_t)b * NB + s / ps];
    return ((size_t)page * ps + s % ps) * Hkv + h;
  }
};
