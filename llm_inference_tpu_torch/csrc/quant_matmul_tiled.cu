// K8: the prefill GEMM for M > 128 rows, int8 per-channel or int4 grouped
// weight-only quantized weights; its kernels also carry K1's MMA branch
// (8 < M <= 128, below).
//
// Replaces llm_inference_tpu/ops/pallas/quant_matmul.py:_quant_matmul_tiled
// (_tiled_kernel). Same function and rounding points: the rows enter as
// bf16 (the prologue ran before, qmm_prologue_launch), the codes widen to
// bf16 exactly (they are small integers), the products accumulate in
// float32 and
//   int8:  y[m][n] = bf16( scale[n] * sum_k x[m][k] * code[n][k] )
//   int4:  y[m][n] = bf16( sum_g scale[n][g] * sum_{k in g} x[m][k] * code[n][k] )
// Weight layout (ops/quantization.py): int8 codes [N][K], int4 codes
// [N][K/2] (code 2j in the low nibble of byte j, 2j+1 in the high one),
// scales float32 [N] or [N][G].
//
// Bound on the H100 SXM: operations. One 2048-row prefill chunk of
// LLaMA-2-7B takes 2 x 2048 x 202.4M = 829 GFLOP per layer (wqkv, wo,
// gate-up, down), 0.84 ms at 989 TFLOP/s of bf16; the int8 codes of a layer
// (202 MB) take 0.06 ms to read.
//
// Two routes, chosen by qmm_tiled_route:
//
// 1. qmm_wgmma: int8, and int4 groups of a multiple of 64 codes (the main
//    paths' 128). Hopper's warpgroup MMA (sm90.cuh) computes the product
//    transposed, y^T = W x^T: the weight codes are the A operand, widened
//    in registers, and the rows x the B operand, read from shared memory
//    by descriptor. A block owns 128 weight rows (output columns) by BM
//    rows of x (256 for int8; 176 for int4, whose second accumulator set
//    leaves room for no more) and has three warpgroups:
//    - one producer thread keeps a ring of STAGES slots full by TMA: per
//      64-deep k step the x tile [BM][64] bf16 (128-byte swizzle, the
//      layout the descriptor reads; rows past M arrive as zeros) and the
//      raw code tile [128][64 bytes] (int8, 64-byte swizzle) or [128][32
//      bytes] (int4, 32-byte swizzle), each slot guarded by a "full"
//      mbarrier (its bytes landed) and an "empty" one (256 consumer
//      arrivals);
//    - two consumer warpgroups own 64 weight rows each. Per k step a
//      consumer reads its codes from the slot (conflict-free thanks to
//      the swizzle), widens them into A fragments with exact magic-number
//      conversions (int8: 0x4B0000uu - (2^23 + 128) in float32, one cvt
//      to a bf16 pair; int4: 0x43 above a nibble is the bf16 128 + code +
//      8, minus 136 in one bf16x2 subtract), issues four m64nBMk16
//      wgmmas, waits for them and frees the slot. The consumers are tied
//      by no barrier: one widens while the other's products run;
//    - int4 sums each group into `part` (the group's first wgmma
//      overwrites it) and folds part * scale[n][g] into `acc` after the
//      group's last step; the scales are loaded when the group starts.
//    setmaxnreg moves registers from the producer (40) to the consumers
//    (232): acc is 128 floats a thread for int8, acc + part 88 + 88 for
//    int4. The epilogue scales (int8), swaps values between neighbouring
//    lanes so each thread holds two adjacent columns of one row, and
//    stores bf16 pairs of rows below M. N need only be a multiple of 64:
//    the last band of a width like 32064 or 262208 has 64 weight rows,
//    the TMA fills the missing 64 with zeros (the tensor map has the true
//    N), and the second consumer's products on them are not stored (its
//    scales are read from row 0).
//    Blocks are numbered m tile fastest, so the m tiles of one band of
//    128 weight rows run side by side and the later ones find the codes
//    in L2: the codes cross HBM about once, as on the TPU, whose grid
//    walks the m tiles inside a weight block.
//    Measured against this design (PERF.md §6): the codes widened into
//    shared memory for wgmmas with both operands there (9 % slower), the
//    next step widened under the current step's wgmmas, the two
//    consumers issuing in turns, persistent blocks, and two or three k
//    steps a wgmma group; none was faster. int8 runs near torch.matmul's
//    bf16 rate; int4 is held by the widening, hence its wide tile.
// 2. qmm_tiled: int4 groups of 8, 16 or 32 codes, which no main path
//    runs (a group shorter than the 64-deep k step would need a fold
//    inside one step's wgmmas). The earlier mma.sync kernel: a block owns
//    a 128 x 128 output tile; per 32-deep K chunk it widens the weight
//    chunk to bf16 in shared memory once and all 8 warps reuse it
//    (mma.sync m16n8k16); the x chunk arrives by cp.async into a double
//    buffer. Each group's partial sums take their column scales in
//    registers (a second set of accumulators): a group of 32 codes folds
//    after its chunk, of 16 after each 16-deep product, of 8 after each
//    m16n8k8 half. Rows past M are zero-filled and not stored.
// N must be a multiple of 128 and K of 64 on both routes.
//
// K1's MMA branch (1 <= M <= 128 rows that its GEMV does not take,
// quant_matmul.cu; qmm_mma_launch below) runs the same two kernels, so it
// keeps their rounding points, with these changes to route 1
// (qmm_wgmma_sk):
// - a row tile fitted to M: the x rows are wgmma's N dimension, so the
//   tile is the smallest of 16, 32, 64 and 128 rows that holds M (rows
//   past M arrive as TMA zero fill and are not stored);
// - a grid that fills the card: at M <= 128 the 32-172 weight tiles of
//   LLaMA-2-7B's projections leave SMs idle or start a second wave, so
//   one persistent block an SM takes an even share of tiles x units (a
//   slot of two k steps; for int4 a group), stream-K. A tile covered by
//   one block is stored at once; the partials of a tile that blocks share
//   go to the device's scratch, and the tile's last block to finish (an
//   acq_rel counter, as K2's merge) adds them in block order: the same
//   bits every launch;
// - a ring slot holds two k steps, so a TMA row of codes is 128 (int8)
//   or 64 (int4) contiguous bytes and the second step widens under the
//   first's products; four slots (a deeper ring streamed slower at small
//   M); the codes read once (L2 evict-first), the rows by every tile;
// - a dependent launch: the blocks start, and stream their first codes,
//   while the prologue pre-pass ahead of them (which lets them) runs, and
//   wait for its end before they read the rows.
// Groups of 8, 16 or 32 codes take route 2 with its columns past N (a
// multiple of 64) neither read nor stored. Bound at M = 128 (LLaMA-2-7B,
// int8 codes): about 2 ms for a 128-row prefill's 32 x 4 projections,
// bytes and operations alike (the codes 6.5 GB at 3.35 TB/s against
// 1.66 TFLOP at 989 TFLOP/s); int4 halves the bytes and is bound by the
// operations. Measured against this design, one change at a time
// (PERF.md §6 PR 13): a ring of 6 to 16 slots, no L2 hint, four
// accumulator chains at narrow tiles, the int4 scales loaded a unit
// ahead, a fix-up whose last block writes no partial, no dependent
// launch; none was faster by more than 7 % anywhere.
// Why two wgmma kernels and not one: K8 run as a shape of qmm_wgmma_sk
// (a row tile of 256 / 176 rows, one k step a slot, one block a tile,
// no fix-up compiled, not a dependent launch) was timed against
// qmm_wgmma in turns at 2048 and 1024 rows (PERF.md §6 PR 13, calls
// 12-14): int4 0.92-1.01 of it, but int8 1.03-1.07, more than the 3 %
// K8 may lose; the codes' issue order, where int8's scales load, the
// dependent launch, the fix-up and the A-fragment fence each moved it
// by under 1 %.
//
// The tensor maps of route 1 are encoded on the host for every call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no link against libcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int4_gemv.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

// ------------------------------------------------- route 1: wgmma + TMA

constexpr int kWgThreads = 384;     // producer warpgroup + 2 consumers
constexpr int kWgTN = 128;          // weight rows (output columns) a block
constexpr int kWgTK = 64;           // k a pipeline step

template <bool INT4>
struct Wg {
  static constexpr int BM = INT4 ? 176 : 256;      // output rows a block
  static constexpr int STAGES = INT4 ? 8 : 5;
  static constexpr int XB = BM * kWgTK * 2;        // x tile bytes
  static constexpr int WROW = INT4 ? kWgTK / 2 : kWgTK;
  static constexpr int WB = kWgTN * WROW;          // code tile bytes
  static constexpr int SMEM = STAGES * (XB + WB) + 1024;   // + alignment
};

// Widen k step j of a code tile whose rows are RB bytes into the A
// fragments a[ks][0..3] of the four 16-deep products: rows r and r + 8 of
// the tile. A row holds RB / 64 int8 k steps or RB / 32 int4 ones, stored
// as TMA writes it with the RB-byte swizzle: the 16-byte chunk c of row r
// sits at chunk c ^ ((r RB / 128) mod (RB / 16)), the same for r + 8.
template <int RB>
__device__ __forceinline__ void widen8(uint32_t wtile, int r, int tg, int j,
                                       uint32_t (&a)[4][4]) {
  const int sw = ((r * RB) >> 7) & (RB / 16 - 1);
  const uint32_t sel = 0x7440u | (2u * (tg & 1));
  const uint32_t row[2] = {wtile + r * RB + 4u * (tg >> 1),
                           wtile + (r + 8) * RB + 4u * (tg >> 1)};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t w;
        asm volatile("ld.shared.u32 %0, [%1];\n"
                     : "=r"(w)
                     : "r"(row[i] + 16u * ((4 * j + ks) ^ sw) + 8u * h));
        w ^= 0x80808080u;                       // code + 128 in each byte
        const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) -
                         8388736.0f;
        const float hi =
            __uint_as_float(__byte_perm(w, 0x4B000000u, sel + 1)) -
            8388736.0f;
        a[ks][i + 2 * h] = mma::pack_bf16(lo, hi);
      }
}

template <int RB>
__device__ __forceinline__ void widen4(uint32_t wtile, int r, int tg, int j,
                                       uint32_t (&a)[4][4]) {
  const int sw = ((r * RB) >> 7) & (RB / 16 - 1);
  const __nv_bfloat162 k136 = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t base = wtile + (r + 8 * i) * RB;
    uint32_t w[8];
#pragma unroll
    for (int c = 0; c < 2; ++c)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(w[4 * c]), "=r"(w[4 * c + 1]), "=r"(w[4 * c + 2]),
                     "=r"(w[4 * c + 3])
                   : "r"(base + 16u * ((2 * j + c) ^ sw)));
    // word 2 ks + h holds, in its byte tg, codes 16 ks + 8 h + 2 tg (low
    // nibble) and + 1 (high nibble)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t wd = w[2 * ks + h];
        // the low nibble of byte tg to bits 0-3, the high one (a shifted
        // copy's) to bits 16-19; 0x43 above each and the nibble's sign bit
        // flipped: the bf16 pair 136 + code
        const uint32_t d = __byte_perm(wd, wd >> 4, tg | ((4 + tg) << 8));
        uint32_t v = (d & 0x000F000Fu) ^ 0x43084308u;
        __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
        b = __hsub2(b, k136);
        a[ks][i + 2 * h] = *reinterpret_cast<uint32_t*>(&b);
      }
  }
}

template <bool INT4>
__global__ void __launch_bounds__(kWgThreads, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap xmap,   // x [M][K] bf16
          const __grid_constant__ CUtensorMap wmap,   // codes [N][K'] u8
          const float* __restrict__ scale,            // [N] or [N, G]
          __nv_bfloat16* __restrict__ out,            // [M, N]
          int M, int K, int N, int G) {
  using C = Wg<INT4>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  // the swizzled tiles start 1024-byte aligned: x slots, then code slots
  const uint32_t xs0 = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ws0 = xs0 + C::STAGES * C::XB;
  const int nk = K / kWgTK;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * kWgTN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::STAGES;
        sm90::mbar_wait(&empty[s], ((kt / C::STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], C::XB + C::WB);
        sm90::tma_load_2d(xs0 + s * C::XB, &xmap, &full[s], kt * kWgTK, m0);
        sm90::tma_load_2d(ws0 + s * C::WB, &wmap, &full[s], kt * C::WROW,
                          n0);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns weight rows 64c..64c+63
    sm90::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int gr = lane >> 2, tg = lane & 3;
    const int r = 64 * c + 16 * warp + gr;      // rows r, r + 8 of the tile
    // this warpgroup's 64 weight rows exist (N is a multiple of 64)
    const bool rows_in = n0 + 64 * c < N;
    const size_t row = rows_in ? (size_t)n0 + r : 0;
    constexpr int ND = C::BM / 2;               // accumulators a thread
    float acc[ND];
    float part[INT4 ? ND : 1];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    // int4: k steps a group, and the group's two row scales
    const int spg = INT4 ? (K / G) / kWgTK : 1;
    float gs0 = 0.f, gs1 = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % C::STAGES;
      const bool first = INT4 && kt % spg == 0;
      if (first) {
        const int g = kt / spg;
        gs0 = __ldg(scale + row * G + g);
        gs1 = __ldg(scale + (row + 8) * G + g);
      }
      sm90::mbar_wait(&full[s], (kt / C::STAGES) & 1);
      uint32_t a[4][4];
      if constexpr (INT4)
        widen4<32>(ws0 + s * C::WB, r, tg, 0, a);
      else
        widen8<64>(ws0 + s * C::WB, r, tg, 0, a);
      const uint32_t xs = xs0 + s * C::XB;
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t desc = sm90::desc_k128(xs + 32u * ks);
        if constexpr (INT4)
          sm90::wgmma_rs(part, a[ks], desc, (first && ks == 0) ? 0 : 1);
        else
          sm90::wgmma_rs(acc, a[ks], desc, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      if constexpr (INT4) {
        sm90::fence_regs(part);
      } else {
        sm90::fence_regs(acc);
      }
      sm90::mbar_arrive(&empty[s]);
      if constexpr (INT4) {
        if ((kt + 1) % spg == 0) {              // the group is complete
#pragma unroll
          for (int i = 0; i < ND; ++i)
            acc[i] = fmaf(part[i], (i & 2) ? gs1 : gs0, acc[i]);
          sm90::fence_regs(acc);                // done before part is reused
        }
      }
    }

    // epilogue: thread holds y[m][n] for n = n0 + r (+ 8) and m = m0 + 8j
    // + 2tg (+ 1); lanes gr and gr ^ 1 trade so each stores a column pair
    float s0 = 1.f, s1 = 1.f;
    if constexpr (!INT4) {
      s0 = __ldg(scale + row);
      s1 = __ldg(scale + row + 8);
    }
    const int odd = gr & 1;
#pragma unroll
    for (int j = 0; j < C::BM / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sh = h ? s1 : s0;
        const float v0 = acc[4 * j + 2 * h] * sh;       // row m, column n
        const float v1 = acc[4 * j + 2 * h + 1] * sh;   // row m + 1
        const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        const int mm = m0 + 8 * j + 2 * tg + odd;
        const int nn = n0 + r + 8 * h - odd;
        if (mm < M && rows_in)
          *reinterpret_cast<uint32_t*>(out + (size_t)mm * N + nn) =
              odd ? mma::pack_bf16(got, v1) : mma::pack_bf16(v0, got);
      }
    }
  }
}

// ------------------------- route 1 for K1's 1 <= M <= 128 rows: stream-K

// A slot holds two 64-deep k steps: the x tiles [BM][64] of both (128-byte
// swizzle each) and the codes [128][2 steps] (int8 128-byte rows, int4
// 64-byte rows), so each TMA row of codes is 128 or 64 contiguous bytes.
template <bool INT4, int BM>
struct Sk {
  static constexpr int XB1 = BM * kWgTK * 2;       // one step's x tile
  static constexpr int XB = 2 * XB1;
  static constexpr int WROW = INT4 ? kWgTK : 2 * kWgTK;   // bytes a row
  static constexpr int WB = kWgTN * WROW;          // code tile bytes
  // four slots (or as many as fit): a deeper ring streamed the codes
  // slower at M <= 64 (0.0498 against 0.0397 ms at 11 slots on int8
  // w_gateup, M = 16, PERF.md), and no faster at 128
  static constexpr int FIT = (232448 - 2048) / (XB + WB);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = STAGES * (XB + WB) + 1024;   // + alignment
};

// The 256 consumer threads meet (named barrier 1; the producer warpgroup
// does not take part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// atomicAdd with release and acquire semantics at device scope (as K2's
// merge, decode_tile.cuh)
__device__ __forceinline__ int add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Keep the A fragments of a slot's two k steps in their registers until
// here: a wgmma reads them after it is issued, so the second step's
// widening must not take the first's registers before the wait.
__device__ __forceinline__ void fence_a(uint32_t (&a)[2][4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("" : "+r"(a[h][ks][i]) :: "memory");
}

// acc += a completed int4 group's sums times its scales (rows r, r + 8)
template <int ND>
__device__ __forceinline__ void fold(float (&acc)[ND], float (&grp)[ND],
                                     float gs0, float gs1) {
#pragma unroll
  for (int i = 0; i < ND; ++i)
    acc[i] = fmaf(grp[i], (i & 2) ? gs1 : gs0, acc[i]);
  sm90::fence_regs(acc);                        // done before grp is reused
}

// Block b of a stream-K launch of P blocks over `total` units owns the
// units [sk_first(b), sk_first(b + 1)); sk_block(u) is the owner of u.
__device__ __forceinline__ int sk_first(int b, int P, int total) {
  return (int)((long long)b * total / P);
}

__device__ __forceinline__ int sk_block(int u, int P, int total) {
  return (int)(((long long)(u + 1) * P - 1) / total);
}

// The work is tiles x units: a tile is 128 weight rows (output columns),
// a unit `spu` slots of two k steps (int8: one slot; int4: the slots of
// one group, or of two groups of an odd number of steps), the k steps
// past K zero-filled by TMA. Block b takes the units [b total / P,
// (b + 1) total / P) in tile-major order through one TMA ring, as many as
// every other block to within one. A tile it covers whole is stored at
// once; a tile it shares writes its float32 partial (int8 unscaled, int4
// with its groups' scales) to the block's slot in `part` (slot 2b for its
// first tile, 2b + 1 for its last), and the tile's last block to finish
// (an acq_rel count in done[tile], zero between launches and left so)
// adds the partials in block order: the same bits every launch.
template <bool INT4, int BM, bool ODD>
__global__ void __launch_bounds__(kWgThreads, 1)
qmm_wgmma_sk(const __grid_constant__ CUtensorMap xmap,   // x [M][K] bf16
             const __grid_constant__ CUtensorMap wmap,   // codes [N][K'] u8
             const float* __restrict__ scale,            // [N] or [N, G]
             __nv_bfloat16* __restrict__ out,            // [M, N]
             float* __restrict__ part,                   // [2 P][BM 128]
             int* __restrict__ done,                     // [tiles]
             int M, int N, int G, int spg, int units, int spu, int total) {
  using C = Sk<INT4, BM>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  __shared__ int s_last;
  const uint32_t xs0 = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ws0 = xs0 + C::STAGES * C::XB;
  const int P = gridDim.x, b = blockIdx.x;
  const int lo = sk_first(b, P, total), hi = sk_first(b + 1, P, total);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy; the codes are read
    // once (evict first), the rows by every tile (kept in L2)
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const uint64_t policy = sm90::policy_evict_first();
      sm90::prefetch_tensormap(&wmap);
      sm90::prefetch_tensormap(&xmap);
      // the codes of the first slots go out before the rows: they are
      // weights, the rows the output of the kernel ahead on the stream,
      // which may still run (a dependent launch) until
      // grid_dependency_wait returns
      int cnt = 0;
      for (int u = lo; u < hi && cnt < C::STAGES; ++u) {
        const int t = u / units;
        const int q0 = (u - t * units) * spu;      // the unit's first slot
        for (int j = 0; j < spu && cnt < C::STAGES; ++j, ++cnt) {
          sm90::mbar_expect_tx(&full[cnt], C::XB + C::WB);
          sm90::tma_load_2d_hint(ws0 + cnt * C::WB, &wmap, &full[cnt],
                                 (q0 + j) * C::WROW, t * kWgTN, policy);
        }
      }
      const int early = cnt;
      sm90::grid_dependency_wait();
      cnt = 0;
      for (int u = lo; u < hi; ++u) {
        const int t = u / units;
        const int q0 = (u - t * units) * spu;
        for (int j = 0; j < spu; ++j, ++cnt) {
          const int s = cnt % C::STAGES;
          const int k0 = 2 * (q0 + j) * kWgTK;
          if (cnt >= early) {
            sm90::mbar_wait(&empty[s], ((cnt / C::STAGES) & 1) ^ 1);
            sm90::mbar_expect_tx(&full[s], C::XB + C::WB);
            sm90::tma_load_2d_hint(ws0 + s * C::WB, &wmap, &full[s],
                                   (q0 + j) * C::WROW, t * kWgTN, policy);
          }
          sm90::tma_load_2d(xs0 + s * C::XB, &xmap, &full[s], k0, 0);
          sm90::tma_load_2d(xs0 + s * C::XB + C::XB1, &xmap, &full[s],
                            k0 + kWgTK, 0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns weight rows 64c..64c+63 of a tile
    sm90::setmaxnreg_inc<232>();
    const int ct = threadIdx.x - 128;
    const int c = ct / 128;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int gr = lane >> 2, tg = lane & 3;
    const int r = 64 * c + 16 * warp + gr;      // rows r, r + 8 of the tile
    constexpr int ND = BM / 2;                  // accumulators a thread
    float acc[ND];
    float grp[INT4 ? ND : 1];
    // The scales come from valid addresses for the rows past N and the
    // steps past K (whose sums are not stored, or are zero), so no branch
    // that differs between threads sits among the products (ptxas then
    // serialises the wgmmas, C7520): a tile's row scales (int8) as it
    // starts, a group's (int4) as the group starts.
    float gs0 = 0.f, gs1 = 0.f;
    int cnt = 0;
    for (int u = lo; u < hi;) {
      const int t = u / units, n0 = t * kWgTN;
      const int ufirst = u;
      const int uend = min(hi, (t + 1) * units);
      // this warpgroup's 64 weight rows exist (N is a multiple of 64)
      const bool rows_in = n0 + 64 * c < N;
      const size_t row = rows_in ? (size_t)n0 + r : 0;
      float s0 = 1.f, s1 = 1.f;
      if constexpr (!INT4) {
        s0 = __ldg(scale + row);
        s1 = __ldg(scale + row + 8);
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = 0.f;
      for (; u < uend; ++u) {
        const int q0 = (u - t * units) * spu;
        for (int j = 0; j < spu; ++j, ++cnt) {
          const int s = cnt % C::STAGES;
          const uint32_t xs = xs0 + s * C::XB, ws = ws0 + s * C::WB;
          sm90::mbar_wait(&full[s], (cnt / C::STAGES) & 1);
          uint32_t a[2][4][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {         // the slot's two k steps
            const int kt = 2 * (q0 + j) + h;
            // a group starts at the slot's first step unless a group is an
            // odd number of steps (ODD)
            const bool first = INT4 && (ODD || h == 0) && kt % spg == 0;
            if (first) {
              const int g = min(kt / spg, G - 1);
              gs0 = __ldg(scale + row * G + g);
              gs1 = __ldg(scale + (row + 8) * G + g);
            }
            if constexpr (INT4)
              widen4<C::WROW>(ws, r, tg, h, a[h]);
            else
              widen8<C::WROW>(ws, r, tg, h, a[h]);
            sm90::wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              const uint64_t desc =
                  sm90::desc_k128(xs + h * C::XB1 + 32u * ks);
              if constexpr (INT4)             // a group's first product
                sm90::wgmma_rs(grp, a[h][ks], desc,    // overwrites grp
                               (first && ks == 0) ? 0 : 1);
              else
                sm90::wgmma_rs(acc, a[h][ks], desc, 1);
            }
            if constexpr (ODD) {                // a group may end here
              sm90::wgmma_commit();
              sm90::wgmma_wait<0>();
              sm90::fence_regs(grp);
              if ((kt + 1) % spg == 0) fold(acc, grp, gs0, gs1);
            }
          }
          if constexpr (!ODD) {
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
          }
          fence_a(a);
          if constexpr (INT4) {
            sm90::fence_regs(grp);
            // groups of an even number of steps end with a slot
            if (!ODD && (2 * (q0 + j) + 2) % spg == 0)
              fold(acc, grp, gs0, gs1);
          } else {
            sm90::fence_regs(acc);
          }
          sm90::mbar_arrive(&empty[s]);
        }
      }

      if (ufirst != t * units || uend != (t + 1) * units) {
        // a shared tile: this block's partial to its slot; the tile's last
        // block adds the partials of its blocks in block order
        float4* mine = reinterpret_cast<float4*>(
            part + (size_t)(2 * b + (ufirst == lo ? 0 : 1)) * (BM * kWgTN));
#pragma unroll
        for (int q = 0; q < ND / 4; ++q)
          __stcg(mine + q * 256 + ct, make_float4(acc[4 * q], acc[4 * q + 1],
                                                  acc[4 * q + 2],
                                                  acc[4 * q + 3]));
        const int b_lo = sk_block(t * units, P, total);
        const int b_hi = sk_block((t + 1) * units - 1, P, total);
        consumer_sync();                        // the partial is written;
        if (ct == 0)                            // released to the tile's
          s_last = add_acq_rel(done + t, 1) == b_hi - b_lo;   // other
        consumer_sync();                        // blocks, theirs acquired
        if (!s_last) continue;
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] = -0.f;
        for (int bb = b_lo; bb <= b_hi; ++bb) {
          const int slot =
              2 * bb + (sk_first(bb, P, total) / units == t ? 0 : 1);
          const float4* p = reinterpret_cast<const float4*>(
                                part + (size_t)slot * (BM * kWgTN)) + ct;
          float4 v[ND / 4];                     // all loads in flight
#pragma unroll
          for (int q = 0; q < ND / 4; ++q) v[q] = __ldcg(p + q * 256);
#pragma unroll
          for (int q = 0; q < ND / 4; ++q) {
            acc[4 * q] += v[q].x;
            acc[4 * q + 1] += v[q].y;
            acc[4 * q + 2] += v[q].z;
            acc[4 * q + 3] += v[q].w;
          }
        }
        if (ct == 0) done[t] = 0;               // ready for the next launch
      }

      // the tile's output, as qmm_wgmma's epilogue, for rows below M and
      // weight rows below N
      if (!rows_in) continue;
      const int odd = gr & 1;
#pragma unroll
      for (int jj = 0; jj < BM / 8; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sh = h ? s1 : s0;
          const float v0 = acc[4 * jj + 2 * h] * sh;
          const float v1 = acc[4 * jj + 2 * h + 1] * sh;
          const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
          const int mm = 8 * jj + 2 * tg + odd;
          const int nn = n0 + r + 8 * h - odd;
          if (mm < M)
            *reinterpret_cast<uint32_t*>(out + (size_t)mm * N + nn) =
                odd ? mma::pack_bf16(got, v1) : mma::pack_bf16(v0, got);
        }
      }
    }
  }
}

// ------------------------------------------ route 2: mma.sync, int4 only

constexpr int TM = 128, TN = 128, TK = 32;
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N
constexpr int LDS = TK + 8;         // bf16 per shared row (80 bytes)

// SUB: 0 for groups of 32 codes, else the group size (16 or 8). EDGE: N
// is a multiple of 64 only, and the last tile's columns past N are
// neither read nor stored.
template <int SUB, bool EDGE>
__global__ void __launch_bounds__(kThreads, 1)
qmm_tiled(const __nv_bfloat16* __restrict__ a,   // [M, K] bf16 rows
          const uint8_t* __restrict__ w,         // this layer's codes
          const float* __restrict__ scale,       // [N, G]
          __nv_bfloat16* __restrict__ out,       // [M, N]
          int M, int K, int N, int G) {
  __shared__ __align__(16) __nv_bfloat16 As[2][TM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][TN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;   // warp tile 64 x 32
  const int gr = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int nk = K / TK;

  // this thread's share of a weight chunk: 16 codes of column bcol
  const int bcol = tid >> 1, bhalf = tid & 1;
  const uint8_t* wsrc = w + (size_t)(n0 + bcol) * (K / 2) + bhalf * 8;

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = part[i][j][c] = 0.f;

  auto load_a = [&](int kt, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {            // 128 rows x 4 vectors of 16 B
      const int v = tid + i * kThreads;
      const int r = v >> 2, c = (v & 3) * 8;
      const int row = m0 + r;
      const __nv_bfloat16* src =
          a + (size_t)(row < M ? row : M - 1) * K + (size_t)kt * TK + c;
      mma::cp_async16(&As[buf][r * LDS + c], src, row < M ? 16 : 0);
    }
  };
  uint2 wraw;                                 // 16 codes
  const bool col_in = !EDGE || n0 + bcol < N;
  auto load_w = [&](int kt) {
    wraw = col_in ? __ldg(reinterpret_cast<const uint2*>(wsrc + kt * 16))
                  : make_uint2(0u, 0u);
  };
  auto store_w = [&](int buf) {              // 16 codes → 16 exact bf16
    uint32_t p[8];
    float c0[8], c1[8];
    int4g::unpack8(wraw.x, c0);
    int4g::unpack8(wraw.y, c1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = mma::exact_bf16_bits(c0[2 * j]) |
             (mma::exact_bf16_bits(c0[2 * j + 1]) << 16);
      p[4 + j] = mma::exact_bf16_bits(c1[2 * j]) |
                 (mma::exact_bf16_bits(c1[2 * j + 1]) << 16);
    }
    uint4* dst = reinterpret_cast<uint4*>(&Bs[buf][bcol * LDS + bhalf * 16]);
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
  };

  // acc += part * (group g's column scales), then part = 0
  auto fold = [&](int g) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + tg * 2;
      if (EDGE && col >= N) continue;
      const float s0 = __ldg(scale + (size_t)col * G + g);
      const float s1 = __ldg(scale + (size_t)(col + 1) * G + g);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        acc[mi][ni][0] = fmaf(part[mi][ni][0], s0, acc[mi][ni][0]);
        acc[mi][ni][1] = fmaf(part[mi][ni][1], s1, acc[mi][ni][1]);
        acc[mi][ni][2] = fmaf(part[mi][ni][2], s0, acc[mi][ni][2]);
        acc[mi][ni][3] = fmaf(part[mi][ni][3], s1, acc[mi][ni][3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) part[mi][ni][c] = 0.f;
      }
    }
  };

  load_a(0, 0);
  mma::cp_async_commit();
  load_w(0);
  store_w(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_a(kt + 1, buf ^ 1);
      load_w(kt + 1);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();                 // chunk kt's rows have landed
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks) {
      const int c = ks * 16 + tg * 2;
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* r0 = &As[buf][(wm + mi * 16 + gr) * LDS + c];
        const __nv_bfloat16* r1 = r0 + 8 * LDS;
        af[mi][0] = mma::lds32(r0);
        af[mi][1] = mma::lds32(r1);
        af[mi][2] = mma::lds32(r0 + 8);
        af[mi][3] = mma::lds32(r1 + 8);
      }
      if constexpr (SUB == 8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {        // the product's two k-halves
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const uint32_t b = mma::lds32(
                &Bs[buf][(wn + ni * 8 + gr) * LDS + c + 8 * h]);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
              mma::mma_1688(part[mi][ni], af[mi][2 * h], af[mi][2 * h + 1],
                            b);
          }
          fold(kt * 4 + ks * 2 + h);
        }
      } else {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* bp = &Bs[buf][(wn + ni * 8 + gr) * LDS + c];
          const uint32_t b0 = mma::lds32(bp), b1 = mma::lds32(bp + 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            mma::mma_16816(part[mi][ni], af[mi], b0, b1);
        }
        if constexpr (SUB == 16) fold(kt * 2 + ks);
      }
    }
    if constexpr (SUB == 0) fold(kt);        // a 32-code group is complete
    // the other buffer was last read before this iteration's barrier
    if (kt + 1 < nk) store_w(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + tg * 2;
    if (EDGE && col >= N) continue;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = m0 + wm + mi * 16 + gr;
      if (row < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
            mma::pack_bf16(acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * N + col) =
            mma::pack_bf16(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

// ------------------------------------------------------------- host side

using EncodeFn = decltype(&cuTensorMapEncodeTiled);

EncodeFn encode_fn() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeFn>(p);
  }();
  return fn;
}

// A 2-D row-major tensor [rows][cols] of `type` as TMA tiles [box_rows]
// [box_cols]; false if the encoding is refused.
bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
            const void* ptr, int rows, int cols, int box_rows, int box_cols,
            CUtensorMapSwizzle swizzle) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool INT4>
int launch_wgmma(const void* a, const void* w, const void* scale, void* out,
                 int M, int K, int N, int G, cudaStream_t st) {
  using C = Wg<INT4>;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, M, K, C::BM,
              kWgTK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N,
              INT4 ? K / 2 : K, kWgTN, C::WROW,
              INT4 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      qmm_wgmma<INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + C::BM - 1) / C::BM, (N + kWgTN - 1) / kWgTN);
  qmm_wgmma<INT4><<<grid, kWgThreads, C::SMEM, st>>>(
      xmap, wmap, (const float*)scale, (__nv_bfloat16*)out, M, K, N, G);
  return (int)cudaGetLastError();
}

template <bool INT4, int BM, bool ODD>
int launch_sk(const void* a, const void* w, const void* scale, void* out,
              void* part, void* done, int M, int K, int N, int G, int grid,
              int spg, int units, int spu, int total, cudaStream_t st) {
  using C = Sk<INT4, BM>;
  auto kernel = qmm_wgmma_sk<INT4, BM, ODD>;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, M, K, BM,
              kWgTK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N,
              INT4 ? K / 2 : K, kWgTN, C::WROW,
              INT4 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  // the shared memory limit is set once a device (bit d of `set`)
  static unsigned set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(set & (1u << dev))) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) set |= 1u << dev;
  }
  // a dependent launch: the blocks start, and stream their first codes,
  // while the kernel ahead (the prologue pre-pass, which lets them) ends
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap,
                         (const float*)scale, (__nv_bfloat16*)out,
                         (float*)part, (int*)done, M, N, G, spg, units, spu,
                         total);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool INT4, bool ODD>
int launch_sk_rows(const void* a, const void* w, const void* scale,
                   void* out, void* part, void* done, int M, int K, int N,
                   int G, int bm, int grid, int spg, int units, int spu,
                   int total, cudaStream_t st) {
  switch (bm) {
    case 16:
      return launch_sk<INT4, 16, ODD>(a, w, scale, out, part, done, M, K, N,
                                      G, grid, spg, units, spu, total, st);
    case 32:
      return launch_sk<INT4, 32, ODD>(a, w, scale, out, part, done, M, K, N,
                                      G, grid, spg, units, spu, total, st);
    case 64:
      return launch_sk<INT4, 64, ODD>(a, w, scale, out, part, done, M, K, N,
                                      G, grid, spg, units, spu, total, st);
    case 128:
      return launch_sk<INT4, 128, ODD>(a, w, scale, out, part, done, M, K,
                                       N, G, grid, spg, units, spu, total,
                                       st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool EDGE>
int launch_tiled(const void* a, const void* w, const void* scale, void* out,
                 int M, int K, int N, int G, cudaStream_t st) {
  dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN);
  const __nv_bfloat16* ap = (const __nv_bfloat16*)a;
  const uint8_t* wp = (const uint8_t*)w;
  const float* sp = (const float*)scale;
  __nv_bfloat16* op = (__nv_bfloat16*)out;
  const int gsize = K / G;
  if (gsize == 8)
    qmm_tiled<8, EDGE><<<grid, kThreads, 0, st>>>(ap, wp, sp, op, M, K, N,
                                                  G);
  else if (gsize == 16)
    qmm_tiled<16, EDGE><<<grid, kThreads, 0, st>>>(ap, wp, sp, op, M, K, N,
                                                   G);
  else
    qmm_tiled<0, EDGE><<<grid, kThreads, 0, st>>>(ap, wp, sp, op, M, K, N,
                                                  G);
  return (int)cudaGetLastError();
}

// qmm_tiled for groups of 8, 16 or 32 codes; N a multiple of 64
int launch_small_groups(const void* a, const void* w, const void* scale,
                        void* out, int M, int K, int N, int G,
                        cudaStream_t st) {
  return N % TN == 0
             ? launch_tiled<false>(a, w, scale, out, M, K, N, G, st)
             : launch_tiled<true>(a, w, scale, out, M, K, N, G, st);
}

}  // namespace

// Which kernel qmm_tiled_launch runs for a layer's shape: 1 the wgmma
// kernel (int8, int4 groups of a multiple of 64 codes), 0 the mma.sync
// kernel (int4 groups of 8, 16 or 32 codes), -1 none (it would refuse).
extern "C" int qmm_tiled_route(int K, int N, int G, int bits) {
  if (K % kWgTK != 0 || N % 64 != 0 || (bits != 4 && bits != 8))
    return -1;
  if (bits == 8) return 1;
  const int gsize = G >= 1 && K % G == 0 ? K / G : 0;
  if (gsize % kWgTK == 0 && gsize > 0) return 1;
  return gsize == 32 || gsize == 16 || gsize == 8 ? 0 : -1;
}

// a: bf16 rows [M, K]; w: ONE layer's codes (int8 [N, K] when bits == 8,
// packed int4 [N, K/2] when bits == 4), 16-byte aligned; scale: float32
// [N] (int8) or [N, G] (int4); out: bf16 [M, N]. Requires K % 64 == 0,
// N % 64 == 0 and, for int4, groups of K / G codes a multiple of 64, or
// 32, 16 or 8.
extern "C" int qmm_tiled_launch(const void* a, const void* w,
                                const void* scale, void* out, int M, int K,
                                int N, int G, int bits, void* stream) {
  const int route = qmm_tiled_route(K, N, G, bits);
  if (M < 1 || route < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1)
    return bits == 8 ? launch_wgmma<false>(a, w, scale, out, M, K, N, G, st)
                     : launch_wgmma<true>(a, w, scale, out, M, K, N, G, st);
  return launch_small_groups(a, w, scale, out, M, K, N, G, st);
}

extern "C" int qmm_prologue_launch(const void* x, const void* res,
                                   const void* gamma, void* xn, void* xout,
                                   int M, int K, float eps, void* stream);

// K1's branch for 1 <= M <= 128 rows that the GEMV does not take
// (quant_matmul.cu): the prologue pre-pass when there is one (gamma, res
// or xout given: xn = bf16(rms_norm(x + res) * gamma), xout = bf16(x +
// res); xn a bf16 [M, K] scratch), then the product on xn (else on x):
// int8 and int4 groups of a multiple of 64 codes on qmm_wgmma_sk,
// int4 groups of 8, 16 or 32 codes on qmm_tiled. plan: int64 {M, K, N, G,
// bits, bm, grid, part, done, spg, units, spu, total}
// (ops/kernels/quant_matmul.py, mma_plan): a row tile of bm rows (16, 32,
// 64 or 128, at least M), `grid` persistent blocks over `total` units of
// spu two-step slots, `units` a tile, spg k steps an int4 group; part
// float32 [2 grid][bm 128], done int32 [ceil(N / 128)] zeros, left so
// (neither used by qmm_tiled). One array, kept by the caller per shape,
// in place of thirteen arguments a call. Requires K % 64 == 0,
// N % 64 == 0.
extern "C" int qmm_mma_launch(const void* x, const void* res,
                              const void* gamma, void* xn, void* xout,
                              const void* w, const void* scale, void* out,
                              const long long* plan, float eps,
                              void* stream) {
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const int M = (int)plan[0], K = (int)plan[1], N = (int)plan[2];
  const int G = (int)plan[3], bits = (int)plan[4], bm = (int)plan[5];
  const int grid = (int)plan[6];
  void* part = reinterpret_cast<void*>(plan[7]);
  void* done = reinterpret_cast<void*>(plan[8]);
  const int spg = (int)plan[9], units = (int)plan[10], spu = (int)plan[11];
  const int total = (int)plan[12];
  if (M < 1 || M > 128 || M > bm || K % kWgTK != 0 || N % 64 != 0 ||
      (bits != 4 && bits != 8) || (bits == 4 && (G < 1 || K % G != 0)))
    return (int)cudaErrorInvalidValue;
  const int gsize = bits == 4 ? K / G : 0;
  const bool wg = bits == 8 || gsize % kWgTK == 0;
  if (!wg && gsize != 8 && gsize != 16 && gsize != 32)
    return (int)cudaErrorInvalidValue;
  // the plan covers the shape: every k step of every tile once
  if (wg && (part == nullptr || done == nullptr || spu < 1 || units < 1 ||
             grid < 1 || grid > total ||
             total != (N + kWgTN - 1) / kWgTN * units ||
             (long long)units * spu * 2 * kWgTK < K ||
             (long long)(units - 1) * spu * 2 * kWgTK >= K ||
             (bits == 4 && spg * kWgTK != gsize)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const void* a = x;
  if (gamma || res || xout) {
    const int e = qmm_prologue_launch(x, res, gamma, xn, xout, M, K, eps,
                                      stream);
    if (e != 0) return e;
    a = xn;
  }
  if (!wg) return launch_small_groups(a, w, scale, out, M, K, N, G, st);
  if (bits == 8)
    return launch_sk_rows<false, false>(a, w, scale, out, part, done, M, K,
                                        N, G, bm, grid, 1, units, spu, total,
                                        st);
  // groups of an odd number of k steps end inside a slot (a wait there)
  if (spg % 2)
    return launch_sk_rows<true, true>(a, w, scale, out, part, done, M, K, N,
                                      G, bm, grid, spg, units, spu, total,
                                      st);
  return launch_sk_rows<true, false>(a, w, scale, out, part, done, M, K, N,
                                     G, bm, grid, spg, units, spu, total,
                                     st);
}
