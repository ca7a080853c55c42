// The weight ring of the cooperative layer kernels: K6/K7 (layer_tail.cu)
// and K12 (layer_fused.cu), and in a one-phase instance without a grid
// barrier K1's int4 GEMV (qmm4_gemv.cu). One persistent block an SM
// streams a layer's quantized weights, phase after phase, through a ring
// of shared-memory slots and multiplies them by one to 32 activation rows
// on the tensor cores. What the kernels add is their phases' epilogues,
// the work between the phases and the grid barriers that separate them.
//
// The block: ten warps.
// - A weight producer warp streams the block's weights, phase after phase,
//   into a ring of R slots: a stage's codes as 2-D TMA boxes (the copy
//   engine; a box is a 128-byte k-slab of every column of the batch,
//   128-byte swizzled, L2 promotion of 256 bytes, evicted first from L2 so
//   that the code, the activations and the scratch stay: the next phase's
//   first stage had computed twice as long), its int4 group scales by
//   4-byte cp.async, one mbarrier a slot counting both. It never waits for
//   the phases: the weights do not depend on the activations, so while the
//   consumers wait at a grid barrier (or attend, K12) it runs on into the
//   next phase's stages until the ring is full. (A 1-D bulk copy a column
//   a stage measured about 50 ns a copy on the H100, serialised.)
// - An activation producer warp copies each stage's activation rows (and a
//   norm phase's gamma) beside the weights, on a second mbarrier a slot;
//   before a phase whose rows a grid barrier makes it first waits for that
//   barrier (Phase::gate). A phase whose rows the consumers hold in shared
//   memory (Phase::eb == 0, Smem::xs at a pitch of Phase::ap bytes: K12's
//   first phase, M = 1; K1's GEMV, M <= 8) only arrives on the slot's
//   barrier, which keeps the two producers in step.
// - Eight consumer warps split each stage's K among themselves (one 32-code
//   chunk each, q chunks for a stage of 256 q codes), each holding the sums
//   of every column of the batch, and release the slot. They bound the
//   kernels on the H100 (about 17 instructions a tile of 8 columns x 32
//   int4 codes, two of them mma.sync).
//
// Work spread evenly: a phase's N columns (gate-up: its I gate/up pairs)
// are cut into nblk contiguous ranges that differ by at most one column,
// so every SM streams the same bytes of each phase to within one column,
// less than one stage. More columns a block than a batch holds (192 int4,
// 128 int4 in groups of 16 or 8, 96 int8 columns) run in batches; a
// phase with a cap (K1's GEMV) runs batches of sizes within one unit of
// each other, at most the cap (a batch computes every tile its
// instantiation holds: 243 columns as 192 + 51 compute 48 tiles, as
// 122 + 121 32). At M <= 8 rows every weight byte is streamed once; rows
// beyond come in passes of 8.
//
// Products on the tensor cores: mma.sync.m16n8k16 with the activations as
// A and the codes as B (8 output columns x 16 k), widened exactly to bf16
// in registers.
// - int4, float32 rows (forms kFormNorm, kFormF32): rows 0-7 of A are the
//   eight rows of a pass in bf16, rows 8-15 their bf16 remainders
//   x - bf16(x): the two products land in one float32 sum, so the
//   activations keep 16 bits of mantissa. bf16 rows (kFormBf16) leave the
//   remainders 0. A nibble u = code + 8 placed in the mantissa of bf16 128
//   reads 136 + code, and one bf16x2 subtraction leaves the code. Groups
//   of 32k codes: a lane takes the 8 codes of one 32-bit word (nibbles i
//   and i + 4 paired), the four lanes of a column the chunk's four words,
//   so a chunk's two products lie in one group and take its scale once:
//   acc += s * (hi + lo). Groups of 16 (8): the four lanes share a word,
//   each taking nibbles t and t + 4, a product per group (m16n8k8 for 8),
//   each folding its own scale.
// - int8 per channel (kVarI8): rows 0-7 of A the rows rounded to bf16 (the
//   int8 GEMVs dot bf16(x)), rows 8-15 zero. A lane takes word t of each of
//   the chunk's two 16-byte units; a code c's byte b = c mod 256 becomes
//   bf16 exactly as (128 + (b & 127)) - (128 or 256 by b's top bit): both
//   terms are bf16 bit patterns made by one lop3 each (0x4300 | ...; the
//   top bit lands on the exponent's lowest bit), and one bf16x2
//   subtraction leaves the code. Bytes 0 and 2 of a word make one register,
//   1 and 3 (after a shift) the other: 7 instructions for 4 codes. The
//   products add up in the mma's own float32 accumulator; the column's
//   scale multiplies the sum in the epilogue. Grouped int8 (kVarI8G,
//   groups of 32k codes, K12) takes each chunk's products in a fresh
//   accumulator and folds them times the group's scale, the scales
//   copied beside the codes as int4's groups of 32k codes are.
//
// Every sum (the consumer warps' partials, the partials of the squares) is
// taken in a fixed order, so two calls on the same inputs give the same
// bits.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace ring {

// consumer warps: a stage's chunks split eight ways, each warp taking
// every tile of 8 columns of its chunks (sixteen warps, two with half the
// tiles each, measured slower in K6: 96 registers and spills)
constexpr int kConsumers = 8;
constexpr int kConsumerThreads = kConsumers * 32;
constexpr int kWeightWarp = kConsumers;        // then the two producers
constexpr int kActWarp = kConsumers + 1;
constexpr int kThreads = (kConsumers + 2) * 32;
constexpr int kMaxM = 32;
constexpr int kRows = 8;                       // rows a pass (mma n / 2)
constexpr int kStageCodes = 256;               // a stage is q x 256 codes
constexpr int kMaxCols = 192;                  // int4 columns a batch
constexpr int kMaxQ = 8;
constexpr int kMaxSlots = 16;
constexpr int kMaxPhases = 4;
constexpr int kSmemMax = 232448;
constexpr int kMaxDevices = 64;
// scratch floats before the kernels' own; the first word is the grid
// barrier's counter (zero when allocated, a multiple of 2^31 between
// launches)
constexpr int kHeader = 64;
// shared memory: 3 x kMaxSlots mbarriers, the phase flag, rstd[32], the
// block's sums of squares [32] and their per-thread partials [256]; then
// the consumers' partial sums (and the kernel's own area); then the ring
constexpr int kOffFlag = 3 * kMaxSlots * 8;
constexpr int kOffRstd = kOffFlag + 16;
constexpr int kOffSs = kOffRstd + kMaxM * 4;
constexpr int kOffSsr = kOffSs + kMaxM * 4;
constexpr int kColGroups = kConsumerThreads / 8;   // epilogue: 8 rows
constexpr int kMisc = 3072;
static_assert(kOffSsr + kConsumerThreads * 4 <= kMisc, "misc area");
constexpr int kAlign = 1024;                   // a swizzled TMA box's start
constexpr int kSlab = 128;                     // bytes of a box row

// how the consumers make a stage's A fragments from its rows
constexpr int kFormBf16 = 0;   // bf16 rows
constexpr int kFormNorm = 1;   // float32 rows x rstd x gamma
constexpr int kFormF32 = 2;    // float32 rows
// the codes: int4 in groups of 32k, 16 or 8 codes; int8 per channel
constexpr int kVar32 = 0, kVar16 = 1, kVar8 = 2, kVarI8 = 3, kVarI8G = 4;

struct Phase {
  CUtensorMap map;     // the codes as a 2-D uint8 tensor, boxes [ub][128]
  CUtensorMap smap;    // groups of 16 or 8: the scales as a 2-D float32
                       // tensor, boxes [ub][a stage unit's groups]
  const uint8_t* w;    // codes [N, K/2] (int4) or [N, K] (int8) of a layer
  const float* s;      // scales [N, G] (int4) or [N] (int8)
  const float* z;      // zero points [N, G] (K1's int4 GEMV in groups of
                       // 16 or 8, run's ZB) or null
  const void* src;     // activation rows [M, K]: bf16 (eb 2) or float32 (4)
  const __nv_bfloat16* gamma;   // a norm phase's [K]
  int units;           // columns, or gate/up pairs, cut over the blocks
  int pairs;           // unit i: gate column i and up column up + i
  int up;
  int K, G, gs, bits;
  int eb;              // bytes of an activation; 0: the row is Smem::xs
  int norm;            // kFormNorm: gamma rides beside the rows
  int gate;            // grid barriers passed before the rows exist
  int cap;             // > 0: batches of even sizes, at most cap units
                       // (0: the ring's limit, the last batch the rest)
  int qw;              // > 1: the slot holds a stage of qw chunks a warp
                       // (K1 GEMV's search; make_plan_qw2)
  // the ring plan (make_plan)
  int q;               // chunks a consumer warp a stage
  int ub;              // units a batch (the boxes' rows)
  int cols;            // the most columns of a batch
  int ncp;             // their shared-memory rows: ub (gate-up: gate and
                       // up each) rounded up to 8
  int rows;            // rows a slab: ncp, or the tiles of the phase's
                       // instantiation (run_phase) when more
  int var;             // kVar32, kVar16, kVar8, kVarI8 or kVarI8G
  int off_sc, off_act, off_gam, ap;   // slot offsets, act row pitch
                                      // (eb == 0: Smem::xs's, set by the
                                      // kernel after make_plan; 0 at M = 1)
  int bg;              // groups of 16 or 8: a 256-code unit's groups
};

struct Plan {
  Phase ph[kMaxPhases];
  int ph0, nph;        // the phases [ph0, nph) run
  int red_warps;       // > 0: the warps whose partials Smem::red holds
                       // (0: kConsumers)
  int R, slot, red_cols, xs_off, fixed, smem;
};

// What the ring's code reads of a kernel's arguments (their first member).
struct Ring {
  Plan pl;
  // the widenings' masks and bias patterns, kernel parameters so that one
  // lop3 with two register operands does an and-or (with both as
  // immediates the compiler split K6's into two lop3)
  uint32_t nib_mask, nib_bias;          // int4: 0x000F000F, 0x43084308
  uint32_t lo7, top, b128;              // int8: 0x007F007F, 0x00800080,
                                        //       0x43004300
  int M;
};

// ------------------------------------------------------------ the plan

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

inline int kt_groups(const Phase& p, int kt) { return (kt - 1) / p.gs + 2; }

// A stage's scales. Groups of 32k codes (a few a stage): [group][ncp
// rows], copied by 4-byte cp.async, a lane a column. Groups of 16 or 8
// codes (16 or 32 a 256-code unit, as many bytes as the codes): by TMA,
// one box of [ub rows][bg groups] a unit (gate-up: two), 64- or 128-byte
// rows swizzled as the codes are, [unit][ncp rows][bg]. (4-byte copies,
// 33 a column a stage at g = 8, held the producer warp: a lane a column
// made every copy a sector of its own, a lane a group made the address
// arithmetic a column's.)
inline int scale_bytes(const Phase& p, int kt) {
  if (p.bits != 4) return p.G > 1 ? kt_groups(p, kt) * p.ncp * 4 : 0;
  if (p.gs % 32 == 0) return kt_groups(p, kt) * p.ncp * 4;
  return kt / kStageCodes * p.ncp * p.bg * 4;
}

// 128-byte slabs of a column a 256-code stage unit
inline int slabs_per_q(const Phase& p) { return p.bits == 8 ? 2 : 1; }

inline int act_pitch(const Phase& p, int kt) {
  // 16 (float32) or 64 (bf16) bytes past a multiple of 128: the
  // consumers' 16-byte reads of eight rows fall in distinct banks
  return p.eb == 0 ? 0 : kt * p.eb + (p.eb == 4 ? 16 : 64);
}

// The tiles of 8 columns of the instantiation that runs n tiles (groups of
// 32k codes and int8; 16 and 8 run 8 or 16 tiles with clamped rows).
inline int tiles_of(int n) {
  return n <= 4 ? 4 : n <= 8 ? 8 : n <= 12 ? 12 : n <= 16 ? 16 : 24;
}

inline int slot_bytes(const Phase& p, int q, int Mp) {
  const int kt = kStageCodes * q;
  return q * slabs_per_q(p) * p.rows * kSlab + scale_bytes(p, kt) +
         Mp * act_pitch(p, kt) + (p.norm ? kt * 2 : 0);
}

// The ring plan of phases [ph0, nph) for nblk blocks: each phase's batch,
// the slot (the largest one-q stage, 256 codes a column, or qw-q stage of
// a phase that asks for one), each phase's q (as many chunks as fit that
// slot), the number of slots. The fixed part
// holds the misc area and the larger of the consumers' partial sums plus
// xs_bytes (Smem::xs) and extra bytes of the kernel's own. Returns 0 or
// cudaErrorInvalidValue.
inline int make_plan(Plan& pl, int M, int nblk, int xs_bytes, int extra) {
  const int Mp = M < kRows ? M : kRows;
  int s1 = 0, red = 8;
  for (int i = pl.ph0; i < pl.nph; ++i) {
    Phase& p = pl.ph[i];
    const int per = p.pairs ? 2 : 1;
    const int umax = (p.units + nblk - 1) / nblk;
    // columns a batch: int8 96 (12 tiles), int4 groups of 16 or 8 128
    // (16), of 32k codes 192 (24); run_phase's instantiations cover them
    const int cmax = p.bits == 8 ? kMaxCols / 2
                     : p.gs % 32 ? kMaxCols * 2 / 3 : kMaxCols;
    if (p.cap > 0) {   // batches of even sizes, at most cap units
      const int lim = p.cap < cmax / per ? p.cap : cmax / per;
      const int nb = umax > lim ? (umax + lim - 1) / lim : 1;
      p.ub = (umax + nb - 1) / nb;
    } else {
      p.ub = umax < cmax / per ? umax : cmax / per;
    }
    if (p.ub < 1) p.ub = 1;
    p.cols = p.ub * per;
    p.ncp = round_up(p.ub, 8) * per;
    p.var = p.bits == 8        ? (p.G > 1 ? kVarI8G : kVarI8)
            : p.gs % 32 == 0 ? kVar32
                             : (p.gs == 16 ? kVar16 : kVar8);
    p.bg = kStageCodes / p.gs;
    // every tile an instantiation reads lies in the slab (unread rows)
    const bool wide = p.var == kVar32 || p.var == kVarI8 || p.var == kVarI8G;
    p.rows = wide && tiles_of(p.ncp / 8) * 8 > p.ncp ? tiles_of(p.ncp / 8) * 8
                                                     : p.ncp;
    const int sz = slot_bytes(p, p.qw > 1 ? p.qw : 1, Mp);
    if (sz > s1) s1 = sz;
    if (p.ncp > red) red = p.ncp;
  }
  for (int i = pl.ph0; i < pl.nph; ++i) {
    Phase& p = pl.ph[i];
    int qmax = (p.K + kStageCodes - 1) / kStageCodes;
    if (qmax > kMaxQ) qmax = kMaxQ;
    p.q = 1;
    while (p.q < qmax && slot_bytes(p, p.q + 1, Mp) <= s1) ++p.q;
    const int kt = kStageCodes * p.q;
    p.ap = act_pitch(p, kt);
    p.off_sc = p.q * slabs_per_q(p) * p.rows * kSlab;
    p.off_act = p.off_sc + scale_bytes(p, kt);
    p.off_gam = p.off_act + Mp * p.ap;
  }
  pl.slot = round_up(s1, kAlign);
  pl.red_cols = red;
  const int red_bytes =
      (pl.red_warps > 0 ? pl.red_warps : kConsumers) * red * kRows * 4;
  pl.xs_off = kMisc + red_bytes;
  const int area = red_bytes + xs_bytes > extra ? red_bytes + xs_bytes : extra;
  pl.fixed = round_up(kMisc + area, kAlign);
  // kAlign more for aligning the dynamic shared memory's start
  pl.R = (kSmemMax - kAlign - pl.fixed) / pl.slot;
  if (pl.R > kMaxSlots) pl.R = kMaxSlots;
  if (pl.R < 2) return (int)cudaErrorInvalidValue;
  pl.smem = kAlign + pl.fixed + pl.R * pl.slot;
  return 0;
}

// K6/K7's and K12's plan: an int4 phase's slot holds a stage of two
// chunks a consumer warp (Phase::qw; a slot's barriers and its copies'
// issue spread over twice the bytes) where that keeps two slots, else
// one chunk. On the H100 (tools/ring_variants.py) K6 ran 7-21 % and K12
// int4 5 % faster than on stages of one chunk, K12 int8 (two slabs a
// chunk) 3 % slower: int8 phases keep one.
inline int make_plan_qw2(Plan& pl, int M, int nblk, int xs_bytes,
                         int extra) {
  for (int i = pl.ph0; i < pl.nph; ++i)
    pl.ph[i].qw = pl.ph[i].bits == 4 ? 2 : 1;
  if (make_plan(pl, M, nblk, xs_bytes, extra) == 0) return 0;
  for (int i = pl.ph0; i < pl.nph; ++i) pl.ph[i].qw = 1;
  return make_plan(pl, M, nblk, xs_bytes, extra);
}

// The first unit of block b of nblk: nblk contiguous ranges of a phase's
// units that differ by at most one unit. In 32 bits (units x nblk is far
// below 2^32): a 64-bit division is a called routine, and its call made
// K6 spill 8 bytes.
__host__ __device__ __forceinline__ int cut(int units, int b, int nblk) {
  return (int)((unsigned)units * (unsigned)b / (unsigned)nblk);
}

// Passes over the weights: one for every 8 rows.
__host__ __device__ __forceinline__ int row_passes(int M) {
  return (M + kRows - 1) / kRows;
}

// K / G codes a group: a multiple of 32, or 8 or 16 (then K a multiple of
// 64: a row of scales is a multiple of 16 bytes for their tensor map)
inline bool groups_ok(int K, int G) {
  if (G < 1 || K % 32 || K % G) return false;
  const int gs = K / G;
  return gs % 32 == 0 || gs == 8 || (gs == 16 && K % 64 == 0);
}

// A phase of a layer's weight: codes w of `bits` (int8: G = 1, per
// channel), units columns (pairs: gate/up pairs, up columns from up),
// activations of eb bytes from src, gamma for a norm phase, the grid
// barriers (gate) its rows wait for.
inline void set_phase(Phase& p, const void* w, const void* s, int units,
                      int pairs, int up, int K, int G, int bits, int eb,
                      const void* src, const void* gamma, int gate) {
  p.w = (const uint8_t*)w;
  p.s = (const float*)s;
  p.units = units;
  p.pairs = pairs;
  p.up = up;
  p.K = K;
  p.G = G;
  p.gs = K / G;
  p.bits = bits;
  p.eb = eb;
  p.src = src;
  p.gamma = (const __nv_bfloat16*)gamma;
  p.norm = gamma != nullptr;
  p.gate = gate;
}

inline void set_masks(Ring& r) {
  r.nib_mask = 0x000F000Fu;
  r.nib_bias = 0x43084308u;
  r.lo7 = 0x007F007Fu;
  r.top = 0x00800080u;
  r.b128 = 0x43004300u;
}

using EncodeFn = decltype(&cuTensorMapEncodeTiled);

inline EncodeFn encode_fn() {
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

// A phase's codes [rows][K bits / 8] bytes as boxes of [ub][128 bytes],
// 128-byte swizzled, rows and bytes past the tensor read as zeros.
inline bool encode_codes(Phase& p, int rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t width = (cuuint64_t)p.K * p.bits / 8;
  const cuuint64_t dims[2] = {width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {width};
  const cuuint32_t box[2] = {(cuuint32_t)kSlab, (cuuint32_t)p.ub};
  const cuuint32_t estr[2] = {1, 1};
  return fn(&p.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<uint8_t*>(p.w), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Groups of 16 or 8: the scales [rows][G] float32 as boxes of [ub][bg],
// the 64- or 128-byte rows swizzled (the codes' 128-byte swizzle, or its
// 64-byte form), groups past the tensor read as zeros. G floats a row must
// be a multiple of 16 bytes (K a multiple of 64 at g = 16).
inline bool encode_scales(Phase& p, int rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr || p.G % 4) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)p.G, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)p.G * 4};
  const cuuint32_t box[2] = {(cuuint32_t)p.bg, (cuuint32_t)p.ub};
  const cuuint32_t estr[2] = {1, 1};
  return fn(&p.smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(p.s), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            p.bg * 4 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan's tensor maps (gate-up: both halves of [2 up, K]).
inline bool encode_plan(Plan& pl) {
  for (int i = pl.ph0; i < pl.nph; ++i) {
    Phase& p = pl.ph[i];
    const int rows = p.pairs ? 2 * p.up : p.units;
    if (!encode_codes(p, rows)) return false;
    if ((p.var == kVar16 || p.var == kVar8) && !encode_scales(p, rows))
      return false;
  }
  return true;
}

// The card's SM count, once per device, and the kernel's shared-memory
// limit raised on it (sms: the caller's per-kernel cache).
template <typename Kernel>
inline int card_blocks(Kernel kernel, int (&sms)[kMaxDevices], int& nblk) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (e != cudaSuccess) return (int)e;
    sms[dev] = n;
  }
  nblk = sms[dev];
  return 0;
}

// ------------------------------------------------------- device helpers

struct Smem {
  uint64_t* full;      // weights of a slot landed
  uint64_t* afull;     // activations of a slot landed
  uint64_t* empty;     // the consumers released a slot
  int* flag;           // grid barriers passed (for the activation warp)
  float* rstd;
  float* ssacc;
  float* ssr;
  float* red;          // [kConsumers][red_cols][kRows], then xs
  float* xs;           // a phase's float32 row (Phase::eb == 0)
  unsigned char* ring;
};

__device__ __forceinline__ Smem smem_of(unsigned char* sm, const Plan& pl) {
  sm += (kAlign - sm90::smem_u32(sm) % kAlign) % kAlign;
  Smem S;
  S.full = reinterpret_cast<uint64_t*>(sm);
  S.afull = S.full + kMaxSlots;
  S.empty = S.afull + kMaxSlots;
  S.flag = reinterpret_cast<int*>(sm + kOffFlag);
  S.rstd = reinterpret_cast<float*>(sm + kOffRstd);
  S.ssacc = reinterpret_cast<float*>(sm + kOffSs);
  S.ssr = reinterpret_cast<float*>(sm + kOffSsr);
  S.red = reinterpret_cast<float*>(sm + kMisc);
  S.xs = reinterpret_cast<float*>(sm + pl.xs_off);
  S.ring = sm + pl.fixed;
  return S;
}

// The barriers, the flag and the block's sums of squares, before the
// warps take their roles (then a __syncthreads).
__device__ __forceinline__ void init_block(const Smem& S, const Plan& pl) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < pl.R; ++i) {
      sm90::mbar_init(S.full + i, 1);
      sm90::mbar_init(S.afull + i, 1);
      sm90::mbar_init(S.empty + i, kConsumers);
    }
    *S.flag = 0;
    sm90::fence_barrier_init();
  }
  if (threadIdx.x < kMaxM) S.ssacc[threadIdx.x] = 0.f;
}

__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ unsigned atom_add_release(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The consumers' hand-over of a passed grid barrier to the activation
// warp: a release store and an acquire load of the shared flag, so that
// what the barrier's acquire made visible to the consumer thread is
// visible to the warp's copies.
__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.s32 [%0], %1;\n"
               :: "r"(sm90::smem_u32(p)), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];\n"
               : "=r"(v) : "r"(sm90::smem_u32(p)) : "memory");
  return v;
}

// the block's units [u0, u1) of a phase: nblk ranges within one unit
__device__ __forceinline__ void units_of(const Phase& p, int& u0, int& u1) {
  u0 = cut(p.units, blockIdx.x, gridDim.x);
  u1 = cut(p.units, blockIdx.x + 1, gridDim.x);
}

// The shared-memory row of a batch's column i (nu units from ua): gate-up
// holds its gate columns from row 0, its up columns from row ncp / 2; and
// that column's weight row.
__device__ __forceinline__ int row_of(const Phase& p, int nu, int i) {
  return p.pairs && i >= nu ? p.ncp / 2 + (i - nu) : i;
}
__device__ __forceinline__ int column(const Phase& p, int ua, int nu, int i) {
  return p.pairs && i >= nu ? p.up + ua + (i - nu) : ua + i;
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// x, y -> hi = bf16(x, y), lo = bf16 of the remainders (exact in float32)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  hi = mma::pack_bf16(x, y);
  lo = mma::pack_bf16(x - bf_lo(hi), y - bf_hi(hi));
}

__device__ __forceinline__ uint32_t bsub2(uint32_t x, uint32_t y) {
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
              *reinterpret_cast<const __nv_bfloat162*>(&y));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf16x2 of the nibbles at bits 0-3 and 16-19 of v (two's complement
// codes): 0x4300 | (u ^ 8) is bf16 136 + code, less 136 leaves the code.
__device__ __forceinline__ uint32_t widen2(uint32_t v, uint32_t mask,
                                           uint32_t bias) {
  return bsub2((v & mask) ^ bias, 0x43084308u);
}

// bf16x2 of int8 codes: lo of bytes 0 and 2 of w, hi of bytes 1 and 3
// (the header's int8 widening)
__device__ __forceinline__ void widen8(uint32_t w, const Ring& r,
                                       uint32_t& lo, uint32_t& hi) {
  const uint32_t v = w >> 8;
  lo = bsub2((w & r.lo7) | r.b128, (w & r.top) | r.b128);
  hi = bsub2((v & r.lo7) | r.b128, (v & r.top) | r.b128);
}

// ------------------------------------------------------------ producers

// Walks the block's stages in the consumers' order and calls f(s, p, ph,
// pass, ua, nu, k0, kts) for each: phases PH0..NPH-1, passes of 8 rows,
// batches of p.ub units, K in stages of 256 q codes. The phases unrolled:
// each copy reads its Phase's fields as constants (a run-time phase index
// made every read an indexed load and the producers' issue slower: K6
// lost 2-3 %).
template <int PH0, int NPH, typename F>
__device__ __forceinline__ void for_stages(const Ring& r, F f) {
  int s = 0;
#pragma unroll
  for (int ph = PH0; ph < NPH; ++ph) {
    const Phase& p = r.pl.ph[ph];
    int u0, u1;
    units_of(p, u0, u1);
    const int kt = kStageCodes * p.q;
    for (int pass = 0; pass < row_passes(r.M); ++pass)
      for (int ua = u0; ua < u1; ua += p.ub) {
        const int nu = min(p.ub, u1 - ua);
        for (int k0 = 0; k0 < p.K; k0 += kt, ++s)
          f(s, p, ph, pass, ua, nu, k0, min(kt, p.K - k0));
      }
  }
}

// The weight producer of phases PH0..NPH-1 of BITS-bit codes.
template <int PH0, int NPH, int BITS>
__device__ __forceinline__ void produce_weights(const Ring& r,
                                                const Smem& S) {
  const int lane = threadIdx.x & 31, R = r.pl.R;
  // the weights pass through L2 once: evicted first, so that the code,
  // the activations and the scratch stay
  const uint64_t policy = sm90::policy_evict_first();
  for_stages<PH0, NPH>(r, [&](int s, const Phase& p, int, int, int ua,
                              int nu, int k0, int kts) {
    const int slot = s % R;
    if (s >= R) sm90::mbar_wait(S.empty + slot, ((s / R) & 1) ^ 1);
    unsigned char* base = S.ring + (size_t)slot * r.pl.slot;
    if (BITS == 4 || p.var == kVarI8G) {
      const int cols = nu * (p.pairs ? 2 : 1);
      const int g0 = k0 / p.gs, ng = (k0 + kts - 1) / p.gs - g0 + 1;
      if (p.var == kVar32 || p.var == kVarI8G) {
        // [group][shared-memory row]: a lane's columns, group by group
        float* sc = reinterpret_cast<float*>(base + p.off_sc);
        for (int c = lane; c < cols; c += 32) {
          const float* src = p.s + (size_t)column(p, ua, nu, c) * p.G + g0;
          float* dst = sc + row_of(p, nu, c);
          for (int j = 0; j < ng; ++j)
            sm90::cp_async4(dst + j * p.ncp, src + j);
        }
      }
      sm90::cp_async_arrive(S.full + slot);
      __syncwarp();
    }
    if (lane == 0) {
      // codes: one box of ub rows a 128-byte slab (gate-up: two); small
      // groups' scales: a box a 256-code unit
      const int slabs = (kts * BITS / 8 + kSlab - 1) / kSlab;
      const int boxes = p.pairs ? 2 : 1;
      int units = 0;
      if constexpr (BITS == 4)
        if (p.var != kVar32) units = (kts + kStageCodes - 1) / kStageCodes;
      sm90::mbar_expect_tx(S.full + slot,
                           boxes * p.ub * (slabs * kSlab + units * p.bg * 4));
      for (int j = 0; j < slabs; ++j) {
        unsigned char* dst = base + j * p.rows * kSlab;
        const int x = k0 * BITS / 8 + j * kSlab;
        sm90::tma_load_2d_hint(sm90::smem_u32(dst), &p.map, S.full + slot,
                               x, ua, policy);
        if (p.pairs)
          sm90::tma_load_2d_hint(sm90::smem_u32(dst + p.ncp / 2 * kSlab),
                                 &p.map, S.full + slot, x, p.up + ua,
                                 policy);
      }
      for (int u = 0; u < units; ++u) {
        unsigned char* dst = base + p.off_sc + u * p.ncp * p.bg * 4;
        const int x = k0 / p.gs + u * p.bg;
        sm90::tma_load_2d_hint(sm90::smem_u32(dst), &p.smap, S.full + slot,
                               x, ua, policy);
        if (p.pairs)
          sm90::tma_load_2d_hint(sm90::smem_u32(dst + p.ncp / 2 * p.bg * 4),
                                 &p.smap, S.full + slot, x, p.up + ua,
                                 policy);
      }
    }
  });
  mma::cp_async_wait<0>();   // every scale landed before the warp exits
}

template <int PH0, int NPH>
__device__ __forceinline__ void produce_acts(const Ring& r, const Smem& S) {
  const int lane = threadIdx.x & 31, R = r.pl.R;
  int gate = 0;   // the grid barriers this warp has seen passed
  for_stages<PH0, NPH>(r, [&](int s, const Phase& p, int, int pass, int,
                              int, int k0, int kts) {
    if (p.gate > gate) {
      // its rows are written by every block before the grid barrier
      while (ld_acquire_cta(S.flag) < p.gate) {
      }
      sm90::fence_proxy_async_global();
      gate = p.gate;
    }
    const int slot = s % R;
    if (s >= R) sm90::mbar_wait(S.empty + slot, ((s / R) & 1) ^ 1);
    if (p.eb == 0) {   // the consumers hold the row
      if (lane == 0) sm90::mbar_arrive(S.afull + slot);
      return;
    }
    unsigned char* base = S.ring + (size_t)slot * r.pl.slot;
    const int m0 = pass * kRows, Mp = min(kRows, r.M - m0);
    if (lane == 0)
      sm90::mbar_expect_tx(S.afull + slot,
                           Mp * kts * p.eb + (p.norm ? kts * 2 : 0));
    __syncwarp();
    const char* src = static_cast<const char*>(p.src);
    if (lane < Mp)
      sm90::bulk_load(sm90::smem_u32(base + p.off_act + lane * p.ap),
                      src + ((size_t)(m0 + lane) * p.K + k0) * p.eb,
                      kts * p.eb, S.afull + slot);
    else if (p.norm && lane == Mp)
      sm90::bulk_load(sm90::smem_u32(base + p.off_gam), p.gamma + k0,
                      kts * 2, S.afull + slot);
  });
}

// The warp's role for phases PH0..NPH-1 of BITS-bit codes: the two
// producers, or (false) a consumer.
template <int PH0, int NPH, int BITS>
__device__ __forceinline__ bool produce(const Ring& r, const Smem& S) {
  const int warp = threadIdx.x >> 5;
  if (warp == kWeightWarp)
    produce_weights<PH0, NPH, BITS>(r, S);
  else if (warp == kActWarp)
    produce_acts<PH0, NPH>(r, S);
  return warp >= kConsumers;
}

// ------------------------------------------------------------ consumers

// Lane (g, t)'s activation fragments of chunk c, groups of 32k codes: row
// g at k = 32c + 8t + j, as the A operand of mma_16816 (rows 0-7 bf16,
// rows 8-15 the remainders), A[0] the chunk's first product, A[1] its
// second.
template <int FORM>
__device__ __forceinline__ void frag32(const unsigned char* base,
                                       const Phase& p, const uint8_t* xrow,
                                       float rs, int c, int t,
                                       uint32_t (&A)[2][4]) {
  if constexpr (FORM == kFormBf16) {   // bf16 rows: the remainders are 0
    const uint4 u =
        *reinterpret_cast<const uint4*>(xrow + (32 * c + 8 * t) * 2);
    A[0][0] = __byte_perm(u.x, u.z, 0x5410);
    A[0][2] = __byte_perm(u.x, u.z, 0x7632);
    A[1][0] = __byte_perm(u.y, u.w, 0x5410);
    A[1][2] = __byte_perm(u.y, u.w, 0x7632);
    A[0][1] = A[0][3] = A[1][1] = A[1][3] = 0u;
  } else {
    const float4* xp =
        reinterpret_cast<const float4*>(xrow + (32 * c + 8 * t) * 4);
    const float4 p0 = xp[0], p1 = xp[1];
    float v[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    if constexpr (FORM == kFormNorm) {   // xn = x * rstd * gamma
      const uint4 gq = *reinterpret_cast<const uint4*>(
          base + p.off_gam + (32 * c + 8 * t) * 2);
      const uint32_t gw[4] = {gq.x, gq.y, gq.z, gq.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = v[2 * j] * rs * bf_lo(gw[j]);
        v[2 * j + 1] = v[2 * j + 1] * rs * bf_hi(gw[j]);
      }
    }
    split2(v[0], v[4], A[0][0], A[0][1]);
    split2(v[1], v[5], A[0][2], A[0][3]);
    split2(v[2], v[6], A[1][0], A[1][1]);
    split2(v[3], v[7], A[1][2], A[1][3]);
  }
}

// The products of CU chunks from c, groups of 32k codes (grp: each chunk's
// group within the stage). Lane (g, t) takes word t of row g of each tile
// of 8 columns: chunk c sits in slab c / 8, its 16-byte slot swizzled by
// the row (128-byte swizzle). No branch and no clamp among the NCT tiles:
// tiles past the batch's read rows that the slab pads (make_plan) and are
// never read back.
template <int FORM, int NCT, int CU>
__device__ __forceinline__ void chunks32(const unsigned char* base,
                                         const Phase& p, const uint8_t* xrow,
                                         float rs, int c, const int (&grp)[CU],
                                         uint32_t mask, uint32_t bias, int g,
                                         int t, float (&acc)[NCT][2]) {
  uint32_t A[CU][2][4];
  const uint8_t* cw[CU];
  const float* sp[CU];
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    frag32<FORM>(base, p, xrow, rs, c + u, t, A[u]);
    cw[u] = base + (((c + u) >> 3) * p.rows + g) * kSlab +
            ((((c + u) & 7) ^ g) << 4) + 4 * t;
    sp[u] = reinterpret_cast<const float*>(base + p.off_sc) +
            grp[u] * p.ncp + 2 * t;
  }
#pragma unroll
  for (int ct = 0; ct < NCT; ++ct) {
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(cw[u] + ct * 8 * kSlab);
      // nibbles (0, 4), (1, 5), (2, 6), (3, 7) of the word
      const uint32_t b0 = widen2(w, mask, bias);
      const uint32_t b1 = widen2(w >> 4, mask, bias);
      const uint32_t b2 = widen2(w >> 8, mask, bias);
      const uint32_t b3 = widen2(w >> 12, mask, bias);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma::mma_16816(d, A[u][0], b0, b1);
      mma::mma_16816(d, A[u][1], b2, b3);
      const float2 sv = *reinterpret_cast<const float2*>(sp[u] + ct * 8);
      acc[ct][0] = fmaf(d[0] + d[2], sv.x, acc[ct][0]);
      acc[ct][1] = fmaf(d[1] + d[3], sv.y, acc[ct][1]);
    }
  }
}

// The same chunk in groups of 16 (kVar16) or 8 (kVar8) codes: the four
// lanes of a column share each word, lane t taking nibbles t and t + 4,
// with the activations at k = 32c + t + 4j. ZB (zero points): each
// group's sum of the row, the four lanes' parts summed over the quad,
// times z[n][grp] of each of the lane's two columns, where zc is the
// batch's first column's zero points (p.z + ua * G), last its last
// column and zg the chunk's first group.
template <int FORM, int VAR, int NCT, bool ZB = false>
__device__ __forceinline__ void chunk_small(const unsigned char* base,
                                            const Phase& p,
                                            const uint8_t* xrow, float rs,
                                            int c, int nct, uint32_t mask,
                                            uint32_t bias, int g, int t,
                                            float (&acc)[NCT][2],
                                            const float* zc = nullptr,
                                            int last = 0, int zg = 0) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = 32 * c + t + 4 * j;
    if constexpr (FORM == kFormBf16) {
      v[j] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(xrow)[k]);
    } else {
      v[j] = reinterpret_cast<const float*>(xrow)[k];
      if constexpr (FORM == kFormNorm)
        v[j] = v[j] * rs * __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(base + p.off_gam)[k]);
    }
  }
  uint32_t hi[4], lo[4];   // word w: k = 32c + 8w + t and + 4
#pragma unroll
  for (int w = 0; w < 4; ++w) split2(v[2 * w], v[2 * w + 1], hi[w], lo[w]);
  // ZB: the row's sum over each of the chunk's groups (16: words 2h and
  // 2h + 1; 8: word w), in a fixed order
  constexpr int kGroups = VAR == kVar16 ? 2 : 4;
  float xs[kGroups];
  if constexpr (ZB) {
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8 / kGroups; ++j) sum += v[q * (8 / kGroups) + j];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      xs[q] = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
    }
  }
  // the scales of the chunk's groups for columns 2t and 2t + 1 of a tile:
  // row r's of 256-code unit c / 8 at 16-byte unit v ^ (r & 7) of its
  // 128-byte row (g = 8; v = c & 7, the chunk's 4 groups), or at byte 8h
  // of 16-byte unit v ^ ((r >> 1) & 3) of its 64-byte row (g = 16; v =
  // (c & 7) / 2, h = c & 1, the chunk's 2 groups); su is that v
  const unsigned char* sc = base + p.off_sc + (c >> 3) * p.ncp * p.bg * 4;
  const int su = VAR == kVar8 ? (c & 7) : (c & 7) >> 1;
  // rows 2t and 2t + 1 of tile 0 (tile cc: cc * 8 rows further, which
  // leaves the swizzle's row bits as they are)
  const unsigned char *sa, *sb;
  if constexpr (VAR == kVar16) {
    sa = sc + 2 * t * 64 + ((su ^ t) << 4) + (c & 1) * 8;
    sb = sa + 64;
  } else {
    sa = sc + 2 * t * 128 + ((su ^ (2 * t)) << 4);
    sb = sc + (2 * t + 1) * 128 + ((su ^ (2 * t + 1)) << 4);
  }
  const uint8_t* cq = base + (c >> 3) * p.rows * kSlab + g * kSlab +
                      (((c & 7) ^ g) << 4);
#pragma unroll
  for (int ct = 0; ct < NCT; ++ct) {
    const int cc = min(ct, nct - 1);
    const uint4 q4 = *reinterpret_cast<const uint4*>(cq + cc * 8 * kSlab);
    const uint32_t wv[4] = {q4.x, q4.y, q4.z, q4.w};
    uint32_t b[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) b[w] = widen2(wv[w] >> (4 * t), mask, bias);
    const int so = cc * 8 * p.bg * 4;
    if constexpr (VAR == kVar16) {
      const float2 s2a = *reinterpret_cast<const float2*>(sa + so);
      const float2 s2b = *reinterpret_cast<const float2*>(sb + so);
      const float sv[2][2] = {{s2a.x, s2b.x}, {s2a.y, s2b.y}};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t A[4] = {hi[2 * hh], lo[2 * hh], hi[2 * hh + 1],
                               lo[2 * hh + 1]};
        mma::mma_16816(d, A, b[2 * hh], b[2 * hh + 1]);
        acc[ct][0] = fmaf(d[0] + d[2], sv[hh][0], acc[ct][0]);
        acc[ct][1] = fmaf(d[1] + d[3], sv[hh][1], acc[ct][1]);
      }
    } else {
      // two groups at a time: fewer scales live beside the products
#pragma unroll
      for (int w = 0; w < 4; w += 2) {
        const float2 s2a = *reinterpret_cast<const float2*>(sa + so + 4 * w);
        const float2 s2b = *reinterpret_cast<const float2*>(sb + so + 4 * w);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma::mma_1688(d, hi[w], lo[w], b[w]);
        acc[ct][0] = fmaf(d[0] + d[2], s2a.x, acc[ct][0]);
        acc[ct][1] = fmaf(d[1] + d[3], s2b.x, acc[ct][1]);
        float e[4] = {0.f, 0.f, 0.f, 0.f};
        mma::mma_1688(e, hi[w + 1], lo[w + 1], b[w + 1]);
        acc[ct][0] = fmaf(e[0] + e[2], s2a.y, acc[ct][0]);
        acc[ct][1] = fmaf(e[1] + e[3], s2b.y, acc[ct][1]);
      }
    }
    if constexpr (ZB) {
      // columns past the batch read its last column's zero points, unused
      const float* za = zc + (size_t)min(cc * 8 + 2 * t, last) * p.G + zg;
      const float* zb = zc + (size_t)min(cc * 8 + 2 * t + 1, last) * p.G + zg;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        acc[ct][0] = fmaf(xs[q], __ldg(za + q), acc[ct][0]);
        acc[ct][1] = fmaf(xs[q], __ldg(zb + q), acc[ct][1]);
      }
    }
  }
}

// An int8 chunk c (32 codes, two 16-byte units of slab c / 4): lane (g, t)
// takes word t of each unit, codes 4t.. and 16 + 4t.. of the chunk, and
// the rows rounded to bf16 at those k (the mma's k pairs (2t, 2t + 1) and
// (2t + 8, 2t + 9) are the word's bytes (0, 2) and (1, 3)). The products
// add up in acc, the mma's own accumulator (rows 8-15 of A are zero).
// GRP (kVarI8G): the chunk's products in a fresh accumulator, folded
// times the scales of its group grp (within the stage) from the slot.
template <int FORM, int NCT, bool GRP = false>
__device__ __forceinline__ void chunk8(const unsigned char* base,
                                       const Phase& p, const uint8_t* xrow,
                                       float rs, int c, int grp, const Ring& r,
                                       int g, int t, float (&acc)[NCT][2]) {
  const float4 x0 =
      *reinterpret_cast<const float4*>(xrow + (32 * c + 4 * t) * 4);
  const float4 x1 =
      *reinterpret_cast<const float4*>(xrow + (32 * c + 16 + 4 * t) * 4);
  float v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  if constexpr (FORM == kFormNorm) {
    const unsigned char* gp = base + p.off_gam + (32 * c + 4 * t) * 2;
    const uint2 g0 = *reinterpret_cast<const uint2*>(gp);
    const uint2 g1 = *reinterpret_cast<const uint2*>(gp + 32);
    const uint32_t gw[4] = {g0.x, g0.y, g1.x, g1.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = v[2 * j] * rs * bf_lo(gw[j]);
      v[2 * j + 1] = v[2 * j + 1] * rs * bf_hi(gw[j]);
    }
  }
  const uint32_t A0[4] = {mma::pack_bf16(v[0], v[2]), 0u,
                          mma::pack_bf16(v[1], v[3]), 0u};
  const uint32_t A1[4] = {mma::pack_bf16(v[4], v[6]), 0u,
                          mma::pack_bf16(v[5], v[7]), 0u};
  const uint8_t* cw = base + ((c >> 2) * p.rows + g) * kSlab + 4 * t;
  const int o0 = ((2 * (c & 3)) ^ g) << 4, o1 = ((2 * (c & 3) + 1) ^ g) << 4;
#pragma unroll
  for (int ct = 0; ct < NCT; ++ct) {
    const uint32_t w0 =
        *reinterpret_cast<const uint32_t*>(cw + ct * 8 * kSlab + o0);
    const uint32_t w1 =
        *reinterpret_cast<const uint32_t*>(cw + ct * 8 * kSlab + o1);
    uint32_t b0, b1, b2, b3;
    widen8(w0, r, b0, b1);
    widen8(w1, r, b2, b3);
    float d[4] = {GRP ? 0.f : acc[ct][0], GRP ? 0.f : acc[ct][1], 0.f, 0.f};
    mma::mma_16816(d, A0, b0, b1);
    mma::mma_16816(d, A1, b2, b3);
    if constexpr (GRP) {
      const float2 sv = *reinterpret_cast<const float2*>(
          reinterpret_cast<const float*>(base + p.off_sc) + grp * p.ncp +
          2 * t + ct * 8);
      acc[ct][0] = fmaf(d[0], sv.x, acc[ct][0]);
      acc[ct][1] = fmaf(d[1], sv.y, acc[ct][1]);
    } else {
      acc[ct][0] = d[0];
      acc[ct][1] = d[1];
    }
  }
}

// Adds the consumer threads' partials sq (thread = 8 col group + row) to
// the block's sums of squares of rows m0.., in a fixed order.
__device__ __forceinline__ void sum_squares(const Smem& S, float sq, int m0) {
  S.ssr[threadIdx.x] = sq;
  named_sync();
  if (threadIdx.x < kRows && m0 + (int)threadIdx.x < kMaxM) {
    float tot = 0.f;
    for (int j = 0; j < kColGroups; ++j)
      tot += S.ssr[j * kRows + threadIdx.x];
    S.ssacc[m0 + threadIdx.x] += tot;
  }
}

// Column i's sum of row `row` over the consumer warps' partials, in warp
// order.
__device__ __forceinline__ float col_sum(const Smem& S, int rc, int i,
                                         int row) {
  float v = 0.f;
  for (int w = 0; w < kConsumers; ++w) v += S.red[(w * rc + i) * kRows + row];
  return v;
}

// The consumers' place in the ring: the slot of the next stage and the
// parity of its fill.
struct Cursor {
  int slot = 0;
  uint32_t par = 0;
  __device__ void next(int R) {
    if (++slot == R) {
      slot = 0;
      par ^= 1u;
    }
  }
};

// Phase PI (PI < 0: phase pi, chosen at run time) on the consumers: NCT
// tiles of 8 columns a batch at most, every one in each warp; the stage's
// chunks split over the warps; XS: a phase of the kernel may take its row
// from Smem::xs (Phase::eb == 0; K6 keeps no xs pointer in its loops).
// Epi is the kernel's: epi.pre<PI>(pi, m0,
// ua, nu) at a batch's start, epi.out<PI>(pi, m0, ua, nu, cols) once the
// warps' partials of the batch are in Smem::red. (K6 names its phases at
// compile time: with a run-time index every Phase field the loops read is
// an indexed parameter load held in a register, and K6 spilled; K12's
// four phases in one loop of two instantiations spill nothing, its four
// named ones one register.)
template <int PI, int FORM, int VAR, int NCT, bool XS, class Epi,
          bool ZB = false>
__device__ __forceinline__ void run(const Ring& r, int pi, const Smem& S,
                                    Cursor& cur, const Epi& epi) {
  const Phase& p = r.pl.ph[PI < 0 ? pi : PI];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, R = r.pl.R;
  const uint32_t mask = r.nib_mask, bias = r.nib_bias;
  int u0, u1;
  units_of(p, u0, u1);
  const int kt = kStageCodes * p.q;
  for (int m0 = 0; m0 < r.M; m0 += kRows) {
    const int Mp = min(kRows, r.M - m0);
    const int gr = g < Mp ? g : Mp - 1;   // rows past M repeat the last
    const float rs = FORM == kFormNorm ? S.rstd[m0 + gr] : 1.f;
    for (int ua = u0; ua < u1; ua += p.ub) {
      const int nu = min(p.ub, u1 - ua), cols = nu * (p.pairs ? 2 : 1);
      const int nct = p.pairs ? p.ncp >> 3 : (nu + 7) >> 3;
      epi.template pre<PI>(pi, m0, ua, nu);
      float acc[NCT][2];
#pragma unroll
      for (int ct = 0; ct < NCT; ++ct) acc[ct][0] = acc[ct][1] = 0.f;
      for (int k0 = 0; k0 < p.K; k0 += kt, cur.next(R)) {
        sm90::mbar_wait(S.full + cur.slot, cur.par);
        sm90::mbar_wait(S.afull + cur.slot, cur.par);
        const unsigned char* base = S.ring + (size_t)cur.slot * r.pl.slot;
        const uint8_t* xrow =
            (!XS || p.eb ? base + p.off_act
                         : reinterpret_cast<const uint8_t*>(S.xs + k0)) +
            gr * p.ap;
        const int nch = min(kt, p.K - k0) >> 5;
        int c = nch * warp / kConsumers;
        const int c_hi = nch * (warp + 1) / kConsumers;
        if constexpr (VAR == kVar32) {
          // chunk c's group within the stage, and its offset in the group
          int off = k0 % p.gs + 32 * c, grp = off / p.gs;
          off -= grp * p.gs;
          auto step = [&]() {
            const int gc = grp;
            off += 32;
            if (off == p.gs) {
              off = 0;
              ++grp;
            }
            return gc;
          };
          if constexpr (NCT == 4) {   // few tiles: two chunks at a time
            for (; c + 1 < c_hi; c += 2) {
              int gg[2];
              gg[0] = step();
              gg[1] = step();
              chunks32<FORM, NCT, 2>(base, p, xrow, rs, c, gg, mask, bias, g,
                                     t, acc);
            }
          }
          for (; c < c_hi; ++c) {
            const int gg[1] = {step()};
            chunks32<FORM, NCT, 1>(base, p, xrow, rs, c, gg, mask, bias, g,
                                   t, acc);
          }
        } else if constexpr (VAR == kVarI8 || VAR == kVarI8G) {
          // grouped: chunk c's group within the stage (groups of 32k)
          int grp = (k0 % p.gs + 32 * c) / p.gs;
          int off = (k0 % p.gs + 32 * c) - grp * p.gs;
          for (; c < c_hi; ++c) {
            chunk8<FORM, NCT, VAR == kVarI8G>(base, p, xrow, rs, c, grp, r,
                                              g, t, acc);
            if constexpr (VAR == kVarI8G) {
              off += 32;
              if (off == p.gs) {
                off = 0;
                ++grp;
              }
            }
          }
        } else if constexpr (ZB) {
          const float* zc = p.z + (size_t)ua * p.G;
          for (; c < c_hi; ++c)
            chunk_small<FORM, VAR, NCT, true>(base, p, xrow, rs, c, nct, mask,
                                              bias, g, t, acc, zc, nu - 1,
                                              (k0 + 32 * c) / p.gs);
        } else {
          for (; c < c_hi; ++c)
            chunk_small<FORM, VAR, NCT>(base, p, xrow, rs, c, nct, mask,
                                        bias, g, t, acc);
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(S.empty + cur.slot);
      }
      float* red = S.red + warp * r.pl.red_cols * kRows;
#pragma unroll
      for (int ct = 0; ct < NCT; ++ct)
        if (ct < nct) {
          red[(ct * 8 + 2 * t) * kRows + g] = acc[ct][0];
          red[(ct * 8 + 2 * t + 1) * kRows + g] = acc[ct][1];
        }
      named_sync();
      epi.template out<PI>(pi, m0, ua, nu, cols);
      named_sync();
    }
  }
}

// The phase's tiles of 8 columns a batch (the most, ncp / 8) pick the
// instantiation: int4 groups of 32k codes 4, 8, 12, 16 or 24 tiles (16 or
// 8: 8 or 24); int8 (BITS 8, at most 96 columns a batch) 4, 8 or 12.
// The phase's tiles of 8 columns a batch (the most, ncp / 8) pick the
// instantiation: int4 groups of 32k codes 4, 8, 12, 16 or 24 tiles, of 16
// or 8 codes 8 or 16 (at most 128 columns a batch: 24 tiles spilled at
// the 168 registers ten warps leave a thread); int8 (at most 96 columns)
// 4, 8 or 12. (Inlined: a called phase spilled its registers in K12.)
// G8: int8 in groups (kVarI8G; a kernel of its own, so that per-channel
// int8 keeps its registers). ZB: int4 groups of 16 or 8 with zero points
// (Phase::z; K1's GEMV alone).
template <int PI, int FORM, int BITS, bool XS = false, bool G8 = false,
          bool ZB = false, class Epi>
__device__ __forceinline__ void run_phase(const Ring& r, int pi,
                                          const Smem& S, Cursor& cur,
                                          const Epi& epi) {
  const Phase& p = r.pl.ph[PI < 0 ? pi : PI];
  const int n = p.ncp >> 3;
  if constexpr (BITS == 8) {
    constexpr int V = G8 ? kVarI8G : kVarI8;
    if (n <= 4)
      run<PI, FORM, V, 4, XS>(r, pi, S, cur, epi);
    else if (n <= 8)
      run<PI, FORM, V, 8, XS>(r, pi, S, cur, epi);
    else
      run<PI, FORM, V, 12, XS>(r, pi, S, cur, epi);
  } else if (p.var == kVar32) {
    if (n <= 4)
      run<PI, FORM, kVar32, 4, XS>(r, pi, S, cur, epi);
    else if (n <= 8)
      run<PI, FORM, kVar32, 8, XS>(r, pi, S, cur, epi);
    else if (n <= 12)
      run<PI, FORM, kVar32, 12, XS>(r, pi, S, cur, epi);
    else if (n <= 16)
      run<PI, FORM, kVar32, 16, XS>(r, pi, S, cur, epi);
    else
      run<PI, FORM, kVar32, 24, XS>(r, pi, S, cur, epi);
  } else if (p.var == kVar16) {
    if (n <= 8)
      run<PI, FORM, kVar16, 8, XS, Epi, ZB>(r, pi, S, cur, epi);
    else
      run<PI, FORM, kVar16, 16, XS, Epi, ZB>(r, pi, S, cur, epi);
  } else {
    if (n <= 8)
      run<PI, FORM, kVar8, 8, XS, Epi, ZB>(r, pi, S, cur, epi);
    else
      run<PI, FORM, kVar8, 16, XS, Epi, ZB>(r, pi, S, cur, epi);
  }
}

// The consumers' grid barrier: every block's writes so far are visible to
// every block (and to its bulk copies) once it returns; the activation
// warp learns of it through the flag (n: the barriers passed). The block's
// threads meet first, then one thread arrives for them all with a release
// add (a fence in every thread took 0.8-3.4 us, two fence.sc in one ~1.4
// us more) and spins on acquire loads without sleeping.
__device__ __forceinline__ void grid_barrier(unsigned* gbar, const Smem& S,
                                             int n) {
  named_sync();
  if (threadIdx.x == 0) {
    sm90::fence_proxy_async_global();
    const unsigned inc =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    const unsigned old = atom_add_release(gbar, inc);
    while (((old ^ ld_acquire(gbar)) & 0x80000000u) == 0) {
    }
    st_release_cta(S.flag, n);
  }
  named_sync();
}

// rstd of each of M rows from the nblk blocks' partial sums of squares
// ss [nblk][kMaxM] (after a grid barrier): a warp a row, a lane's blocks
// in order, then the lanes in a fixed tree; into Smem::rstd.
__device__ __forceinline__ void rstd_of_rows(const float* ss, int M, int H,
                                             float eps,
                             const Smem& S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < M; m += kConsumers) {
    float tot = 0.f;
    for (int b0 = 0; b0 < (int)gridDim.x; b0 += 256) {
      float v[8];   // eight loads in flight, then added in block order
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = b0 + lane + 32 * i;
        v[i] = b < (int)gridDim.x ? __ldcg(ss + b * kMaxM + m) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) tot += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
    if (lane == 0) S.rstd[m] = rsqrtf(tot / (float)H + eps);
  }
  named_sync();
}

}  // namespace ring
