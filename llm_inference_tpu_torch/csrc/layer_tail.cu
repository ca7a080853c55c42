// K6: the decode layer tail in one launch, grouped int4 weights:
//   wo_out = attn . wo                                  (float32)
//   h2     = bf16(h + wo_out)
//   xn     = (h + wo_out) * rsqrt(mean((h + wo_out)^2) + eps) * gamma
//   act    = silu(xn . w_gate) * (xn . w_up)           (float32)
//   y      = bf16(act . w_down)
// nothing rounded between the phases. K7: the FFN block of a
// tensor-parallel layer, the same tail without its wo phase (the wo
// partials are summed across ranks before the residual):
//   x32 = float(bf16(x)) + float(residual),  h2 = bf16(x32)
//   xn, act, y as above from x32.
//
// K6 replaces llm_inference_tpu/ops/pallas/quant_matmul.py:
// layer_tail_fused (_layer_tail_kernel), K7 quant_matmul.py:ffn_fused
// (_ffn_kernel). Each TPU kernel is one grid walked in order over its
// weights' column blocks, so Mosaic's pipeline fetches the next phase's
// weights while the last blocks of a phase compute.
//
// Bound on the H100 SXM (3.35 TB/s): the call must read the layer's int4
// weights and their scales once. LLaMA-2-7B, g = 128, K6: wo 8.4 + 0.5 MB,
// gate-up 45.1 + 2.8 MB, down 22.5 + 1.4 MB = 80.8 MB -> 24.1 us at any
// M <= 8. K7 at tp = 2 (one rank's shard: gate-up [11008, 4096], down
// [4096, 5504]): 35.9 MB -> 10.7 us.
//
// The design: one persistent block an SM (a cooperative launch, so that
// every block is resident), ten warps:
// - a weight producer warp streams the block's weights, phase after
//   phase, into a ring of R shared-memory slots: a stage's codes as 2-D
//   TMA boxes (the copy engine; a box is a 128-byte k-slab of every
//   column of the batch, 128-byte swizzled, L2 promotion of 256 bytes,
//   evicted first from L2 so that the code, the activations and the
//   scratch stay: the next phase's first stage had computed twice as
//   long), its scales by 4-byte cp.async, one mbarrier a slot counting
//   both. It
//   never waits for the phases: the weights do not depend on the
//   activations, so while the consumers wait at a grid barrier it runs on
//   into the next phase's stages until the ring is full. (A 1-D bulk copy
//   a column a stage measured about 50 ns a copy on the H100, serialised:
//   gate-up's 168 copies of 128 bytes a stage took the kernel to twice
//   the old one's time.);
// - an activation producer warp copies each stage's activation rows (and
//   gamma) beside the weights, on a second mbarrier a slot; from the
//   second phase on it first waits for the grid barrier that makes them;
// - eight consumer warps split each stage's K among themselves (one
//   32-code chunk each, q chunks for a stage of 256 q codes), each holding
//   the sums of every column of the block, and release the slot. They
//   bound the kernel on the H100 (about 17 instructions a tile of 8
//   columns x 32 codes, two of them mma.sync).
// The phases [wo (K6) or the norm's prologue (K7)] | gate-up + SwiGLU |
// down are separated by a grid barrier of the consumers alone (a counter
// in the scratch whose top bit flips when every block has arrived), which
// the producers never wait for.
//
// Work spread evenly: a phase's N columns (gate-up: its I gate/up pairs)
// are cut into nblk contiguous ranges that differ by at most one column,
// so every SM streams the same bytes of each phase to within one column,
// less than one stage. More than 192 columns a block (small cards) run in
// batches. At M <= 8 rows every weight byte is streamed once; rows beyond
// come in passes of 8 (at most ceil(M / 8) passes).
//
// Products on the tensor cores: mma.sync.m16n8k16 with the activations as
// A (rows 0-7 the eight rows of a pass in bf16, rows 8-15 their bf16
// remainders x - bf16(x): the two products land in one float32 sum, so
// the activations keep 16 bits of mantissa) and the codes as B (8 output
// columns x 16 k), widened exactly to bf16 in registers: a nibble u = code
// + 8 placed in the mantissa of bf16 128 reads 136 + code, and one bf16x2
// subtraction leaves the code. Groups of 32k codes: a lane takes the 8
// codes of one 32-bit word (nibbles i and i + 4 paired), the four lanes
// of a column the chunk's four words, so a chunk's two products lie in
// one group and take its scale once: acc += s * (hi + lo). Groups of 16
// (8): the four lanes share a word, each taking nibbles t and t + 4, a
// product per group (m16n8k8 for 8), each folding its own scale.
//
// No whole-row work at a phase head: the wo epilogue writes x32 = h +
// wo_out, h2 and a per-block partial sum of squares; after the barrier
// every block sums the nblk partials in block order (rstd), and the
// activations arrive by K-tile beside the weights. Every sum (the
// consumer warps' partials, the partials of the squares) is taken in a
// fixed order, so two calls on the same inputs give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

// consumer warps: a stage's chunks split eight ways, each warp taking
// every tile of 8 columns of its chunks (sixteen warps, two with half the
// tiles each, measured slower: 96 registers and spills)
constexpr int kConsumers = 8;
constexpr int kWeightWarp = kConsumers;        // then the two producers
constexpr int kActWarp = kConsumers + 1;
constexpr int kThreads = (kConsumers + 2) * 32;
constexpr int kMaxM = 32;
constexpr int kRows = 8;                       // rows a pass (mma n / 2)
constexpr int kStageCodes = 256;               // a stage is q x 256 codes
constexpr int kMaxCols = 192;                  // columns a batch
constexpr int kMaxQ = 8;
constexpr int kMaxSlots = 16;
constexpr int kSmemMax = 232448;
constexpr int kMaxDevices = 64;
// scratch floats before the sums of squares; its first word is the grid
// barrier's counter (zero when allocated, a multiple of 2^31 between
// launches)
constexpr int kHeader = 64;
// shared memory: 3 x kMaxSlots mbarriers, the phase flag, rstd[32], the
// block's sums of squares [32] and their per-thread partials [256]; then
// the consumers' partial sums; then the ring
constexpr int kOffFlag = 3 * kMaxSlots * 8;
constexpr int kOffRstd = kOffFlag + 16;
constexpr int kOffSs = kOffRstd + kMaxM * 4;
constexpr int kOffSsr = kOffSs + kMaxM * 4;
constexpr int kColGroups = kConsumers * 32 / 8;   // epilogue: 8 rows
constexpr int kMisc = 3072;
static_assert(kOffSsr + kConsumers * 32 * 4 <= kMisc, "misc area");
constexpr int kAlign = 1024;                   // a swizzled TMA box's start
constexpr int kSlab = 128;                     // bytes of a box row

struct Phase {
  CUtensorMap map;     // the codes as a 2-D uint8 tensor, boxes [ub][128]
  const uint8_t* w;    // codes [N, K/2] of the layer
  const float* s;      // scales [N, G]
  const void* src;     // activation rows [M, K]: bf16 (eb 2) or float32 (4)
  int units;           // columns, or gate/up pairs, cut over the blocks
  int pairs;           // unit i: gate column i and up column I + i
  int K, G, gs, eb, norm;
  // the ring plan (make_plan)
  int q;               // chunks a consumer warp a stage
  int ub;              // units a batch (the boxes' rows)
  int cols;            // the most columns of a batch
  int ncp;             // their shared-memory rows: ub (gate-up: gate and
                       // up each) rounded up to 8
  int rows;            // rows a slab: ncp, or the tiles of the phase's
                       // instantiation (run_phase) when more
  int var;             // 0: groups of 32k codes, 1: 16, 2: 8
  int off_sc, off_act, off_gam, ap;   // slot offsets, act row pitch
};

struct Plan {
  Phase ph[3];
  int R, slot, red_cols, fixed, smem;
};

struct Args {
  Plan pl;
  // the nibble mask and the bf16 136 of the widening (widen2), kernel
  // parameters so that one lop3 with two register operands does both
  uint32_t nib_mask, nib_bias;
  const __nv_bfloat16* h;       // [M, H]: K6 the residual stream, K7 x
  const __nv_bfloat16* res;     // [M, H] (K7)
  const __nv_bfloat16* gamma;   // [H]
  float* x32;                   // [M, H] scratch
  float* act;                   // [M, I] scratch
  float* ss;                    // [nblk, 32] partial sums of squares
  unsigned* gbar;               // grid barrier counter
  __nv_bfloat16* h2;            // [M, H]
  __nv_bfloat16* y;             // [M, H]
  int M, H, I;
  float eps;
};

// ------------------------------------------------------------ the plan

int round_up(int x, int m) { return (x + m - 1) / m * m; }

int kt_groups(const Phase& p, int kt) { return (kt - 1) / p.gs + 2; }

int act_pitch(const Phase& p, int kt) {
  // 16 (float32) or 64 (bf16) bytes past a multiple of 128: the
  // consumers' 16-byte reads of eight rows fall in distinct banks
  return kt * p.eb + (p.eb == 4 ? 16 : 64);
}

// The tiles of 8 columns of the instantiation that runs n tiles (groups of
// 32k codes; 16 and 8 run 8 or 24 tiles with clamped rows).
int tiles_of(int n) {
  return n <= 4 ? 4 : n <= 8 ? 8 : n <= 12 ? 12 : n <= 16 ? 16 : 24;
}

int slot_bytes(const Phase& p, int q, int Mp) {
  const int kt = kStageCodes * q;
  return q * p.rows * kSlab + kt_groups(p, kt) * p.ncp * 4 +
         Mp * act_pitch(p, kt) + (p.norm ? kt * 2 : 0);
}

// The ring plan for nblk blocks: each phase's batch, the slot (the largest
// one-q stage, 256 codes a column), each phase's q (as many chunks as fit
// that slot), the number of slots. Returns 0 or cudaErrorInvalidValue.
int make_plan(Plan& pl, int M, int nblk, bool wo) {
  const int Mp = M < kRows ? M : kRows;
  int s1 = 0, red = 8;
  for (int i = wo ? 0 : 1; i < 3; ++i) {
    Phase& p = pl.ph[i];
    const int per = p.pairs ? 2 : 1;
    const int umax = (p.units + nblk - 1) / nblk;
    p.ub = umax < kMaxCols / per ? umax : kMaxCols / per;
    if (p.ub < 1) p.ub = 1;
    p.cols = p.ub * per;
    p.ncp = round_up(p.ub, 8) * per;
    p.var = p.gs % 32 == 0 ? 0 : (p.gs == 16 ? 1 : 2);
    // every tile an instantiation reads lies in the slab (unread rows)
    p.rows = p.var == 0 && tiles_of(p.ncp / 8) * 8 > p.ncp
                 ? tiles_of(p.ncp / 8) * 8 : p.ncp;
    const int sz = slot_bytes(p, 1, Mp);
    if (sz > s1) s1 = sz;
    if (p.ncp > red) red = p.ncp;
  }
  for (int i = wo ? 0 : 1; i < 3; ++i) {
    Phase& p = pl.ph[i];
    int qmax = (p.K + kStageCodes - 1) / kStageCodes;
    if (qmax > kMaxQ) qmax = kMaxQ;
    p.q = 1;
    while (p.q < qmax && slot_bytes(p, p.q + 1, Mp) <= s1) ++p.q;
    const int kt = kStageCodes * p.q;
    p.ap = act_pitch(p, kt);
    p.off_sc = p.q * p.rows * kSlab;
    p.off_act = p.off_sc + kt_groups(p, kt) * p.ncp * 4;
    p.off_gam = p.off_act + Mp * p.ap;
  }
  pl.slot = round_up(s1, kAlign);
  pl.red_cols = red;
  pl.fixed = round_up(kMisc + kConsumers * red * kRows * 4, kAlign);
  // kAlign more for aligning the dynamic shared memory's start
  pl.R = (kSmemMax - kAlign - pl.fixed) / pl.slot;
  if (pl.R > kMaxSlots) pl.R = kMaxSlots;
  if (pl.R < 2) return (int)cudaErrorInvalidValue;
  pl.smem = kAlign + pl.fixed + pl.R * pl.slot;
  return 0;
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

// K / G codes a group: a multiple of 32, or 8 or 16
bool groups_ok(int K, int G) {
  if (G < 1 || K % 32 || K % G) return false;
  const int gs = K / G;
  return gs % 32 == 0 || gs == 8 || gs == 16;
}

void set_phase(Phase& p, const void* w, const void* s, int units, int pairs,
               int K, int G, int eb, int norm) {
  p.w = (const uint8_t*)w;
  p.s = (const float*)s;
  p.units = units;
  p.pairs = pairs;
  p.K = K;
  p.G = G;
  p.gs = K / G;
  p.eb = eb;
  p.norm = norm;
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
  float* red;          // [kConsumers][red_cols][kRows]
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
  S.ring = sm + pl.fixed;
  return S;
}

__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 32) : "memory");
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
__device__ __forceinline__ int column(const Phase& p, int ua, int nu, int i,
                                      int I) {
  return p.pairs && i >= nu ? I + ua + (i - nu) : ua + i;
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

// bf16x2 of the nibbles at bits 0-3 and 16-19 of v (two's complement
// codes): 0x4300 | (u ^ 8) is bf16 136 + code, less 136 leaves the code.
// mask = 0x000F000F and bias = 0x43084308 arrive in registers: with
// both as immediates the compiler split the and-xor into two lop3.
__device__ __forceinline__ uint32_t widen2(uint32_t v, uint32_t mask,
                                           uint32_t bias) {
  const uint32_t b = (v & mask) ^ bias, k136 = 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b),
              *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ------------------------------------------------------------ producers

// Walks the block's stages in the consumers' order and calls f(s, p, ph,
// pass, ua, nu, k0, kts) for each: phases from ph0, passes of 8 rows,
// batches of p.ub units, K in stages of 256 q codes.
template <typename F>
__device__ __forceinline__ void for_stages(const Args& a, int ph0, F f) {
  int s = 0;
  for (int ph = ph0; ph < 3; ++ph) {
    const Phase& p = a.pl.ph[ph];
    int u0, u1;
    units_of(p, u0, u1);
    const int kt = kStageCodes * p.q;
    for (int pass = 0; pass < row_passes(a.M); ++pass)
      for (int ua = u0; ua < u1; ua += p.ub) {
        const int nu = min(p.ub, u1 - ua);
        for (int k0 = 0; k0 < p.K; k0 += kt, ++s)
          f(s, p, ph, pass, ua, nu, k0, min(kt, p.K - k0));
      }
  }
}

__device__ void produce_weights(const Args& a, const Smem& S, int ph0) {
  const int lane = threadIdx.x & 31, R = a.pl.R;
  // the weights pass through L2 once: evicted first, so that the code,
  // the activations and the scratch stay
  const uint64_t policy = sm90::policy_evict_first();
  for_stages(a, ph0, [&](int s, const Phase& p, int, int, int ua, int nu,
                         int k0, int kts) {
    const int slot = s % R;
    if (s >= R) sm90::mbar_wait(S.empty + slot, ((s / R) & 1) ^ 1);
    unsigned char* base = S.ring + (size_t)slot * a.pl.slot;
    const int cols = nu * (p.pairs ? 2 : 1);
    const int g0 = k0 / p.gs, ng = (k0 + kts - 1) / p.gs - g0 + 1;
    // scales [group][shared-memory row]: a lane's columns, group by group
    float* sc = reinterpret_cast<float*>(base + p.off_sc);
    for (int c = lane; c < cols; c += 32) {
      const float* src = p.s + (size_t)column(p, ua, nu, c, a.I) * p.G + g0;
      float* dst = sc + row_of(p, nu, c);
      for (int j = 0; j < ng; ++j) sm90::cp_async4(dst + j * p.ncp, src + j);
    }
    sm90::cp_async_arrive(S.full + slot);
    __syncwarp();
    if (lane == 0) {
      // codes: one box of ub rows a 128-byte slab (gate-up: two)
      const int slabs = (kts + 2 * kSlab - 1) / (2 * kSlab);
      const int boxes = p.pairs ? 2 : 1;
      sm90::mbar_expect_tx(S.full + slot, slabs * boxes * p.ub * kSlab);
      for (int j = 0; j < slabs; ++j) {
        unsigned char* dst = base + j * p.rows * kSlab;
        const int x = k0 / 2 + j * kSlab;
        sm90::tma_load_2d_hint(sm90::smem_u32(dst), &p.map, S.full + slot,
                               x, ua, policy);
        if (p.pairs)
          sm90::tma_load_2d_hint(sm90::smem_u32(dst + p.ncp / 2 * kSlab),
                                 &p.map, S.full + slot, x, a.I + ua, policy);
      }
    }
  });
  mma::cp_async_wait<0>();   // every scale landed before the warp exits
}

__device__ void produce_acts(const Args& a, const Smem& S, int ph0) {
  const int lane = threadIdx.x & 31, R = a.pl.R;
  int gate = 0;   // the grid barriers this warp has seen passed
  for_stages(a, ph0, [&](int s, const Phase& p, int ph, int pass, int, int,
                         int k0, int kts) {
    if (ph > gate) {
      // its rows are written by every block before the grid barrier
      while (ld_acquire_cta(S.flag) < ph) {
      }
      sm90::fence_proxy_async_global();
      gate = ph;
    }
    const int slot = s % R;
    if (s >= R) sm90::mbar_wait(S.empty + slot, ((s / R) & 1) ^ 1);
    unsigned char* base = S.ring + (size_t)slot * a.pl.slot;
    const int m0 = pass * kRows, Mp = min(kRows, a.M - m0);
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
      sm90::bulk_load(sm90::smem_u32(base + p.off_gam), a.gamma + k0,
                      kts * 2, S.afull + slot);
  });
}

// ------------------------------------------------------------ consumers

// Lane (g, t)'s activation fragments of chunk c, groups of 32k codes: row
// g at k = 32c + 8t + j, as the A operand of mma_16816 (rows 0-7 bf16,
// rows 8-15 the remainders), A[0] the chunk's first product, A[1] its
// second.
template <int PH>
__device__ __forceinline__ void frag32(const unsigned char* base,
                                       const Phase& p, const uint8_t* xrow,
                                       float rs, int c, int t,
                                       uint32_t (&A)[2][4]) {
  if constexpr (PH == 0) {   // bf16 rows: the remainders are 0
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
    if constexpr (PH == 1) {   // xn = x * rstd * gamma
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
template <int PH, int NCT, int CU>
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
    frag32<PH>(base, p, xrow, rs, c + u, t, A[u]);
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

// The same chunk in groups of 16 (VAR 1) or 8 (VAR 2) codes: the four
// lanes of a column share each word, lane t taking nibbles t and t + 4,
// with the activations at k = 32c + t + 4j; gbase is the chunk's first
// group within the stage.
template <int PH, int VAR, int NCT>
__device__ __forceinline__ void chunk_small(const unsigned char* base,
                                            const Phase& p,
                                            const uint8_t* xrow, float rs,
                                            int c, int gbase, int nct,
                                            uint32_t mask, uint32_t bias,
                                            int g, int t,
                                            float (&acc)[NCT][2]) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = 32 * c + t + 4 * j;
    if constexpr (PH == 0) {
      v[j] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(xrow)[k]);
    } else {
      v[j] = reinterpret_cast<const float*>(xrow)[k];
      if constexpr (PH == 1)
        v[j] = v[j] * rs * __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(base + p.off_gam)[k]);
    }
  }
  uint32_t hi[4], lo[4];   // word w: k = 32c + 8w + t and + 4
#pragma unroll
  for (int w = 0; w < 4; ++w) split2(v[2 * w], v[2 * w + 1], hi[w], lo[w]);
  const float* sc = reinterpret_cast<const float*>(base + p.off_sc) +
                    gbase * p.ncp + 2 * t;
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
    if constexpr (VAR == 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t A[4] = {hi[2 * hh], lo[2 * hh], hi[2 * hh + 1],
                               lo[2 * hh + 1]};
        mma::mma_16816(d, A, b[2 * hh], b[2 * hh + 1]);
        const float2 sv =
            *reinterpret_cast<const float2*>(sc + hh * p.ncp + cc * 8);
        acc[ct][0] = fmaf(d[0] + d[2], sv.x, acc[ct][0]);
        acc[ct][1] = fmaf(d[1] + d[3], sv.y, acc[ct][1]);
      }
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma::mma_1688(d, hi[w], lo[w], b[w]);
        const float2 sv =
            *reinterpret_cast<const float2*>(sc + w * p.ncp + cc * 8);
        acc[ct][0] = fmaf(d[0] + d[2], sv.x, acc[ct][0]);
        acc[ct][1] = fmaf(d[1] + d[3], sv.y, acc[ct][1]);
      }
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

// A batch's sums (the consumer warps' partials added in warp order) and
// the phase's epilogue: thread (col group, row) = (tid / 8, tid % 8).
template <int PH>
__device__ void epilogue(const Args& a, const Smem& S, const Phase& p,
                         int m0, int ua, int nu, int cols) {
  const int row = threadIdx.x & 7, cgp = threadIdx.x >> 3;
  const int m = m0 + row, rc = a.pl.red_cols;
  const bool live = m < a.M;
  float sq = 0.f;
  const int nout = PH == 1 ? nu : cols;
  for (int i = cgp; i < nout; i += kColGroups) {
    float v = 0.f;
    for (int w = 0; w < kConsumers; ++w)
      v += S.red[(w * rc + i) * kRows + row];
    if (!live) continue;
    if constexpr (PH == 0) {
      const size_t at = (size_t)m * a.H + ua + i;
      const float x = __bfloat162float(a.h[at]) + v;
      a.x32[at] = x;
      a.h2[at] = __float2bfloat16(x);
      sq = fmaf(x, x, sq);
    } else if constexpr (PH == 1) {
      float u = 0.f;
      for (int w = 0; w < kConsumers; ++w)
        u += S.red[(w * rc + p.ncp / 2 + i) * kRows + row];
      a.act[(size_t)m * a.I + ua + i] = v * (1.f / (1.f + expf(-v))) * u;
    } else {
      a.y[(size_t)m * a.H + ua + i] = __float2bfloat16(v);
    }
  }
  if constexpr (PH == 0) sum_squares(S, sq, m0);
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

// A phase on the consumers: NCT tiles of 8 columns a batch at most, every
// one in each warp; the stage's chunks split over the warps.
template <int PH, int VAR, int NCT>
__device__ void run(const Args& a, const Smem& S, Cursor& cur) {
  const Phase& p = a.pl.ph[PH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, R = a.pl.R;
  const uint32_t mask = a.nib_mask, bias = a.nib_bias;
  int u0, u1;
  units_of(p, u0, u1);
  const int kt = kStageCodes * p.q;
  for (int m0 = 0; m0 < a.M; m0 += kRows) {
    const int Mp = min(kRows, a.M - m0);
    const int gr = g < Mp ? g : Mp - 1;   // rows past M repeat the last
    const float rs = PH == 1 ? S.rstd[m0 + gr] : 1.f;
    for (int ua = u0; ua < u1; ua += p.ub) {
      const int nu = min(p.ub, u1 - ua), cols = nu * (p.pairs ? 2 : 1);
      const int nct = p.pairs ? p.ncp >> 3 : (nu + 7) >> 3;
      if constexpr (PH == 0) {   // the epilogue's h, into L2 meanwhile
        const int m = m0 + (threadIdx.x & 7);
        if (m < a.M)
          for (int i = threadIdx.x >> 3; i < nu; i += kColGroups)
            sm90::prefetch_l2(a.h + (size_t)m * a.H + ua + i);
      }
      float acc[NCT][2];
#pragma unroll
      for (int ct = 0; ct < NCT; ++ct) acc[ct][0] = acc[ct][1] = 0.f;
      for (int k0 = 0; k0 < p.K; k0 += kt, cur.next(R)) {
        sm90::mbar_wait(S.full + cur.slot, cur.par);
        sm90::mbar_wait(S.afull + cur.slot, cur.par);
        const unsigned char* base = S.ring + (size_t)cur.slot * a.pl.slot;
        const uint8_t* xrow = base + p.off_act + gr * p.ap;
        const int nch = min(kt, p.K - k0) >> 5;
        int c = nch * warp / kConsumers;
        const int c_hi = nch * (warp + 1) / kConsumers;
        if constexpr (VAR == 0) {
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
              chunks32<PH, NCT, 2>(base, p, xrow, rs, c, gg, mask, bias, g,
                                   t, acc);
            }
          }
          for (; c < c_hi; ++c) {
            const int gg[1] = {step()};
            chunks32<PH, NCT, 1>(base, p, xrow, rs, c, gg, mask, bias, g,
                                 t, acc);
          }
        } else {
          for (; c < c_hi; ++c)
            chunk_small<PH, VAR, NCT>(base, p, xrow, rs, c, c * (32 / p.gs),
                                      nct, mask, bias, g, t, acc);
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(S.empty + cur.slot);
      }
      float* red = S.red + warp * a.pl.red_cols * kRows;
#pragma unroll
      for (int ct = 0; ct < NCT; ++ct)
        if (ct < nct) {
          red[(ct * 8 + 2 * t) * kRows + g] = acc[ct][0];
          red[(ct * 8 + 2 * t + 1) * kRows + g] = acc[ct][1];
        }
      named_sync();
      epilogue<PH>(a, S, p, m0, ua, nu, cols);
      named_sync();
    }
  }
}

// The phase's tiles of 8 columns a batch (the most, ncp / 8) pick the
// instantiation: 4, 8, 12, 16 or 24 tiles (8 or 24 in groups of 16 or 8).
template <int PH>
__device__ void run_phase(const Args& a, const Smem& S, Cursor& cur) {
  const Phase& p = a.pl.ph[PH];
  const int n = p.ncp >> 3;
  if (p.var == 0) {
    if (n <= 4)
      run<PH, 0, 4>(a, S, cur);
    else if (n <= 8)
      run<PH, 0, 8>(a, S, cur);
    else if (n <= 12)
      run<PH, 0, 12>(a, S, cur);
    else if (n <= 16)
      run<PH, 0, 16>(a, S, cur);
    else
      run<PH, 0, 24>(a, S, cur);
  } else if (p.var == 1) {
    if (n <= 8)
      run<PH, 1, 8>(a, S, cur);
    else
      run<PH, 1, 24>(a, S, cur);
  } else {
    if (n <= 8)
      run<PH, 2, 8>(a, S, cur);
    else
      run<PH, 2, 24>(a, S, cur);
  }
}

// K7's first phase: x32 = x + res, h2 and the sums of squares of the
// block's columns
__device__ void k7_prologue(const Args& a, const Smem& S) {
  int u0, u1;
  units_of(a.pl.ph[0], u0, u1);
  const int row = threadIdx.x & 7, cgp = threadIdx.x >> 3;
  for (int m0 = 0; m0 < a.M; m0 += kRows) {
    const int m = m0 + row;
    float sq = 0.f;
    if (m < a.M)
      for (int n = u0 + cgp; n < u1; n += kColGroups) {
        const size_t at = (size_t)m * a.H + n;
        const float x = __bfloat162float(a.h[at]) + __bfloat162float(a.res[at]);
        a.x32[at] = x;
        a.h2[at] = __float2bfloat16(x);
        sq = fmaf(x, x, sq);
      }
    sum_squares(S, sq, m0);
    named_sync();
  }
}

// The consumers' grid barrier: every block's writes so far are visible to
// every block (and to its bulk copies) once it returns. The block's
// threads meet first, then one thread arrives for them all with a release
// add (a fence in every thread took 0.8-3.4 us, two fence.sc in one ~1.4
// us more) and spins on acquire loads without sleeping.
__device__ void grid_barrier(const Args& a, const Smem& S, int n) {
  named_sync();
  if (threadIdx.x == 0) {
    sm90::fence_proxy_async_global();
    const unsigned inc =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    const unsigned old = atom_add_release(a.gbar, inc);
    while (((old ^ ld_acquire(a.gbar)) & 0x80000000u) == 0) {
    }
    st_release_cta(S.flag, n);
  }
  named_sync();
}

template <bool WO>
__device__ void consume(const Args& a, const Smem& S) {
  Cursor cur;
  if constexpr (WO)
    run_phase<0>(a, S, cur);
  else
    k7_prologue(a, S);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < a.M) a.ss[blockIdx.x * kMaxM + tid] = S.ssacc[tid];
  grid_barrier(a, S, 1);
  // rstd of each row from the nblk partial sums: a warp a row, a lane's
  // blocks in order, then the lanes in a fixed tree
  for (int m = warp; m < a.M; m += kConsumers) {
    float tot = 0.f;
    for (int b0 = 0; b0 < (int)gridDim.x; b0 += 256) {
      float v[8];   // eight loads in flight, then added in block order
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = b0 + lane + 32 * i;
        v[i] = b < (int)gridDim.x ? __ldcg(a.ss + b * kMaxM + m) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) tot += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
    if (lane == 0) S.rstd[m] = rsqrtf(tot / (float)a.H + a.eps);
  }
  named_sync();
  run_phase<1>(a, S, cur);
  grid_barrier(a, S, 2);
  run_phase<2>(a, S, cur);
}

// WO: K6 (the wo phase); else K7 (the residual from res).
template <bool WO>
__global__ void __launch_bounds__(kThreads, 1)
    layer_tail_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Smem S = smem_of(sm, a.pl);
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.pl.R; ++i) {
      sm90::mbar_init(S.full + i, 1);
      sm90::mbar_init(S.afull + i, 1);
      sm90::mbar_init(S.empty + i, kConsumers);
    }
    *S.flag = 0;
    sm90::fence_barrier_init();
  }
  if (threadIdx.x < kMaxM) S.ssacc[threadIdx.x] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == kWeightWarp)
    produce_weights(a, S, WO ? 0 : 1);
  else if (warp == kActWarp)
    produce_acts(a, S, WO ? 0 : 1);
  else
    consume<WO>(a, S);
}

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

// A phase's codes [rows][K/2] bytes as boxes of [ub][128 bytes], 128-byte
// swizzled, rows and bytes past the tensor read as zeros.
bool encode_codes(Phase& p, int rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)p.K / 2, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)p.K / 2};
  const cuuint32_t box[2] = {(cuuint32_t)kSlab, (cuuint32_t)p.ub};
  const cuuint32_t estr[2] = {1, 1};
  return fn(&p.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<uint8_t*>(p.w), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The card's SM count and the kernel's shared-memory limit, once per
// device; then the plan for that many blocks, the tensor maps and the
// launch.
template <bool WO>
int launch(Args& a, float* scratch, cudaStream_t stream) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(layer_tail_kernel<WO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (e != cudaSuccess) return (int)e;
    sms[dev] = n;
  }
  const int nblk = sms[dev];
  const int code = make_plan(a.pl, a.M, nblk, WO);
  if (code) return code;
  for (int i = WO ? 0 : 1; i < 3; ++i) {
    Phase& p = a.pl.ph[i];
    if (!encode_codes(p, p.pairs ? 2 * a.I : p.units))
      return (int)cudaErrorInvalidValue;
  }
  a.nib_mask = 0x000F000Fu;
  a.nib_bias = 0x43084308u;
  a.gbar = reinterpret_cast<unsigned*>(scratch);
  a.ss = scratch + kHeader;
  a.act = a.ss + nblk * kMaxM;
  if (!WO) a.x32 = a.act + (size_t)a.M * a.I;
  a.pl.ph[1].src = a.x32;
  a.pl.ph[2].src = a.act;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)layer_tail_kernel<WO>,
                                  dim3(nblk), dim3(kThreads), args,
                                  a.pl.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// h/attn/gamma/h2/y bf16; w* packed int4 codes [N, K/2] and s* float32
// scales [N, G] of ONE layer (ops/quantization.py), the codes 16-byte
// aligned, as attn and gamma. wo_out: float32 [M, H] scratch (x32 = h +
// wo_out); act: the float32 scratch [64 | nblk x 32 | M x I] (its first
// word the grid barrier's counter, zero before the first launch, left so
// by each), nblk being the card's SM count. Requires 1 <= M <= 32, H, Ko
// and I multiples of 32 and every group size a multiple of 32, or 8 or 16.
extern "C" int layer_tail_launch(const void* h, const void* attn,
                                 const void* gamma, const void* wo,
                                 const void* so, const void* wgu,
                                 const void* sgu, const void* wd,
                                 const void* sd, void* wo_out, void* act,
                                 void* h2, void* y, int M, int H, int Ko,
                                 int I, int Go, int Gg, int Gd, float eps,
                                 void* stream) {
  if (M < 1 || M > kMaxM || H % 32 || Ko % 32 || I % 32 ||
      !groups_ok(Ko, Go) || !groups_ok(H, Gg) || !groups_ok(I, Gd))
    return (int)cudaErrorInvalidValue;
  Args a{};
  set_phase(a.pl.ph[0], wo, so, H, 0, Ko, Go, 2, 0);
  a.pl.ph[0].src = attn;
  set_phase(a.pl.ph[1], wgu, sgu, I, 1, H, Gg, 4, 1);
  set_phase(a.pl.ph[2], wd, sd, H, 0, I, Gd, 4, 0);
  a.h = (const __nv_bfloat16*)h;
  a.gamma = (const __nv_bfloat16*)gamma;
  a.x32 = (float*)wo_out;
  a.h2 = (__nv_bfloat16*)h2;
  a.y = (__nv_bfloat16*)y;
  a.M = M;
  a.H = H;
  a.I = I;
  a.eps = eps;
  return launch<true>(a, (float*)act, (cudaStream_t)stream);
}

// K7: x/res/gamma/h2/y bf16 [M, H] ([H] for gamma); wgu/sgu, wd/sd one
// layer's codes and scales as above; act the float32 scratch [64 | nblk x
// 32 | M x I | M x H] (x32 last). Requires 1 <= M <= 32, H and I
// multiples of 32 and both group sizes a multiple of 32, or 8 or 16.
extern "C" int ffn_fused_launch(const void* x, const void* res,
                                const void* gamma, const void* wgu,
                                const void* sgu, const void* wd,
                                const void* sd, void* act, void* h2, void* y,
                                int M, int H, int I, int Gg, int Gd,
                                float eps, void* stream) {
  if (M < 1 || M > kMaxM || H % 32 || I % 32 || !groups_ok(H, Gg) ||
      !groups_ok(I, Gd))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.pl.ph[0].units = H;
  set_phase(a.pl.ph[1], wgu, sgu, I, 1, H, Gg, 4, 1);
  set_phase(a.pl.ph[2], wd, sd, H, 0, I, Gd, 4, 0);
  a.h = (const __nv_bfloat16*)x;
  a.res = (const __nv_bfloat16*)res;
  a.gamma = (const __nv_bfloat16*)gamma;
  a.h2 = (__nv_bfloat16*)h2;
  a.y = (__nv_bfloat16*)y;
  a.M = M;
  a.H = H;
  a.I = I;
  a.eps = eps;
  return launch<false>(a, (float*)act, (cudaStream_t)stream);
}

// The ring plan of a launch on nblk blocks (wo: K6, else K7), for the
// tests: out[0..3] = slots, slot bytes, shared memory, passes over the
// weights; then for each phase (wo, gate-up, down; zeros for K7's first)
// q, units a batch, columns a batch, their shared-memory rows, the rows of
// a slab, and the fewest and the most units a block takes. Returns 0 or
// cudaErrorInvalidValue.
extern "C" int layer_tail_plan(int M, int H, int Ko, int I, int Go, int Gg,
                               int Gd, int nblk, int wo, int* out) {
  if (M < 1 || M > kMaxM || nblk < 1 || H % 32 || Ko % 32 || I % 32 ||
      (wo && !groups_ok(Ko, Go)) || !groups_ok(H, Gg) || !groups_ok(I, Gd))
    return (int)cudaErrorInvalidValue;
  Plan pl{};
  if (wo) set_phase(pl.ph[0], nullptr, nullptr, H, 0, Ko, Go, 2, 0);
  set_phase(pl.ph[1], nullptr, nullptr, I, 1, H, Gg, 4, 1);
  set_phase(pl.ph[2], nullptr, nullptr, H, 0, I, Gd, 4, 0);
  const int code = make_plan(pl, M, nblk, wo != 0);
  if (code) return code;
  out[0] = pl.R;
  out[1] = pl.slot;
  out[2] = pl.smem;
  out[3] = row_passes(M);
  for (int i = 0; i < 3; ++i) {
    const Phase& p = pl.ph[i];
    int lo = p.units, hi = 0;
    for (int b = 0; b < nblk; ++b) {
      const int n = cut(p.units, b + 1, nblk) - cut(p.units, b, nblk);
      lo = n < lo ? n : lo;
      hi = n > hi ? n : hi;
    }
    const int v[7] = {p.q, p.ub, p.cols, p.ncp, p.rows, lo, hi};
    for (int j = 0; j < 7; ++j) out[4 + 7 * i + j] = wo || i > 0 ? v[j] : 0;
  }
  return 0;
}
