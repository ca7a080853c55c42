"""K1: weight-only matmul with the fused residual + RMSNorm prologue, K8:
its tiled prefill GEMM above 128 rows, K6: the fused decode layer tail,
and K7: the fused FFN block of a tensor-parallel layer (counterparts of
`llm_inference_tpu/ops/pallas/quant_matmul.py: quant_matmul`, its blocked
GEMV kernel (int8 per-channel and grouped, int4 grouped, each with or
without zero points), `_quant_matmul_tiled`, `layer_tail_fused` and
`ffn_fused`).

K1:  y = rms_norm(x (+ residual), gamma, eps) @ dequant(W[layer])

with the TPU kernel's rounding points: x enters as bf16, the prologue runs
in float32 and x_out = x + residual is stored as bf16. int8: the normed
rows are rounded to bf16 for the dot and the per-column scale hits the
float32 sum (grouped: each group's scale hits its partial dot). int4: the
normed rows stay float32 (the N-pair branch's dot is a float32 dot,
quant_matmul.py:183, 251) and each group's scale hits that group's
partial dot, y = Σ_g s[n, g] · (x_g · codes_g)_n. Zero points (z_ref)
add Σ_g sum(x_g) · zbias[n, g]: sums of the float32 rows for int8 per
channel and int4, of each group's bf16 rows for grouped int8
(quant_matmul.py:309-323). y is bf16 (then the caller's dtype).

K8 (M > 128 rows, quant_matmul.py:954-1007): the prologue runs before the
GEMM in the caller's dtype (the TPU package's jnp prologue), then the GEMM
dots bf16 rows against the codes: int8 takes its column scale on the
float32 sum, grouped weights each group's scale on that group's partial
dot, and zero points the sums of the bf16 rows (quant_matmul.py:474-487).

K6:  (down_out, h2) = layer_tail_fused(h, attn, wo, w_gateup, w_down, ...)

    wo_out = attn · wo          (float32, grouped int4)
    h2     = bf16(h + wo_out)
    xn     = rms_norm(h + wo_out) · gamma               (float32)
    act    = silu(xn · w_gate) · (xn · w_up)           (float32)
    y      = bf16(act · w_down)

nothing rounded between the phases. It takes M ≤ 32 rows and stacked
grouped symmetric int4 weights on the N-pair route, else returns None and
the caller runs the K1 chain.

K7:  (down_out, h2) = ffn_fused(x, residual, gamma, eps, w_gateup, w_down)

K6 without its wo phase, for a tensor-parallel layer whose wo partials
are summed across ranks first: x32 = bf16(x) + residual in float32,
h2 = x32 in x's dtype, then the norm, gate-up, SwiGLU and down as K6. It
returns None where the TPU package's ffn_fused does (more than 32 rows,
weights that are not stacked grouped int4, groups under 8 codes).

The int4 kernels take every group size of the TPU kernels' int4 paths
that the port's layout can feed them: K1 and K8 groups of 8, 16, 32 or
64k codes, K6, K7 and K12 groups of 8, 16 or 32k codes (small_groups_ok).
K8 runs groups of 64k codes (and int8) on its wgmma kernel, groups of 8,
16 or 32 on its mma.sync kernel (csrc/quant_matmul_tiled.cu). K1 runs a
GEMV up to 8 rows (int8: csrc/quant_matmul.cu; int4: csrc/qmm4_gemv.cu,
K6's weight ring in a one-phase instance, one persistent block an SM that
normalises its rows while its first codes stream) and above them K8's two
kernels: the wgmma one with a row tile fitted to M over one persistent
block an SM (`mma_plan`), the mma.sync one for groups of 8, 16 or 32 codes.

CUDA tensors go through `csrc/quant_matmul.cu` and `csrc/qmm4_gemv.cu` (K1),
`csrc/quant_matmul_tiled.cu` (K8) and `csrc/layer_tail.cu` (K6, K7); CPU
tensors through `quant_matmul_ref`, `layer_tail_fused_ref` and
`ffn_fused_ref`, their plain versions. K6 and K7 are one cooperative
launch of a persistent block an SM (the kernel plans its ring itself);
`tail_scratch_floats` is their float32 scratch, kept per device and grown.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from llm_inference_tpu_torch.ops.quantization import QTensor, codes

_MAX_M = 128      # above this the TPU package runs its tiled kernel (K8)
# the CUDA kernels' GEMV takes up to 8 rows whose activations (bf16 for
# int8, float32 for int4) fit in 200 KiB of shared memory
# (csrc/quant_matmul.cu); larger M runs the MMA path
_GEMV_MAX_M = 8
_GEMV_MAX_SMEM = 200 * 1024
_TAIL_MAX_M = 32  # layer_tail_fused's row limit (quant_matmul.py:710)
# K8's blocks own 128 output columns; its wgmma kernel steps K by 64
# (csrc/quant_matmul_tiled.cu)
_TILE_N = 128
_TILE_K = 64
# the row tiles of K1's MMA branch (qmm_wgmma_sk): the smallest that holds M
_ROW_TILES = (16, 32, 64, 128)

# K6/K7's scratch (csrc/layer_tail.cu): the header floats (the grid
# barrier's counter first), then a partial sum of squares for each of 32
# rows a block
_TAIL_HEADER = 64
_sms: dict = {}            # device -> SM count
_tail_scratch: dict = {}   # device -> float32 scratch of K6/K7
_mma_part: dict = {}       # device -> float32 partial tiles of K1's MMA branch
_mma_done: dict = {}       # device -> its zeroed int32 tile counters
_mma_plans: dict = {}      # (device, M, K, N, groups, bits) -> launch plan

# kernel launches made by quant_matmul (K1, and K8 above 128 rows),
# layer_tail_fused (K6) and ffn_fused (K7); the plain versions are not
# counted. mma_launches: those of K1's launches that took its MMA branch
# (also counted in `launches`)
launches = 0
mma_launches = 0
tiled_launches = 0
tail_launches = 0
ffn_launches = 0


def _rows(x):
    *lead, K = x.shape
    M = 1
    for d in lead:
        M *= d
    return lead, M, K


def _layer(qt: QTensor, layer) -> QTensor:
    return qt.layer(0 if layer is None else layer) if qt.stacked else qt


def _grouped_dot(x32, qt: QTensor):
    """Σ_g s[n, g] · (x_g · codes_g)_n (+ sum(x_g) · zbias[n, g] for an
    asymmetric weight) in float32, one (unstacked) weight with grouped
    scales: x32 [M, K] float32 → [M, N] float32, the groups summed in
    order (as the TPU kernels do), one [M, N] product at a time."""
    c = codes(qt)                                                # [N, K]
    N, K = c.shape
    gs = K // qt.groups
    y = x32.new_zeros((x32.shape[0], N))
    for g in range(qt.groups):
        xg = x32[:, g * gs:(g + 1) * gs]
        y += (xg @ c[:, g * gs:(g + 1) * gs].T.to(torch.float32)
              ) * qt.scale[:, g]
        if qt.zbias is not None:
            y += xg.sum(-1, keepdim=True) * qt.zbias[:, g]
    return y


def _channel_dot(xb, qt: QTensor, xsum=None):
    """bf16 rows xb [M, K] against one int8 per-channel weight: the column
    scale on the float32 sum, then sum(x) · zbias for an asymmetric one
    (xsum [M, 1]: the float32 sum of the rows the caller names, else
    xb's)."""
    y = (xb.to(torch.float32) @ qt.q.to(torch.float32).T) * qt.scale.reshape(
        -1)
    if qt.zbias is not None:
        if xsum is None:
            xsum = xb.to(torch.float32).sum(-1, keepdim=True)
        y = y + xsum * qt.zbias.reshape(-1)
    return y


def quant_matmul_ref(x, qt: QTensor, layer=None, *, norm_gamma=None,
                     norm_eps: float = 1e-5, residual=None,
                     want_x_out: bool = False):
    """Plain version of `quant_matmul` (same arguments and results).

    Its rounding points are the TPU kernels': up to 128 rows int8 dots the
    bf16-rounded rows (per group for grouped scales) and int4 the float32
    rows; an asymmetric weight's sum(x) · zbias takes the float32 rows
    before their rounding for int8 per-channel and int4, each group's bf16
    rows for grouped int8 (quant_matmul.py:309-323). Above 128 rows (K8)
    every dot and every sum takes the bf16 rows the prologue leaves."""
    f32, bf16 = torch.float32, torch.bfloat16
    lead, M, K = _rows(x)
    fused = norm_gamma is not None or residual is not None
    x_full = None
    xsum = None
    if M > _MAX_M:
        # the TPU package's prefill path: prologue outside the kernel, in
        # the caller's dtype, then the bf16 dot
        x32 = x.reshape(M, K).to(f32)
        if residual is not None:
            x32 = x32 + residual.reshape(M, K).to(f32)
        x_full = x32.to(x.dtype)
        if norm_gamma is not None:
            var = torch.mean(x32 * x32, dim=-1, keepdim=True)
            x32 = x32 * torch.rsqrt(var + norm_eps) * norm_gamma.to(f32)
        xn = x32.to(x.dtype).to(bf16) if fused else x.reshape(M, K).to(bf16)
    else:
        x2 = x.reshape(M, K).to(bf16)
        if fused:
            x32 = x2.to(f32)
            if residual is not None:
                x32 = x32 + residual.reshape(M, K).to(f32)
            x_full = x32.to(bf16)
            if norm_gamma is not None:
                var = torch.mean(x32 * x32, dim=-1, keepdim=True)
                x32 = x32 * torch.rsqrt(var + norm_eps)
                x32 = x32 * norm_gamma.to(f32)
            xsum = x32.sum(-1, keepdim=True)
            # int8 dots bf16 rows; the int4 branch keeps them float32
            xn = x32 if qt.bits == 4 else x32.to(bf16)
        else:
            xn = x2
    w = _layer(qt, layer)
    if qt.bits == 4:
        y = _grouped_dot(xn.to(f32), w)
    elif w.grouped:
        y = _grouped_dot(xn.to(bf16).to(f32), w)
    else:
        y = _channel_dot(xn, w, xsum)
    y = y.to(bf16).reshape(*lead, -1).to(x.dtype)
    if not want_x_out:
        return y
    if x_full is None:
        x_full = x.reshape(M, K)
    return y, x_full.reshape(*lead, K).to(x.dtype)


def _check_weight(qt: QTensor, what: str):
    z = qt.zbias
    if (qt.q.dtype != torch.int8 or not qt.q.is_contiguous()
            or qt.scale.dtype != torch.float32
            or not qt.scale.is_contiguous()
            or (z is not None and (z.dtype != torch.float32
                                   or not z.is_contiguous()
                                   or z.shape != qt.scale.shape))):
        raise ValueError(f"{what} takes contiguous int8 codes [.., N, K'] "
                         "and float32 scales (and zero points in their "
                         "shape; models.llama.prepare_params)")


def small_groups_ok(group_size: int, multiple: int) -> bool:
    """Whether an int4 kernel whose groups come in multiples of `multiple`
    codes takes `group_size`: such a multiple, or 8, 16 or 32 codes (the
    int4 GEMV takes them as the weight ring does, csrc/weight_ring.cuh)."""
    return group_size % multiple == 0 or group_size in (8, 16, 32)


class MmaPlan(NamedTuple):
    """K1's MMA branch for one shape (`mma_plan`)."""
    bm: int        # row tile: the smallest of _ROW_TILES that holds M
    grid: int      # persistent blocks
    floats: int    # scratch: two partial tiles (bm x 128 floats) a block
    tiles: int     # 128-row weight tiles (the last maybe 64 rows)
    spg: int       # k steps an int4 group (1 for int8)
    units: int     # units a tile
    spu: int       # ring slots (two 64-deep k steps each) a unit
    total: int     # units in all: tiles x units


def mma_plan(M: int, K: int, N: int, groups: int, bits: int,
             sms: int) -> MmaPlan:
    """The plan of K1's MMA branch (csrc/quant_matmul_tiled.cu,
    qmm_wgmma_sk) for M rows on a card of `sms` SMs, int8 (per-channel,
    or groups of a multiple of 64 codes) or int4 groups of a multiple of
    64 codes; the kernel takes every count from it. The work is tiles x
    units (a ring slot of two 64-deep k steps; for grouped scales the
    slots of one group, or of two groups of an odd number of steps),
    cut into `grid` ranges of whole units that differ by at most one unit:
    one persistent block an SM, or one a unit where there are fewer units
    than SMs. A tile two or more blocks share is summed through the
    scratch."""
    bm = next(b for b in _ROW_TILES if b >= M)
    tiles = -(-N // _TILE_N)
    slots = -(-K // (2 * _TILE_K))
    spg = spu = 1
    if bits == 4 or groups > 1:
        spg = K // groups // _TILE_K
        spu = spg // 2 if spg % 2 == 0 else spg
    units = -(-slots // spu)
    total = tiles * units
    grid = min(sms, total)
    return MmaPlan(bm, grid, 2 * grid * bm * _TILE_N, tiles, spg, units,
                   spu, total)


def _mma_launch_plan(device, M: int, K: int, N: int, groups: int,
                     bits: int) -> int:
    """Address of the launch plan of K1's MMA branch on `device`, the int64
    array {M, K, N, groups, bits, bm, grid, partials, counters, spg,
    units, spu, total} that qmm_mma_launch reads in place of thirteen
    arguments: `mma_plan` for the card's SM count, and the device's
    float32 partials and int32 tile counters, grown as needed and kept
    between calls (zeros when allocated; the tile's last block leaves its
    counter zero, and launches on one stream run in order). Kept by shape
    until a buffer grows. Int4 groups of 8, 16 or 32 codes take the
    mma.sync kernel, which needs no plan but the shape."""
    key = (device, M, K, N, groups, bits)
    plan = _mma_plans.get(key)
    if plan is not None:
        return plan[1]
    if bits == 4 and (K // groups) % _TILE_K:
        vals = (M, K, N, groups, bits, _MAX_M) + (0,) * 7
    else:
        sms = _sms.get(device)
        if sms is None:
            sms = _sms[device] = torch.cuda.get_device_properties(
                device).multi_processor_count
        p = mma_plan(M, K, N, groups, bits, sms)
        part = _mma_part.get(device)
        done = _mma_done.get(device)
        if part is None or part.numel() < p.floats:
            part = _mma_part[device] = torch.empty(
                p.floats, dtype=torch.float32, device=device)
            _mma_plans.clear()
        if done is None or done.numel() < p.tiles:
            done = _mma_done[device] = torch.zeros(
                p.tiles, dtype=torch.int32, device=device)
            _mma_plans.clear()
        vals = (M, K, N, groups, bits, p.bm, p.grid, part.data_ptr(),
                done.data_ptr(), p.spg, p.units, p.spu, p.total)
    arr = (ctypes.c_int64 * 13)(*vals)
    _mma_plans[key] = (arr, ctypes.addressof(arr))
    return ctypes.addressof(arr)


def quant_matmul(x, qt: QTensor, layer=None, *, norm_gamma=None,
                 norm_eps: float = 1e-5, residual=None,
                 want_x_out: bool = False):
    """y = [rms_norm(x (+ residual), norm_gamma)] @ dequant(qt[layer]).

    x: [..., K]; qt: one weight or a stack over layers with `layer` (a
    Python int) selecting the slice. Returns y [..., N] in x.dtype, and
    with want_x_out also x + residual (the new residual stream). Every
    format of quantize runs on the card: int8 per-channel or in groups of
    a multiple of 64 codes, int4 as small_groups_ok says, with or without
    zero points."""
    if not x.is_cuda:
        return quant_matmul_ref(x, qt, layer, norm_gamma=norm_gamma,
                                norm_eps=norm_eps, residual=residual,
                                want_x_out=want_x_out)
    global launches, mma_launches, tiled_launches
    from llm_inference_tpu_torch.ops.kernels import _build
    lead, M, K = _rows(x)
    N = qt.out_features
    tiled = M > _MAX_M
    what = "K8" if tiled else "K1"
    _check_weight(qt, what)
    int4 = qt.bits == 4
    G = qt.groups
    if tiled:
        # N a multiple of 64: the last band of 128 weight rows may hold 64
        if (K % _TILE_K or N % 64
                or (int4 and not small_groups_ok(qt.group_size, _TILE_K))):
            raise ValueError(
                f"K8 needs K % {_TILE_K} == 0, N % 64 == 0 and int4 "
                f"groups of a multiple of {_TILE_K} codes, or of 8, 16 or "
                f"32, got K={K} N={N} bits={qt.bits} group_size="
                f"{qt.group_size}")
    elif (K % 64 or N % 64
          or (int4 and not small_groups_ok(qt.group_size, 64))):
        raise ValueError(f"K1 needs K % 64 == 0, N % 64 == 0 and int4 groups "
                         f"of a multiple of 64 codes, or of 8, 16 or 32, got "
                         f"K={K} N={N} bits={qt.bits} group_size="
                         f"{qt.group_size}")
    if not int4 and G > 1 and qt.group_size % _TILE_K:
        raise ValueError(f"{what} needs int8 groups of a multiple of "
                         f"{_TILE_K} codes, got {qt.group_size}")
    asym = qt.zbias is not None
    bf16 = torch.bfloat16
    for name, t in (("residual", residual), ("norm_gamma", norm_gamma)):
        if t is not None and t.dtype != bf16:
            raise TypeError(f"{what} takes a bf16 {name}, got {t.dtype}")
    x2 = x.reshape(M, K).to(bf16).contiguous()
    res = None if residual is None else residual.reshape(M, K).contiguous()
    gam = None if norm_gamma is None else norm_gamma.reshape(K).contiguous()
    out = torch.empty((M, N), dtype=bf16, device=x.device)
    fused = norm_gamma is not None or residual is not None
    x_out = (torch.empty((M, K), dtype=bf16, device=x.device)
             if want_x_out and fused else None)
    # the MMA and tiled paths normalise the rows once into this scratch;
    # the GEMV normalises in shared memory and takes none
    mma = M > _GEMV_MAX_M or M * K * (4 if int4 else 2) > _GEMV_MAX_SMEM
    xn = (torch.empty((M, K), dtype=bf16, device=x.device)
          if fused and mma else None)
    # the MMA and tiled paths' sums of the rows for the zero points, one a
    # row and group, made by their pre-pass
    xsum = (torch.empty((M, G), dtype=torch.float32, device=x.device)
            if asym and mma else None)
    li = 0 if layer is None else int(layer)
    if not qt.stacked and li:
        raise ValueError("layer given for an unstacked weight")
    ptrs = (x2.data_ptr(), None if res is None else res.data_ptr(),
            None if gam is None else gam.data_ptr())
    xn_ptr = None if xn is None else xn.data_ptr()
    xo_ptr = None if x_out is None else x_out.data_ptr()
    xs_ptr = None if xsum is None else xsum.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w_ptr = qt.q.data_ptr() + li * N * (K // 2 if int4 else K)
    s_ptr = qt.scale.data_ptr() + li * N * G * 4
    z_ptr = None if not asym else qt.zbias.data_ptr() + li * N * G * 4
    if tiled:
        # the TPU package's prefill path: the prologue runs before the
        # GEMM (one pre-pass, as its jnp prologue), the GEMM on bf16 rows;
        # zero points take the pass's sums of the bf16 rows
        a = x2
        if fused or asym:
            _build.check(_build.lib().qmm_prologue_launch(
                *ptrs, xn_ptr, xo_ptr, xs_ptr, M, K, G, 0, float(norm_eps),
                stream), "quant_matmul prologue")
            if fused:
                a = xn
        _build.check(_build.lib().qmm_tiled_launch(
            a.data_ptr(), w_ptr, s_ptr, z_ptr, xs_ptr, out.data_ptr(), M, K,
            N, G, qt.bits, stream), "quant_matmul tiled")
        tiled_launches += 1
    else:
        if mma:
            # the prologue pre-pass (when fused, or for the zero points'
            # sums), then the product on wgmma with a row tile fitted to M
            # (csrc/quant_matmul_tiled.cu), whose TMA reads the rows from
            # a 16-byte aligned address
            if not fused and ptrs[0] % 16:
                x2 = x2.clone()
                ptrs = (x2.data_ptr(),) + ptrs[1:]
            # the zero points' sums (sum_mode): of the float32 rows before
            # their rounding for int8 per channel and int4 (1), of each
            # group's bf16 rows for grouped int8 (0), as K1's TPU body
            code = _build.lib().qmm_mma_launch(
                *ptrs, xn_ptr, xo_ptr, w_ptr, s_ptr, z_ptr, xs_ptr,
                out.data_ptr(),
                _mma_launch_plan(x.device, M, K, N, G, qt.bits),
                0 if qt.bits == 8 and qt.grouped else 1, float(norm_eps),
                stream)
        elif int4:
            # the rows are read 16 bytes at a time, the codes by TMA
            if w_ptr % 16:
                raise ValueError("K1 needs 16-byte aligned int4 codes")
            x2, res, gam = (None if t is None else _aligned(t)
                            for t in (x2, res, gam))
            ptrs = tuple(None if t is None else t.data_ptr()
                         for t in (x2, res, gam))
            code = _build.lib().qmm4_launch(*ptrs, w_ptr, s_ptr, z_ptr,
                                            out.data_ptr(), xo_ptr, M, K,
                                            N, G, float(norm_eps), stream)
        else:
            code = _build.lib().qmm_launch(*ptrs, w_ptr, s_ptr, z_ptr,
                                           out.data_ptr(), xo_ptr, M, K,
                                           N, G, float(norm_eps), stream)
        _build.check(code, "quant_matmul")
        launches += 1
        mma_launches += mma
    y = out.reshape(*lead, N).to(x.dtype)
    if not want_x_out:
        return y
    if x_out is None:
        return y, x
    return y, x_out.reshape(*lead, K).to(x.dtype)


# ------------------------------------------------------------------- K6

def tail_scratch_floats(M: int, H: int, I: int, sms: int) -> int:
    """Float32 scratch of K6/K7 (csrc/layer_tail.cu) on `sms` SMs: the
    header (its first word the grid barrier's counter), the blocks' sums
    of squares [sms, 32], act [M, I] and x32 = h + wo_out [M, H]."""
    return _TAIL_HEADER + sms * _TAIL_MAX_M + M * I + M * H


def _tail_buffers(device, M: int, H: int, I: int):
    """(scratch pointer, x32 pointer) of the device's K6/K7 scratch, grown
    as needed and kept between calls: zeros when allocated, so the grid
    barrier's counter starts at 0, and every launch leaves it at a
    multiple of 2^31 (launches on one stream run in order)."""
    sms = _sms.get(device)
    if sms is None:
        sms = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    floats = tail_scratch_floats(M, H, I, sms)
    buf = _tail_scratch.get(device)
    if buf is None or buf.numel() < floats:
        buf = _tail_scratch[device] = torch.zeros(
            floats, dtype=torch.float32, device=device)
    base = buf.data_ptr()
    return base, base + 4 * (floats - M * H)


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (K6 and
    K7 copy attn and gamma with the copy engine; K1's int4 GEMV reads its
    rows 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_tail_weight(qt: QTensor, what: str):
    _check_weight(qt, what)
    if not small_groups_ok(qt.group_size, 32):
        raise ValueError(f"{what} needs int4 groups of a multiple of 32 "
                         f"codes, or of 8 or 16, got {qt.group_size}")
    if qt.q.data_ptr() % 16:
        raise ValueError(f"{what} needs 16-byte aligned codes (the copy "
                         "engine reads them)")


def _fuse_ok(qt) -> bool:
    """The weights K6, K7 and K12 may take at all: the TPU package keeps
    zero points off them (quant_matmul.py:692-696, layer_fused.py:338-345;
    its split-half int4 route, which they do not take either, is the
    forward's choice: models/llama.prepare_params)."""
    return isinstance(qt, QTensor) and qt.zbias is None


def _tail_ok(qt, K: int) -> bool:
    """The TPU package's _npair_ok_for_fuse (quant_matmul.py:692-696):
    stacked grouped symmetric int4 on the N-pair route with K input
    rows."""
    return (_fuse_ok(qt) and qt.bits == 4 and qt.stacked
            and qt.groups > 1 and qt.in_features == K)


def _tail_shapes(h, attn2d, wo, gu, dn):
    """(M, H, Ko, I) when K6 takes the case, else None (the JAX package's
    acceptance conditions, quant_matmul.py:705-729)."""
    _, M, H = _rows(h)
    Ko = attn2d.shape[-1]
    if M > _TAIL_MAX_M:
        return None
    if not (_tail_ok(wo, Ko) and _tail_ok(gu, H)):
        return None
    if wo.out_features != H or gu.out_features % 2:
        return None
    I = gu.out_features // 2
    if not _tail_ok(dn, I):
        return None
    if min(wo.group_size, gu.group_size, dn.group_size) < 8:
        return None
    return M, H, Ko, I


def layer_tail_fused_ref(h, attn2d, wo: QTensor, gu: QTensor, dn: QTensor,
                         gamma, eps: float, layer: int):
    """Plain version of `layer_tail_fused` for a case it takes."""
    f32, bf16 = torch.float32, torch.bfloat16
    *lead, H = h.shape
    M = h.numel() // H
    a = attn2d.reshape(M, -1).to(bf16).to(f32)
    wo_out = _grouped_dot(a, wo.layer(layer))
    x32 = h.reshape(M, H).to(bf16).to(f32) + wo_out
    h2 = x32.to(bf16)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    xn = x32 * torch.rsqrt(var + eps) * gamma.to(f32)
    gate, up = torch.chunk(_grouped_dot(xn, gu.layer(layer)), 2, dim=-1)
    act = gate * torch.sigmoid(gate) * up
    y = _grouped_dot(act, dn.layer(layer)).to(bf16)
    return (y.reshape(*lead, -1).to(h.dtype),
            h2.reshape(*lead, H).to(h.dtype))


def layer_tail_fused(h, attn2d, wo: QTensor, gu: QTensor, dn: QTensor,
                     gamma, eps: float, layer: int):
    """wo → (+h, RMSNorm) → gate-up → SwiGLU → down in one launch.

    h [..., H] is the residual stream, attn2d [..., Hq·D] the attention
    output, gamma [H] the FFN norm, wo/gu/dn stacked QTensors indexed by
    `layer`. Returns (down_out, h2 = h + wo_out) in h.dtype, or None when
    the case is not K6's (the caller runs the K1 chain)."""
    shapes = _tail_shapes(h, attn2d, wo, gu, dn)
    if shapes is None:
        return None
    if not h.is_cuda:
        return layer_tail_fused_ref(h, attn2d, wo, gu, dn, gamma, eps, layer)
    global tail_launches
    from llm_inference_tpu_torch.ops.kernels import _build
    M, H, Ko, I = shapes
    for qt in (wo, gu, dn):
        _check_tail_weight(qt, "K6")
    if H % 32 or Ko % 32 or I % 32:
        raise ValueError(f"K6 needs widths that are multiples of 32, got "
                         f"H={H} Ko={Ko} I={I}")
    bf16 = torch.bfloat16
    if gamma.dtype != bf16:
        raise TypeError(f"K6 takes a bf16 gamma, got {gamma.dtype}")
    dev = h.device
    h2d = h.reshape(M, H).to(bf16).contiguous()
    a2d = _aligned(attn2d.reshape(M, Ko).to(bf16).contiguous())
    gam = _aligned(gamma.reshape(H).contiguous())
    y = torch.empty((M, H), dtype=bf16, device=dev)
    h2 = torch.empty((M, H), dtype=bf16, device=dev)
    scratch, x32 = _tail_buffers(dev, M, H, I)
    li = int(layer)

    def w(qt):
        N, G = qt.out_features, qt.groups
        return (qt.q.data_ptr() + li * N * qt.in_features // 2,
                qt.scale.data_ptr() + li * N * G * 4)

    code = _build.lib().layer_tail_launch(
        h2d.data_ptr(), a2d.data_ptr(), gam.data_ptr(), *w(wo), *w(gu),
        *w(dn), x32, scratch, h2.data_ptr(),
        y.data_ptr(), M, H, Ko, I, wo.groups, gu.groups, dn.groups,
        float(eps), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "layer_tail_fused")
    tail_launches += 1
    *lead, _ = h.shape
    return (y.reshape(*lead, H).to(h.dtype), h2.reshape(*lead, H).to(h.dtype))


# ------------------------------------------------------------------- K7

def _ffn_shapes(x, gu, dn):
    """(M, K, I) when K7 takes the case, else None (the JAX package's
    acceptance conditions, quant_matmul.py:806-826): at most 32 rows,
    stacked grouped symmetric int4 gate-up and down weights on the N-pair
    route of K and I input rows, groups of at least 8 codes that divide
    the rows."""
    _, M, K = _rows(x)
    if M > _TAIL_MAX_M:
        return None
    for qt in (gu, dn):
        if not (_fuse_ok(qt) and qt.bits == 4 and qt.stacked
                and qt.groups > 1):
            return None
    I = gu.out_features // 2
    if gu.in_features != K or dn.in_features != I:
        return None
    gs_g, gs_d = K // gu.groups, I // dn.groups
    if gs_g < 8 or gs_d < 8 or K % gs_g or I % gs_d:
        return None
    return M, K, I


def ffn_fused_ref(x, residual, gamma, eps: float, gu: QTensor, dn: QTensor,
                  layer: int):
    """Plain version of `ffn_fused` for a case it takes."""
    f32, bf16 = torch.float32, torch.bfloat16
    *lead, K = x.shape
    M = x.numel() // K
    x32 = x.reshape(M, K).to(bf16).to(f32) + residual.reshape(M, K).to(f32)
    h2 = x32.to(x.dtype)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    xn = x32 * torch.rsqrt(var + eps) * gamma.to(f32)
    gate, up = torch.chunk(_grouped_dot(xn, gu.layer(layer)), 2, dim=-1)
    act = gate * torch.sigmoid(gate) * up
    y = _grouped_dot(act, dn.layer(layer)).to(x.dtype)
    return y.reshape(*lead, -1), h2.reshape(*lead, K)


def ffn_fused(x, residual, gamma, eps: float, gu: QTensor, dn: QTensor,
              layer: int):
    """rms_norm(x + residual) → gate-up → SwiGLU → down in one launch.

    x [..., K] is the residual stream, residual [..., K] the summed wo
    output of a tensor-parallel layer, gamma [K] the FFN norm, gu/dn
    stacked QTensors (this rank's shards) indexed by `layer`. Returns
    (down_out, h2 = x + residual) in x.dtype, down_out being this rank's
    partial sum, or None when the case is not K7's (the caller runs the K1
    chain)."""
    shapes = _ffn_shapes(x, gu, dn)
    if shapes is None:
        return None
    if not x.is_cuda:
        return ffn_fused_ref(x, residual, gamma, eps, gu, dn, layer)
    global ffn_launches
    from llm_inference_tpu_torch.ops.kernels import _build
    M, K, I = shapes
    for qt in (gu, dn):
        _check_tail_weight(qt, "K7")
    if K % 32 or I % 32 or dn.out_features != K:
        raise ValueError(f"K7 needs widths that are multiples of 32 and a "
                         f"down projection back to K, got K={K} I={I} "
                         f"H={dn.out_features}")
    bf16 = torch.bfloat16
    for name, t in (("residual", residual), ("gamma", gamma)):
        if t.dtype != bf16:
            raise TypeError(f"K7 takes a bf16 {name}, got {t.dtype}")
    dev = x.device
    H = dn.out_features
    x2 = x.reshape(M, K).to(bf16).contiguous()
    res = residual.reshape(M, K).contiguous()
    gam = _aligned(gamma.reshape(K).contiguous())
    y = torch.empty((M, H), dtype=bf16, device=dev)
    h2 = torch.empty((M, K), dtype=bf16, device=dev)
    scratch, _ = _tail_buffers(dev, M, K, I)
    li = int(layer)

    def w(qt):
        N, G = qt.out_features, qt.groups
        return (qt.q.data_ptr() + li * N * qt.in_features // 2,
                qt.scale.data_ptr() + li * N * G * 4)

    code = _build.lib().ffn_fused_launch(
        x2.data_ptr(), res.data_ptr(), gam.data_ptr(), *w(gu), *w(dn),
        scratch, h2.data_ptr(), y.data_ptr(), M, K, I, gu.groups,
        dn.groups, float(eps), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "ffn_fused")
    ffn_launches += 1
    *lead, _ = x.shape
    return (y.reshape(*lead, H).to(x.dtype), h2.reshape(*lead, K).to(x.dtype))
