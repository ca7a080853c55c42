"""K12: one whole decode layer at B = T = 1 in one launch, then its row
write (counterpart of `llm_inference_tpu/ops/pallas/layer_fused.py:
layer_decode_fused` and its kernel `_call`).

The megakernel states its own math, not the split path's:

    x32  = h + residual                                    (float32)
    qkv  = rms_norm(x32) · attn_norm · Wqkv                (float32)
    q    = rope(q) · D^-0.5,  k = rope(k)    (x·cos + rot·sin, float32)
    k16, v16 = bf16(k), bf16(v)                 (the new rows, returned)
    seed = the new token: s = bf16(q) · kd, acc = vd, l = 1, where kd, vd
           are k16, v16, or over an int8 cache their int8
           quantize-dequantize (bf16), as the row write will store them
    attention over the cache slots strictly below pos: float32 softmax,
           int8 scores times k_scale, l sums p before the V scale, then
           p (· v_scale) rounded to bf16 against the rows or codes
    x32' = x32 + (acc / l) · Wo;  h2 = bf16(x32')
    act  = silu(gate) · up,  gate | up = rms_norm(x32') · ffn_norm · Wgu
    down = bf16(act · Wdown)

with nothing rounded between the phases but where named. The GEMVs
follow the TPU kernel's two weight branches: int8 per-channel codes dot
bf16 rows and take the column scale on the float32 sum (int8 in groups:
each group's scale on its partial dot); grouped int4 codes dot float32
rows, each group's scale on its partial dot.

`layer_decode_fused` returns None where the TPU package's function does
(`supports`), and the caller runs the split path: a route, not a
fallback. Otherwise CUDA tensors launch `csrc/layer_fused.cu` (a
cooperative kernel of one block an SM on the weight ring it shares with
K6, `csrc/weight_ring.cuh`; a refused launch raises) and then the row
write (`kv_write.write_rows`, or `quantize_write_rows` over an int8
cache); CPU tensors run `layer_decode_fused_ref` and the row writes'
plain versions. The kernel's float32 scratch (`scratch_floats`) is kept
per device and grown: zeros when allocated, and every launch leaves its
grid barrier's and merge counters as it found them.
"""

from __future__ import annotations

import torch

from llm_inference_tpu_torch.ops import kvcache
from llm_inference_tpu_torch.ops.kernels import kv_write
from llm_inference_tpu_torch.ops.kernels.quant_matmul import (
    _aligned, _check_weight, _fuse_ok, _grouped_dot, small_groups_ok)
from llm_inference_tpu_torch.ops.quantization import QTensor, quantize_kv

NEG_INF = -1e30
WEIGHTS = ("wqkv", "wo", "w_gateup", "w_down")
_D = 128

# kernel launches made by layer_kernel (the plain version is not counted)
launches = 0
_sms: dict = {}        # device -> SM count
_scratch: dict = {}    # device -> the kernel's float32 scratch


def scratch_floats(H: int, Hq: int, Hkv: int, I: int, sms: int) -> int:
    """Float32 scratch of K12 on `sms` SMs (one block an SM), as
    csrc/layer_fused.cu lays it out, each part rounded up to 32 floats:
    64 header floats (the grid barrier's counter first), the heads' merge
    counters, the blocks' partial sums of squares [sms, 32], qkv, the
    attention shares' states [Hkv, sms // Hkv, G, D + 2], attn, x32' and
    act."""
    def r(n):
        return -(-n // 32) * 32
    max_split = max(1, sms // Hkv)
    return (64 + r(Hkv) + r(sms * 32) + r((Hq + 2 * Hkv) * _D)
            + r(Hkv * max_split * (Hq // Hkv) * (_D + 2)) + r(Hq * _D)
            + r(H) + r(I))


def _scratch_buffer(device, H: int, Hq: int, Hkv: int, I: int):
    """The device's K12 scratch, grown as needed and kept between calls
    (its counters start at zero and every launch leaves them so; launches
    on one stream run in order)."""
    sms = _sms.get(device)
    if sms is None:
        sms = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    floats = scratch_floats(H, Hq, Hkv, I, sms)
    buf = _scratch.get(device)
    if buf is None or buf.numel() < floats:
        buf = _scratch[device] = torch.zeros(floats, dtype=torch.float32,
                                             device=device)
    return buf


def supports(cfg, h_shape, layers, cache) -> bool:
    """Whether the megakernel takes this layer: the conditions under which
    the TPU package's layer_decode_fused (layer_fused.py:510-572) does not
    return None, in the port's terms. B = T = 1; a dense bf16 or int8
    KVCache of one sequence whose length is a multiple of 128; D = 128;
    no sliding window, logit softcap, qk-norm or qkv bias; the four fused
    weights stacked QTensors of one format without zero points: int8
    per-channel, int8 in groups of a multiple of 32 codes, or int4 on the
    N-pair route in groups of at least 8 codes that divide K (and D, for
    wo)."""
    B, T, H = h_shape
    if B != 1 or T != 1:
        return False
    if cfg.sliding_window or cfg.attn_logit_softcap or cfg.qk_norm:
        return False
    if "bqkv" in layers or cfg.head_dim != _D:
        return False
    if not isinstance(cache, kvcache.KVCache) or cache.bits not in (8, 16):
        return False
    S = cache.max_seq_len
    if S % 128 or cache.k.shape[1] != 1:
        return False
    ws = [layers.get(k) for k in WEIGHTS]
    # no zero points, int4 on the N-pair route alone (layer_fused.py:338-345)
    if not all(_fuse_ok(w) and w.stacked for w in ws):
        return False
    bits = ws[0].bits
    if bits not in (4, 8) or any(w.bits != bits for w in ws):
        return False
    wq, wo, wg, wd = ws
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    if (wq.in_features != H or wq.out_features != (Hq + 2 * Hkv) * _D
            or wo.in_features != Hq * _D or wo.out_features != H
            or wg.in_features != H or wg.out_features % 2
            or wd.in_features != wg.out_features // 2
            or wd.out_features != H):
        return False
    for w in ws:
        if w.groups == 1:
            if bits == 4:           # the TPU kernel's int4 path is grouped
                return False
            continue
        if w.group_size < 8 or w.in_features % w.group_size:
            return False
    if bits == 8 and any(w.grouped for w in ws):
        # int8 in groups (layer_fused.py:85-99): every weight grouped, in
        # groups of a multiple of 32 codes (the kernel's 32-code chunks)
        if not all(w.grouped and w.group_size % 32 == 0 for w in ws):
            return False
    return wo.groups == 1 or _D % wo.group_size == 0


def _gemv(x32, qt: QTensor):
    """x32 [1, K] float32 → [1, N] float32 through one layer's weight as
    the megakernel's GEMVs: int8 dots the bf16-rounded row and takes the
    column scale on the sum (grouped: each group's scale on its partial
    dot); int4 dots the float32 row group by group."""
    if qt.bits == 4:
        return _grouped_dot(x32, qt)
    xb = x32.to(torch.bfloat16).to(torch.float32)
    if qt.grouped:
        return _grouped_dot(xb, qt)
    return (xb @ qt.q.to(torch.float32).T) * qt.scale.reshape(-1)


def _norm(x32, gamma, eps: float):
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return x32 * torch.rsqrt(var + eps) * gamma.to(torch.float32)


def _rope(x, cos, sin):
    """x [n, D] float32 rotated as x·cos + rot·sin, rot = (-x2, x1)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[:, half:], x[:, :half]], dim=-1)
    return x * cos + rot * sin


def _quant_dq(rows16):
    """bf16 rows through the int8 KV quantizer and back (bf16)."""
    q, s = quantize_kv(rows16)
    return (q.to(torch.float32) * s).to(torch.bfloat16)


def layer_decode_fused_ref(cfg, h, residual, layers, cache, layer: int,
                           positions, cos, sin):
    """Plain version of the megakernel (module docstring): h, residual
    [1, 1, H]; layers the model's layer dict; cache a dense KVCache read at
    `layer` (not written); positions [1, 1]; cos/sin the RoPE rows at the
    position ([..., D] float32). Returns (h2, down_out) [1, 1, H] in
    h.dtype and the new rows k_new, v_new [Hkv, D] bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    H = h.shape[-1]
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    G = Hq // Hkv
    eps = cfg.rms_norm_eps
    wq, wo, wg, wd = (layers[k].layer(layer) for k in WEIGHTS)
    x32 = (h.reshape(1, H).to(bf16).to(f32)
           + residual.reshape(1, H).to(bf16).to(f32))
    qkv = _gemv(_norm(x32, layers["attn_norm"][layer], eps), wq)[0]
    c = cos.reshape(-1, D)[-1].to(f32)
    s = sin.reshape(-1, D)[-1].to(f32)
    q = _rope(qkv[:Hq * D].reshape(Hq, D), c, s) * D ** -0.5
    k = _rope(qkv[Hq * D:(Hq + Hkv) * D].reshape(Hkv, D), c, s)
    k16 = k.to(bf16)
    v16 = qkv[(Hq + Hkv) * D:].reshape(Hkv, D).to(bf16)
    kd, vd = ((_quant_dq(k16), _quant_dq(v16)) if cache.quantized
              else (k16, v16))
    qg = q.to(bf16).to(f32).reshape(Hkv, G, D)
    s_self = torch.einsum("hgd,hd->hg", qg, kd.to(f32))
    # the history: slots strictly below pos (slot pos is this token's,
    # seeded above; the caller writes it after)
    S = cache.max_seq_len
    ok = (torch.arange(S, device=h.device)
          < positions.reshape(-1)[-1].long())                  # [S]
    kc = cache.k[layer, 0].to(f32)                             # [Hkv, S, D]
    vc = torch.where(ok[None, :, None], cache.v[layer, 0].to(f32),
                     torch.zeros((), dtype=f32, device=h.device))
    scores = torch.einsum("hgd,hsd->hgs", qg, kc)
    if cache.quantized:
        scores = scores * cache.k_scale[layer, 0].T[:, None, :]
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    m = torch.maximum(s_self, scores.amax(dim=-1))
    p_self = torch.exp(s_self - m)
    p = torch.exp(scores - m[..., None])
    l = p_self + p.sum(dim=-1)
    if cache.quantized:
        vs = torch.where(ok, cache.v_scale[layer, 0].T,
                         torch.zeros((), dtype=f32, device=h.device))
        p = p * vs[:, None, :]
    p = p.to(bf16).to(f32)
    acc = (p_self[..., None] * vd.to(f32)[:, None, :]
           + torch.einsum("hgs,hsd->hgd", p, vc))
    attn = (acc / l[..., None]).reshape(1, Hq * D)
    x32 = x32 + _gemv(attn, wo)
    h2 = x32.to(bf16)
    gate, up = torch.chunk(_gemv(_norm(x32, layers["ffn_norm"][layer], eps),
                                 wg), 2, dim=-1)
    down = _gemv(gate * torch.sigmoid(gate) * up, wd).to(bf16)
    return (h2.reshape(1, 1, H).to(h.dtype),
            down.reshape(1, 1, H).to(h.dtype), k16, v16)


def layer_kernel(cfg, h, residual, layers, cache, layer: int, positions,
                 cos, sin):
    """The megakernel alone (layer_decode_fused_ref's arguments and
    results) for a case `supports` takes: CUDA tensors launch it, CPU
    tensors run the plain version."""
    if not h.is_cuda:
        return layer_decode_fused_ref(cfg, h, residual, layers, cache, layer,
                                      positions, cos, sin)
    global launches
    from llm_inference_tpu_torch.ops.kernels import _build
    f32, bf16 = torch.float32, torch.bfloat16
    H = h.shape[-1]
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    S = cache.max_seq_len
    ws = [layers[k] for k in WEIGHTS]
    I = ws[2].out_features // 2
    bits = ws[0].bits
    for w in ws:
        _check_weight(w, "K12")
        if bits == 4 and not small_groups_ok(w.group_size, 32):
            raise ValueError(f"K12 needs int4 groups of a multiple of 32 "
                             f"codes, or of 8 or 16, got {w.group_size}")
        if bits == 8 and (w.grouped != ws[0].grouped
                          or w.grouped and w.group_size % 32):
            raise ValueError(f"K12 needs int8 weights all per channel or all "
                             f"in groups of a multiple of 32 codes, got "
                             f"{w.group_size}")
        if w.q.data_ptr() % 16:
            raise ValueError("K12 needs 16-byte aligned codes (the copy "
                             "engine reads them)")
    if H % 32 or I % 32 or Hq // Hkv > 8:
        raise ValueError(f"K12 needs H and I multiples of 32 and at most 8 "
                         f"query heads a kv head, got H={H} I={I} "
                         f"G={Hq // Hkv}")
    code_dtype = bf16 if cache.bits == 16 else torch.int8
    if not (cache.k.dtype == cache.v.dtype == code_dtype
            and cache.k.is_contiguous() and cache.v.is_contiguous()):
        raise ValueError(f"K12 takes a contiguous {code_dtype} cache, got "
                         f"{cache.k.dtype}")
    gammas = [layers[n][layer] for n in ("attn_norm", "ffn_norm")]
    if any(g.dtype != bf16 for g in gammas):
        raise TypeError(f"K12 takes bf16 norms, got {gammas[0].dtype}")
    dev = h.device
    scratch = _scratch_buffer(dev, H, Hq, Hkv, I)
    k_new = torch.empty((Hkv, D), dtype=bf16, device=dev)
    v_new = torch.empty((Hkv, D), dtype=bf16, device=dev)
    h2 = torch.empty((H,), dtype=bf16, device=dev)
    down = torch.empty((H,), dtype=bf16, device=dev)
    # h, res and the FFN norm are read in 16-byte pieces
    hb = _aligned(h.reshape(H).to(bf16).contiguous())
    rb = _aligned(residual.reshape(H).to(bf16).contiguous())
    gf = _aligned(gammas[1].contiguous())
    c = cos.reshape(-1, D)[-1].to(f32).contiguous()
    s = sin.reshape(-1, D)[-1].to(f32).contiguous()
    pos = positions.reshape(-1)[-1:].to(torch.int32).contiguous()

    def ptrs(qt):
        return (qt.q.data_ptr() + layer * qt.q[0].numel(),
                qt.scale.data_ptr() + layer * qt.scale[0].numel() * 4)

    layer_bytes = Hkv * S * D * cache.k.element_size()
    ks = vs = None
    if cache.quantized:
        ks = cache.k_scale.data_ptr() + layer * S * Hkv * 4
        vs = cache.v_scale.data_ptr() + layer * S * Hkv * 4
    code = _build.lib().layer_fused_launch(
        hb.data_ptr(), rb.data_ptr(), gammas[0].contiguous().data_ptr(),
        gf.data_ptr(), c.data_ptr(), s.data_ptr(),
        *ptrs(ws[0]), *ptrs(ws[1]), *ptrs(ws[2]), *ptrs(ws[3]),
        cache.k.data_ptr() + layer * layer_bytes,
        cache.v.data_ptr() + layer * layer_bytes, ks, vs, pos.data_ptr(),
        scratch.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        h2.data_ptr(), down.data_ptr(), H, Hq, Hkv, S, I, scratch.numel(),
        *(qt.groups for qt in ws), bits, float(cfg.rms_norm_eps),
        float(D ** -0.5), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "layer_fused (K12)")
    launches += 1
    return (h2.reshape(1, 1, H).to(h.dtype),
            down.reshape(1, 1, H).to(h.dtype), k_new, v_new)


def layer_decode_fused(cfg, h, residual, layers, cache, layer: int,
                       positions, cos, sin):
    """One decode layer through the megakernel, then the new rows into the
    cache at min(pos, S - 1), in place. Returns (h2, down_out) [1, 1, H],
    the pair the next layer's prologue adds, or None when `supports` does
    not take the case (the caller runs the split path)."""
    if not supports(cfg, h.shape, layers, cache):
        return None
    h2, down, k_new, v_new = layer_kernel(cfg, h, residual, layers, cache,
                                          layer, positions, cos, sin)
    off = positions.reshape(-1)[-1:]
    if cache.quantized:
        kv_write.quantize_write_rows(cache.k, cache.v, cache.k_scale,
                                     cache.v_scale, layer, k_new, v_new, off)
    else:
        kv_write.write_rows(cache.k, cache.v, layer, k_new, v_new, off)
    return h2, down
