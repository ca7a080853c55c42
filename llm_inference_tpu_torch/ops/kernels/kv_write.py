"""K3 and K4 redesigned: the dense cache's KV write, with the RoPE of q
and k folded in (`rope_write`), and the entry points that write rows as
they come: K3 `write_token`, the int4 cache's `write_token_scales`, K4
`quantize_write_token`, and the whole-layer megakernel's `write_rows`
and `quantize_write_rows` (counterparts of
`llm_inference_tpu/ops/pallas/kv_write.py:write_token`,
`write_token_scales`, `quantize_write_token`, `write_rows` and
`quantize_write_rows`).

`rope_write` is one layer's write of a forward over a dense cache, for
any number T of new tokens: it rotates q [B, T, H, D] and k [B, T, Hkv,
D] (the unrotated column slices of the qkv projection, read through
their strides) by the RoPE rows cos/sin [B, T, D], returns the rotated
q, and writes the rotated k and v into the layer's cache at slot
clamp(offsets[b], 0, S - T) + t, as bf16 rows, int8 codes or packed int4
codes with their slot-major [L, B, S, Hkv] scales: one launch a layer,
in place. Its plain version is the port's `rope.apply_rope_gathered`
followed by `update_cache_layer`'s write (`window_write_ref`).

`write_token` writes one new K and V row per sequence into the stacked
cache [L, B, Hkv, S, Dc] at slot min(offsets[b], S-1), in place (a copy
of the rows in the cache's dtype: bf16 rows, or an int4 cache's packed
Dc = D/2 byte rows). `write_token_scales` writes one token's K and V
scale rows into the slot-major [L, B, S, Hkv] scales the same way.
`quantize_write_token` quantizes the rows to int8 first (per (sequence,
head) scales over D, quantization.quantize_kv) and writes the codes and
both scale rows, in place, in one launch. `write_rows` and
`quantize_write_rows` are the B = 1 forms that take the megakernel's
outputs as they come, [Hkv, D] rows and one offset (K12,
ops/kernels/layer_fused.py). Without the RoPE, k and v rows may differ
in width (DeepSeek's latent cache: k rows of 576 values, v rows of 512,
or their packed int4 bytes): `write_token` copies each row's own bytes,
`quantize_write_token` takes widths that are multiples of 32 up to 576
and quantizes each row over its own. All but the scale write launch the one
kernel template of `csrc/kv_write.cu` (`kv_rope_write_launch`; without
the RoPE for the five entry points that take rows as they come), and
each entry point counts its own launches. CUDA tensors go through the
kernels; CPU tensors through the `*_ref` plain versions.
"""

from __future__ import annotations

import torch

from llm_inference_tpu_torch.ops.quantization import (quantize_kv,
                                                      quantize_kv4)
from llm_inference_tpu_torch.ops.rope import apply_rope_gathered

# kernel launches made by rope_write / write_token / write_token_scales /
# quantize_write_token / write_rows / quantize_write_rows (the plain
# versions are not counted)
rope_launches = 0
launches = 0
scale_launches = 0
quant_launches = 0
rows_launches = 0
qrows_launches = 0

# the kernel's kinds (kv_write.cu `Kind`): rows copied as bytes, bf16
# rows, int8 codes, packed int4 codes
_COPY, _BF16, _INT8, _INT4 = 0, 1, 2, 3
_KIND = {16: _BF16, 8: _INT8, 4: _INT4}


def rope_supports(dtype, head_dim: int, k_all, bits: int) -> bool:
    """Whether `rope_write` takes a layer: bf16 rows of a head_dim that is
    a multiple of 32 up to 256, over a bf16, int8 or int4 cache."""
    return (dtype == torch.bfloat16 and head_dim % 32 == 0
            and head_dim <= 256
            and (bits != 16 or k_all.dtype == torch.bfloat16))


def window_write_ref(k_all, v_all, ks_all, vs_all, layer: int, k_new, v_new,
                     offsets, bits: int = 16):
    """Plain version of the write: T new rows per sequence (k_new/v_new
    [B, T, Hkv, D]) into layer `layer` of the stacked cache at slots
    clamp(offsets[b], 0, S - T) + t (dynamic_update_slice's window start;
    at T = 1 K3's min(offsets[b], S - 1)), quantized first for an int8
    (bits 8, quantize_kv) or int4 (bits 4, quantize_kv4) cache, whose
    scales go to the slot-major [L, B, S, Hkv] ks_all / vs_all. In place."""
    B, T = k_new.shape[:2]
    S = k_all.shape[3]
    start = torch.clamp(offsets.reshape(B).long(), 0, S - T)
    steps = torch.arange(T, device=k_all.device)
    kn = k_new.transpose(1, 2)                                # [B, Hkv, T, D]
    vn = v_new.transpose(1, 2)
    if bits != 16:
        quantize = quantize_kv4 if bits == 4 else quantize_kv
        (kn, ks), (vn, vs) = quantize(kn), quantize(vn)
        # scales [B, Hkv, T, 1] → slot-major [B, T, Hkv]
        for s_all, s_new in ((ks_all, ks), (vs_all, vs)):
            s_new = s_new[..., 0].transpose(1, 2)
            for b in range(B):
                s_all[layer, b].index_copy_(0, start[b] + steps, s_new[b])
    for c_all, new in ((k_all, kn), (v_all, vn)):
        new = new.to(c_all.dtype)
        for b in range(B):
            c_all[layer, b].index_copy_(1, start[b] + steps, new[b])


def rope_write_ref(q, k, v, cos, sin, offsets, k_all, v_all, layer: int,
                   ks_all=None, vs_all=None, bits: int = 16):
    """Plain version of `rope_write` (same arguments)."""
    q = apply_rope_gathered(q, cos, sin)
    window_write_ref(k_all, v_all, ks_all, vs_all, layer,
                     apply_rope_gathered(k, cos, sin), v, offsets, bits)
    return q


def rope_write(q, k, v, cos, sin, offsets, k_all, v_all, layer: int,
               ks_all=None, vs_all=None, bits: int = 16):
    """The RoPE on q [B, T, H, D] and k [B, T, Hkv, D] (bf16, D
    contiguous, any other strides) at the rows cos/sin [B, T, D] float32,
    then k and v [B, T, Hkv, D] written into layer `layer` of a dense
    cache at slot clamp(offsets[b], 0, S - T) + t, in place: bits 16, bf16
    rows [L, B, Hkv, S, D]; bits 8, int8 codes [L, B, Hkv, S, D]; bits 4,
    packed int4 codes [L, B, Hkv, S, D/2]; with the quantized kinds'
    float32 scales ks_all / vs_all [L, B, S, Hkv]. Returns the rotated q,
    [B, T, H, D] bf16 contiguous. One launch for every T."""
    if not k_all.is_cuda:
        return rope_write_ref(q, k, v, cos, sin, offsets, k_all, v_all,
                              layer, ks_all, vs_all, bits)
    global rope_launches
    B, T, H, D = q.shape
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"rope_write takes bf16 q, k and v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D % 32 or D > 256:
        raise ValueError(f"rope_write takes D % 32 == 0 and D <= 256, "
                         f"got {D}")
    if bits == 4 and D % 2:
        raise ValueError(f"an int4 cache packs two dims per byte; D {D} "
                         "is odd")
    Hkv = k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"rope_write takes q [B, T, H, D] and k, v [B, T, "
                         f"Hkv, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if cos.shape != (B, T, D) or sin.shape != cos.shape or not (
            cos.dtype == sin.dtype == torch.float32):
        raise ValueError(f"rope_write takes float32 cos/sin [B, T, D], got "
                         f"{tuple(cos.shape)} {cos.dtype}")
    q_out = torch.empty((B, T, H, D), dtype=torch.bfloat16, device=q.device)
    _launch("rope_write", k_all, v_all, ks_all, vs_all, layer, k, v, offsets,
            _KIND[bits], q=q, cos=cos.contiguous(), sin=sin.contiguous(),
            q_out=q_out)
    rope_launches += 1
    return q_out


def _align(nbytes: int) -> int:
    """The widest power of two up to 16 that divides nbytes (kv_write.cu
    `pow2_div`): the word a lane's values move in."""
    w = 16
    while nbytes % w:
        w //= 2
    return w


# the widest row K4 takes without the RoPE (kv_write.cu kWideE x 32)
_WIDE_D = 576


def _launch(what, k_all, v_all, ks_all, vs_all, layer, k, v, offsets, kind,
            q=None, cos=None, sin=None, q_out=None):
    """Check the caches and rows and launch `kv_rope_write_launch` on one
    layer (no count). k: [B, T, Hkv, D] and v: [B, T, Hkv, Dv] rows, D and
    Dv the head row's values (the cache row's bytes for a copy, whose rows
    are in the cache's dtype); Dv = D with the RoPE."""
    from llm_inference_tpu_torch.ops.kernels import _build
    L, B, Hkv, S, Dc = k_all.shape
    Dcv = v_all.shape[4]
    T, D, Dv = k.shape[1], k.shape[3], v.shape[3]
    quantized = kind in (_INT8, _INT4)
    want = {_COPY: k_all.dtype, _BF16: torch.bfloat16, _INT8: torch.int8,
            _INT4: torch.int8}[kind]
    dc, dcv = (D // 2, Dv // 2) if kind == _INT4 else (D, Dv)
    ok = (k_all.is_contiguous() and v_all.is_contiguous()
          and v_all.shape[:4] == k_all.shape[:4]
          and k_all.dtype == v_all.dtype == want
          and (kind == _COPY or (Dc == dc and Dcv == dcv))
          and k.shape == (B, T, Hkv, D) and v.shape == (B, T, Hkv, Dv)
          and (q is None or Dv == D))
    if quantized:
        ok = ok and (ks_all is not None and vs_all is not None
                     and ks_all.is_contiguous() and vs_all.is_contiguous()
                     and ks_all.dtype == vs_all.dtype == torch.float32
                     and ks_all.shape == vs_all.shape == (L, B, S, Hkv))
    if not ok:
        raise ValueError(
            f"{what} needs contiguous {want} caches [L, B, Hkv, S, {dc}] and "
            f"[L, B, Hkv, S, {dcv}]" + (" and float32 scales [L, B, S, Hkv]"
                                       if quantized else "")
            + f" for rows [B, T, Hkv, {D}] and [B, T, Hkv, {Dv}], got "
            f"{tuple(k_all.shape)} {tuple(v_all.shape)} {k_all.dtype}, rows "
            f"{tuple(k.shape)} {tuple(v.shape)}")
    if T > S:
        raise ValueError(f"{what}: {T} rows do not fit {S} slots")
    size = k.element_size()
    # the wide K4 reads its values one by one (kv_write.cu
    # kv_quant_write_wide): element alignment is enough
    wide = kind == _INT8 and q is None and (D != Dv or D > 256)
    word = (16 if kind == _COPY else size if wide
            else _align(D // 32 * size))
    for t in (k, v) if q is None else (q, k, v):
        if t.stride(3) != 1 or t.data_ptr() % word or any(
                s * size % word for s in t.stride()[:3]):
            raise ValueError(f"{what} reads rows with D contiguous and "
                             f"{word}-byte aligned, got strides "
                             f"{t.stride()}")
    if q is not None and (q_out.data_ptr() % word or cos.data_ptr() % 16
                          or sin.data_ptr() % 16):
        raise ValueError(f"{what}: q_out, cos and sin must be aligned")
    off = offsets.reshape(B).to(torch.int32).contiguous()
    k_bytes = B * Hkv * S * Dc * k_all.element_size()
    v_bytes = B * Hkv * S * Dcv * v_all.element_size()
    scale_bytes = B * S * Hkv * 4
    unit = size if kind == _COPY else 1      # a copy's strides are bytes
    strides = [s * unit for t in (q if q is not None else k, k, v)
               for s in t.stride()[:3]]

    def ptr(t, offset=0):
        return None if t is None else t.data_ptr() + offset
    code = _build.lib().kv_rope_write_launch(
        ptr(q), ptr(k), ptr(v), ptr(cos), ptr(sin), ptr(off), ptr(q_out),
        ptr(k_all, layer * k_bytes), ptr(v_all, layer * v_bytes),
        ptr(ks_all, layer * scale_bytes) if quantized else None,
        ptr(vs_all, layer * scale_bytes) if quantized else None,
        *strides, B, T, 0 if q is None else q.shape[2], Hkv, S,
        D * size if kind == _COPY else D, Dv * size if kind == _COPY else Dv,
        kind,
        int(k.dtype == torch.float32),
        torch.cuda.current_stream(k_all.device).cuda_stream)
    _build.check(code, what)


def write_token_ref(k_all, v_all, layer: int, k_new, v_new, offsets):
    """Plain version. k_new [B, Hkv, 1, D], v_new [B, Hkv, 1, Dv];
    offsets: [B] int."""
    B = k_new.shape[0]
    S = k_all.shape[3]
    off = torch.clamp(offsets.reshape(B).long(), 0, S - 1)
    rows = torch.arange(B, device=k_all.device)
    k_all[layer][rows, :, off] = k_new[:, :, 0].to(k_all.dtype)
    v_all[layer][rows, :, off] = v_new[:, :, 0].to(v_all.dtype)
    return k_all, v_all


def write_token(k_all, v_all, layer: int, k_new, v_new, offsets):
    """Write ONE new token per sequence into [L, B, Hkv, S, D] caches, in
    place (the v cache's rows may have another width, [.., Dv]: DeepSeek's
    latent cache); returns the same cache tensors."""
    if not k_all.is_cuda:
        return write_token_ref(k_all, v_all, layer, k_new, v_new, offsets)
    global launches
    _write(k_all, v_all, layer, k_new, v_new, offsets, "K3")
    launches += 1
    return k_all, v_all


def _write(k_all, v_all, layer, k_new, v_new, offsets, what):
    """Launch the kernel's copy of [B, Hkv, 1, Dc] k rows and [B, Hkv, 1,
    Dcv] v rows (no count)."""
    B, Hkv = k_all.shape[1], k_all.shape[2]
    rows = []
    for c_all, new in ((k_all, k_new), (v_all, v_new)):
        dc = c_all.shape[4]
        if dc * c_all.element_size() % 16:
            raise ValueError(f"{what} copies 16-byte vectors; a row is "
                             f"{dc * c_all.element_size()} B")
        rows.append(new.to(c_all.dtype).reshape(B, 1, Hkv, dc).contiguous())
    _launch(what, k_all, v_all, None, None, layer, *rows, offsets, _COPY)


def write_token_scales_ref(ks_all, vs_all, layer: int, ks_new, vs_new,
                           offsets):
    """Plain version of `write_token_scales` (same arguments)."""
    B = ks_new.shape[0]
    S = ks_all.shape[2]
    off = torch.clamp(offsets.reshape(B).long(), 0, S - 1)
    rows = torch.arange(B, device=ks_all.device)
    ks_all[layer][rows, off] = ks_new[:, 0].to(ks_all.dtype)
    vs_all[layer][rows, off] = vs_new[:, 0].to(vs_all.dtype)
    return ks_all, vs_all


def write_token_scales(ks_all, vs_all, layer: int, ks_new, vs_new, offsets):
    """Write ONE token's per-head K and V scales (ks_new/vs_new [B, 1, Hkv]
    float32) into slot-major [L, B, S, Hkv] float32 scales at slot
    min(offsets[b], S-1), in place; returns the two scale tensors."""
    if not ks_all.is_cuda:
        return write_token_scales_ref(ks_all, vs_all, layer, ks_new, vs_new,
                                      offsets)
    global scale_launches
    from llm_inference_tpu_torch.ops.kernels import _build
    L, B, S, Hkv = ks_all.shape
    if not (ks_all.is_contiguous() and vs_all.is_contiguous()
            and ks_all.dtype == vs_all.dtype == torch.float32
            and vs_all.shape == ks_all.shape):
        raise ValueError("the scale write needs two contiguous float32 "
                         "scale arrays [L, B, S, Hkv] of one shape")
    kn = ks_new.to(torch.float32).reshape(B, Hkv).contiguous()
    vn = vs_new.to(torch.float32).reshape(B, Hkv).contiguous()
    off = offsets.reshape(B).to(torch.int32).contiguous()
    layer_bytes = B * S * Hkv * 4
    code = _build.lib().kv_scale_write_launch(
        ks_all.data_ptr() + layer * layer_bytes,
        vs_all.data_ptr() + layer * layer_bytes, kn.data_ptr(),
        vn.data_ptr(), off.data_ptr(), B, Hkv, S,
        torch.cuda.current_stream(ks_all.device).cuda_stream)
    _build.check(code, "kv_scale_write")
    scale_launches += 1
    return ks_all, vs_all


def quantize_write_token_ref(k_all, v_all, ks_all, vs_all, layer: int,
                             k_new, v_new, offsets):
    """Plain version of `quantize_write_token` (same arguments)."""
    B = k_new.shape[0]
    S = k_all.shape[3]
    off = torch.clamp(offsets.reshape(B).long(), 0, S - 1)
    rows = torch.arange(B, device=k_all.device)
    for codes_all, scales_all, new in ((k_all, ks_all, k_new),
                                       (v_all, vs_all, v_new)):
        q, s = quantize_kv(new[:, :, 0])            # [B, Hkv, D], [B, Hkv, 1]
        codes_all[layer][rows, :, off] = q
        scales_all[layer][rows, off] = s[..., 0]
    return k_all, v_all, ks_all, vs_all


def quantize_write_token(k_all, v_all, ks_all, vs_all, layer: int,
                         k_new, v_new, offsets):
    """Quantize ONE new token per sequence (k_new [B, Hkv, 1, D], v_new
    [B, Hkv, 1, Dv], bf16 or float32; D and Dv multiples of 32 up to 576,
    each row quantized over its own width) and write its int8 codes into
    [L, B, Hkv, S, D] and [L, B, Hkv, S, Dv] and its scales into
    slot-major [L, B, S, Hkv] float32 caches at slot min(offsets[b],
    S-1), in place; returns the four cache tensors."""
    if not k_all.is_cuda:
        return quantize_write_token_ref(k_all, v_all, ks_all, vs_all, layer,
                                        k_new, v_new, offsets)
    global quant_launches
    _quant_write(k_all, v_all, ks_all, vs_all, layer, k_new, v_new, offsets,
                 "K4")
    quant_launches += 1
    return k_all, v_all, ks_all, vs_all


def _quant_write(k_all, v_all, ks_all, vs_all, layer, k_new, v_new, offsets,
                 what):
    """Launch the kernel's int8 quantize-and-write of [B, Hkv, 1, D] k
    rows and [B, Hkv, 1, Dv] v rows (bf16 or float32, D contiguous),
    without the RoPE (no count)."""
    dtype = k_new.dtype
    if dtype not in (torch.bfloat16, torch.float32) or v_new.dtype != dtype:
        raise TypeError(f"{what} takes bf16 or float32 rows, got {dtype}")
    B, Hkv = k_all.shape[1], k_all.shape[2]
    for t, c_all in ((k_new, k_all), (v_new, v_all)):
        D = c_all.shape[4]
        if D % 32 or D > _WIDE_D:
            raise ValueError(f"{what} takes rows of a multiple of 32 values "
                             f"up to {_WIDE_D}, got {D}")
        if t.shape != (B, Hkv, 1, D) or t.stride(3) != 1:
            raise ValueError(f"{what} takes [B, Hkv, 1, D] rows with D "
                             f"contiguous, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    _launch(what, k_all, v_all, ks_all, vs_all, layer,
            k_new.transpose(1, 2), v_new.transpose(1, 2), offsets, _INT8)


# ------------------------------------------------- the megakernel's writes

def _rows(k_new, v_new, offset):
    """[Hkv, D] rows and a scalar offset as one sequence's [1, Hkv, 1, D]
    rows and [1] offsets (views, no copy)."""
    Hkv, D = k_new.shape
    off = offset if torch.is_tensor(offset) else torch.tensor(
        offset, device=k_new.device)
    return (k_new.reshape(1, Hkv, 1, D), v_new.reshape(1, Hkv, 1, D),
            off.reshape(-1)[-1:])


def write_rows_ref(k_all, v_all, layer: int, k_new, v_new, offset):
    """Plain version of `write_rows` (same arguments)."""
    return write_token_ref(k_all, v_all, layer, *_rows(k_new, v_new, offset))


def write_rows(k_all, v_all, layer: int, k_new, v_new, offset):
    """Write the rows k_new/v_new [Hkv, D] of ONE sequence (B = 1) into
    [L, 1, Hkv, S, D] caches at slot min(offset, S-1), in place; offset is
    an int or a one-element tensor. Returns the same cache tensors."""
    if not k_all.is_cuda:
        return write_rows_ref(k_all, v_all, layer, k_new, v_new, offset)
    global rows_launches
    _write(k_all, v_all, layer, *_rows(k_new, v_new, offset), "write_rows")
    rows_launches += 1
    return k_all, v_all


def quantize_write_rows_ref(k_all, v_all, ks_all, vs_all, layer: int, k_new,
                            v_new, offset):
    """Plain version of `quantize_write_rows` (same arguments)."""
    return quantize_write_token_ref(k_all, v_all, ks_all, vs_all, layer,
                                    *_rows(k_new, v_new, offset))


def quantize_write_rows(k_all, v_all, ks_all, vs_all, layer: int, k_new,
                        v_new, offset):
    """Quantize the rows k_new/v_new [Hkv, D] (bf16 or float32) of ONE
    sequence as quantize_write_token does and write codes and scales into
    [L, 1, Hkv, S, D] int8 caches and [L, 1, S, Hkv] float32 scales at
    slot min(offset, S-1), in place. Returns the four cache tensors."""
    if not k_all.is_cuda:
        return quantize_write_rows_ref(k_all, v_all, ks_all, vs_all, layer,
                                       k_new, v_new, offset)
    global qrows_launches
    _quant_write(k_all, v_all, ks_all, vs_all, layer,
                 *_rows(k_new, v_new, offset), "quantize_write_rows")
    qrows_launches += 1
    return k_all, v_all, ks_all, vs_all
