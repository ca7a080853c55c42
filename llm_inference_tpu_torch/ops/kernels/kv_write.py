"""K3: decode-step KV-cache write, the int4 cache's scale write, K4: the
int8 quantize-and-write, and the whole-layer megakernel's two row writes
(counterparts of `llm_inference_tpu/ops/pallas/kv_write.py:write_token`,
`write_token_scales`, `quantize_write_token`, `write_rows` and
`quantize_write_rows`).

`write_token` writes one new K and V row per sequence into the stacked
cache [L, B, Hkv, S, Dc] at slot min(offsets[b], S-1), in place (bf16
rows, or an int4 cache's packed Dc = D/2 byte rows). `write_token_scales`
writes one token's K and V scale rows into the slot-major [L, B, S, Hkv]
scales the same way. `quantize_write_token` quantizes the rows to int8
first (per (sequence, head) scales over D, quantization.quantize_kv) and
writes the codes and both scale rows, in place, in one launch.
`write_rows` and `quantize_write_rows` are the B = 1 forms that take the
megakernel's outputs as they come, [Hkv, D] rows and one offset (K12,
ops/kernels/layer_fused.py); they launch the K3 and K4 kernels on a batch
of one and count their own launches. CUDA tensors go through the kernels
of `csrc/kv_write.cu`; CPU tensors through the `*_ref` plain versions.
"""

from __future__ import annotations

import torch

from llm_inference_tpu_torch.ops.quantization import quantize_kv

# kernel launches made by write_token / write_token_scales /
# quantize_write_token / write_rows / quantize_write_rows (the plain
# versions are not counted)
launches = 0
scale_launches = 0
quant_launches = 0
rows_launches = 0
qrows_launches = 0


def write_token_ref(k_all, v_all, layer: int, k_new, v_new, offsets):
    """Plain version. k_new/v_new: [B, Hkv, 1, D]; offsets: [B] int."""
    B = k_new.shape[0]
    S = k_all.shape[3]
    off = torch.clamp(offsets.reshape(B).long(), 0, S - 1)
    rows = torch.arange(B, device=k_all.device)
    k_all[layer][rows, :, off] = k_new[:, :, 0].to(k_all.dtype)
    v_all[layer][rows, :, off] = v_new[:, :, 0].to(v_all.dtype)
    return k_all, v_all


def write_token(k_all, v_all, layer: int, k_new, v_new, offsets):
    """Write ONE new token per sequence into [L, B, Hkv, S, D] caches, in
    place; returns the same cache tensors."""
    if not k_all.is_cuda:
        return write_token_ref(k_all, v_all, layer, k_new, v_new, offsets)
    global launches
    _write(k_all, v_all, layer, k_new, v_new, offsets, "K3")
    launches += 1
    return k_all, v_all


def _write(k_all, v_all, layer, k_new, v_new, offsets, what):
    """Launch the K3 kernel (no count)."""
    from llm_inference_tpu_torch.ops.kernels import _build
    L, B, Hkv, S, D = k_all.shape
    if not (k_all.is_contiguous() and v_all.is_contiguous()
            and v_all.shape == k_all.shape and v_all.dtype == k_all.dtype):
        raise ValueError(f"{what} needs two contiguous caches of one "
                         "shape/dtype")
    kn = k_new.to(k_all.dtype).reshape(B, Hkv, D).contiguous()
    vn = v_new.to(k_all.dtype).reshape(B, Hkv, D).contiguous()
    off = offsets.reshape(B).to(torch.int32).contiguous()
    row_bytes = D * k_all.element_size()
    if row_bytes % 16:
        raise ValueError(f"{what} copies 16-byte vectors; row is "
                         f"{row_bytes} B")
    layer_bytes = B * Hkv * S * row_bytes
    code = _build.lib().kv_write_launch(
        k_all.data_ptr() + layer * layer_bytes,
        v_all.data_ptr() + layer * layer_bytes,
        kn.data_ptr(), vn.data_ptr(), off.data_ptr(), B, Hkv, S, row_bytes,
        torch.cuda.current_stream(k_all.device).cuda_stream)
    _build.check(code, what)


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
    """Quantize ONE new token per sequence (k_new/v_new [B, Hkv, 1, D],
    bf16 or float32) and write its int8 codes into [L, B, Hkv, S, D] and
    its scales into slot-major [L, B, S, Hkv] float32 caches at slot
    min(offsets[b], S-1), in place; returns the four cache tensors."""
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
    """Launch the K4 kernel (no count)."""
    from llm_inference_tpu_torch.ops.kernels import _build
    L, B, Hkv, S, D = k_all.shape
    caches_ok = (all(t.is_contiguous() for t in (k_all, v_all, ks_all,
                                                 vs_all))
                 and k_all.dtype == v_all.dtype == torch.int8
                 and v_all.shape == k_all.shape
                 and ks_all.dtype == vs_all.dtype == torch.float32
                 and ks_all.shape == vs_all.shape == (L, B, S, Hkv))
    if not caches_ok:
        raise ValueError(f"{what} needs contiguous int8 caches [L, B, Hkv, "
                         "S, D] and float32 scales [L, B, S, Hkv]")
    if D % 32 or D > 256:
        raise ValueError(f"{what} takes D % 32 == 0 and D <= 256, got {D}")
    dtype = k_new.dtype
    if dtype not in (torch.bfloat16, torch.float32) or v_new.dtype != dtype:
        raise TypeError(f"{what} takes bf16 or float32 rows, got {dtype}")
    strides = []
    for t in (k_new, v_new):
        if t.shape != (B, Hkv, 1, D) or t.stride(3) != 1:
            raise ValueError(f"{what} takes [B, Hkv, 1, D] rows with D "
                             f"contiguous, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
        strides += [t.stride(0), t.stride(1)]
    off = offsets.reshape(B).to(torch.int32).contiguous()
    code_bytes = B * Hkv * S * D
    scale_bytes = B * S * Hkv * 4
    code = _build.lib().kv_quant_write_launch(
        k_all.data_ptr() + layer * code_bytes,
        v_all.data_ptr() + layer * code_bytes,
        ks_all.data_ptr() + layer * scale_bytes,
        vs_all.data_ptr() + layer * scale_bytes,
        k_new.data_ptr(), v_new.data_ptr(), off.data_ptr(), B, Hkv, S, D,
        *strides, int(dtype == torch.float32),
        torch.cuda.current_stream(k_all.device).cuda_stream)
    _build.check(code, what)


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
