"""K11: blockwise (flash) prefill attention over a paged pool, bf16, int8
or packed int4 pages (counterpart of
`llm_inference_tpu/ops/pallas/paged_flash.py`, `paged_flash_attention`,
`_paged_flash` and `supports`): the fresh rows of a prefix-cache suffix,
or of a later chunk of a long admission, attend over the sequence's
earlier pages and their own, straight out of the pool.

The function is K9's over the slots the page table maps (slot s of
sequence b is row s % ps of page page_table[b, s // ps]), with K9's
rounding points and its zero rows where no slot is live. CUDA tensors go
through `csrc/flash_attention.cu` (K9's kernel with the paged address
policy); CPU tensors through `paged_flash_ref`, which gathers the pages
densely and runs K9's plain version over the same 64-slot blocks.
"""

from __future__ import annotations

import torch

from llm_inference_tpu_torch.ops.kernels import flash_attention as k9
from llm_inference_tpu_torch.ops.kernels.paged_attention import (
    gather_pages, gather_scales)

# kernel launches made by paged_flash_attention (the plain version is not
# counted)
launches = 0


def supports(q_shape, page_size: int) -> bool:
    """Whether the kernel takes this prefill (else the gather path): the
    JAX package's gate, paged_flash.py:202-208."""
    B, T, Hq, D = q_shape
    return T >= 8 and D in (64, 128, 256) and page_size % 128 == 0


def paged_flash_ref(q, k_pages, v_pages, page_table, layer: int, positions,
                    scale: float, logit_softcap: float = 0.0,
                    sliding_window: int = 0, k_scale=None, v_scale=None):
    """Plain version: the pages gathered densely, then K9's plain version
    (flash_attention_ref) over the NB·ps slots."""
    kd = gather_pages(k_pages, page_table, layer)[None]
    vd = gather_pages(v_pages, page_table, layer)[None]
    ks = vs = None
    if k_scale is not None:
        ks = gather_scales(k_scale, page_table, layer)[None]
        vs = gather_scales(v_scale, page_table, layer)[None]
    return k9.flash_attention_ref(q, kd, vd, 0, positions, scale,
                                  logit_softcap, sliding_window, ks, vs)


def paged_flash_attention(q, k_pages, v_pages, page_table, layer: int,
                          positions, scale: float | None = None,
                          logit_softcap: float = 0.0,
                          sliding_window: int = 0, k_scale=None,
                          v_scale=None):
    """q [B, T, Hq, D] (the fresh rows, post-RoPE); k_pages/v_pages
    [L, P, Hkv, ps, Dc] with the rows' K/V written (bf16, int8 codes, or
    packed int4 codes with Dc = D/2, the quantized ones with
    k_scale/v_scale [L, P, ps, Hkv] float32); page_table [B, NB] int32
    covering every position up to each row's last; positions [B, T]
    absolute, each row non-decreasing. Returns [B, T, Hq, D] in q.dtype.
    Callers check `supports` first; the kernel raises on what it does not
    take."""
    B, T, Hq, D = q.shape
    L, P, Hkv, ps, Dc = k_pages.shape
    NB = page_table.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    window = int(sliding_window or 0)
    quantized = k_scale is not None
    if quantized != (not k_pages.is_floating_point()) or (
            (k_scale is None) != (v_scale is None)):
        raise ValueError("a quantized pool needs its k_scale and v_scale, a "
                         "float pool none")
    if not k_pages.is_cuda:
        return paged_flash_ref(q, k_pages, v_pages, page_table, layer,
                               positions, scale, logit_softcap, window,
                               k_scale, v_scale)
    global launches
    from llm_inference_tpu_torch.ops.kernels import _build
    packed = quantized and Dc * 2 == D
    kind = 2 if packed else 1 if quantized else 0
    code_dtype = torch.int8 if quantized else torch.bfloat16
    if not (supports(q.shape, ps) and Hq % Hkv == 0
            and k_pages.dtype == v_pages.dtype == code_dtype
            and v_pages.shape == k_pages.shape
            and Dc == (D // 2 if packed else D)
            and k_pages.is_contiguous() and v_pages.is_contiguous()
            and page_table.shape[0] == B):
        raise ValueError(f"K11 does not take q {tuple(q.shape)} over a "
                         f"{k_pages.dtype} pool {tuple(k_pages.shape)}")
    if packed and q.dtype != torch.bfloat16:
        raise TypeError(f"K11 over int4 pages takes a bf16 q, got {q.dtype}")
    ks = vs = None
    if quantized:
        if not (k_scale.dtype == v_scale.dtype == torch.float32
                and k_scale.shape == v_scale.shape == (L, P, ps, Hkv)
                and k_scale.is_contiguous() and v_scale.is_contiguous()):
            raise ValueError("K11 takes contiguous float32 scales "
                             f"[L, P, ps, Hkv] = {(L, P, ps, Hkv)}")
        scale_bytes = P * ps * Hkv * 4
        ks = k_scale.data_ptr() + layer * scale_bytes
        vs = v_scale.data_ptr() + layer * scale_bytes
    qc = q.to(torch.bfloat16).contiguous()
    pos = positions.reshape(B, T).to(torch.int32).contiguous()
    pt = page_table.to(torch.int32).contiguous()
    out = torch.empty((B, T, Hq, D), dtype=torch.bfloat16, device=q.device)
    layer_bytes = P * Hkv * ps * Dc * k_pages.element_size()
    code = _build.lib().paged_flash_attn_launch(
        qc.data_ptr(), k_pages.data_ptr() + layer * layer_bytes,
        v_pages.data_ptr() + layer * layer_bytes, ks, vs, pt.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, NB, ps, D, kind,
        float(scale), float(logit_softcap), window,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_flash_attention")
    launches += 1
    return out.to(q.dtype)
