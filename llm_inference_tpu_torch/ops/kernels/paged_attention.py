"""K10a: single-token GQA attention over a paged pool of bf16 pages or
int8 codes with slot-major scales, and K10b: the same over packed int4
pages (counterparts of `llm_inference_tpu/ops/pallas/paged_attention.py`,
`paged_decode_attention`, `_paged_attn`, `_paged_attn4` and `supports`).

The function is K2's (K5's over int4 pages) over the slots a sequence's
page table maps: slot s of sequence b is row s % ps of pool page
page_table[b, s // ps]. The slot count is max_blocks x page_size, and a
position past it clamps to its last slot (a retired row's position grows
past its table; the null page absorbs its writes).

CUDA tensors go through `csrc/decode_attention.cu` (the K2 template with
the paged address policy); CPU tensors through `paged_attention_ref`,
which gathers the pages densely and runs K2's plain version.
"""

from __future__ import annotations

import torch

from llm_inference_tpu_torch.ops.kernels import decode_attention as k2

# kernel launches made by paged_attention: K10a (bf16 and int8 pools) and
# K10b (int4 pools); the plain version is not counted
launches = 0
int4_launches = 0


def supports(q_shape, page_size: int) -> bool:
    """Whether the kernel handles this case (else the gather path): the JAX
    package's gate, paged_attention.py:406-408."""
    B, T, Hq, D = q_shape
    return T == 1 and D in (64, 128, 256) and page_size % 8 == 0


def gather_pages(pages, page_table, layer: int):
    """One layer of a pool [L, P, Hkv, ps, Dc] through the table [B, NB] →
    the dense [B, Hkv, NB·ps, Dc] view."""
    g = pages[layer][page_table.long()]                # [B, NB, Hkv, ps, Dc]
    B, NB, Hkv, ps, Dc = g.shape
    return g.transpose(1, 2).reshape(B, Hkv, NB * ps, Dc)


def gather_scales(scales, page_table, layer: int):
    """One layer of slot-major pool scales [L, P, ps, Hkv] → [B, NB·ps,
    Hkv]."""
    g = scales[layer][page_table.long()]                   # [B, NB, ps, Hkv]
    B, NB, ps, Hkv = g.shape
    return g.reshape(B, NB * ps, Hkv)


def paged_attention_ref(q, k_pages, v_pages, page_table, layer: int,
                        positions, scale: float, logit_softcap: float = 0.0,
                        window: int = 0, k_scale=None, v_scale=None):
    """Plain version: the sequences' pages gathered densely, then K2's
    plain version (decode_attention_ref, the same rounding points) with
    positions clamped to the last slot. Returns [B, Hkv, G, D] bf16."""
    NB, ps = page_table.shape[1], k_pages.shape[3]
    kd = gather_pages(k_pages, page_table, layer)[None]
    vd = gather_pages(v_pages, page_table, layer)[None]
    ks = vs = None
    if k_scale is not None:
        ks = gather_scales(k_scale, page_table, layer)[None]
        vs = gather_scales(v_scale, page_table, layer)[None]
    pos = torch.clamp(positions.reshape(-1).long(), max=NB * ps - 1)
    return k2.decode_attention_ref(q, kd, vd, 0, pos, scale, logit_softcap,
                                   window, ks, vs)


def paged_attention(q, k_pages, v_pages, page_table, layer: int, positions,
                    scale: float | None = None, logit_softcap: float = 0.0,
                    window: int = 0, k_scale=None, v_scale=None):
    """q [B, 1, Hq, D]; k_pages/v_pages [L, P, Hkv, ps, Dc] with this
    step's token written (bf16, int8 codes, or packed int4 codes with Dc =
    D/2, the quantized ones with k_scale/v_scale [L, P, ps, Hkv] float32);
    page_table [B, NB] int32; positions [B] absolute position of the
    token. Returns [B, 1, Hq, D] in q.dtype. Callers check `supports`
    first; the kernel raises on what it does not take."""
    B, T, Hq, D = q.shape
    L, P, Hkv, ps, Dc = k_pages.shape
    NB = page_table.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    window = int(window or 0)
    quantized = not k_pages.is_floating_point()
    packed = quantized and Dc * 2 == D
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("a quantized pool needs its k_scale and v_scale")
    if not k_pages.is_cuda:
        out = paged_attention_ref(q, k_pages, v_pages, page_table, layer,
                                  positions, scale, logit_softcap, window,
                                  k_scale, v_scale)
        return out.reshape(B, 1, Hq, D).to(q.dtype)
    global launches, int4_launches
    from llm_inference_tpu_torch.ops.kernels import _build
    what = "K10b" if packed else "K10a"
    code_dtype = torch.int8 if quantized else torch.bfloat16
    if not (supports(q.shape, ps) and G <= k2._MAX_G and Hq % Hkv == 0
            and k_pages.dtype == v_pages.dtype == code_dtype
            and v_pages.shape == k_pages.shape
            and Dc == (D // 2 if packed else D)
            and k_pages.is_contiguous() and v_pages.is_contiguous()
            and page_table.shape[0] == B):
        raise ValueError(f"{what} does not take q {tuple(q.shape)} over a "
                         f"{k_pages.dtype} pool {tuple(k_pages.shape)}")
    if packed and q.dtype != torch.bfloat16:
        raise TypeError(f"K10b takes a bf16 q, got {q.dtype}")
    ks = vs = None
    if quantized:
        if not (k_scale.dtype == v_scale.dtype == torch.float32
                and k_scale.shape == v_scale.shape == (L, P, ps, Hkv)
                and k_scale.is_contiguous() and v_scale.is_contiguous()):
            raise ValueError(f"{what} takes contiguous float32 scales "
                             f"[L, P, ps, Hkv] = {(L, P, ps, Hkv)}")
        scale_bytes = P * ps * Hkv * 4
        ks = k_scale.data_ptr() + layer * scale_bytes
        vs = v_scale.data_ptr() + layer * scale_bytes
    qg = q.to(torch.bfloat16).reshape(B, Hkv, G, D).contiguous()
    pos = positions.reshape(B).to(torch.int32).contiguous()
    pt = page_table.to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, G, D), dtype=torch.bfloat16, device=q.device)
    layer_bytes = P * Hkv * ps * Dc * k_pages.element_size()
    kind = 2 if packed else 1 if quantized else 0
    nsplit, part, done = k2.split_buffers(q.device, B, Hkv, G, NB * ps, D,
                                          kind)
    code = _build.lib().paged_decode_attn_launch(
        qg.data_ptr(), k_pages.data_ptr() + layer * layer_bytes,
        v_pages.data_ptr() + layer * layer_bytes, ks, vs, pt.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part, done, B, Hkv, G, NB, ps, D,
        kind, nsplit, float(scale), float(logit_softcap), window,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_attention")
    if packed:
        int4_launches += 1
    else:
        launches += 1
    return out.reshape(B, 1, Hq, D).to(q.dtype)
