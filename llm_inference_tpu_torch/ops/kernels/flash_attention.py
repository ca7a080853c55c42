"""K9: blockwise (flash) causal prefill attention over the stacked dense
cache, bf16, int8 or packed int4 (counterpart of
`llm_inference_tpu/ops/pallas/flash_attention.py`, `flash_attention`,
`_flash`, `_flash_body`, `_flash_body4` and `supports`).

The scores never leave the kernel: each block of query rows walks the
cache in slot blocks with an online softmax, skipping blocks outside the
rows' causal frontier and window, and masking only the blocks that are not
fully visible. Masking uses absolute query positions, non-decreasing along
each row (every prefill path here), so a chunk at a history offset attends
over the earlier chunks' slots.

Rounding points, as the TPU kernel's:
- bf16 and int8 caches: q, K and V enter as bf16 (int8 codes exactly);
  with an int8 cache the score columns take k_scale[slot] after the score
  scale, l sums the unnormalised p, which then takes v_scale[slot] and is
  rounded to bf16 for the P·V product (flash_attention.py:142-160).
- int4 cache: q and p stay float32 (flash_attention.py:201, 224); the
  nibbles are exact. The output is bf16, then the caller's dtype.
A row with no live slot block returns zeros (l = 0, flash_attention.py:
164-167).

CUDA tensors go through `csrc/flash_attention.cu`; CPU tensors through
`flash_attention_ref`, its plain PyTorch version, which walks the slots in
the kernel's 64-slot blocks.
"""

from __future__ import annotations

import torch

from llm_inference_tpu_torch.ops.quantization import unpack_kv4

NEG_INF = -1e30
BLOCK_S = 64       # the CUDA kernel's slot block (csrc/flash_attention.cu)

# kernel launches made by flash_attention (the plain version is not counted)
launches = 0


def supports(q_shape, S: int, quantized: bool = False) -> bool:
    """Whether the flash path takes this prefill (else ops.attention):
    the JAX package's gate, flash_attention.py:416-426. Below 2^20 score
    elements the plain path is the faster one there."""
    B, T, Hq, D = q_shape
    return (T > 1 and D in (64, 128, 256) and S % 128 == 0 and T >= 8
            and T * S >= (1 << 20))


def flash_attention_ref(q, k_all, v_all, layer: int, positions,
                        scale: float, logit_softcap: float = 0.0,
                        sliding_window: int = 0, k_scale=None, v_scale=None):
    """Plain version of `flash_attention` (same arguments): the online
    softmax over BLOCK_S-slot blocks with the TPU kernel's rounding
    points. V (and its scale) is zeroed on slots beyond every query of the
    row, which no kernel reads, so NaN there cannot leak."""
    B, T, Hq, D = q.shape
    _, _, Hkv, S, Dc = k_all.shape
    G = Hq // Hkv
    f32, bf16 = torch.float32, torch.bfloat16
    packed = Dc * 2 == D
    qf = q.to(f32) if packed else q.to(bf16).to(f32)
    qg = qf.permute(0, 2, 1, 3).reshape(B, Hkv, G, T, D)
    pos = positions.reshape(B, T).long()
    frontier = pos.amax(dim=1)                                  # [B]
    m = torch.full((B, Hkv, G, T, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, T, D), dtype=f32, device=q.device)
    zero = torch.zeros((), dtype=f32, device=q.device)
    for s0 in range(0, S, BLOCK_S):
        s1 = min(s0 + BLOCK_S, S)
        kb, vb = k_all[layer, :, :, s0:s1], v_all[layer, :, :, s0:s1]
        if packed:
            kb, vb = unpack_kv4(kb).to(f32), unpack_kv4(vb).to(f32)
        else:
            kb, vb = kb.to(bf16).to(f32), vb.to(bf16).to(f32)
        slot = torch.arange(s0, s1, device=q.device)
        ok = slot[None, None, :] <= pos[:, :, None]             # [B, T, bs]
        if sliding_window > 0:
            ok &= slot[None, None, :] > pos[:, :, None] - sliding_window
        ok = ok[:, None, None]                              # [B, 1, 1, T, bs]
        live = slot[None, :] <= frontier[:, None]               # [B, bs]
        scores = torch.einsum("bhgtd,bhsd->bhgts", qg, kb) * scale
        if k_scale is not None:  # [B, bs, Hkv] → [B, Hkv, 1, 1, bs]
            scores = scores * k_scale[layer, :, s0:s1].transpose(1, 2)[
                :, :, None, None, :]
        if logit_softcap > 0.0:
            scores = torch.tanh(scores / logit_softcap) * logit_softcap
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        if v_scale is not None:
            vs = torch.where(live[:, None, :],
                             v_scale[layer, :, s0:s1].transpose(1, 2), zero)
            p = p * vs[:, :, None, None, :]
        if not packed:
            p = p.to(bf16).to(f32)
        vb = torch.where(live[:, None, :, None], vb, zero)
        acc = acc * alpha + torch.einsum("bhgts,bhsd->bhgtd", p, vb)
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(bf16)
    return out.reshape(B, Hq, T, D).permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(q, k_all, v_all, layer: int, positions,
                    scale: float | None = None, logit_softcap: float = 0.0,
                    sliding_window: int = 0, k_scale=None, v_scale=None):
    """Blockwise masked attention over the cache.

    q [B, T, Hq, D] (this chunk's queries, post-RoPE); k_all/v_all
    [L, B, Hkv, S, Dc] with the chunk's K/V already written (bf16, int8
    codes, or packed int4 codes with Dc = D/2; the quantized ones with
    k_scale/v_scale [L, B, S, Hkv] float32); positions [B, T] absolute
    query positions, each row non-decreasing. Returns [B, T, Hq, D] in
    q.dtype. Callers check `supports` first."""
    B, T, Hq, D = q.shape
    L, _, Hkv, S, Dc = k_all.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    window = int(sliding_window or 0)
    quantized = k_scale is not None
    if quantized != (not k_all.is_floating_point()) or (
            (k_scale is None) != (v_scale is None)):
        raise ValueError("a quantized KV cache needs its k_scale and "
                         "v_scale, a float cache none")
    if not k_all.is_cuda:
        return flash_attention_ref(q, k_all, v_all, layer, positions, scale,
                                   logit_softcap, window, k_scale, v_scale)
    global launches
    from llm_inference_tpu_torch.ops.kernels import _build
    packed = quantized and Dc * 2 == D
    kind = 2 if packed else 1 if quantized else 0
    code_dtype = torch.int8 if quantized else torch.bfloat16
    if not (k_all.dtype == v_all.dtype == code_dtype
            and v_all.shape == k_all.shape and k_all.is_contiguous()
            and v_all.is_contiguous() and Dc == (D // 2 if packed else D)
            and D in (64, 128, 256) and S % BLOCK_S == 0 and Hq % Hkv == 0):
        raise ValueError(f"K9 does not take q {tuple(q.shape)} over a "
                         f"{k_all.dtype} cache {tuple(k_all.shape)}")
    if packed and q.dtype != torch.bfloat16:
        # the TPU kernel's int4 body dots q at its own precision
        raise TypeError(f"K9 over an int4 cache takes a bf16 q, got "
                        f"{q.dtype}")
    ks = vs = None
    if quantized:
        if not (k_scale.dtype == v_scale.dtype == torch.float32
                and k_scale.shape == v_scale.shape == (L, B, S, Hkv)
                and k_scale.is_contiguous() and v_scale.is_contiguous()):
            raise ValueError("K9 takes contiguous float32 scales "
                             f"[L, B, S, Hkv] = {(L, B, S, Hkv)}")
        scale_bytes = B * S * Hkv * 4
        ks = k_scale.data_ptr() + layer * scale_bytes
        vs = v_scale.data_ptr() + layer * scale_bytes
    qc = q.to(torch.bfloat16).contiguous()
    pos = positions.reshape(B, T).to(torch.int32).contiguous()
    out = torch.empty((B, T, Hq, D), dtype=torch.bfloat16, device=q.device)
    layer_bytes = B * Hkv * S * Dc * k_all.element_size()
    code = _build.lib().flash_attn_launch(
        qc.data_ptr(), k_all.data_ptr() + layer * layer_bytes,
        v_all.data_ptr() + layer * layer_bytes, ks, vs, pos.data_ptr(),
        out.data_ptr(), B, T, Hq, Hkv, S, D, kind, float(scale),
        float(logit_softcap), window,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention")
    launches += 1
    return out.to(q.dtype)
