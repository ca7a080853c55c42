"""Masked GQA attention in plain PyTorch (counterpart of
`llm_inference_tpu/ops/attention.py`): the prefill path and the numerical
oracle. Keys and values come from the cache [B, Hkv, S, D]; the mask
`slot <= query position` covers causal prefill and decode alike. Softmax
runs in float32. An int8 cache passes its codes with their slot-major
scales, which fold exactly into the score and probability columns."""

from __future__ import annotations

from typing import Optional

import torch

from llm_inference_tpu_torch.ops.quantization import unpack_kv4

NEG_INF = -1e30


def make_attention_mask(q_positions: torch.Tensor, kv_len: int,
                        sliding_window: int = 0) -> torch.Tensor:
    """Boolean mask [B, 1, T, S]: True where a query may attend a slot."""
    slots = torch.arange(kv_len, device=q_positions.device,
                         dtype=q_positions.dtype)
    mask = slots[None, None, :] <= q_positions[:, :, None]
    if sliding_window > 0:
        mask &= slots[None, None, :] > (q_positions[:, :, None]
                                        - sliding_window)
    return mask[:, None, :, :]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, scale: Optional[float] = None,
           logit_softcap: float = 0.0,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, T, Hq, D], k [B, Hkv, S, D], v [B, Hkv, S, Dv], mask [B, 1,
    T, S] → [B, T, Hq, Dv] in q.dtype. Products of q.dtype values
    accumulate in float32, as the JAX einsums do with preferred_element_type.

    int8 codes in k/v come with k_scale/v_scale [B, S, Hkv]: the scores
    take k_scale[slot] after the score scale, and the probabilities
    v_scale[slot] (zeroed on slots no query attends) before they are
    rounded to q.dtype for the product with the codes. Packed int4 codes
    ([B, Hkv, S, D/2], quantization.quantize_kv4) unpack to their int8
    values first, then fold the same way."""
    B, T, Hq, D = q.shape
    quantized = not (k.is_floating_point() and v.is_floating_point())
    if quantized and k.shape[-1] * 2 == D:
        # packed int4: k and v each unpack to twice their own width (v
        # rows may be narrower than k's: DeepSeek's latent cache)
        k, v = unpack_kv4(k), unpack_kv4(v)
    if quantized and k.shape[-1] != D:
        raise ValueError(f"codes of width {k.shape[-1]} for head_dim {D}")
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("quantized codes need k_scale and v_scale, float "
                         "caches none")
    Hkv = k.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    f32 = torch.float32
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, T, D).to(f32)
    kf = k.to(q.dtype).to(f32)
    scores = torch.einsum("bhgtd,bhsd->bhgts", qg, kf) * scale
    if k_scale is not None:     # [B, S, Hkv] slot-major → [B, Hkv, 1, 1, S]
        scores = scores * k_scale.transpose(1, 2)[:, :, None, None, :]
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    scores = torch.where(mask[:, :, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    # zero V on slots no query may attend: their probabilities are 0, but
    # 0 × NaN is NaN, and a retired slot may hold NaN K/V (or an inf scale)
    any_query = mask.any(dim=2)                              # [B, 1, S]
    if v_scale is not None:
        vs = v_scale.transpose(1, 2)[:, :, None, None, :]
        probs = probs * torch.where(any_query[:, :, None, None, :], vs,
                                    torch.zeros((), dtype=vs.dtype,
                                                device=vs.device))
    vq = torch.where(any_query[..., None], v.to(q.dtype),
                     torch.zeros((), dtype=q.dtype, device=v.device))
    out = torch.einsum("bhgts,bhsd->bhgtd", probs.to(q.dtype).to(f32),
                       vq.to(f32))
    out = out.reshape(B, Hq, T, v.shape[-1]).permute(0, 2, 1, 3)
    return out.to(q.dtype)
