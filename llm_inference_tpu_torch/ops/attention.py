"""Masked GQA attention in plain PyTorch (counterpart of
`llm_inference_tpu/ops/attention.py`): the prefill path and the numerical
oracle. Keys and values come from the cache [B, Hkv, S, D]; the mask
`slot <= query position` covers causal prefill and decode alike. Softmax
runs in float32."""

from __future__ import annotations

from typing import Optional

import torch

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
    """q [B, T, Hq, D], k/v [B, Hkv, S, D], mask [B, 1, T, S] →
    [B, T, Hq, D] in q.dtype. Products of q.dtype values accumulate in
    float32, as the JAX einsums do with preferred_element_type."""
    if k_scale is not None or v_scale is not None or not (
            k.is_floating_point() and v.is_floating_point()):
        raise NotImplementedError("int8/int4 KV caches are not ported yet")
    B, T, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    f32 = torch.float32
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, T, D).to(f32)
    kf = k.to(q.dtype).to(f32)
    scores = torch.einsum("bhgtd,bhsd->bhgts", qg, kf) * scale
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    scores = torch.where(mask[:, :, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    # zero V on slots no query may attend: their probabilities are 0, but
    # 0 × NaN is NaN, and a retired slot may hold NaN K/V
    attendable = mask.any(dim=2)[:, :, :, None]              # [B, 1, S, 1]
    vq = torch.where(attendable, v.to(q.dtype),
                     torch.zeros((), dtype=q.dtype, device=v.device))
    out = torch.einsum("bhgts,bhsd->bhgtd", probs.to(q.dtype).to(f32),
                       vq.to(f32))
    out = out.reshape(B, Hq, T, v.shape[-1]).permute(0, 2, 1, 3)
    return out.to(q.dtype)
