"""K2: single-token GQA attention over the stacked dense cache
(counterpart of `llm_inference_tpu/ops/pallas/decode_attention.py`).

CUDA tensors go through `csrc/decode_attention.cu`; CPU tensors through
`decode_attention_ref`, its plain PyTorch version.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_MAX_S = 16384
_MAX_G = 8

# kernel launches made by decode_attention (the plain version is not counted)
launches = 0


def supports(q_shape, S: int) -> bool:
    """Whether the kernel handles this case (else ops.attention) — the JAX
    package's gate, decode_attention.py:618-621."""
    B, T, Hq, D = q_shape
    return T == 1 and S <= _MAX_S and D in (64, 128, 256) and S % 128 == 0


def decode_attention_ref(q, k_all, v_all, layer: int, positions,
                         scale: float, logit_softcap: float = 0.0,
                         window: int = 0):
    """Plain version: bf16 q, K and V, float32 softmax, p rounded to bf16
    before the P.V product, bf16 output [B, Hkv, G, D]. Slots outside
    (pos - window, pos] are masked and their V zeroed (a kernel never
    reads them, so NaN there must not leak)."""
    B, _, Hq, D = q.shape
    Hkv, S = k_all.shape[2], k_all.shape[3]
    G = Hq // Hkv
    f32, bf16 = torch.float32, torch.bfloat16
    qg = q.reshape(B, Hkv, G, D).to(bf16).to(f32)
    k = k_all[layer].to(bf16).to(f32)                        # [B, Hkv, S, D]
    v = v_all[layer].to(bf16).to(f32)
    pos = positions.reshape(B, 1).long()
    slot = torch.arange(S, device=q.device)[None, :]
    ok = slot <= pos
    if window > 0:
        ok &= slot > pos - window
    ok = ok[:, None, None, :]                                # [B, 1, 1, S]
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k) * scale
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    v = torch.where(ok[:, :, 0, :, None], v, torch.zeros((), dtype=f32,
                                                         device=v.device))
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(bf16).to(f32), v)
    return (acc / l).to(bf16)


def decode_attention(q, k_all, v_all, layer: int, positions,
                     scale: float | None = None, logit_softcap: float = 0.0,
                     window: int = 0):
    """q [B, 1, Hq, D]; k_all/v_all [L, B, Hkv, S, D] with this step's
    token already written; positions [B] (or [B, 1]) absolute position of
    the token. Returns [B, 1, Hq, D] in q.dtype. Callers check
    `supports` first."""
    B, T, Hq, D = q.shape
    if T != 1:
        raise ValueError("decode attention is single-step")
    L, _, Hkv, S, _ = k_all.shape
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    window = int(window or 0)
    if not k_all.is_cuda:
        out = decode_attention_ref(q, k_all, v_all, layer, positions, scale,
                                   logit_softcap, window)
        return out.reshape(B, 1, Hq, D).to(q.dtype)
    global launches
    from llm_inference_tpu_torch.ops.kernels import _build
    if k_all.dtype != torch.bfloat16 or v_all.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"K2 takes a bf16 cache, got {k_all.dtype}; int8/int4 caches "
            "are not ported yet")
    if not (supports(q.shape, S) and G <= _MAX_G and k_all.is_contiguous()
            and v_all.is_contiguous()):
        raise ValueError(f"K2 does not take q {tuple(q.shape)} over a "
                         f"cache {tuple(k_all.shape)}")
    qg = q.to(torch.bfloat16).reshape(B, Hkv, G, D).contiguous()
    pos = positions.reshape(B).to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, G, D), dtype=torch.bfloat16, device=q.device)
    layer_bytes = B * Hkv * S * D * 2
    code = _build.lib().decode_attn_launch(
        qg.data_ptr(), k_all.data_ptr() + layer * layer_bytes,
        v_all.data_ptr() + layer * layer_bytes, pos.data_ptr(),
        out.data_ptr(), B, Hkv, G, S, D, float(scale), float(logit_softcap),
        window, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "decode_attention")
    launches += 1
    return out.reshape(B, 1, Hq, D).to(q.dtype)
