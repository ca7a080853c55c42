"""RMSNorm (counterpart of `llm_inference_tpu/ops/norms.py`): reduced in
float32, cast back to the input dtype, then multiplied by the weight (HF
LlamaRMSNorm numerics). On the decode path the norm runs inside the K1
prologue (ops/kernels/quant_matmul.py); this one serves the final norm."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed.to(dtype) * weight).to(dtype)
