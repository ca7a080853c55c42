"""Linear / matmul dispatch (counterpart of `llm_inference_tpu/ops/linear.py`).

QTensor weights go through K1 (ops/kernels/quant_matmul.py); dense
weights through a plain float32-accumulated product.
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_inference_tpu_torch.ops import norms
from llm_inference_tpu_torch.ops.kernels import quant_matmul as qm
from llm_inference_tpu_torch.ops.quantization import QTensor


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # products of x.dtype values, summed in float32
    return (x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)).to(x.dtype)


def matmul(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
           layer=None) -> torch.Tensor:
    """y = x @ W (+ bias). A QTensor stacked over layers takes `layer`."""
    if isinstance(w, QTensor):
        y = qm.quant_matmul(x, w, layer=layer)
    else:
        y = _dense(x, w if layer is None or w.dim() == 2 else w[layer])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def norm_matmul(x: torch.Tensor, w, gamma: torch.Tensor, eps: float, *,
                residual: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None, layer=None,
                want_x_out: bool = False):
    """y = rms_norm(x (+ residual), gamma, eps) @ W (+ bias), the norm and
    residual add fused into K1 for QTensor weights. want_x_out also
    returns x + residual (the updated residual stream)."""
    if isinstance(w, QTensor):
        out = qm.quant_matmul(x, w, layer=layer, norm_gamma=gamma,
                              norm_eps=eps, residual=residual,
                              want_x_out=want_x_out)
        y, x_full = out if want_x_out else (out, None)
    else:
        x_full = x
        if residual is not None:
            x_full = (x.to(torch.float32)
                      + residual.to(torch.float32)).to(x.dtype)
        y = matmul(norms.rms_norm(x_full, gamma, eps), w, layer=layer)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return (y, x_full) if want_x_out else y
