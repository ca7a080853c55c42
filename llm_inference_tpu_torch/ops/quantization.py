"""Weight-only quantization: INT8, symmetric, per-channel.

Counterpart of `llm_inference_tpu/ops/quantization.py` (QTensor :27,
quantize :117, dequantize :314, qmatmul_ref :328). Codes and scales are
bit-identical to the JAX package for the same float32 weights: both divide
in float32 and round half to even.

A weight is [in_features K, out_features N] (activations right-multiply),
but its codes are stored transposed, [..., N, K]: one K-contiguous row per
output column, the layout in which the CUDA GEMV (ops/kernels/
quant_matmul.py) streams a column with 16-byte loads. (The JAX package's
column-blocked [N/bn, K, bn] layout exists for the TPU's DMA engine and is
not copied.) Scales are float32 [..., 1, N]. int4, grouped and asymmetric
weights raise NotImplementedError until they are ported.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QTensor:
    """Quantized weight, optionally stacked over a leading layer axis."""
    q: torch.Tensor                  # int8 [..., N, K], K contiguous
    scale: torch.Tensor              # float32 [..., 1, N]

    @property
    def in_features(self) -> int:
        return self.q.shape[-1]

    @property
    def out_features(self) -> int:
        return self.q.shape[-2]

    @property
    def shape(self):
        return (self.in_features, self.out_features)

    @property
    def stacked(self) -> bool:
        return self.q.dim() == 3

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, q=self.q.to(device),
                                   scale=self.scale.to(device))

    def layer(self, idx: int) -> "QTensor":
        """One layer of a stacked QTensor (views, no copy)."""
        return dataclasses.replace(self, q=self.q[idx], scale=self.scale[idx])


def _unsupported(bits: int, group_size: int, asymmetric: bool) -> None:
    if bits != 8 or group_size > 0 or asymmetric:
        raise NotImplementedError(
            f"bits={bits} group_size={group_size} asymmetric={asymmetric}: "
            "only int8 symmetric per-channel weights are ported")


def quantize(w: torch.Tensor, bits: int = 8, group_size: int = 0,
             asymmetric: bool = False) -> QTensor:
    """Symmetric per-channel quantization of a [K, N] weight:
    scale = max(max|w| / 127, 1e-8) per column, q = round(w / scale)."""
    if w.dim() != 2:
        raise ValueError(f"expected a 2-D weight, got {tuple(w.shape)}")
    # a group as wide as K is one group per column: per-channel
    _unsupported(bits, group_size if group_size < w.shape[0] else 0,
                 asymmetric)
    qmax = 127.0
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=0, keepdim=True)                 # [1, N]
    scale = torch.clamp(absmax / qmax, min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -qmax - 1, qmax)
    return QTensor(q=q.to(torch.int8).T.contiguous(), scale=scale)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Dense [..., K, N] weight: code · scale."""
    w = qt.q.to(torch.float32) * qt.scale.transpose(-1, -2)     # [..., N, K]
    return w.transpose(-1, -2).to(dtype)


def qmatmul_ref(x: torch.Tensor, qt: QTensor, dtype=None) -> torch.Tensor:
    """x [..., K] @ dequant(W) for one (unstacked) weight: the dot runs on
    bf16 x against the raw codes with float32 accumulation, and the
    per-column scale hits the output."""
    dtype = dtype or x.dtype
    y = x.to(torch.bfloat16).to(torch.float32) @ qt.q.to(torch.float32).T
    return (y * qt.scale[0]).to(dtype)
