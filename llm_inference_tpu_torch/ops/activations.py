"""Gated activations (counterpart of
`llm_inference_tpu/ops/activations.py`)."""

from __future__ import annotations

import torch


def swiglu_split(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) · up, written as the JAX package's jax.nn.silu
    (gate · sigmoid(gate)) so a bf16 model rounds at the same points."""
    return gate * torch.sigmoid(gate) * up
