"""Token embedding lookup (counterpart of
`llm_inference_tpu/ops/embedding.py`)."""

from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of `table` [V, H] at `ids` [...] → [..., H] in table.dtype."""
    return table[ids.long()]
