"""Token sampling: greedy, temperature, top-k, top-p, min-p (counterpart
of `llm_inference_tpu/ops/sampling.py:26-52, 91, 184-206`).

Randomness comes from an explicit `torch.Generator`. It cannot reproduce
JAX's threefry draws, so the port is held to the JAX package's filtered
distributions and greedy tokens, not to its sampled ids. Penalties and
logit_bias wait for a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask logits outside the top-k to NEG_INF."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted
    probabilities whose mass reaches p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    num_keep = keep_sorted.sum(dim=-1, keepdim=True)
    threshold = torch.gather(sorted_logits, -1, num_keep - 1)
    return torch.where(logits < threshold, torch.full_like(logits, NEG_INF),
                       logits)


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """Drop tokens whose probability is below min_p · P(argmax)."""
    thresh = logits.amax(dim=-1, keepdim=True) + torch.log(
        torch.tensor(min_p, dtype=logits.dtype, device=logits.device))
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                       logits)


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  min_p: float = 0.0) -> torch.Tensor:
    """The float32 logits `sample` draws from (temperature, then min-p,
    top-k and top-p, in the JAX package's order)."""
    logits = logits.to(torch.float32)
    if temperature != 1.0:
        logits = logits / temperature
    if min_p > 0.0:
        logits = apply_min_p(logits, min_p)
    if top_k > 0:
        logits = apply_top_k(logits, top_k)
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    return logits


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
           greedy: bool = False, min_p: float = 0.0) -> torch.Tensor:
    """Next-token ids [B] int32 from logits [B, V]."""
    if greedy or temperature == 0.0:
        return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p,
                                        min_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def chosen_logprob(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """log P(token) under softmax(logits): [B, V], [B] → [B] float32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, -1, token[:, None].long())[:, 0]
