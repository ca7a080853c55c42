"""Rotary position embeddings, HF LLaMA pairing (x[i] pairs x[i + d/2]).

Counterpart of `llm_inference_tpu/ops/rope.py`: the same table builder
(linear, ntk, llama3, yarn and longrope scaling) and the split-form
rotation, all in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def make_rope_table(max_positions: int, head_dim: int,
                    theta: float = 10000.0, scaling: Optional[dict] = None,
                    dtype=torch.float32, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [max_positions, head_dim], each frequency
    duplicated across both halves."""
    f32 = dict(dtype=torch.float32, device=device)
    stype = None
    if scaling:
        stype = scaling.get("type") or scaling.get("rope_type")
    if scaling and stype == "ntk":
        factor = float(scaling["factor"])
        theta = theta * factor ** (head_dim / (head_dim - 2))
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, **f32)
                                / head_dim))
    if scaling and stype in ("llama3", "llama3.1"):
        factor = float(scaling["factor"])
        lo = float(scaling.get("low_freq_factor", 1.0))
        hi = float(scaling.get("high_freq_factor", 4.0))
        orig = float(scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / inv_freq
        scaled = torch.where(wavelen > orig / lo, inv_freq / factor, inv_freq)
        smooth = (orig / wavelen - lo) / (hi - lo)
        blended = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        medium = (wavelen >= orig / hi) & (wavelen <= orig / lo)
        inv_freq = torch.where(medium, blended, scaled)
    mscale = 1.0
    if scaling and stype == "yarn":
        factor = float(scaling["factor"])
        orig = float(scaling.get("original_max_position_embeddings")
                     or max_positions)
        beta_fast = float(scaling.get("beta_fast", 32.0))
        beta_slow = float(scaling.get("beta_slow", 1.0))
        dim = head_dim

        def corr_dim(n_rot):
            return (dim * math.log(orig / (n_rot * 2 * math.pi))
                    / (2 * math.log(theta)))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
        ramp = torch.clamp((torch.arange(dim // 2, **f32) - low)
                           / max(high - low, 1e-3), 0.0, 1.0)
        extrap = 1.0 - ramp
        inv_freq = (inv_freq / factor) * (1.0 - extrap) + inv_freq * extrap

        def _ms(scale, m=1.0):
            return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0

        af = scaling.get("attention_factor")
        ms, msad = scaling.get("mscale"), scaling.get("mscale_all_dim")
        if af is not None:
            mscale = float(af)
        elif ms and msad:
            mscale = _ms(factor, float(ms)) / _ms(factor, float(msad))
        else:
            mscale = _ms(factor)
    if scaling and stype == "longrope":
        orig = float(scaling.get("original_max_position_embeddings",
                                 max_positions))
        use_long = max_positions > orig
        fac = scaling["long_factor" if use_long else "short_factor"]
        inv_freq = inv_freq / torch.as_tensor(fac, **f32)
        s = max(float(scaling.get("max_position_embeddings",
                                  max_positions)) / orig, 1.0)
        if s > 1.0:
            mscale = math.sqrt(1.0 + math.log(s) / math.log(orig))
    pos = torch.arange(max_positions, **f32)
    if scaling and stype == "linear":
        pos = pos / float(scaling["factor"])
    freqs = torch.outer(pos, inv_freq)                       # [P, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)                  # [P, d]
    return ((torch.cos(emb) * mscale).to(dtype),
            (torch.sin(emb) * mscale).to(dtype))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cos_table: torch.Tensor, sin_table: torch.Tensor
               ) -> torch.Tensor:
    """x [B, T, H, D] rotated at positions [B, T]; same shape and dtype."""
    idx = positions.long()
    return apply_rope_gathered(x, cos_table[idx], sin_table[idx])


def apply_rope_gathered(x: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor) -> torch.Tensor:
    """apply_rope with cos/sin already gathered: [B, T, D]."""
    half = x.shape[-1] // 2
    x32 = x.to(torch.float32)
    c1 = cos[:, :, None, :half]
    c2 = cos[:, :, None, half:]
    s1 = sin[:, :, None, :half]
    s2 = sin[:, :, None, half:]
    x1 = x32[..., :half]
    x2 = x32[..., half:]
    out = torch.cat([x1 * c1 - x2 * s1, x2 * c2 + x1 * s2], dim=-1)
    return out.to(x.dtype)
