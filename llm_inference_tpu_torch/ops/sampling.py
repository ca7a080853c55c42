"""Token sampling: greedy, temperature, top-k, top-p, min-p, with static
knobs (`sample`) or per-row knob tensors (`sample_per_row`), the serving
API's penalties (`apply_penalties`) and logit bias (`bias_row`), and
logprobs (counterpart of `llm_inference_tpu/ops/sampling.py:26-206` and
of the logit-bias row at `engine/engine.py:222-240`).

`sample` draws from an explicit `torch.Generator`. The schedulers draw
with `sample_per_row` over Gumbel noise from `row_noise`, an integer hash
of (request seed, absolute position, vocab index): a row's draw depends on
nothing else, not on its batch-mates and not on a generator's state, so a
preempted request replays the same tokens, on the CPU as on the card.
Neither reproduces JAX's threefry draws, so the port is held to the JAX
package's filtered distributions and greedy tokens, not to its sampled
ids.
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


def apply_penalties(logits: torch.Tensor, out_counts: torch.Tensor,
                    seen_mask: torch.Tensor, repetition: torch.Tensor,
                    presence: torch.Tensor,
                    frequency: torch.Tensor) -> torch.Tensor:
    """The serving API's penalties on logits [B, V] (float32 out):
    out_counts [B, V] int — output token counts; seen_mask [B, V] bool —
    prompt ∪ output tokens; repetition/presence/frequency [B] float32 (1,
    0, 0 switch them off). The CTRL-style repetition penalty divides a
    positive and multiplies a negative logit of every seen token;
    presence (once) and frequency (per count) subtract from output tokens
    only."""
    logits = logits.to(torch.float32)
    rep = repetition.to(torch.float32)[:, None]
    pen = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen_mask & (rep != 1.0), pen, logits)
    logits = logits - presence.to(torch.float32)[:, None] * (out_counts > 0)
    return logits - frequency.to(torch.float32)[:, None] * out_counts


def bias_row(logit_bias, vocab: int, device=None) -> torch.Tensor:
    """{token_id: bias} → a [vocab] float32 row; ids outside [0, vocab)
    raise ValueError."""
    row = torch.zeros((vocab,), dtype=torch.float32)
    for t, b in (logit_bias or {}).items():
        t = int(t)
        if not 0 <= t < vocab:
            raise ValueError(f"logit_bias token id {t} out of range "
                             f"[0, {vocab})")
        row[t] = float(b)
    return row.to(device)


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
    """log P(token) under softmax(logits): [..., V], [...] → [...]
    float32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, -1, token[..., None].long())[..., 0]


def top_logprobs(logits: torch.Tensor, n: int):
    """The n most likely tokens under softmax(logits): [B, V] →
    (logprobs [B, n] float32, ids [B, n] int32)."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    vals, ids = torch.topk(lp, n, dim=-1)
    return vals, ids.to(torch.int32)


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """An integer hash of int64 values in [0, 2^32) onto the same range.
    The multiplier is below 2^27, so no product leaves int64."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def row_noise(seeds: torch.Tensor, positions: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """Gumbel noise [B, vocab] float32 for row b's draw at absolute
    position positions[b] under seeds[b] (the port's `row_keys`): a hash
    of (seed, position, vocab index) in int64 ops, so the same on every
    device and independent of batch-mates."""
    dev = seeds.device
    key = _mix32(_mix32(seeds.to(torch.int64) & _M32)
                 ^ (positions.to(torch.int64) & _M32))
    v = torch.arange(vocab, dtype=torch.int64, device=dev)
    h = _mix32((key[:, None] + v[None, :] * 0x9E3779B9) & _M32)
    # 24 bits → u in (0, 1), exact in float32
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def filter_per_row(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor,
                   max_top_k: int = 64, use_top_p: bool = True,
                   min_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The float32 logits a sampled row draws from, with per-row knob
    tensors [B] (sampling.py:146-170): temperature (rows at <= 0 scale by
    1), then min-p (rows at 0 skip), top-k clamped to max_top_k (rows at 0
    skip; max_top_k == 0 skips the stage), top-p (rows at 1 skip;
    use_top_p=False skips the stage). Filtered tokens are NEG_INF."""
    logits = logits.to(torch.float32)
    neg = torch.full_like(logits, NEG_INF)
    t = torch.where(temperature <= 0.0, torch.ones_like(temperature),
                    temperature).to(torch.float32)[:, None]
    scaled = logits / t
    if min_p is not None:
        thresh = (scaled.amax(dim=-1, keepdim=True)
                  + torch.log(torch.clamp(min_p.to(torch.float32),
                                          min=1e-10))[:, None])
        scaled = torch.where((min_p > 0.0)[:, None] & (scaled < thresh), neg,
                             scaled)
    if max_top_k > 0:
        vals = torch.topk(scaled, min(max_top_k, scaled.shape[-1]),
                          dim=-1).values
        k_eff = torch.clamp(top_k.long(), 1, vals.shape[-1]) - 1
        kth = torch.gather(vals, -1, k_eff[:, None])
        scaled = torch.where((top_k > 0)[:, None] & (scaled < kth), neg,
                             scaled)
    if use_top_p:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p.to(torch.float32)[:, None]
        num_keep = torch.clamp(keep.sum(dim=-1, keepdim=True), min=1)
        threshold = torch.gather(sorted_logits, -1, num_keep - 1)
        scaled = torch.where((top_p < 1.0)[:, None] & (scaled < threshold),
                             neg, scaled)
    return scaled


def sample_per_row(logits: torch.Tensor, noise: torch.Tensor,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor, greedy: torch.Tensor,
                   max_top_k: int = 64, use_top_p: bool = True,
                   min_p: Optional[torch.Tensor] = None,
                   penalties: Optional[tuple] = None,
                   bias: Optional[torch.Tensor] = None,
                   allowed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token ids [B] int32 with per-row knobs (sampling.py:107-181).
    The logits are shaped first, in the JAX order: `bias` [B, V] (the
    logit bias) is added, tokens outside `allowed` [B, V] bool (a guided
    decoding mask) drop to NEG_INF, and `penalties` (counts, seen, rep,
    pres, freq: apply_penalties' arguments) apply. Then a greedy row
    (greedy, or temperature <= 0) takes the argmax of the shaped unscaled
    logits; any other row the Gumbel-max draw argmax(filter_per_row(...)
    + noise), `noise` [B, V] from row_noise. Callers report logprobs on
    the raw logits."""
    logits = logits.to(torch.float32)
    if bias is not None:
        logits = logits + bias
    if allowed is not None:
        logits = torch.where(allowed, logits,
                             torch.full_like(logits, NEG_INF))
    if penalties is not None:
        logits = apply_penalties(logits, *penalties)
    arg = torch.argmax(logits, dim=-1)
    scaled = filter_per_row(logits, temperature, top_k, top_p, max_top_k,
                            use_top_p, min_p)
    drawn = torch.argmax(scaled + noise, dim=-1)
    return torch.where(greedy | (temperature <= 0.0), arg, drawn).to(
        torch.int32)
