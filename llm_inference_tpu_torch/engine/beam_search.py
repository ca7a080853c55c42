"""Beam-search decoding (counterpart of
`llm_inference_tpu/engine/beam_search.py`).

- The W beams ride the batch axis of the decode forward: one step runs
  the forward for all W beams at once, takes the top W of the flattened
  [W·V] cumulative log-probs on the device, and reorders the KV cache rows
  by parent beam (`engine.reorder_cache`: codes and scales, gathered into
  new tensors, so repeated parents are safe).
- The top W break ties by the lower flat index, as `jax.lax.top_k` does
  (a stable descending sort; `torch.topk` promises no order among equal
  values).
- Finished beams (EOS) are frozen: their score stops accumulating and
  they keep competing with one candidate at that score; the host keeps
  the sequences.
- The reorder is a copy of the whole cache every step (W rows of every
  layer), inherent to beam search over a contiguous cache.

Scoring: the sum of token log-probs, with optional GNMT length
normalisation score / ((5 + len) / 6)^alpha at the end.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from llm_inference_tpu_torch.engine.engine import (expand_cache,
                                                   reorder_cache)

_NEG = -1e30


@dataclasses.dataclass
class BeamHypothesis:
    token_ids: List[int]          # generated tokens (EOS excluded)
    score: float                  # length-normalised cumulative log-prob
    log_prob: float               # raw cumulative log-prob
    finished: bool                # ended with EOS


def _top(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, ties to
    the lower index (jax.lax.top_k's order)."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


class BeamSearchDecoder:
    """Deterministic beam search over an InferenceEngine, one prompt at a
    time (the W beams occupy the batch axis)."""

    def __init__(self, engine, beam_width: int = 4,
                 length_penalty: float = 0.0,
                 eos_token_ids: Optional[Sequence[int]] = None):
        if beam_width < 1:
            raise ValueError("beam_width must be >= 1")
        if getattr(engine, "tp", None) is not None:
            raise NotImplementedError("beam search over a tensor-parallel "
                                      "engine is not ported yet")
        self.engine = engine
        self.W = beam_width
        self.length_penalty = length_penalty
        self.eos = tuple(eos_token_ids if eos_token_ids is not None
                         else (2,))

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _step(self, cache, tokens, pos, scores, finished):
        """One device step for all W beams. tokens/pos/scores/finished: [W]
        (pos all equal). Returns (the reordered cache, the chosen tokens,
        their scores, the new finished flags, the parent beams, whether
        each parent was already finished)."""
        W = tokens.shape[0]
        dev = tokens.device
        logits, cache = self.engine._forward(
            tokens[:, None], pos[:, None], cache,
            torch.zeros((W,), dtype=torch.long, device=dev))
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        cand = scores[:, None] + logp                       # [W, V]
        # a frozen beam offers exactly ONE candidate (column 0, at its
        # frozen score): it keeps competing without fanning out
        cand = torch.where(finished[:, None],
                           torch.full_like(cand, _NEG), cand)
        cand[:, 0] = torch.where(finished, scores, cand[:, 0])
        top_scores, top_idx = _top(cand.reshape(-1), W)
        parents = top_idx // V
        toks = (top_idx % V).to(torch.int32)
        was_finished = finished[parents]
        eos = torch.tensor(self.eos, dtype=torch.int32, device=dev)
        new_finished = was_finished | (toks[:, None] == eos[None]).any(-1)
        # a child inherits its parent's rows, the row this forward wrote for
        # the parent's input token included
        cache = reorder_cache(cache, parents)
        return (cache, toks, top_scores, new_finished, parents,
                was_finished)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def search(self, prompt: Sequence[int],
               max_new_tokens: int = 32) -> List[BeamHypothesis]:
        """Run beam search; returns the hypotheses sorted best-first."""
        engine, W = self.engine, self.W
        prompt = engine._encode_prompts([prompt])[0]
        need = len(prompt) + max_new_tokens
        if need > engine.engine_cfg.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens needs {need} cache slots but "
                f"max_seq_len is {engine.engine_cfg.max_seq_len}")

        logits, cache1 = engine.prefill([list(prompt)])
        cache = expand_cache(cache1, W)
        del cache1
        logp0 = torch.log_softmax(logits[0].float(), dim=-1)   # [V]
        scores, first = _top(logp0, W)                       # seed beams
        tokens = first.to(torch.int32)
        eos_set = set(self.eos)
        first_np = tokens.tolist()
        finished = torch.tensor([t in eos_set for t in first_np],
                                device=tokens.device)
        pos = torch.full((W,), len(prompt), dtype=torch.int32,
                         device=tokens.device)

        # the host's sequences per beam (reordered with the device rows)
        seqs: List[List[int]] = [[t] for t in first_np]
        done: List[bool] = [t in eos_set for t in first_np]

        for _ in range(max_new_tokens - 1):
            if all(done):
                break
            (cache, tokens, scores, finished, parents,
             was_finished) = self._step(cache, tokens, pos, scores, finished)
            pos = pos + 1
            # one read: tokens, parents and the frozen flags
            t_np, p_np, wf_np = torch.stack(
                (tokens, parents.to(torch.int32),
                 was_finished.to(torch.int32))).tolist()
            seqs = [list(seqs[p]) for p in p_np]
            done = [bool(wf_np[i]) for i in range(W)]
            for i in range(W):
                if not wf_np[i]:                 # frozen beams emit nothing
                    seqs[i].append(t_np[i])
                    done[i] = t_np[i] in eos_set

        s_np = scores.double().tolist()
        hyps = []
        for i in range(W):
            toks = seqs[i]
            fin = bool(done[i])
            if fin and toks and toks[-1] in eos_set:
                toks = toks[:-1]
            lp = float(s_np[i])
            denom = (((5.0 + len(toks) + 1) / 6.0) ** self.length_penalty
                     if self.length_penalty > 0 else 1.0)
            hyps.append(BeamHypothesis(token_ids=toks, score=lp / denom,
                                       log_prob=lp, finished=fin))
        hyps.sort(key=lambda h: h.score, reverse=True)
        return hyps


def beam_search(engine, prompt, beam_width: int = 4,
                max_new_tokens: int = 32,
                eos_token_ids: Optional[Sequence[int]] = None,
                length_penalty: float = 0.0) -> List[BeamHypothesis]:
    """One-shot wrapper around BeamSearchDecoder."""
    dec = BeamSearchDecoder(engine, beam_width, length_penalty,
                            eos_token_ids)
    return dec.search(prompt, max_new_tokens)
