"""Greedy speculative decoding (counterpart of
`llm_inference_tpu/engine/speculative.py`): proposals from the sequence's
own history (n-gram lookup) or from a draft model, verified by ONE forward
of the target over a window of γ + 1 positions.

- `propose_ngram`: the most recent earlier occurrence of the last n tokens
  (n from `ngram` down to `min_ngram`), and up to γ tokens that followed.
- `SpeculativeDecoder` (B = 1, n-gram) and `DraftModelSpeculativeDecoder`
  (a draft engine decodes γ greedy tokens, the target verifies them).
- `SpeculativeBatchingScheduler` (per-slot n-gram speculation inside
  continuous batching) and `DraftSpeculativeBatchingScheduler` (a draft
  model's batched cache beside the target's slots).

Acceptance is exact for greedy decoding: a proposed token is accepted iff
it equals the verify forward's argmax at the position before it, and the
first mismatch contributes that argmax as a bonus token. The verify runs
the attention of a T = γ + 1 window (the plain masked `attend`: the flash
kernel needs T >= 8) where a plain decode step runs the T = 1 decode
kernel; where two candidates nearly tie, the two routes' roundings may
pick differently, and both streams are argmax-consistent continuations of
their own numbers.

No cache rollback: the verify writes K/V for all γ + 1 positions, the
rejected ones included, and the next window overwrites those rows before
any query reads them, because every attention route masks the slots
above the query's position (the int8 and int4 scales are rewritten with
their codes). A window that crossed the cache end would have its write
shifted back (the dense writes clamp their start to S - T) over committed
rows, so `generate` refuses a request whose window could reach it, and the
schedulers decode rows near the end with a plain chunk instead.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from llm_inference_tpu_torch.config import GenerationConfig
from llm_inference_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler)
from llm_inference_tpu_torch.ops import sampling

_GREEDY = GenerationConfig(greedy=True)          # a draft model's proposals


def propose_ngram(ids: Sequence[int], gamma: int, ngram: int = 3,
                  min_ngram: int = 1) -> List[int]:
    """Longest-suffix n-gram lookup: find the most recent earlier occurrence
    of the last n tokens (n from `ngram` down to `min_ngram`) and return up
    to `gamma` tokens that followed it."""
    ids = list(ids)
    L = len(ids)
    for n in range(min(ngram, L - 1), min_ngram - 1, -1):
        tail = ids[L - n:]
        # the most recent match strictly before the suffix itself
        for s in range(L - n - 1, -1, -1):
            if ids[s:s + n] == tail:
                return ids[s + n:s + n + gamma]
    return []


def _refuse_tp(engine, what: str) -> None:
    if getattr(engine, "tp", None) is not None:
        raise NotImplementedError(f"{what} over a tensor-parallel engine is "
                                  f"not ported yet")


def _check_draft(engine, draft_engine) -> None:
    """A draft model must share the target's vocabulary, and its cache
    must cover the target's positions (the draft advances in lockstep)."""
    _refuse_tp(draft_engine, "a draft model")
    if draft_engine.cfg.vocab_size != engine.cfg.vocab_size:
        raise ValueError(f"draft vocab {draft_engine.cfg.vocab_size} != "
                         f"target vocab {engine.cfg.vocab_size}")
    if draft_engine.engine_cfg.max_seq_len < engine.engine_cfg.max_seq_len:
        raise ValueError("draft max_seq_len must cover the target's (the "
                         "draft window advances in lockstep)")


def _accept(proposal: Sequence[int], greedy) -> Tuple[int, List[int]]:
    """(accepted count, emitted tokens): the proposal's prefix that equals
    the running argmax `greedy` [>= len + 1], then the bonus argmax."""
    a = 0
    while a < len(proposal) and proposal[a] == int(greedy[a]):
        a += 1
    return a, [int(t) for t in proposal[:a]] + [int(greedy[a])]


class SpeculativeDecoder:
    """Greedy speculative decoding over an InferenceEngine (batch 1)."""

    def __init__(self, engine, gamma: int = 4, ngram: int = 3):
        _refuse_tp(engine, "speculative decoding")
        self.engine = engine
        self.gamma = gamma
        self.ngram = ngram
        self.stats = {"steps": 0, "accepted": 0, "produced": 0}

    # proposal hooks (DraftModelSpeculativeDecoder overrides them)

    def _start(self, prompt: List[int]) -> None:
        """Called once after the target's prefill, before the verify loop."""

    def _propose(self, history: List[int], cur: int, pos: int) -> List[int]:
        return propose_ngram(history, self.gamma, self.ngram)

    def _window(self, cache, tokens: List[int], pos0: int):
        """One verify forward over a fixed-width γ + 1 window (padded with
        repeats of the last token). Returns (argmax [W] numpy, cache)."""
        W = self.gamma + 1
        dev = self.engine.device
        padded = (tokens + [tokens[-1]] * W)[:W]
        ids = torch.tensor([padded], dtype=torch.int32, device=dev)
        positions = (pos0 + torch.arange(W, dtype=torch.int32,
                                         device=dev))[None]
        logits, cache = self.engine.window_forward(ids, positions, cache)
        return logits[0].argmax(-1).cpu().numpy(), cache

    @torch.no_grad()
    def generate(self, prompt: Sequence[int],
                 gen: Optional[GenerationConfig] = None
                 ) -> Tuple[List[int], dict]:
        """Returns (token_ids, stats). Greedy only: acceptance is exact for
        the argmax (sampled acceptance would need rejection sampling). The
        output keeps a final stop token, as JAX's does."""
        gen = gen or GenerationConfig(greedy=True)
        if not gen.greedy:
            raise ValueError("speculative decoding here is greedy-only")
        eos = set(gen.eos_token_ids)
        engine = self.engine
        S = engine.engine_cfg.max_seq_len
        need = len(prompt) + gen.max_new_tokens + self.gamma + 1
        if need > S:
            raise ValueError(
                f"prompt + max_new_tokens + speculative window needs {need} "
                f"cache slots but max_seq_len is {S} (the verify window "
                f"writes gamma+1 positions ahead; a clamped write would "
                f"corrupt committed KV)")

        logits, cache = engine.prefill([list(prompt)])
        cur = int(logits[0].argmax())
        out = [cur]
        history = list(prompt) + out
        pos = len(prompt)
        self._start(list(prompt))

        while len(out) < gen.max_new_tokens and cur not in eos:
            proposal = self._propose(history, cur, pos)
            greedy, cache = self._window(cache, [cur] + proposal, pos)
            self.stats["steps"] += 1
            a, emitted = _accept(proposal, greedy)
            self.stats["accepted"] += a
            for t in emitted:
                out.append(t)
                history.append(t)
                if t in eos or len(out) >= gen.max_new_tokens:
                    break
            cur = out[-1]
            pos += len(emitted)
        self.stats["produced"] += len(out)
        return out, dict(self.stats)


class DraftModelSpeculativeDecoder(SpeculativeDecoder):
    """Two-model speculative decoding: a DRAFT engine decodes γ greedy
    tokens (one call of its decode loop), the TARGET verifies all γ + 1
    positions in one forward. Expected tokens a verify step: 1 + γ x the
    draft's agreement rate. The draft's rejected KV rows lie beyond the
    committed position and are rewritten before any read (module
    docstring). The draft must share the target's vocabulary, and its
    max_seq_len must cover the target's. `stats["backfills"]` counts the
    single draft steps that fill a position the draft skipped."""

    def __init__(self, engine, draft_engine, gamma: int = 4):
        super().__init__(engine, gamma)
        _check_draft(engine, draft_engine)
        self.draft = draft_engine
        self.stats["backfills"] = 0
        self._dcache = None
        self._dnext = 0                     # next unwritten draft position

    def _start(self, prompt: List[int]) -> None:
        _, self._dcache = self.draft.prefill([prompt])
        self._dnext = len(prompt)

    def _one(self, tok: int, pos: int, steps: int):
        dev = self.draft.device
        toks, _, self._dcache, _, _ = self.draft._decode_chunk_fn(
            self._dcache, torch.tensor([tok], dtype=torch.int32, device=dev),
            torch.tensor([pos], dtype=torch.int32, device=dev), steps=steps,
            gen=_GREEDY, logprobs=False)
        return toks

    def _propose(self, history: List[int], cur: int, pos: int) -> List[int]:
        # backfill: after a whole window was accepted, the bonus token moved
        # `pos` one past the draft's last written position; feed the skipped
        # history token first, or the draft would attend a stale row there
        while self._dnext < pos:
            self._one(history[self._dnext], self._dnext, 1)
            self.stats["backfills"] += 1
            self._dnext += 1
        toks = self._one(cur, pos, self.gamma)
        self._dnext = pos + self.gamma
        return toks[0].tolist()


class SpeculativeBatchingScheduler(ContinuousBatchingScheduler):
    """Continuous batching with per-slot n-gram speculation (greedy only).

    One batched verify forward of width γ + 1 replaces each decode step:
    every live slot proposes up to γ tokens from its own history; a slot
    with no match makes a plain one-token step inside the same forward.
    When a live row is too close to the cache end for a window (pos + γ +
    1 > S), that dispatch is a plain decode chunk. Requests that ask for
    sampling, penalties, logit_bias, guided decoding, an adapter or
    top_logprobs are refused at submit (the plain scheduler serves them).
    `spec_stats`: verify steps, accepted proposals, tokens produced by the
    verify steps, and the plain-chunk fallbacks."""

    # the proposals read req.output_ids on the host at dispatch: an
    # admission's first token must be read before it
    defer_admit_fetch = False

    def __init__(self, engine, gen=None, slots=None, gamma: int = 4,
                 ngram: int = 3):
        super().__init__(engine, gen, slots)
        # the accept loop reads every verify's tokens: no harvest pipelining,
        # and the plain-chunk fallback completes synchronously too
        self.pipeline_harvest = False
        self.gamma = gamma
        self.ngram = ngram
        self.spec_stats = {"steps": 0, "accepted": 0, "produced": 0,
                           "fallbacks": 0}

    def _propose_all(self, live, tok_np, pos_np) -> dict:
        """Proposal hook: slot → up to γ proposed token ids. Here: n-gram
        lookup over each request's own history."""
        props = {}
        for b in live:
            req = self.slot_req[b]
            hist = list(req.prompt_ids) + req.output_ids
            props[b] = propose_ngram(hist, self.gamma, self.ngram)
        return props

    def _resolve_sampling(self, req):
        if req.adapter is not None:
            raise ValueError("speculative scheduler does not support "
                             "adapters (use the plain scheduler)")
        out = super()._resolve_sampling(req)
        _, _, _, gr, _, rep, pres, freq = out
        if not gr or rep != 1.0 or pres != 0.0 or freq != 0.0:
            raise ValueError(
                "speculative scheduler serves greedy requests only "
                "(acceptance is argmax-exact)")
        if (self._logit_bias(req) or req.top_logprobs
                or req.guided_choice is not None
                or req.guided_regex is not None
                or req.guided_json is not None):
            raise ValueError(
                "speculative scheduler does not support logit_bias/"
                "guided/adapter/top_logprobs (use the plain scheduler)")
        return out

    def _verify(self, ids, posm):
        """The batched verify: (argmax [B, W], its logprobs [B, W]) on the
        host, the cache written in place."""
        dev = self.device
        logits, self.cache = self.engine.window_forward(
            torch.from_numpy(ids).to(dev), torch.from_numpy(posm).to(dev),
            self.cache)
        g = logits.argmax(-1)
        glp = sampling.chosen_logprob(logits, g)
        self.phase_n["syncs"] += 1
        return g.cpu().numpy(), glp.cpu().numpy()

    def _dispatch_decode(self, steps: int) -> None:
        t0 = time.perf_counter()
        live = [b for b, r in enumerate(self.slot_req) if r is not None]
        # one read of the slots' last tokens and positions
        self.phase_n["syncs"] += 1
        tok_np, pos_np = torch.stack((self.token, self.pos)).cpu().numpy()
        W = self.gamma + 1
        if any(int(pos_np[b]) + W > self.S for b in live):
            # too close to the cache end for a window (a clamped write
            # would overwrite committed KV): a plain chunk
            self.spec_stats["fallbacks"] += 1
            super()._dispatch_decode(steps)
            return
        ids = np.zeros((self.B, W), np.int32)
        posm = np.tile(np.arange(W, dtype=np.int32), (self.B, 1))
        props = self._propose_all(live, tok_np, pos_np)
        for b in live:
            cur = int(tok_np[b])
            ids[b] = ([cur] + props[b] + [cur] * W)[:W]
            posm[b] += int(pos_np[b])
        g, glp = self._verify(ids, posm)
        self.spec_stats["steps"] += 1
        now = time.perf_counter()
        new_tok, new_pos = tok_np.copy(), pos_np.copy()
        for b in live:
            req = self.slot_req[b]
            a, emitted = _accept(props[b], g[b])
            self.spec_stats["accepted"] += a
            stops = self._stops(req)
            kept = 0
            for j, t in enumerate(emitted):
                if req.cancelled:
                    break
                req.output_ids.append(t)
                req.output_logprobs.append(float(glp[b, j]))
                kept += 1
                if t in stops:
                    req.finished = True
                else:
                    self._check_stop_strings(req, t)
                if (req.finished
                        or len(req.output_ids) >= req.max_new_tokens):
                    break
            self.spec_stats["produced"] += kept
            self._emit(req)
            if (req.cancelled or req.finished
                    or len(req.output_ids) >= req.max_new_tokens):
                req.done_t = now
                self.slot_req[b] = None
                self.dstate_host[b] = -1
                self._on_retire(b)
            else:
                new_tok[b] = req.output_ids[-1]
                new_pos[b] = int(pos_np[b]) + kept
        self.token = torch.from_numpy(new_tok).to(self.device)
        self.pos = torch.from_numpy(new_pos).to(self.device)
        self.phase_s["dispatch"] += time.perf_counter() - t0


class DraftSpeculativeBatchingScheduler(SpeculativeBatchingScheduler):
    """Two-model speculative decoding inside continuous batching: a DRAFT
    model keeps its own batched KV cache aligned with the target's slots.
    Each step it (a) catches its cache up with whatever the target
    committed since (forwards of γ + 1 positions without logits, plain
    fallback chunks included), then (b) runs a batched γ-step greedy decode
    to propose, and the target verifies every row in the base class's
    window forward. The emitted streams equal the plain scheduler's
    whatever the draft's quality (greedy acceptance is exact)."""

    # the draft prefill of each admission has no batched counterpart
    wave_admission = False

    def __init__(self, engine, draft_engine, gen=None, slots=None,
                 gamma: int = 4):
        _check_draft(engine, draft_engine)
        super().__init__(engine, gen, slots, gamma=gamma)
        self.draft = draft_engine
        self._dcache = draft_engine.new_cache(self.B)
        self._dnext = np.zeros((self.B,), np.int64)  # next unwritten pos
        self.catchups = 0                  # catch-up forwards of the draft

    def _admit_one(self, slot, req) -> bool:
        ok = super()._admit_one(slot, req)
        if ok and self.slot_req[slot] is req:
            # the draft's prefill of the prompt into this slot's draft row
            plen = len(req.prompt_ids)
            small = self.draft.new_cache(
                1, max_seq=self.draft.prefill_cache_len(plen))
            _, one = self.draft.prefill([list(req.prompt_ids)], cache=small)
            self._insert(one, None, plen, slot, 0, cache=self._dcache)
            self._dnext[slot] = plen
        return ok

    def _propose_all(self, live, tok_np, pos_np) -> dict:
        C = self.gamma + 1
        dev = self.device
        # (a) catch up: write the committed history the draft has not seen,
        # C tokens a round (a fallback chunk can leave it further behind).
        # A row without lag writes padding from its position on, which the
        # proposals below overwrite before reading; a row at pos writes
        # below pos + C <= S, so no write is shifted by the cache end.
        while True:
            lag = [b for b in live if self._dnext[b] < int(pos_np[b])]
            if not lag:
                break
            ids = np.zeros((self.B, C), np.int32)
            posm = np.tile(np.arange(C, dtype=np.int32), (self.B, 1))
            for b in live:
                req = self.slot_req[b]
                o = min(int(self._dnext[b]), int(pos_np[b]))
                hist = list(req.prompt_ids) + req.output_ids
                w = hist[o:min(o + C, int(pos_np[b]))]
                ids[b, :len(w)] = w
                posm[b] += o
                if w:
                    self._dnext[b] = o + len(w)
            _, self._dcache = self.draft.window_forward(
                torch.from_numpy(ids).to(dev),
                torch.from_numpy(posm).to(dev), self._dcache,
                logits_mode="none")
            self.catchups += 1
        # (b) the batched proposals: γ greedy steps fed the target's pending
        # token (its KV at pos, proposals for pos + 1 .. pos + γ)
        toks, _, self._dcache, _, _ = self.draft._decode_chunk_fn(
            self._dcache, torch.from_numpy(tok_np).to(dev),
            torch.from_numpy(pos_np).to(dev), steps=self.gamma, gen=_GREEDY,
            logprobs=False)
        toks = toks.cpu().numpy()                    # [B, γ]
        for b in live:
            self._dnext[b] = int(pos_np[b]) + self.gamma
        return {b: [int(t) for t in toks[b]] for b in live}
