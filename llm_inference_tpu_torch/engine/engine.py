"""InferenceEngine: bucketed prefill and chunked decode on one model
(counterpart of `llm_inference_tpu/engine/engine.py:40-575, 752-861`).

Decode runs `engine_cfg.decode_chunk` steps on the device between two
host syncs, as the JAX engine's scan does: each step's sampled token stays
on the device and feeds the next step; the host reads the chunk's tokens
once. Prompts longer than the largest prefill bucket run as a sequence of
largest-bucket chunks over one cache. `cache_dtype` is a float dtype (bf16
cache), torch.int8 / "int8" (int8 codes with slot-major float32 scales) or
"int4" (packed int4 codes with the same scales). The continuous-batching
schedulers (engine/scheduler.py) run on top: they call `prefill` and
`paged_forward` for admissions and the decode-chunk programs
(`_decode_chunk_fn`, `_decode_chunk_rows_fn`) over their slots, dense or
paged. There is no LoRA or mesh: `data_parallel` is 1, `has_lora` False.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            ModelConfig)
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache, paged_kvcache, sampling
from llm_inference_tpu_torch.utils.metrics import Metrics


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[int]
    text: str
    ttft_s: float                 # time to first token (prefill + sample)
    decode_tokens_per_s: float
    finished: bool                # hit EOS (vs max_new_tokens)


class InferenceEngine:
    """Single-model serving engine (synchronous API)."""

    def __init__(self, cfg: ModelConfig, params, *,
                 engine_cfg: Optional[EngineConfig] = None,
                 tokenizer=None, cache_dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.engine_cfg = engine_cfg or EngineConfig()
        self.tokenizer = tokenizer
        self.cache_dtype = cache_dtype
        S = self.engine_cfg.max_seq_len
        if S % 128 and S >= 512:
            # the decode and flash kernels need the cache extent to be a
            # multiple of 128 (decode_attention.supports, flash_attention.
            # supports); otherwise attention takes the plain path, which
            # materialises [B, H, T, S] scores (the JAX engine's warning)
            warnings.warn(
                f"max_seq_len={S} is not a multiple of 128: prefill and "
                f"decode attention fall off the kernels to the plain path. "
                f"Round up to {-(-S // 128) * 128}.")
        self.device = resolve_device(device)
        self.params = params
        self.metrics = Metrics()
        self._rope = llama.rope_table(cfg, self.engine_cfg.max_seq_len,
                                      self.device)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def new_cache(self, batch: int, max_seq: Optional[int] = None):
        return kvcache.init_cache(
            self.cfg.num_layers, batch, self.cfg.num_kv_heads,
            max_seq or self.engine_cfg.max_seq_len, self.cfg.head_dim,
            self.cache_dtype, device=self.device)

    def _bucket(self, n: int) -> int:
        for b in self.engine_cfg.prefill_buckets:
            # a bucket wider than the cache would write past max_seq_len
            if n <= b <= self.engine_cfg.max_seq_len:
                return b
        return n

    def prefill_cache_len(self, n: int) -> int:
        """Smallest cache extent that admits an n-token prompt through the
        chunked `prefill` path with every bucket-rounded write window in
        bounds."""
        fitting = [b for b in self.engine_cfg.prefill_buckets
                   if b <= self.engine_cfg.max_seq_len]
        chunk = max(fitting) if fitting else self.engine_cfg.max_seq_len
        if n <= chunk:
            return min(self._bucket(n), self.engine_cfg.max_seq_len)
        last_o = ((n - 1) // chunk) * chunk
        return min(last_o + self._bucket(n - last_o),
                   self.engine_cfg.max_seq_len)

    def _encode_prompts(self, prompts) -> List[List[int]]:
        out = []
        for p in prompts:
            if isinstance(p, str):
                if self.tokenizer is None:
                    raise ValueError("string prompts need a tokenizer")
                out.append(list(self.tokenizer.encode(p)))
            else:
                out.append(list(p))
        return out

    # no mesh and no LoRA stacks in the port (engine.py:129, 435-441)
    data_parallel = 1
    has_lora = False

    def resolve_adapter(self, adapter) -> int:
        """Adapter name/slot → LoRA stack slot: None is the base model
        (0); the port has no adapters, so anything else raises."""
        if adapter is None:
            return 0
        raise NotImplementedError("LoRA adapters are not ported yet")

    def _forward(self, ids, positions, cache, last_idx, paged_history=False):
        """The one forward every path runs: last-token logits [B, V]."""
        return llama.forward(self.cfg, self.params, ids, positions, cache,
                             logits_mode="last", last_idx=last_idx,
                             rope_tables=self._rope,
                             paged_history=paged_history)

    def paged_forward(self, history: bool = False) -> Callable:
        """The forward over a paged cache, f(ids, positions, cache,
        last_idx) → (logits, cache); history=True attends a chunk over the
        sequence's earlier pages (engine.py:160-187)."""
        return lambda ids, positions, cache, last_idx: self._forward(
            ids, positions, cache, last_idx, paged_history=history)

    def _fwd_for(self, cache) -> Callable:
        if isinstance(cache, paged_kvcache.PagedKVCache):
            return self.paged_forward()
        return self._forward

    @torch.no_grad()
    def _decode_chunk_fn(self, cache, token, pos, *, steps: int,
                         gen: GenerationConfig, generator=None):
        """`steps` decode forwards over every row with static sampling
        knobs (engine.py:267-310); each step's token feeds the next on the
        device, with no host sync. token/pos [B]: the last token and its
        position. Returns (tokens [B, steps] int32, their logprobs [B,
        steps] float32, cache, token, pos)."""
        B = token.shape[0]
        zeros = torch.zeros((B,), dtype=torch.long, device=token.device)
        fwd = self._fwd_for(cache)
        toks, lps = [], []
        for _ in range(steps):
            logits, cache = fwd(token[:, None], pos[:, None], cache, zeros)
            token = sampling.sample(logits, generator,
                                    temperature=gen.temperature,
                                    top_k=gen.top_k, top_p=gen.top_p,
                                    greedy=gen.greedy, min_p=gen.min_p)
            toks.append(token)
            lps.append(sampling.chosen_logprob(logits, token))
            pos = pos + 1
        return (torch.stack(toks, 1), torch.stack(lps, 1), cache, token,
                pos)

    @torch.no_grad()
    def _decode_chunk_rows_fn(self, cache, token, pos, temp, topk, topp,
                              greedy, minp, seeds, *, steps: int,
                              max_top_k: int, use_top_p: bool = True,
                              use_min_p: bool = False, top_n: int = 0):
        """As _decode_chunk_fn with per-row knob tensors [B]
        (engine.py:329-405, seeded): row b's draw at position p uses the
        noise of (seeds[b], p) only. With top_n > 0 also returns each
        step's top_n logprobs and ids [B, steps, top_n], else None.
        Returns (tokens, logprobs, cache, token, pos, top values, top
        ids)."""
        B = token.shape[0]
        V = self.cfg.vocab_size
        zeros = torch.zeros((B,), dtype=torch.long, device=token.device)
        fwd = self._fwd_for(cache)
        toks, lps, tvs, tis = [], [], [], []
        for _ in range(steps):
            logits, cache = fwd(token[:, None], pos[:, None], cache, zeros)
            token = sampling.sample_per_row(
                logits, sampling.row_noise(seeds, pos + 1, V), temp, topk,
                topp, greedy, max_top_k, use_top_p,
                min_p=minp if use_min_p else None)
            toks.append(token)
            lps.append(sampling.chosen_logprob(logits, token))
            if top_n:
                tv, ti = sampling.top_logprobs(logits, top_n)
                tvs.append(tv)
                tis.append(ti)
            pos = pos + 1
        top = ((torch.stack(tvs, 1), torch.stack(tis, 1)) if top_n
               else (None, None))
        return (torch.stack(toks, 1), torch.stack(lps, 1), cache, token,
                pos, *top)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, token_lists: List[List[int]], cache=None,
                start_positions: Optional[Sequence[int]] = None):
        """Prefill a batch of prompts (optionally continuing a cache at
        per-sequence offsets). Returns (logits [B, V] float32, cache)."""
        B = len(token_lists)
        starts = list(start_positions or [0] * B)
        longest = max(len(t) + s for t, s in zip(token_lists, starts))
        if longest > self.engine_cfg.max_seq_len:
            raise ValueError(
                f"prompt needs {longest} cache slots but max_seq_len is "
                f"{self.engine_cfg.max_seq_len}")
        if cache is None:
            cache = self.new_cache(B)
        extent = min(self.engine_cfg.max_seq_len, cache.max_seq_len)
        if longest > extent:
            raise ValueError(f"prompt needs {longest} cache slots but the "
                             f"provided cache extent is {extent}")
        # prompts beyond the largest bucket run as a sequence of
        # largest-bucket chunks continuing the same cache
        fitting = [b for b in self.engine_cfg.prefill_buckets
                   if b <= self.engine_cfg.max_seq_len]
        chunk = max(fitting) if fitting else self.engine_cfg.max_seq_len
        n_chunks = (max(len(t) for t in token_lists) + chunk - 1) // chunk
        final = None
        for c in range(n_chunks):
            o = c * chunk
            part = [t[o:o + chunk] for t in token_lists]
            need = max(max(len(p) for p in part), 1)
            T = min(self._bucket(need), extent - o - max(starts))
            if T < need:
                raise ValueError(
                    f"prefill chunk needs {need} slots but only {T} fit "
                    f"before max_seq_len for the largest start offset")
            ids = np.zeros((B, T), np.int32)
            pos = np.zeros((B, T), np.int32)
            last = np.zeros((B,), np.int64)
            for i, toks in enumerate(part):
                ids[i, :len(toks)] = toks
                pos[i] = starts[i] + o + np.arange(T)
                last[i] = max(len(toks) - 1, 0)
            logits, cache = self._forward(
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(pos).to(self.device), cache,
                torch.from_numpy(last).to(self.device))
            if n_chunks > 1:
                # keep the logits of rows whose prompt ended in this chunk
                if final is None:
                    final = logits.clone()
                for i, t in enumerate(token_lists):
                    if o < len(t) <= o + chunk:
                        final[i] = logits[i]
        return (final if final is not None else logits), cache

    @torch.no_grad()
    def generate(self, prompts: Sequence[Union[str, Sequence[int]]],
                 gen: Optional[GenerationConfig] = None,
                 stream: Optional[Callable[[int, int, str], None]] = None,
                 ) -> List[GenerationResult]:
        """Batch generation. `stream(row, token_id, text_piece)` is called
        as tokens arrive."""
        gen = gen or GenerationConfig()
        if (gen.repetition_penalty != 1.0 or gen.presence_penalty != 0.0
                or gen.frequency_penalty != 0.0 or gen.logit_bias):
            raise NotImplementedError("sampling penalties and logit_bias "
                                      "are not ported yet")
        token_lists = self._encode_prompts(prompts)
        B = len(token_lists)
        lengths = np.array([len(t) for t in token_lists], np.int32)
        need = int(lengths.max()) + gen.max_new_tokens
        if need > self.engine_cfg.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens needs {need} cache slots but "
                f"max_seq_len is {self.engine_cfg.max_seq_len}")
        eos = set(gen.eos_token_ids)
        generator = torch.Generator(device=self.device).manual_seed(gen.seed)

        def draw(logits):
            return sampling.sample(logits, generator,
                                   temperature=gen.temperature,
                                   top_k=gen.top_k, top_p=gen.top_p,
                                   greedy=gen.greedy, min_p=gen.min_p)

        t0 = time.perf_counter()
        logits, cache = self.prefill(token_lists)
        first = draw(logits)
        first_np = first.cpu().numpy()
        ttft = time.perf_counter() - t0

        results = [[int(first_np[i])] for i in range(B)]
        finished = np.array([int(first_np[i]) in eos for i in range(B)])
        if stream is not None:
            for i in range(B):
                if not finished[i]:
                    self._stream_one(stream, i, int(first_np[i]))

        token = first
        pos = torch.from_numpy(lengths).to(self.device)  # next write slot
        zeros = torch.zeros((B,), dtype=torch.long, device=self.device)
        chunk = max(1, self.engine_cfg.decode_chunk)
        produced = 1
        t_dec = time.perf_counter()
        decoded = 0
        while produced < gen.max_new_tokens and not finished.all():
            steps = min(chunk, gen.max_new_tokens - produced)
            toks = []
            for _ in range(steps):
                logits, cache = self._forward(token[:, None], pos[:, None],
                                              cache, zeros)
                token = draw(logits)
                toks.append(token)
                pos = pos + 1
            toks_np = torch.stack(toks, dim=1).cpu().numpy()   # host sync
            for i in range(B):
                for j in range(steps):
                    if finished[i]:
                        break
                    t = int(toks_np[i, j])
                    results[i].append(t)
                    decoded += 1              # only delivered tokens count
                    if t in eos:
                        finished[i] = True
                    elif stream is not None:
                        self._stream_one(stream, i, t)
            produced += steps
        dt = time.perf_counter() - t_dec
        tps = decoded / dt if dt > 0 else 0.0

        out = []
        for i in range(B):
            ids = results[i]
            fin = any(t in eos for t in ids)
            if fin:
                ids = ids[:next(j for j, t in enumerate(ids) if t in eos)]
            text = self.tokenizer.decode(ids) if self.tokenizer else ""
            out.append(GenerationResult(token_ids=ids, text=text,
                                        ttft_s=ttft,
                                        decode_tokens_per_s=tps,
                                        finished=fin))
        return out

    def _stream_one(self, stream, row, token_id):
        piece = (self.tokenizer.decode_token(token_id)
                 if self.tokenizer else "")
        stream(row, token_id, piece)
