"""InferenceEngine: bucketed prefill and chunked decode on one model,
prompt scoring and embeddings, ChatSession over it, and the chat
templates (counterpart of `llm_inference_tpu/engine/engine.py:40-751,
752-1089`).

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
paged; the rows program also carries each slot's penalty state, logit
bias and guided-decoding DFA state (engine/guided.py), whose transitions
run on the device between steps. `score` gives per-token prompt
logprobs from `logits_mode="all"` forwards, chunked over one cache, and
`embed` L2-normalised final hidden states (last token or mean).
`window_forward` runs a [B, T] window at per-row positions (speculative
verification and a draft cache's catch-up), and `expand_cache` /
`reorder_cache` copy a dense cache's rows, codes and scales, for beam
search. Multi-LoRA serving (engine.py:127-139, 189-218): with adapter
stacks in params["lora"] (models/lora.py; the llama family only) and
`adapter_names`, `generate(adapter=)` and `ChatSession(adapter=)` take a
name or slot, or one a row, and every forward passes each row's slot
(`adapter_idx`); a base request on such an engine runs slot 0 through the
same unfused layer. There is no data parallelism: `data_parallel` is 1.
With `tp` (a parallel.TPGroup, the counterpart of
the JAX engine's `mesh=`, engine.py:86-112) the engine is one rank of a
tensor-parallel model: it shards the full parameters it is given, builds
caches of its kv heads, and every forward is the TP forward; every rank
samples from the same gathered logits, so every rank draws the same
tokens (`score` and `embed` raise there). `generate` records `ttft_s` and
`decode_tokens_per_s` in `metrics` as the JAX engine does (engine.py:806,
843). Sampling takes the serving API's repetition, presence and frequency
penalties and a logit bias (engine.py:222-240, 781-803): the output-token
counts and the prompt ∪ output seen mask of each row live on the device
and are updated in place by every sampled token.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            ModelConfig)
from llm_inference_tpu_torch.models import llama, registry
from llm_inference_tpu_torch.ops import kvcache, paged_kvcache, sampling
from llm_inference_tpu_torch.parallel import sharding
from llm_inference_tpu_torch.parallel.mesh import TPGroup
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
                 tokenizer=None, cache_dtype=torch.bfloat16, device=None,
                 tp: Optional[TPGroup] = None,
                 adapter_names: Optional[Sequence[str]] = None):
        """`params`: the model's prepared parameters (llama.prepare_params
        with tp_size = tp.size under tensor parallelism, where the engine
        keeps its rank's shard of them and runs on tp.device). The family's
        module comes from the registry by cfg.name (llama and the families
        on it, gemma2 and gemma3, mixtral, DeepSeek), and with it the RoPE
        tables and, where the module has them, the cache constructors.
        params["lora"] (LoRA stacks, llama family, one card) serves
        adapters; `adapter_names` names slots 1, 2, ... of them."""
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
        self.tp = tp if tp is not None and tp.size > 1 else None
        # the family's module (models/llama.py, models/gemma2.py), as the
        # JAX engine takes it from the registry (engine.py:87-88)
        self._model = registry.get_model(cfg.name)
        self.has_lora = isinstance(params, dict) and "lora" in params
        if self.has_lora:
            # the JAX engine takes stacks on any family, but only llama's
            # forward reads them: gemma2/mixtral/DeepSeek would serve base
            # requests without them and fail on a named adapter
            if self._model is not llama:
                raise NotImplementedError(
                    f"LoRA adapters serve the llama family only; "
                    f"{cfg.name} ({self._model.__name__}) takes no "
                    f"adapter_idx")
            if self.tp is not None:
                raise NotImplementedError("LoRA under tensor parallelism is "
                                          "not ported yet")
        self.kv_heads = cfg.num_kv_heads
        if self.tp is not None:
            sharding.validate_tp(cfg, tp.size)
            params = sharding.shard_params(params, tp.rank, tp.size)
            self.kv_heads = sharding.local_kv_heads(cfg, tp.size)
            device = tp.device
        self.device = resolve_device(device)
        self.params = params
        self.metrics = Metrics()
        # adapter name → stack slot (engine.py:127-139)
        self.adapter_slots: Dict[str, int] = {}
        self.num_adapters = 0
        if self.has_lora:
            n_slots = next(iter(params["lora"].values()))["a"].shape[1]
            names = list(adapter_names or [])
            if len(names) > n_slots - 1:
                raise ValueError(f"{len(names)} adapter names but only "
                                 f"{n_slots - 1} live slots")
            self.adapter_slots = {n: i + 1 for i, n in enumerate(names)}
            self.num_adapters = n_slots - 1
        self._rope = self._model.rope_table(cfg, self.engine_cfg.max_seq_len,
                                            self.device)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def new_cache(self, batch: int, max_seq: Optional[int] = None):
        """A dense cache of `batch` sequences: the family's own where its
        module has one (DeepSeek's latent cache), else the [L, B, Hkv, S,
        D] cache (engine.py:443-455)."""
        max_seq = max_seq or self.engine_cfg.max_seq_len
        model_nc = getattr(self._model, "new_cache", None)
        if model_nc is not None:
            return model_nc(self.cfg, batch, max_seq, self.cache_dtype,
                            device=self.device)
        return kvcache.init_cache(
            self.cfg.num_layers, batch, self.kv_heads, max_seq,
            self.cfg.head_dim, self.cache_dtype, device=self.device)

    def _bucket(self, n: int) -> int:
        for b in self.engine_cfg.prefill_buckets:
            # a bucket wider than the cache would write past max_seq_len
            if n <= b <= self.engine_cfg.max_seq_len:
                return b
        return n

    def _chunk_len(self) -> int:
        """The largest prefill bucket that fits the cache: long prompts
        run as chunks of this many tokens."""
        fitting = [b for b in self.engine_cfg.prefill_buckets
                   if b <= self.engine_cfg.max_seq_len]
        return max(fitting) if fitting else self.engine_cfg.max_seq_len

    def prefill_cache_len(self, n: int) -> int:
        """Smallest cache extent that admits an n-token prompt through the
        chunked `prefill` path with every bucket-rounded write window in
        bounds."""
        chunk = self._chunk_len()
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

    # no data-parallel mesh in the port (engine.py:435-441)
    data_parallel = 1

    def resolve_adapter(self, adapter) -> int:
        """Adapter name/slot → LoRA stack slot (0 = the base model;
        engine.py:189-204)."""
        if adapter is None:
            return 0
        if not self.has_lora:
            raise ValueError("engine has no LoRA stacks loaded")
        if isinstance(adapter, str):
            if adapter not in self.adapter_slots:
                raise ValueError(f"unknown adapter {adapter!r}; have "
                                 f"{sorted(self.adapter_slots)}")
            return self.adapter_slots[adapter]
        slot = int(adapter)
        if not 0 <= slot <= self.num_adapters:
            raise ValueError(f"adapter slot {slot} out of range "
                             f"[0, {self.num_adapters}]")
        return slot

    def _adapter_rows(self, adapter, batch: int) -> Optional[torch.Tensor]:
        """`adapter` (None, a name or slot, or one of them a row) → the
        rows' slots [B] int64 on the device, or None when every row is the
        base model (engine.py:206-218)."""
        if adapter is None:
            return None
        if isinstance(adapter, (list, tuple)):
            if len(adapter) != batch:
                raise ValueError(f"{len(adapter)} adapters for {batch} "
                                 f"prompts")
            slots = [self.resolve_adapter(a) for a in adapter]
        else:
            slots = [self.resolve_adapter(adapter)] * batch
        if not any(slots):
            return None
        return torch.tensor(slots, dtype=torch.long, device=self.device)

    def _forward(self, ids, positions, cache, last_idx, paged_history=False,
                 adapter_idx=None):
        """The one forward every path runs: last-token logits [B, V];
        adapter_idx [B] the rows' LoRA slots (passed on only when set)."""
        kw = {} if adapter_idx is None else {"adapter_idx": adapter_idx}
        return self._model.forward(self.cfg, self.params, ids, positions,
                                   cache, logits_mode="last",
                                   last_idx=last_idx, rope_tables=self._rope,
                                   paged_history=paged_history, tp=self.tp,
                                   **kw)

    def paged_forward(self, history: bool = False) -> Callable:
        """The forward over a paged cache, f(ids, positions, cache,
        last_idx, adapter_idx=None) → (logits, cache); history=True
        attends a chunk over the sequence's earlier pages
        (engine.py:160-187)."""
        def fwd(ids, positions, cache, last_idx, adapter_idx=None):
            kw = {} if adapter_idx is None else {"adapter_idx": adapter_idx}
            return self._forward(ids, positions, cache, last_idx,
                                 paged_history=history, **kw)
        return fwd

    def _fwd_for(self, cache) -> Callable:
        if isinstance(cache, paged_kvcache.PagedKVCache):
            return self.paged_forward()
        return self._forward

    @staticmethod
    def _gen_penalized(gen: GenerationConfig) -> bool:
        return (gen.repetition_penalty != 1.0 or gen.presence_penalty != 0.0
                or gen.frequency_penalty != 0.0)

    def _bias_row_np(self, logit_bias) -> np.ndarray:
        """{token_id: bias} → a [V] float32 numpy row (ids outside the
        vocabulary raise ValueError)."""
        return sampling.bias_row(logit_bias, self.cfg.vocab_size).numpy()

    def _bias_rows(self, logit_bias, batch: int):
        """{token_id: bias} → [B, V] float32 on the device (one row for
        every sequence), or None when unset; ids outside the vocabulary
        raise."""
        if not logit_bias:
            return None
        row = sampling.bias_row(logit_bias, self.cfg.vocab_size, self.device)
        return row.expand(batch, -1)

    def _penalty_state(self, seen_lists):
        """(output counts [B, V] int32 zeros, seen [B, V] bool with each
        row's ids of seen_lists) on the device: the penalties' state."""
        V = self.cfg.vocab_size
        seen = np.zeros((len(seen_lists), V), bool)
        for i, ids in enumerate(seen_lists):
            seen[i, np.asarray(list(ids), np.int64) % V] = True
        return (torch.zeros((len(seen_lists), V), dtype=torch.int32,
                            device=self.device),
                torch.from_numpy(seen).to(self.device))

    def _pick(self, logits, gen: GenerationConfig, generator, counts=None,
              seen=None, bias=None):
        """Next tokens [B] int32 from logits [B, V] under gen's knobs, the
        logit bias and (with counts/seen) the penalties, which then count
        the picked tokens in place."""
        if bias is not None:
            logits = logits + bias
        if counts is not None:
            B = logits.shape[0]

            def knob(v):
                return torch.full((B,), v, dtype=torch.float32,
                                  device=logits.device)
            logits = sampling.apply_penalties(
                logits, counts, seen, knob(gen.repetition_penalty),
                knob(gen.presence_penalty), knob(gen.frequency_penalty))
        token = sampling.sample(logits, generator,
                                temperature=gen.temperature,
                                top_k=gen.top_k, top_p=gen.top_p,
                                greedy=gen.greedy, min_p=gen.min_p)
        if counts is not None:
            rows = torch.arange(token.shape[0], device=token.device)
            counts[rows, token.long()] += 1
            seen[rows, token.long()] = True
        return token

    @torch.no_grad()
    def _decode_chunk_fn(self, cache, token, pos, counts=None, seen=None,
                         bias=None, *, steps: int, gen: GenerationConfig,
                         generator=None, logprobs: bool = True, aidx=None):
        """`steps` decode forwards over every row with static sampling
        knobs (engine.py:267-310); each step's token feeds the next on the
        device, with no host sync. token/pos [B]: the last token and its
        position; counts/seen the penalties' state (updated in place) and
        bias a [B, V] logit bias, which shape the pick but not the
        logprobs; aidx [B] the rows' LoRA slots. Returns (tokens [B,
        steps] int32, their logprobs [B, steps] float32 or None without
        `logprobs`, cache, token, pos)."""
        B = token.shape[0]
        zeros = torch.zeros((B,), dtype=torch.long, device=token.device)
        fwd = self._fwd_for(cache)
        akw = {} if aidx is None else {"adapter_idx": aidx}
        toks, lps = [], []
        for _ in range(steps):
            logits, cache = fwd(token[:, None], pos[:, None], cache, zeros,
                                **akw)
            token = self._pick(logits, gen, generator, counts, seen, bias)
            toks.append(token)
            if logprobs:
                lps.append(sampling.chosen_logprob(logits, token))
            pos = pos + 1
        return (torch.stack(toks, 1), torch.stack(lps, 1) if logprobs
                else None, cache, token, pos)

    @torch.no_grad()
    def window_forward(self, ids, positions, cache, logits_mode="all"):
        """One forward over a [B, T] window at per-row positions, writing
        the cache in place: the speculative verify (logits [B, T, V] for
        "all"; JAX speculative.py:69-71) and a draft cache's catch-up
        ("none")."""
        return self._model.forward(self.cfg, self.params, ids, positions,
                                   cache, logits_mode=logits_mode,
                                   rope_tables=self._rope)

    @torch.no_grad()
    def _decode_chunk_rows_fn(self, cache, token, pos, temp, topk, topp,
                              greedy, minp, seeds, counts=None, seen=None,
                              rep=None, pres=None, freq=None, bias=None,
                              gmask=None, gtrans=None, cidx=None,
                              dstate=None, aidx=None, *, steps: int,
                              max_top_k: int,
                              use_top_p: bool = True,
                              use_min_p: bool = False,
                              use_penalties: bool = False, top_n: int = 0):
        """As _decode_chunk_fn with per-row knob tensors [B]
        (engine.py:329-405, seeded): row b's draw at position p uses the
        noise of (seeds[b], p) only. With use_penalties, counts [B, V]
        int32 and seen [B, V] bool (updated in place by every step's
        tokens) and rep/pres/freq [B] shape the pick; bias [B, V] is each
        row's logit bias. Guided decoding: gmask [C, S, V] bool and gtrans
        [C, S, V] int are the stacked DFA tables, cidx [B] each row's
        constraint and dstate [B] int32 its DFA state (-1: unconstrained);
        the state moves on the device from step to step. aidx [B]: the
        rows' LoRA slots. With top_n > 0
        also returns each step's top_n logprobs and ids [B, steps, top_n],
        else None. Returns (tokens, logprobs, cache, token, pos, top
        values, top ids, dstate)."""
        B = token.shape[0]
        V = self.cfg.vocab_size
        zeros = torch.zeros((B,), dtype=torch.long, device=token.device)
        rows = torch.arange(B, device=token.device)
        fwd = self._fwd_for(cache)
        akw = {} if aidx is None else {"adapter_idx": aidx}
        toks, lps, tvs, tis = [], [], [], []
        for _ in range(steps):
            logits, cache = fwd(token[:, None], pos[:, None], cache, zeros,
                                **akw)
            allowed = st = None
            if gmask is not None:
                st = torch.clamp(dstate, min=0).long()
                allowed = gmask[cidx, st] | (dstate < 0)[:, None]
            token = sampling.sample_per_row(
                logits, sampling.row_noise(seeds, pos + 1, V), temp, topk,
                topp, greedy, max_top_k, use_top_p,
                min_p=minp if use_min_p else None,
                penalties=((counts, seen, rep, pres, freq) if use_penalties
                           else None), bias=bias, allowed=allowed)
            toks.append(token)
            lps.append(sampling.chosen_logprob(logits, token))
            if top_n:
                tv, ti = sampling.top_logprobs(logits, top_n)
                tvs.append(tv)
                tis.append(ti)
            if use_penalties:
                counts[rows, token.long()] += 1
                seen[rows, token.long()] = True
            if gmask is not None:
                ns = gtrans[cidx, st, token.long()].to(torch.int32)
                dstate = torch.where(dstate >= 0, ns, dstate)
            pos = pos + 1
        top = ((torch.stack(tvs, 1), torch.stack(tis, 1)) if top_n
               else (None, None))
        return (torch.stack(toks, 1), torch.stack(lps, 1), cache, token,
                pos, *top, dstate)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, token_lists: List[List[int]], cache=None,
                start_positions: Optional[Sequence[int]] = None,
                adapter_idx: Optional[torch.Tensor] = None):
        """Prefill a batch of prompts (optionally continuing a cache at
        per-sequence offsets; adapter_idx [B] the rows' LoRA slots).
        Returns (logits [B, V] float32, cache)."""
        akw = {} if adapter_idx is None else {"adapter_idx": adapter_idx}
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
        chunk = self._chunk_len()
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
                torch.from_numpy(last).to(self.device), **akw)
            if n_chunks > 1:
                # keep the logits of rows whose prompt ended in this chunk
                if final is None:
                    final = logits.clone()
                for i, t in enumerate(token_lists):
                    if o < len(t) <= o + chunk:
                        final[i] = logits[i]
        return (final if final is not None else logits), cache

    @torch.no_grad()
    def score(self, prompts: Sequence[Union[str, Sequence[int]]]
              ) -> List[List[Optional[float]]]:
        """Per-token prompt logprobs (engine.py:577-675): result[i][t] =
        log P(token t | tokens < t); the first token has no prediction
        (None). Each chunk is one `logits_mode="all"` forward whose targets
        are the next tokens, so a prompt beyond the largest bucket runs as
        chunks continuing one cache with no logit stitching."""
        if self.tp is not None:
            raise NotImplementedError("score over a tensor-parallel engine "
                                      "is not ported yet")
        token_lists = self._encode_prompts(prompts)
        B = len(token_lists)
        lengths = [len(t) for t in token_lists]
        longest = max(lengths)
        S = self.engine_cfg.max_seq_len
        if longest > S:
            raise ValueError(f"prompt needs {longest} cache slots but "
                             f"max_seq_len is {S}")
        cache = self.new_cache(B)
        chunk = self._chunk_len()
        got = torch.zeros((B, max(longest, 1)), dtype=torch.float32)
        for o in range(0, longest, chunk):
            part = [t[o:o + chunk] for t in token_lists]
            # the bucket rounds the width up: stop it at the cache's end
            T = min(self._bucket(max(max(len(p) for p in part), 1)), S - o)
            ids = np.zeros((B, T), np.int64)
            tgt = np.zeros((B, T), np.int64)
            for i, toks in enumerate(token_lists):
                ids[i, :len(part[i])] = part[i]
                nxt = toks[o + 1:o + T + 1]
                tgt[i, :len(nxt)] = nxt
            pos = np.broadcast_to(o + np.arange(T), (B, T))
            logits, cache = self._model.forward(
                self.cfg, self.params, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(np.array(pos)).to(self.device), cache,
                logits_mode="all", rope_tables=self._rope)
            tgt_t = torch.from_numpy(tgt).to(self.device)
            lp = (torch.gather(logits, -1, tgt_t[..., None])[..., 0]
                  - torch.logsumexp(logits, dim=-1))
            w = min(T, longest - o)
            got[:, o:o + w] = lp[:, :w].cpu()
        # got[i, t] = log P(ids[t + 1] | ids[..t]): shift right by one
        return [[None] + got[i, :L - 1].tolist() if L else []
                for i, L in enumerate(lengths)]

    @torch.no_grad()
    def embed(self, prompts: Sequence[Union[str, Sequence[int]]],
              pooling: str = "last") -> List[List[float]]:
        """Final-norm hidden-state embeddings, one [hidden] list a prompt,
        L2-normalised (engine.py:677-751): pooling "last" takes the last
        token's state, "mean" the mean over the prompt."""
        if pooling not in ("last", "mean"):
            raise ValueError(f"pooling must be last|mean, got {pooling!r}")
        if self.tp is not None:
            raise NotImplementedError("embed over a tensor-parallel engine "
                                      "is not ported yet")
        token_lists = self._encode_prompts(prompts)
        B = len(token_lists)
        lengths = [len(t) for t in token_lists]
        if min(lengths) == 0:
            raise ValueError("cannot embed an empty prompt")
        T = self._bucket(max(lengths))
        if T > self.engine_cfg.max_seq_len:
            raise ValueError(f"prompt needs {T} slots but max_seq_len is "
                             f"{self.engine_cfg.max_seq_len}")
        ids = np.zeros((B, T), np.int64)
        mask = np.zeros((B, T), np.float32)
        for i, toks in enumerate(token_lists):
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1.0
        pos = np.broadcast_to(np.arange(T), (B, T))
        h, _ = self._model.forward(
            self.cfg, self.params, torch.from_numpy(ids).to(self.device),
            torch.from_numpy(np.array(pos)).to(self.device),
            self.new_cache(B, max_seq=T), logits_mode="hidden",
            rope_tables=self._rope)
        h = h.to(torch.float32)
        if pooling == "mean":
            m = torch.from_numpy(mask).to(self.device)[..., None]
            v = (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        else:
            last = torch.tensor([n - 1 for n in lengths], device=self.device)
            v = h[torch.arange(B, device=self.device), last]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True), min=1e-9)
        return v.cpu().tolist()

    @torch.no_grad()
    def generate(self, prompts: Sequence[Union[str, Sequence[int]]],
                 gen: Optional[GenerationConfig] = None,
                 stream: Optional[Callable[[int, int, str], None]] = None,
                 adapter=None) -> List[GenerationResult]:
        """Batch generation. `stream(row, token_id, text_piece)` is called
        as tokens arrive. `adapter`: a LoRA adapter's name or slot for
        every row, or one a prompt (engine.py:752-778)."""
        gen = gen or GenerationConfig()
        token_lists = self._encode_prompts(prompts)
        B = len(token_lists)
        aidx = self._adapter_rows(adapter, B)
        bias = self._bias_rows(gen.logit_bias, B)
        lengths = np.array([len(t) for t in token_lists], np.int32)
        need = int(lengths.max()) + gen.max_new_tokens
        if need > self.engine_cfg.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens needs {need} cache slots but "
                f"max_seq_len is {self.engine_cfg.max_seq_len}")
        eos = set(gen.eos_token_ids)
        generator = torch.Generator(device=self.device).manual_seed(gen.seed)

        t0 = time.perf_counter()
        logits, cache = self.prefill(token_lists, adapter_idx=aidx)
        # the penalties' state: repetition over prompt ∪ output, presence
        # and frequency over the output
        counts = seen = None
        if self._gen_penalized(gen):
            counts, seen = self._penalty_state(token_lists)
        first = self._pick(logits, gen, generator, counts, seen, bias)
        first_np = first.cpu().numpy()
        ttft = time.perf_counter() - t0
        self.metrics.observe("ttft_s", ttft)

        results = [[int(first_np[i])] for i in range(B)]
        finished = np.array([int(first_np[i]) in eos for i in range(B)])
        if stream is not None:
            for i in range(B):
                if not finished[i]:
                    self._stream_one(stream, i, int(first_np[i]))

        token = first
        pos = torch.from_numpy(lengths).to(self.device)  # next write slot
        chunk = max(1, self.engine_cfg.decode_chunk)
        produced = 1
        t_dec = time.perf_counter()
        decoded = 0
        while produced < gen.max_new_tokens and not finished.all():
            steps = min(chunk, gen.max_new_tokens - produced)
            toks, _, cache, token, pos = self._decode_chunk_fn(
                cache, token, pos, counts, seen, bias, steps=steps, gen=gen,
                generator=generator, logprobs=False, aidx=aidx)
            toks_np = toks.cpu().numpy()                     # host sync
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
        self.metrics.observe("decode_tokens_per_s", tps)

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


def _as_words(t: torch.Tensor) -> torch.Tensor:
    """t (contiguous) with its last dim viewed as the widest integers that
    tile its bytes, so that a copy of batch rows moves words, not bytes."""
    n = t.shape[-1] * t.element_size()
    for dt in (torch.int64, torch.int32, torch.int16):
        if n % dt.itemsize == 0:
            return t.view(dt)
    return t


def _map_rows(cache: kvcache.KVCache, fn) -> kvcache.KVCache:
    """A dense cache whose every tensor (codes and scales) is fn of the
    old one's words along the batch dim 1."""
    return dataclasses.replace(cache, **{
        f: fn(_as_words(t)).view(t.dtype)
        for f in ("k", "v", "k_scale", "v_scale")
        if (t := getattr(cache, f)) is not None})


def expand_cache(cache: kvcache.KVCache, width: int) -> kvcache.KVCache:
    """Each sequence of a dense cache repeated `width` times along the
    batch (row b to rows b·width .. b·width + width - 1), scales with the
    codes (JAX beam_search.py:67-69)."""
    return _map_rows(cache, lambda t: t.repeat_interleave(width, dim=1))


def reorder_cache(cache: kvcache.KVCache, parents) -> kvcache.KVCache:
    """The dense cache's batch rows gathered by `parents` [B] (row b takes
    row parents[b]), scales with the codes (JAX beam_search.py:99). The
    gather reads into new tensors before anything is written, so repeated
    parents are safe."""
    idx = parents.to(device=cache.k.device, dtype=torch.long)
    return _map_rows(cache, lambda t: t.index_select(1, idx))


class ChatSession:
    """Multi-round chat that keeps the KV cache across rounds
    (engine.py:864-975): history stays resident and each round prefills
    only the new turn at the next free slot. The last sampled token of a
    round is never forwarded; it is carried into the next round's
    prefill. The repetition penalty's scope is the whole resident
    history; presence and frequency count this round's completion. One
    LoRA adapter a session (engine.py:872-877): the resident history was
    written under it, so switching adapters starts a new session."""

    def __init__(self, engine: InferenceEngine,
                 template: Optional[Callable[[str, int], str]] = None,
                 adapter=None):
        self._aidx = engine._adapter_rows(adapter, 1)
        self.engine = engine
        self.template = template or chat_template_for(engine.cfg.name)
        self.cache = None
        self.pos = 0          # next unwritten cache slot / absolute position
        self.round = 0
        self._pending: List[int] = []   # sampled but never forwarded tokens
        self._seen_ids: set = set()     # full history (repetition scope)

    @torch.no_grad()
    def ask(self, user_text: str, gen: Optional[GenerationConfig] = None,
            stream: Optional[Callable[[str], None]] = None) -> str:
        eng = self.engine
        gen = gen or GenerationConfig()
        prompt = self.template(user_text, self.round)
        toks = (self._pending
                + eng.tokenizer.encode(prompt, add_bos=(self.round == 0)))
        self._pending = []
        need = self.pos + len(toks) + gen.max_new_tokens
        if need > eng.engine_cfg.max_seq_len:
            raise ValueError(
                f"chat history + turn + max_new_tokens needs {need} cache "
                f"slots but max_seq_len is {eng.engine_cfg.max_seq_len}; "
                f"start a new session or raise max_seq_len")
        if self.cache is None:
            self.cache = eng.new_cache(1)
        logits, self.cache = eng.prefill([toks], cache=self.cache,
                                         start_positions=[self.pos],
                                         adapter_idx=self._aidx)
        self.pos += len(toks)
        generator = torch.Generator(device=eng.device).manual_seed(
            gen.seed + self.round)
        bias = eng._bias_rows(gen.logit_bias, 1)
        counts = seen = None
        if eng._gen_penalized(gen):
            self._seen_ids.update(toks)
            counts, seen = eng._penalty_state([sorted(self._seen_ids)])
        token = eng._pick(logits, gen, generator, counts, seen, bias)
        eos = set(gen.eos_token_ids)

        out_ids: List[int] = []
        cur = int(token[0])           # sampled, not yet forwarded
        pos = torch.tensor([self.pos], dtype=torch.int32, device=eng.device)
        chunk = max(1, eng.engine_cfg.decode_chunk)
        ended_by_eos = cur in eos
        while not ended_by_eos and len(out_ids) + 1 < gen.max_new_tokens:
            out_ids.append(cur)       # about to be forwarded by the chunk
            if stream is not None:
                stream(eng.tokenizer.decode_token(cur))
            steps = min(chunk, gen.max_new_tokens - len(out_ids))
            toks_d, _, self.cache, token, pos = eng._decode_chunk_fn(
                self.cache, token, pos, counts, seen, bias, steps=steps,
                gen=gen, generator=generator, logprobs=False,
                aidx=self._aidx)
            self.pos += 1             # `cur` is now in the cache...
            chunk_toks = toks_d[0].tolist()
            # ...and all but the last sampled token of the chunk are too
            for j, t in enumerate(chunk_toks):
                cur = int(t)
                if cur in eos:
                    ended_by_eos = True
                    break
                if j < len(chunk_toks) - 1:
                    out_ids.append(cur)
                    self.pos += 1
                    if stream is not None:
                        stream(eng.tokenizer.decode_token(cur))
        if not ended_by_eos:
            # the last sampled token was never forwarded: emit it, and
            # carry it into the next round's prefill
            out_ids.append(cur)
            if stream is not None:
                stream(eng.tokenizer.decode_token(cur))
            self._pending = [cur]
        self.round += 1
        self._seen_ids.update(out_ids)
        return eng.tokenizer.decode(out_ids)


def llama2_chat_template(user_text: str, round_idx: int) -> str:
    """LLaMA-2-chat prompt format."""
    return f"[INST] {user_text} [/INST]"


def gemma_chat_template(user_text: str, round_idx: int) -> str:
    """Gemma instruction format (<start_of_turn> markers)."""
    return (f"<start_of_turn>user\n{user_text}<end_of_turn>\n"
            f"<start_of_turn>model\n")


def llama3_chat_template(user_text: str, round_idx: int) -> str:
    """LLaMA-3-instruct header format (<|start_header_id|> markers)."""
    return ("<|start_header_id|>user<|end_header_id|>\n\n"
            f"{user_text}<|eot_id|>"
            "<|start_header_id|>assistant<|end_header_id|>\n\n")


def chatml_chat_template(user_text: str, round_idx: int) -> str:
    """ChatML (<|im_start|> markers), the Qwen family's format."""
    return (f"<|im_start|>user\n{user_text}<|im_end|>\n"
            "<|im_start|>assistant\n")


def phi3_chat_template(user_text: str, round_idx: int) -> str:
    """Phi-3 instruct format (<|user|> / <|assistant|> with <|end|>)."""
    return f"<|user|>\n{user_text}<|end|>\n<|assistant|>\n"


def chat_template_for(model_name: str):
    """The family's chat template (ChatSession's default). Mistral and
    Mixtral instruct use LLaMA-2's [INST] format."""
    head = model_name.split("-")[0].lower()
    if head.startswith("gemma"):
        return gemma_chat_template
    if head.startswith("llama3") or head.startswith("llama-3"):
        return llama3_chat_template
    if head.startswith("qwen"):
        return chatml_chat_template
    if head.startswith("phi3"):
        return phi3_chat_template
    return llama2_chat_template


def format_chat_messages(messages: Sequence[dict],
                         model_name: str = "") -> str:
    """An OpenAI-style message list as the family's chat prompt, the
    stateless counterpart of ChatSession's per-round template.
    LLaMA-2/Mistral: [INST]...[/INST] turns with the <<SYS>> block folded
    into the first user turn; LLaMA-3: header markers; Qwen: ChatML; Phi-3:
    role markers; Gemma: start_of_turn markers (the system text folded into
    the first user turn: gemma has no system role)."""
    head = (model_name or "").split("-")[0].lower()
    if head.startswith("llama3") or head.startswith("llama-3"):
        out = [f"<|start_header_id|>{m['role']}<|end_header_id|>"
               f"\n\n{m['content']}<|eot_id|>" for m in messages]
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(out)
    if head.startswith("qwen"):
        out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
               for m in messages]
        out.append("<|im_start|>assistant\n")
        return "".join(out)
    if head.startswith("phi3"):
        out = [f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in messages]
        out.append("<|assistant|>\n")
        return "".join(out)
    if head.startswith("gemma"):
        out = []
        system = ""
        for m in messages:
            if m["role"] == "system":
                system = m["content"] + "\n\n"
                continue
            role = "model" if m["role"] == "assistant" else "user"
            body = system + m["content"] if role == "user" else m["content"]
            system = ""
            out.append(f"<start_of_turn>{role}\n{body}<end_of_turn>\n")
        out.append("<start_of_turn>model\n")
        return "".join(out)
    system = ""
    turns: List[str] = []
    pending_user: Optional[str] = None
    for m in messages:
        role, content = m["role"], m["content"]
        if role == "system":
            system = content
        elif role == "user":
            pending_user = (content if pending_user is None
                            else pending_user + "\n" + content)
        elif role == "assistant":
            turns.append(f"[INST] {pending_user or ''} [/INST] {content}")
            pending_user = None
    final_user = pending_user or ""
    if system:
        sys_block = f"<<SYS>>\n{system}\n<</SYS>>\n\n"
        if turns:
            turns[0] = "[INST] " + sys_block + turns[0][len("[INST] "):]
        else:
            final_user = sys_block + final_user
    turns.append(f"[INST] {final_user} [/INST]")
    return " ".join(turns)
