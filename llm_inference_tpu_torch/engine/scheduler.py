"""Continuous batching over an InferenceEngine: the dense
ContinuousBatchingScheduler and the PagedScheduler (counterpart of
`llm_inference_tpu/engine/scheduler.py:52-1467`).

- A fixed pool of B decode slots shares one batched KV cache. Requests
  queue; free slots admit them (a burst as one wave: one padded prefill
  per chunk), and every step decodes one chunk of `decode_chunk` tokens
  for all slots. Finished requests retire on the host between chunks;
  idle slots keep decoding garbage that the host drops.
- Sampling knobs are per request and ride as per-slot tensors; a sampled
  row's draw depends only on (request seed, position)
  (ops/sampling.row_noise), so a preempted request replays identically.
- Harvest is one chunk deep (EngineConfig.pipeline_harvest): chunk k + 1
  is dispatched before chunk k's tokens are read, and admissions' first
  tokens are read with that chunk.
- PagedScheduler keeps the KV cache in a page pool
  (ops/paged_kvcache.py): pages are allocated at admission and before
  each chunk and freed at retirement; under pool pressure the youngest
  slot is preempted; with prefix_cache, full prompt pages are shared
  through engine/prefix_cache.py and only the suffix is prefilled, in
  page-aligned chunks over the earlier pages.

The page table lives on the host (numpy) and every sync hands the device
a fresh copy (`_table_snapshot`): a device view of the live host buffer
would see later edits. Two faults of the reference are not copied:
`_admit_batch` re-syncs the table when a wave's every writing row failed
(the reference breaks out first and leaves freed pages mapped for idle
slots), and `_preempt` drops the preempted request's unread first token
(the reference appends it to the reset request, so the replay's stream
starts with that token twice).

Per-request repetition, presence and frequency penalties, logit_bias
and guided decoding (engine/guided.py: token choices, a regex or a flat
JSON schema compiled into a token DFA at submit) ride the decode chunk
as device state (JAX scheduler.py:228-379): each penalised slot's [V]
output counts and prompt ∪ output seen row (seeded at admission from
the prompt and the first token, on the device), each biased slot's [V]
bias row, and the stacked DFA tables with each slot's constraint index
and DFA state, which moves on the device between steps; the host walks
a DFA only at admission (the first token) and reads the states once a
chunk.

LoRA adapters (models/lora.py; JAX scheduler.py:182, 341): each slot's
adapter slot lives in `aidx_host`, set at admission and reset to 0 when
the slot retires, and rides every forward over an engine with stacks:
the admission prefills, each decode chunk and the paged chunked prefill.
The prefix cache salts its hashes with the adapter slot, so pages are
shared within one adapter and never across two.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from llm_inference_tpu_torch.config import GenerationConfig
from llm_inference_tpu_torch.engine import guided, prefix_cache
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.ops import paged_kvcache, sampling

TOP_LOGPROBS_CAP = 16   # the widest top_logprobs a request may ask for
# entries of the stacked guided-decoding tables ([C, S, V] bool + int16)
# above which a new constraint is refused at submit
GUIDED_TABLE_MAX_ENTRIES = 256 * 1024 * 1024


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_ids: List[int]
    max_new_tokens: int
    stream: Optional[Callable[[int, int], None]] = None  # (req_id, token)
    # per-request sampling (None → the scheduler's GenerationConfig; any
    # explicit sampling knob turns greedy off unless greedy is set)
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: Optional[bool] = None
    min_p: Optional[float] = None
    repetition_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    # sampling seed (None → assigned by the scheduler and stored here, so
    # a preemption replay draws the same tokens)
    seed: Optional[int] = None
    stop_token_ids: Optional[Sequence[int]] = None  # not streamed
    stop: Optional[Sequence[str]] = None            # needs a tokenizer
    top_logprobs: Optional[int] = None              # <= TOP_LOGPROBS_CAP
    adapter: Optional[Union[str, int]] = None       # LoRA name or slot
    # {token_id: bias} added to the logits before sampling (None → the
    # scheduler's GenerationConfig.logit_bias); logprobs stay raw
    logit_bias: Optional[dict] = None
    # guided decoding, at most one of: choices (strings, or token-id
    # lists without a tokenizer), an anchored regex, a flat JSON schema;
    # compiled into a guided.TokenDFA at submit
    guided_choice: Optional[Sequence] = None
    guided_regex: Optional[str] = None
    guided_json: Optional[dict] = None
    constraint: Optional[guided.TokenDFA] = None
    _cidx: Optional[int] = None           # its index in the device tables
    # -- filled by the scheduler --
    output_ids: List[int] = dataclasses.field(default_factory=list)
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    output_top_logprobs: List[list] = dataclasses.field(
        default_factory=list)
    submit_t: float = 0.0
    first_token_t: float = 0.0
    done_t: float = 0.0
    finished: bool = False          # a stop token or string (vs budget)
    cancelled: bool = False
    stream_pos: int = 0             # tokens already streamed (survives a
                                    # replay: no duplicates reach clients)
    stop_hit: Optional[str] = None  # the stop string that fired
    final_text: Optional[str] = None  # output text trimmed at stop_hit
    _text: str = ""
    halt_stream_at: Optional[int] = None  # first output index not streamed

    def reset_generation(self) -> None:
        """Reset for a replay from the prompt (preemption, drain);
        stream_pos is kept."""
        self.output_ids = []
        self.output_logprobs = []
        self.output_top_logprobs = []
        self.first_token_t = 0.0
        self.finished = False
        self._text = ""
        self.halt_stream_at = None

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.submit_t


class ContinuousBatchingScheduler:
    """Slot-based continuous batching over a dense KV cache."""

    # a burst of arrivals admits as one wave (one prefill per chunk); off,
    # free slots admit one request at a time
    wave_admission = True
    # admissions' first tokens may be read with the next chunk's harvest;
    # a subclass whose dispatch reads output_ids on the host (speculative
    # proposals) sets this False to read them before the dispatch
    defer_admit_fetch = True

    def __init__(self, engine: InferenceEngine,
                 gen: Optional[GenerationConfig] = None,
                 slots: Optional[int] = None):
        if getattr(engine, "tp", None) is not None:
            raise NotImplementedError("the schedulers over a tensor-parallel "
                                      "engine are not ported yet")
        self.engine = engine
        self.gen = g = gen or GenerationConfig()
        self.B = slots or engine.engine_cfg.max_batch_size
        self.S = engine.engine_cfg.max_seq_len
        self.device = engine.device
        self.cache = self._make_cache()
        self.token = torch.zeros((self.B,), dtype=torch.int32,
                                 device=self.device)
        self.pos = torch.zeros((self.B,), dtype=torch.int32,
                               device=self.device)
        self.queue: deque[Request] = deque()
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self._ids = itertools.count()
        self._eos = set(g.eos_token_ids)
        # per-slot sampling knobs (sampling.sample_per_row)
        self.temp_host = np.full((self.B,), g.temperature, np.float32)
        self.topk_host = np.full((self.B,), g.top_k, np.int32)
        self.topp_host = np.full((self.B,), g.top_p, np.float32)
        self.greedy_host = np.full((self.B,), g.greedy, bool)
        self.minp_host = np.full((self.B,), g.min_p, np.float32)
        self.rep_host = np.full((self.B,), g.repetition_penalty, np.float32)
        self.pres_host = np.full((self.B,), g.presence_penalty, np.float32)
        self.freq_host = np.full((self.B,), g.frequency_penalty, np.float32)
        self.seed_host = np.zeros((self.B,), np.int64)
        self.aidx_host = np.zeros((self.B,), np.int64)   # LoRA slots
        # [B, V] output counts and prompt ∪ output seen rows on the device,
        # made when the first penalised request is admitted
        self._counts = self._seen = None
        # [B, V] logit-bias rows (made at the first biased admission), and
        # the slots whose row may be non-zero: a retired request's row
        # stays until the slot's next admission rewrites it
        self._bias = None
        self.bias_on_host = np.zeros((self.B,), bool)
        # guided decoding: each slot's DFA state (-1: unconstrained) and
        # constraint index into the stacked device tables
        self.dstate_host = np.full((self.B,), -1, np.int32)
        self.cidx_host = np.zeros((self.B,), np.int64)
        self._dfa_list: List[guided.TokenDFA] = []
        self._dfa_key2idx: dict = {}
        self._gmask_dev = None             # [C, S, V] bool
        self._gtrans_dev = None            # [C, S, V] int16
        self._seed_rng = np.random.default_rng(g.seed ^ 0x5EED)
        # wall seconds in admission, decode dispatch and harvest, and the
        # admissions, chunks and blocking device reads ("syncs")
        self.phase_s = {"admit": 0.0, "dispatch": 0.0, "harvest": 0.0}
        self.phase_n = {"admit": 0, "chunks": 0, "syncs": 0}
        # the dispatched chunk whose tokens are not read yet: (tokens,
        # logprobs, top values, top ids, slot_req at dispatch)
        self._pending = None
        self.pipeline_harvest = engine.engine_cfg.pipeline_harvest
        # admissions whose first token is not read yet: (slot, req, token,
        # logprob, top values, top ids)
        self._admit_pend: List[tuple] = []

    def _resolve_sampling(self, req: Request):
        """(temperature, top_k, top_p, greedy, min_p, repetition,
        presence, frequency) with the scheduler's defaults, validated."""
        g = self.gen
        explicit = any(x is not None for x in (req.temperature, req.top_k,
                                               req.top_p, req.min_p))
        greedy = (req.greedy if req.greedy is not None
                  else (False if explicit else g.greedy))
        topk = req.top_k if req.top_k is not None else g.top_k
        mk = self.engine.engine_cfg.max_top_k
        if topk > mk:
            raise ValueError(f"top_k={topk} exceeds EngineConfig.max_top_k"
                             f"={mk}")
        minp = req.min_p if req.min_p is not None else g.min_p
        if not 0.0 <= minp < 1.0:
            raise ValueError(f"min_p={minp} must be in [0, 1)")
        rep = (req.repetition_penalty if req.repetition_penalty is not None
               else g.repetition_penalty)
        if rep <= 0.0:
            raise ValueError(f"repetition_penalty={rep} must be > 0")
        if req.stop and self.engine.tokenizer is None:
            raise ValueError("stop strings need a tokenizer")
        if req.top_logprobs is not None and not (
                0 <= req.top_logprobs <= TOP_LOGPROBS_CAP):
            raise ValueError(f"top_logprobs={req.top_logprobs} must be in "
                             f"[0, {TOP_LOGPROBS_CAP}]")
        self.engine.resolve_adapter(req.adapter)
        return (req.temperature if req.temperature is not None
                else g.temperature, topk,
                req.top_p if req.top_p is not None else g.top_p,
                greedy, minp, rep,
                (req.presence_penalty if req.presence_penalty is not None
                 else g.presence_penalty),
                (req.frequency_penalty if req.frequency_penalty is not None
                 else g.frequency_penalty))

    def _logit_bias(self, req: Request) -> Optional[dict]:
        return (req.logit_bias if req.logit_bias is not None
                else self.gen.logit_bias)

    def _resolve_seed(self, req: Request) -> int:
        """Assign (once) and return the request's sampling seed."""
        if req.seed is None:
            req.seed = int(self._seed_rng.integers(0, 2**31 - 1))
        return req.seed

    def _ensure_penalty_state(self) -> None:
        if self._counts is None:
            V = self.engine.cfg.vocab_size
            self._counts = torch.zeros((self.B, V), dtype=torch.int32,
                                       device=self.device)
            self._seen = torch.zeros((self.B, V), dtype=torch.bool,
                                     device=self.device)

    def _register_dfa(self, dfa: guided.TokenDFA) -> int:
        """The index of a compiled TokenDFA in the stacked device tables,
        rebuilt when it is new (identical constraints share one index).
        The tables pad to power-of-two counts of constraints and states.
        Everything is checked before anything changes, so a refused
        constraint leaves no entry behind."""
        k = dfa.key()
        idx = self._dfa_key2idx.get(k)
        if idx is not None:
            return idx
        V = self.engine.cfg.vocab_size
        if dfa.vocab_size != V:
            raise ValueError(f"constraint vocab {dfa.vocab_size} != "
                             f"model vocab {V}")
        cand = self._dfa_list + [dfa]
        S = max(d.n_states for d in cand)
        S_pad = max(8, 1 << (S - 1).bit_length())
        C_pad = 1 << (len(cand) - 1).bit_length() if len(cand) > 1 else 1
        if C_pad * S_pad * V > GUIDED_TABLE_MAX_ENTRIES:
            raise ValueError(
                f"guided-decoding tables would need {C_pad}x{S_pad}x{V} "
                f"entries — too many resident constraints / states; "
                f"simplify the constraint or retire old ones")
        gmask = np.zeros((C_pad, S_pad, V), bool)
        gtrans = np.zeros((C_pad, S_pad, V), np.int16)
        for i, d in enumerate(cand):
            gmask[i, :d.n_states] = d.mask
            gtrans[i, :d.n_states] = d.trans.astype(np.int16)
        idx = len(self._dfa_list)
        self._dfa_list.append(dfa)
        self._dfa_key2idx[k] = idx
        self._gmask_dev = torch.from_numpy(gmask).to(self.device)
        self._gtrans_dev = torch.from_numpy(gtrans).to(self.device)
        return idx

    def _set_slot_sampling(self, slot: int, req: Request, first) -> None:
        """Program the slot's sampling state at admission, with no device
        read: the knobs and the bias row come from the host, and the
        penalty rows are seeded on the device from the prompt and the
        first token `first` [1] (a device tensor). The DFA state needs the
        token on the host: _finish_admissions sets it."""
        t, k, p, gr, minp, rep, pres, freq = self._resolve_sampling(req)
        self.temp_host[slot] = t
        self.topk_host[slot] = k
        self.topp_host[slot] = p
        self.greedy_host[slot] = gr
        self.minp_host[slot] = minp
        self.rep_host[slot] = rep
        self.pres_host[slot] = pres
        self.freq_host[slot] = freq
        self.seed_host[slot] = self._resolve_seed(req)
        self.aidx_host[slot] = self.engine.resolve_adapter(req.adapter)
        V = self.engine.cfg.vocab_size
        if rep != 1.0 or pres != 0.0 or freq != 0.0:
            # repetition scope: prompt ∪ output; presence and frequency
            # count the output, whose first token is `first`. A slot with
            # neutral knobs ignores its (stale) rows.
            self._ensure_penalty_state()
            seen_row = np.zeros((V,), bool)
            seen_row[np.asarray(req.prompt_ids, np.int64) % V] = True
            first_hot = torch.arange(V, device=self.device) == first[:1]
            self._counts[slot] = first_hot
            self._seen[slot] = self._host_tensor(seen_row) | first_hot
        bias = self._logit_bias(req)
        if bias and self._bias is None:
            self._bias = torch.zeros((self.B, V), dtype=torch.float32,
                                     device=self.device)
        if self._bias is not None and (bias or self.bias_on_host[slot]):
            self._bias[slot] = self._host_tensor(
                self.engine._bias_row_np(bias))
        self.bias_on_host[slot] = bool(bias)
        if req.constraint is not None:
            if req._cidx is None:
                req._cidx = self._register_dfa(req.constraint)
            self.cidx_host[slot] = req._cidx
        else:
            self.cidx_host[slot] = 0
            self.dstate_host[slot] = -1

    def _host_tensor(self, a: np.ndarray) -> torch.Tensor:
        """A device tensor from a COPY of a host array: the arrays change
        at admission and retirement while chunks are queued."""
        return torch.from_numpy(np.array(a, copy=True)).to(self.device)

    def _adapter_idx(self, reqs: Sequence[Optional[Request]]):
        """The rows' LoRA slots [k] on the device for a forward over
        `reqs` (None rows: slot 0), or None over an engine without
        stacks (JAX scheduler.py:501-536)."""
        if not self.engine.has_lora:
            return None
        return self._host_tensor(np.array(
            [0 if r is None else self.engine.resolve_adapter(r.adapter)
             for r in reqs], np.int64))

    # ------------------------------------------------------------------

    def _make_cache(self):
        return self.engine.new_cache(self.B)

    def _insert(self, one_cache, first, plen: int, slot: int,
                row: int, cache=None) -> None:
        """Copy row `row` of an admission prefill's cache into `slot` of
        the batch cache, in place (the reference's _insert_fn): only the
        prefill cache's extent, which may be shorter than the batch's.
        With `cache` (a draft model's batch cache) the rows go there and
        the slot's token and position stay as they are."""
        c = self.cache if cache is None else cache
        n = one_cache.max_seq_len
        c.k[:, slot, :, :n] = one_cache.k[:, row]
        c.v[:, slot, :, :n] = one_cache.v[:, row]
        if c.quantized:
            c.k_scale[:, slot, :n] = one_cache.k_scale[:, row]
            c.v_scale[:, slot, :n] = one_cache.v_scale[:, row]
        if cache is None:
            self._set_tok_pos(slot, first, plen)

    def _set_tok_pos(self, slot: int, first, plen: int) -> None:
        self.token[slot] = first[0]
        self.pos[slot] = plen

    # ------------------------------------------------------------------

    def submit(self, prompt: Union[str, Sequence[int]],
               max_new_tokens: Optional[int] = None,
               stream: Optional[Callable[[int, int], None]] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               greedy: Optional[bool] = None, min_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None,
               seed: Optional[int] = None,
               stop_token_ids: Optional[Sequence[int]] = None,
               stop: Optional[Union[str, Sequence[str]]] = None,
               top_logprobs: Optional[int] = None, adapter=None,
               logit_bias: Optional[dict] = None,
               guided_choice=None, guided_regex=None,
               guided_json=None) -> Request:
        ids = self.engine._encode_prompts([prompt])[0]
        new = max_new_tokens or self.gen.max_new_tokens
        if len(ids) + new > self.S:
            raise ValueError(f"prompt({len(ids)}) + max_new_tokens exceeds "
                             f"max_seq_len {self.S}")
        self._validate_capacity(len(ids), new)
        if isinstance(stop, str):
            stop = [stop]
        req = Request(req_id=next(self._ids), prompt_ids=ids,
                      max_new_tokens=new, stream=stream,
                      submit_t=time.perf_counter(), temperature=temperature,
                      top_k=top_k, top_p=top_p, greedy=greedy, min_p=min_p,
                      repetition_penalty=repetition_penalty,
                      presence_penalty=presence_penalty,
                      frequency_penalty=frequency_penalty, seed=seed,
                      stop_token_ids=stop_token_ids, stop=stop,
                      top_logprobs=top_logprobs, adapter=adapter,
                      logit_bias=logit_bias, guided_choice=guided_choice,
                      guided_regex=guided_regex, guided_json=guided_json)
        self._resolve_sampling(req)
        self.engine._bias_row_np(self._logit_bias(req))   # ids in range
        if (guided_choice is not None or guided_regex is not None
                or guided_json is not None):
            req.constraint = guided.compile_constraint(
                self.engine.cfg.vocab_size, sorted(self._stops(req)),
                tokenizer=self.engine.tokenizer, choice=guided_choice,
                regex=guided_regex, json_schema=guided_json)
            # registered here, so that a table-size refusal reaches the
            # caller and never the step loop
            req._cidx = self._register_dfa(req.constraint)
        if len(self.queue) >= self.engine.engine_cfg.max_queued_requests:
            raise RuntimeError("request queue full")
        self.queue.append(req)
        return req

    # ------------------------------------------------------------------

    def _admit_one(self, slot: int, req: Request) -> bool:
        """Prefill `req` alone and insert it into `slot`; the first-token
        read is deferred to _finish_admissions."""
        plen = len(req.prompt_ids)
        small = self.engine.new_cache(
            1, max_seq=self.engine.prefill_cache_len(plen))
        logits, one = self.engine.prefill([list(req.prompt_ids)],
                                          cache=small,
                                          adapter_idx=self._adapter_idx([req]))
        first = self._first_token_dispatch(slot, req, logits[:1])
        self._insert(one, first, plen, slot, 0)
        self.slot_req[slot] = req
        return True

    def _admit_batch(self, slots: List[int], reqs: List[Request]) -> None:
        """Admit k requests with one prefill over a cache sized at the
        longest prompt's bucket, then insert each row (the reference pads
        the batch to a power of two to bound its compiled programs; eager
        PyTorch has none, so the port prefills k rows)."""
        prompts = [list(r.prompt_ids) for r in reqs]
        small = self.engine.new_cache(
            len(prompts),
            max_seq=self.engine.prefill_cache_len(max(map(len, prompts))))
        logits, ck = self.engine.prefill(prompts, cache=small,
                                         adapter_idx=self._adapter_idx(reqs))
        for i, (slot, req) in enumerate(zip(slots, reqs)):
            first = self._first_token_dispatch(slot, req, logits[i:i + 1])
            self._insert(ck, first, len(req.prompt_ids), slot, i)
            self.slot_req[slot] = req

    def _first_token_dispatch(self, slot: int, req: Request, logits):
        """Sample the first token with the request's knobs, program the
        slot's knobs, and stash the results for _finish_admissions.
        Returns the token tensor [1]."""
        first, lp, tv, ti = self._sample_first(logits, req)
        self._set_slot_sampling(slot, req, first)
        self._admit_pend.append((slot, req, first, lp, tv, ti))
        return first

    def _finish_admissions(self, fetched=None) -> None:
        """Read every pending admission's first token (or take `fetched`,
        read with a chunk's harvest) and run the host bookkeeping:
        logprobs, stop checks, instant retirement, and a guided request's
        DFA walk over its first token."""
        pend, self._admit_pend = self._admit_pend, []
        if not pend:
            return
        if fetched is None:
            self.phase_n["syncs"] += 1
            fetched = self._fetch_admissions(pend)
        now = time.perf_counter()
        for (slot, req, *_), (tok, lp, tv, ti) in zip(pend, fetched):
            req.first_token_t = now      # client-visible: token read
            stops = self._stops(req)
            req.output_ids.append(tok)
            req.output_logprobs.append(lp)
            if req.top_logprobs:
                n = req.top_logprobs
                req.output_top_logprobs.append(list(zip(ti[:n], tv[:n])))
            self._check_stop_strings(req, tok)
            if tok not in stops:
                self._emit(req)
            self.engine.metrics.observe("ttft_s", req.ttft_s)
            if (tok in stops or req.finished
                    or len(req.output_ids) >= req.max_new_tokens):
                req.finished = req.finished or tok in stops
                req.done_t = time.perf_counter()
                self.slot_req[slot] = None
                self._on_retire(slot)
            elif req.constraint is not None:
                self.dstate_host[slot] = req.constraint.walk(req.output_ids)

    @staticmethod
    def _fetch_admissions(pend):
        """[(token, logprob, top values, top ids)] of pending admissions,
        read from the device (the first read waits for them all)."""
        return [(int(p[2][0]), float(p[3][0]), p[4][0].tolist(),
                 p[5][0].tolist()) for p in pend]

    def _harvest_pending(self, pend=None) -> None:
        """Read one dispatched chunk's tokens (with any pending
        admissions' first tokens) and hand them out. With no argument,
        drains self._pending."""
        if pend is None:
            pend, self._pending = self._pending, None
            if pend is None:
                return
        toks, lps, tvs, tis, snap = pend
        t1 = time.perf_counter()
        self.phase_n["syncs"] += 1
        toks_np = toks.cpu().numpy()
        apend = self._admit_pend
        if apend:
            # admissions first: an instant retirement must clear slot_req
            # before the chunk's rows are attributed
            self._finish_admissions(self._fetch_admissions(apend))
        self._harvest(toks_np, lps.cpu().numpy(),
                      None if tvs is None else tvs.cpu().numpy(),
                      None if tis is None else tis.cpu().numpy(),
                      snapshot=snap)
        self.phase_s["harvest"] += time.perf_counter() - t1

    def _harvest(self, toks_np: np.ndarray,
                 lps_np: Optional[np.ndarray] = None,
                 tvs_np: Optional[np.ndarray] = None,
                 tis_np: Optional[np.ndarray] = None,
                 snapshot: Optional[List[Optional[Request]]] = None) -> None:
        """Distribute a chunk's tokens [B, steps]. Row b belongs to
        snapshot[b] (the occupancy at dispatch) and is dropped unless that
        request still holds slot b."""
        now = time.perf_counter()
        for b in range(self.B):
            req = self.slot_req[b] if snapshot is None else snapshot[b]
            if req is None or req is not self.slot_req[b]:
                continue
            stops = self._stops(req)
            for j, t in enumerate(toks_np[b]):
                t = int(t)
                if req.cancelled:
                    break
                req.output_ids.append(t)
                if lps_np is not None:
                    req.output_logprobs.append(float(lps_np[b, j]))
                if tvs_np is not None and req.top_logprobs:
                    n = req.top_logprobs
                    req.output_top_logprobs.append(
                        [(int(i), float(v)) for i, v in
                         zip(tis_np[b, j, :n], tvs_np[b, j, :n])])
                if t in stops:
                    req.finished = True
                else:
                    self._check_stop_strings(req, t)
                if req.finished or len(req.output_ids) >= req.max_new_tokens:
                    break
            self._emit(req)
            if (req.cancelled or req.finished
                    or len(req.output_ids) >= req.max_new_tokens):
                req.done_t = now
                self.slot_req[b] = None
                self.dstate_host[b] = -1     # its constraint is over
                self._on_retire(b)

    def _validate_capacity(self, prompt_len: int, max_new: int) -> None:
        """Hook: reject a request that could never be served."""

    def _on_retire(self, slot: int) -> None:
        """A slot's request finished (or was undone): the slot's adapter
        goes back to the base model, so that nothing admitted later
        inherits it. Subclasses extend it."""
        self.aidx_host[slot] = 0

    def _before_chunk(self, steps: int) -> bool:
        """Hook: about to decode `steps` for the active slots; False skips
        the chunk."""
        return True

    def _stops(self, req: Request) -> set:
        return (self._eos if not req.stop_token_ids
                else self._eos | set(req.stop_token_ids))

    def _check_stop_strings(self, req: Request, tok: int) -> None:
        """Incremental stop-string matching over the decoded output; a
        match finishes the request, records the trimmed text and halts the
        stream before the completing token."""
        if not req.stop:
            return
        piece = self.engine.tokenizer.decode_token(tok)
        prev = len(req._text)
        req._text += piece
        longest = max(len(s) for s in req.stop)
        start = max(0, prev - longest + 1)
        for s in req.stop:
            i = req._text.find(s, start)
            if i >= 0:
                req.finished = True
                req.stop_hit = s
                req.final_text = req._text[:i]
                req.halt_stream_at = len(req.output_ids) - 1
                return

    def _emit(self, req: Request) -> None:
        """Stream the tokens the client has not seen (stop tokens
        excluded; a fired stop string halts before its token)."""
        n = len(req.output_ids)
        limit = n if req.halt_stream_at is None else min(
            n, req.halt_stream_at)
        if req.stream:
            stops = self._stops(req)
            for i in range(req.stream_pos, limit):
                t = req.output_ids[i]
                if t not in stops:
                    req.stream(req.req_id, t)
        req.stream_pos = max(req.stream_pos, n)

    def _sample_first(self, logits, req: Request):
        """The first token with the request's knobs, drawn at position
        len(prompt) under its seed as the decode chunks draw, with its
        logprob and the top logprobs: tensors [1], [1], [1, n], [1, n].
        Its penalties see the prompt (repetition) and no output yet; its
        logit bias and a constraint's start mask (disallowed tokens at
        NEG_INF) fold into one bias row."""
        t, k, p, gr, minp, rep, pres, freq = self._resolve_sampling(req)
        dev = logits.device
        plen = len(req.prompt_ids)
        V = self.engine.cfg.vocab_size

        def full(x, dtype):
            return torch.full((1,), x, dtype=dtype, device=dev)
        penalties = None
        if rep != 1.0 or pres != 0.0 or freq != 0.0:
            seen_row = np.zeros((1, V), bool)
            if rep != 1.0:
                seen_row[0, np.asarray(req.prompt_ids, np.int64) % V] = True
            penalties = (torch.zeros((1, V), dtype=torch.int32, device=dev),
                         self._host_tensor(seen_row),
                         full(rep, torch.float32), full(pres, torch.float32),
                         full(freq, torch.float32))
        bias = None
        logit_bias = self._logit_bias(req)
        if logit_bias or req.constraint is not None:
            row = self.engine._bias_row_np(logit_bias)
            if req.constraint is not None:
                row = row + np.where(
                    req.constraint.mask[req.constraint.start], 0.0,
                    sampling.NEG_INF).astype(np.float32)
            bias = self._host_tensor(row[None])
        noise = sampling.row_noise(full(self._resolve_seed(req), torch.int64),
                                   full(plen, torch.int64), V)
        tok = sampling.sample_per_row(
            logits, noise, full(t, torch.float32), full(k, torch.int32),
            full(p, torch.float32), full(gr, torch.bool),
            self.engine.engine_cfg.max_top_k, True,
            min_p=full(minp, torch.float32), penalties=penalties, bias=bias)
        tv, ti = sampling.top_logprobs(logits, min(TOP_LOGPROBS_CAP, V))
        return tok, sampling.chosen_logprob(logits, tok), tv, ti

    @torch.no_grad()
    def step(self) -> bool:
        """One iteration: admit into free slots, then decode one chunk for
        every active slot. Returns False when fully idle."""
        t0 = time.perf_counter()
        wave = self.wave_admission and self.engine.data_parallel == 1
        if wave and self.queue:
            free = [b for b in range(self.B) if self.slot_req[b] is None]
            k = min(len(free), len(self.queue))
            if k == 1:
                self._admit_one(free[0], self.queue.popleft())
                self.phase_n["admit"] += 1
            elif k > 1:
                self._admit_batch(free[:k],
                                  [self.queue.popleft() for _ in range(k)])
                self.phase_n["admit"] += k
        elif not wave:
            for b in range(self.B):
                if self.slot_req[b] is None and self.queue:
                    if not self._admit_one(b, self.queue.popleft()):
                        break                # out of capacity
                    self.phase_n["admit"] += 1
        # admissions' first tokens are read with the next chunk's harvest,
        # but a guided admission's DFA state gates the next chunk's mask,
        # and a subclass may need them before its dispatch
        if (not self.defer_admit_fetch
                or any(p[1].constraint is not None
                       for p in self._admit_pend)):
            self._finish_admissions()
        self.phase_s["admit"] += time.perf_counter() - t0
        if not any(r is not None for r in self.slot_req):
            self._finish_admissions()
            if self._pending is not None:
                self._harvest_pending()      # drain the chunk in flight
                return True
            return bool(self.queue)
        # always a full chunk: harvest cuts each request at its budget;
        # retired rows' overshoot writes clamp at the cache's edge
        steps = self.engine.engine_cfg.decode_chunk
        if not self._before_chunk(steps):
            if self._pending is not None:
                self._harvest_pending()   # retiring slots may free pages
            self._finish_admissions()
            return True
        self._dispatch_decode(steps)
        self._finish_admissions()
        return True

    def _dispatch_decode(self, steps: int) -> None:
        """Dispatch one decode chunk for all slots; harvest the previous
        one (or this one, without pipelining). Each stage of the rows
        program (top-k, top-p, min-p, penalties, bias, guided masks) runs
        only when a live slot needs it."""
        t0 = time.perf_counter()
        eng = self.engine
        live = [b for b, r in enumerate(self.slot_req) if r is not None]
        use_pen = any(self.rep_host[b] != 1.0 or self.pres_host[b] != 0.0
                      or self.freq_host[b] != 0.0 for b in live)
        top_used = any(self.slot_req[b].top_logprobs for b in live)
        use_bias = any(self.bias_on_host[b] for b in live)
        use_guided = any(self.dstate_host[b] >= 0 for b in live)
        aidx = (self._host_tensor(self.aidx_host) if eng.has_lora
                else None)
        if (all(self.greedy_host[b] for b in live) and not top_used
                and not use_pen and not use_bias and not use_guided):
            # all-greedy chunk: argmax, no filtering work
            toks, lps, self.cache, self.token, self.pos = (
                eng._decode_chunk_fn(
                    self.cache, self.token, self.pos, steps=steps,
                    gen=dataclasses.replace(self.gen, greedy=True),
                    aidx=aidx))
            tvs = tis = None
        else:
            if use_pen:
                self._ensure_penalty_state()
            ht = self._host_tensor
            (toks, lps, self.cache, self.token, self.pos, tvs, tis,
             dstate) = eng._decode_chunk_rows_fn(
                self.cache, self.token, self.pos, ht(self.temp_host),
                ht(self.topk_host), ht(self.topp_host),
                ht(self.greedy_host), ht(self.minp_host),
                ht(self.seed_host),
                self._counts if use_pen else None,
                self._seen if use_pen else None,
                ht(self.rep_host), ht(self.pres_host), ht(self.freq_host),
                self._bias if use_bias else None,
                self._gmask_dev if use_guided else None,
                self._gtrans_dev if use_guided else None,
                ht(self.cidx_host) if use_guided else None,
                ht(self.dstate_host) if use_guided else None, aidx,
                steps=steps,
                max_top_k=(eng.engine_cfg.max_top_k
                           if any(self.topk_host[b] > 0 for b in live)
                           else 0),
                use_top_p=any(self.topp_host[b] < 1.0 for b in live),
                use_min_p=any(self.minp_host[b] > 0.0 for b in live),
                use_penalties=use_pen,
                top_n=(min(TOP_LOGPROBS_CAP, eng.cfg.vocab_size)
                       if top_used else 0))
            if use_guided:
                # the states after the chunk: one read a chunk (the guided
                # path does not pipeline)
                self.phase_n["syncs"] += 1
                self.dstate_host = dstate.cpu().numpy().astype(np.int32)
        self.phase_s["dispatch"] += time.perf_counter() - t0
        self.phase_n["chunks"] += 1
        prev, self._pending = self._pending, (toks, lps, tvs, tis,
                                              list(self.slot_req))
        if prev is not None:
            self._harvest_pending(prev)
        if not self.pipeline_harvest:
            self._harvest_pending()          # synchronous mode

    def cancel(self, req: Request) -> bool:
        """Abort a request: drop it from the queue, or flag it so the next
        harvest retires its slot. Returns whether it was pending."""
        req.cancelled = True
        try:
            self.queue.remove(req)
            req.done_t = time.perf_counter()
            return True
        except ValueError:
            pass
        return any(r is req for r in self.slot_req)

    def adopt(self, requests: Sequence[Request]) -> None:
        """Enqueue requests taken from another scheduler (its
        drain_inflight and queue), keeping their ids, seeds, knobs,
        streams and stream positions: the replay is identical and clients
        see no duplicates. A guided request's DFA registers in this
        scheduler's tables."""
        for req in requests:
            self._validate_capacity(len(req.prompt_ids), req.max_new_tokens)
            if req.constraint is not None:
                req._cidx = self._register_dfa(req.constraint)
            req.reset_generation()
            self.queue.append(req)

    def drain_inflight(self) -> List[Request]:
        """Pull every in-flight request out of its slot and put it back at
        the front of the queue, reset for a replay from the prompt.
        Returns the drained requests."""
        self._pending = None      # the in-flight chunk is replayed anyway
        drained = []
        for b in range(self.B):
            req = self.slot_req[b]
            if req is None:
                continue
            self.slot_req[b] = None
            self.dstate_host[b] = -1
            self._on_retire(b)
            req.reset_generation()
            drained.append(req)
        for req in reversed(drained):
            self.queue.appendleft(req)
        return drained

    def run(self, requests: Sequence[Union[str, Sequence[int]]],
            max_new_tokens: Optional[int] = None) -> List[Request]:
        """Submit everything, run to completion, return the requests in
        submission order."""
        reqs = [self.submit(p, max_new_tokens) for p in requests]
        t0 = time.perf_counter()
        while self.step():
            pass
        dt = time.perf_counter() - t0
        produced = sum(len(r.output_ids) for r in reqs)
        if dt > 0:
            self.engine.metrics.observe("batch_tokens_per_s", produced / dt)
        return reqs


class PagedScheduler(ContinuousBatchingScheduler):
    """Continuous batching over the paged KV cache: admissions prefill
    straight into their pages (no insert copy); pages are allocated at
    admission and before each chunk, freed at retirement; the pool may be
    smaller than slots x max_seq_len (admissions wait, the youngest slot
    is preempted)."""

    def __init__(self, engine: InferenceEngine,
                 gen: Optional[GenerationConfig] = None,
                 slots: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 prefix_cache: bool = False,
                 interleave_prefill: bool = True):
        self._paged_opts = (num_pages, page_size)
        self._prefix_opt = prefix_cache
        self._interleave = interleave_prefill
        super().__init__(engine, gen, slots)
        self._prefill_paged = engine.paged_forward(history=False)
        self._prefill_hist = engine.paged_forward(history=True)
        self.preemptions = 0

    def _make_cache(self):
        num_pages, page_size = self._paged_opts
        cfg = self.engine.cfg
        self.ps = page_size or self.engine.engine_cfg.page_size or 128
        if self.S % self.ps:
            raise ValueError(f"max_seq_len {self.S} not a multiple of "
                             f"page_size {self.ps}")
        self.nb = self.S // self.ps
        pool = num_pages or (self.B * self.nb + 1)
        self.alloc = paged_kvcache.PageAllocator(pool, reserve=1)
        self.store = prefix_cache.PrefixStore() if self._prefix_opt else None
        self.pt_host = np.zeros((self.B, self.nb), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(self.B)]
        self.pos_host = np.zeros((self.B,), np.int64)
        # a family with its own pool (DeepSeek's latent pages) builds it
        # (scheduler.py:1062-1064)
        model_pc = getattr(self.engine._model, "new_paged_cache", None)
        if model_pc is not None:
            return model_pc(cfg, pool, self.ps, self.B, self.nb,
                            self.engine.cache_dtype,
                            device=self.engine.device)
        return paged_kvcache.init_paged_cache(
            cfg.num_layers, pool, cfg.num_kv_heads, self.ps, cfg.head_dim,
            self.B, self.nb, self.engine.cache_dtype,
            device=self.engine.device)

    def _alloc_pages(self, n: int) -> List[int]:
        """Allocate, reclaiming unreferenced prefix-cache pages (least
        recently used first) under pool pressure."""
        if self.store is not None and n > self.alloc.free_pages:
            self.alloc.release(self.store.evict(n - self.alloc.free_pages))
        return self.alloc.allocate(n)

    def _ensure_blocks(self, slot: int, tokens_needed: int):
        """Grow `slot`'s pages to cover tokens_needed positions. Returns
        (ok, grew)."""
        need = (tokens_needed + self.ps - 1) // self.ps
        have = len(self.slot_pages[slot])
        if need <= have:
            return True, False
        try:
            new = self._alloc_pages(need - have)
        except MemoryError:
            return False, False
        self.slot_pages[slot].extend(new)
        self.pt_host[slot, have:need] = new
        return True, True

    def _preempt(self, slot: int) -> None:
        """Pool pressure: send `slot`'s request back to the queue front,
        reset for a replay, and free its pages. Its rows in the chunk not
        yet harvested are dropped (the replay may land in the same slot)."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.dstate_host[slot] = -1
        self.preemptions += 1
        if self._pending is not None:
            self._pending[4][slot] = None
        # an admission of this step whose first token is not read yet: the
        # replay samples it again (the reference appends it to the reset
        # request, so its replay starts with that token twice)
        self._admit_pend = [p for p in self._admit_pend if p[1] is not req]
        self._on_retire(slot)
        req.reset_generation()
        self.queue.appendleft(req)

    def _table_snapshot(self, table_np) -> torch.Tensor:
        """The host page table (or rows of it) on the device, from a fresh
        copy: the host table changes while chunks are queued."""
        return self._host_tensor(table_np)

    def _sync_table(self) -> None:
        self.cache = dataclasses.replace(
            self.cache, page_table=self._table_snapshot(self.pt_host))

    def _validate_capacity(self, prompt_len: int, max_new: int) -> None:
        need = (prompt_len + max_new + self.ps - 1) // self.ps
        usable = self.alloc.num_pages - 1          # page 0 is reserved
        if need > usable:
            raise ValueError(
                f"request needs {need} KV pages but the pool has {usable} "
                f"— it could never be admitted (raise num_pages or lower "
                f"max_new_tokens)")

    def _on_retire(self, slot: int) -> None:
        super()._on_retire(slot)
        for p in self.slot_pages[slot]:
            if self.store is not None and self.store.owns(p):
                self.store.release(p)       # stays cached for reuse
            else:
                self.alloc.release([p])
        self.slot_pages[slot] = []
        self.pt_host[slot] = 0              # the null page

    def _before_chunk(self, steps: int) -> bool:
        grew = False
        # grow the tables; under pool pressure preempt the youngest slot
        # (fewest sunk tokens) until the rest fit
        while True:
            starved = None
            for b, req in enumerate(self.slot_req):
                if req is None:
                    continue
                # a retiring request's full-chunk overshoot stops at S
                ok, g = self._ensure_blocks(
                    b, min(int(self.pos_host[b]) + steps + 1, self.S))
                grew |= g
                if not ok:
                    starved = b
            if starved is None:
                break
            victims = [b for b, r in enumerate(self.slot_req)
                       if r is not None]
            if len(victims) <= 1:
                return False     # a single request cannot fit: wait
            self._preempt(min(victims, key=lambda b: self.pos_host[b]))
            grew = True
        if grew:
            self._sync_table()
        active = False
        for b, req in enumerate(self.slot_req):
            if req is not None:
                self.pos_host[b] += steps
                active = True
        return active

    def _chunk_max(self) -> int:
        fitting = [b for b in self.engine.engine_cfg.prefill_buckets
                   if b <= self.S]
        chunk_max = max(fitting) if fitting else self.S
        return (chunk_max // self.ps) * self.ps or self.ps

    def _bucket(self, part: int, chunk_max: int) -> int:
        bucket = self.engine._bucket(min(part, chunk_max))
        return min(((bucket + self.ps - 1) // self.ps) * self.ps, chunk_max)

    def _table_width(self, blocks: int) -> int:
        """The page-table view's width for a chunk: the power of two of
        blocks covering it (the gather fallback reads width x ps slots)."""
        W = 1
        while W < blocks:
            W *= 2
        return min(W, self.nb)

    def _hashes(self, req: Request) -> List[bytes]:
        """Chain hashes of the prompt's full pages (none without a store),
        salted with the request's adapter slot: an adapter changes the K/V
        rows, so equal prompts under two adapters share no page (JAX
        scheduler.py:1216-1220)."""
        if self.store is None:
            return []
        return prefix_cache.chunk_hashes(
            req.prompt_ids, self.ps,
            salt=self.engine.resolve_adapter(req.adapter))

    def _map_hit(self, slot: int, hashes: List[bytes]) -> int:
        """Map the longest run of cached prefix pages into `slot`'s table;
        returns the number of pages."""
        if self.store is None:
            return 0
        hit_pages = self.store.lookup(hashes, self.ps)
        if hit_pages:
            self.slot_pages[slot] = list(hit_pages)
            self.pt_host[slot, :len(hit_pages)] = hit_pages
        return len(hit_pages)

    def _admit_one(self, slot: int, req: Request) -> bool:
        plen = len(req.prompt_ids)
        hashes = self._hashes(req)
        hit_blocks = self._map_hit(slot, hashes)
        hit_len = hit_blocks * self.ps
        suffix = plen - hit_len
        # the suffix runs as page-aligned chunks; chunk c attends over the
        # pages of the prefix hit and chunks < c
        chunk_max = self._chunk_max()
        done = 0
        logits = None
        while done < suffix:
            part = suffix - done
            bucket = min(self._bucket(part, chunk_max),
                         self.S - hit_len - done)
            ok, _ = self._ensure_blocks(slot, hit_len + done + bucket)
            if not ok:
                self._on_retire(slot)        # undo prefix refs and chunks
                self._sync_table()           # earlier chunks published it
                self.queue.appendleft(req)   # retry when pages free up
                return False
            self._sync_table()
            n_tok = min(part, bucket)
            o = hit_len + done
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :n_tok] = req.prompt_ids[o:o + n_tok]
            pos = (o + np.arange(bucket, dtype=np.int32))[None]
            W = self._table_width((o + bucket) // self.ps)
            cache1 = dataclasses.replace(
                self.cache,
                page_table=self._table_snapshot(self.pt_host[slot:slot + 1,
                                                              :W]))
            prefill = (self._prefill_hist if hit_blocks or done
                       else self._prefill_paged)
            logits, cache1 = prefill(
                self._host_tensor(ids), self._host_tensor(pos), cache1,
                torch.tensor([n_tok - 1], device=self.device),
                self._adapter_idx([req]))
            self.cache = dataclasses.replace(
                cache1, page_table=self._table_snapshot(self.pt_host))
            done += bucket
            if (self._interleave and done < suffix
                    and any(r is not None for r in self.slot_req)):
                # active requests keep decoding between a long admission's
                # chunks; the admitting row is parked on the null page
                self._interleave_decode([slot])
        for j in range(hit_blocks, len(hashes)):
            self.store.insert(hashes[j], self.slot_pages[slot][j])
        first = self._first_token_dispatch(slot, req, logits)
        self._set_tok_pos(slot, first, plen)
        self.pos_host[slot] = plen
        self.slot_req[slot] = req
        return True

    def _admit_batch(self, slots: List[int], reqs: List[Request]) -> None:
        """Admit k requests with one prefill per suffix chunk. The host
        half stays per request (prefix lookup, pages, store); each row's
        table row routes its writes, rows whose suffix ended earlier park
        on the null page, and position masks keep rows apart. A request
        whose prefix an earlier one of this wave is about to write waits
        one step, to hit those pages; a row that runs out of pages is
        undone and requeued."""
        infos = []
        deferred: List[Request] = []
        seen_hashes: set = set()
        for slot, req in zip(slots, reqs):
            hashes = self._hashes(req)
            if hashes and hashes[0] in seen_hashes:
                deferred.append(req)
                continue
            seen_hashes.update(hashes)
            hit_blocks = self._map_hit(slot, hashes)
            plen = len(req.prompt_ids)
            infos.append({"slot": slot, "req": req, "plen": plen,
                          "hashes": hashes, "hit_blocks": hit_blocks,
                          "hit_len": hit_blocks * self.ps,
                          "suffix": plen - hit_blocks * self.ps,
                          "alive": True, "logits": None})
        for req in reversed(deferred):
            self.queue.appendleft(req)
        k = len(infos)
        if not k:
            return
        chunk_max = self._chunk_max()
        failed: List[Request] = []
        done = 0
        while True:
            writing = [f for f in infos
                       if f["alive"] and f["suffix"] > done]
            if not writing:
                break
            part = max(f["suffix"] - done for f in writing)
            bucket = min([self._bucket(part, chunk_max)]
                         + [self.S - f["hit_len"] - done for f in writing])
            still = []
            for f in writing:
                ok, _ = self._ensure_blocks(
                    f["slot"], f["hit_len"] + done + bucket)
                if ok:
                    still.append(f)
                else:
                    self._on_retire(f["slot"])
                    f["alive"] = False
                    failed.append(f["req"])
            # publish before deciding: rows retired above must leave the
            # device table even when no row is left to prefill (the
            # reference breaks out first, scheduler.py:1392-1394)
            self._sync_table()
            if not still:
                break
            W = self._table_width(max(
                (f["hit_len"] + done + bucket) // self.ps for f in still))
            ids = np.zeros((k, bucket), np.int32)
            pos = np.zeros((k, bucket), np.int32)
            last = np.zeros((k,), np.int64)
            table = np.zeros((k, W), np.int32)
            for i, f in enumerate(infos):
                if not (f["alive"] and f["suffix"] > done):
                    continue            # parked: null-page row, pos 0
                n_tok = min(f["suffix"] - done, bucket)
                o = f["hit_len"] + done
                ids[i, :n_tok] = f["req"].prompt_ids[o:o + n_tok]
                pos[i] = o + np.arange(bucket, dtype=np.int32)
                last[i] = n_tok - 1
                table[i] = self.pt_host[f["slot"], :W]
            use_hist = done > 0 or any(f["hit_blocks"] for f in still)
            prefill = self._prefill_hist if use_hist else self._prefill_paged
            cache1 = dataclasses.replace(
                self.cache, page_table=self._table_snapshot(table))
            logits, cache1 = prefill(
                self._host_tensor(ids), self._host_tensor(pos), cache1,
                self._host_tensor(last), self._adapter_idx(
                    [f["req"] if f["alive"] and f["suffix"] > done
                     else None for f in infos]))   # parked rows: slot 0
            self.cache = dataclasses.replace(
                cache1, page_table=self._table_snapshot(self.pt_host))
            for i, f in enumerate(infos):
                if f["alive"] and done < f["suffix"] <= done + bucket:
                    f["logits"] = logits[i:i + 1]
            done += bucket
            if (self._interleave
                    and any(f["alive"] and f["suffix"] > done
                            for f in infos)
                    and any(r is not None for r in self.slot_req)):
                self._interleave_decode(
                    [f["slot"] for f in infos if f["alive"]])
        for req in reversed(failed):
            self.queue.appendleft(req)
        for f in infos:
            if not f["alive"]:
                continue
            slot, req = f["slot"], f["req"]
            if self.store is not None:
                for j in range(f["hit_blocks"], len(f["hashes"])):
                    self.store.insert(f["hashes"][j],
                                      self.slot_pages[slot][j])
            first = self._first_token_dispatch(slot, req, f["logits"])
            self._set_tok_pos(slot, first, f["plen"])
            self.pos_host[slot] = f["plen"]
            self.slot_req[slot] = req

    def _interleave_decode(self, admitting_slots: List[int]) -> None:
        """Decode one chunk for the active slots between an admission's
        prefill chunks, with the admitting rows parked on the null page
        (their garbage decode must not write into their half-prefilled,
        possibly shared, pages)."""
        # earlier admissions of this step decode here: their knobs and
        # first tokens must be settled first
        self._finish_admissions()
        steps = self.engine.engine_cfg.decode_chunk
        saved = self.pt_host[admitting_slots].copy()
        self.pt_host[admitting_slots] = 0
        ok = self._before_chunk(steps)
        self._sync_table()
        if ok:
            self._dispatch_decode(steps)
        self.pt_host[admitting_slots] = saved
        self._sync_table()
