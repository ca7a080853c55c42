"""HTTP serving front-end over the port's continuous-batching schedulers
(counterpart of `llm_inference_tpu/engine/server.py`), on the standard
library only:

- POST /generate    {"prompt": str | [int], "max_new_tokens"?, ...}
                    → {"request_id", "token_ids", "text", "ttft_s", ...}
                    ("stream": true: newline-delimited JSON, one object a
                    token, then {"done": true, ...})
- POST /cancel      {"request_id": n}
- GET  /health      → {"status": "ok", "queued": n, "active": n}
- GET  /metrics     → the engine's metrics as JSON, or the Prometheus text
                    form with ?format=prometheus (or Accept: text/plain)
- GET  /v1/models   → the served model and its LoRA adapters (--lora); a
                    request whose "model" names an adapter runs on it
- POST /v1/completions, /v1/chat/completions — OpenAI-compatible: n
  choices, best_of reranking, logprobs, the presence, frequency (and,
  beyond the JAX server's fields, repetition) penalties, seeds, stop,
  logit_bias (string token-id keys), response_format json_schema →
  guided decoding, echo and max_tokens: 0 prompt scoring through
  engine.score; "stream": true for SSE `data:` chunks ending in
  `data: [DONE]`
- POST /v1/embeddings — engine.embed, pooling "last" or "mean"

Guided decoding (engine/guided.py) is open on both surfaces:
`guided_choice` (strings, or token-id lists without a tokenizer),
`guided_regex` and `guided_json`.

Handler threads submit into the scheduler under one lock and wait on a
per-request event; one background thread runs `step()` in a loop. Scoring
and embedding run under the same lock, so the device only ever sees one
thread's work. If the step loop dies, every waiting and later request
answers 500 with its error, and /health reports it.

Speculative serving runs on the dense cache, greedy requests only
(engine/speculative.py): --speculative serves SpeculativeBatchingScheduler
(n-gram proposals, --gamma of them a window), --draft-model (a preset,
weights from --draft-checkpoint or drawn from a seed) serves
DraftSpeculativeBatchingScheduler. --lora NAME=PEFT_DIR (repeatable)
serves LoRA adapters beside the base model (cli.build_engine); a request
picks one by `adapter` or by an OpenAI `model` naming it. Tensor
parallelism through the schedulers (--tp > 1), with or without --lora,
and data parallelism (--dp > 1) are not ported: they raise
NotImplementedError at start-up.

    python -m llm_inference_tpu_torch.engine.server --device cpu \\
        --model tiny --quant int8 --port 8000 [--speculative | \\
        --draft-model tiny] [--gamma 4]
    python -m llm_inference_tpu_torch.engine.server --model llama2-7b \\
        --quant int4 --group-size 128 --kv-cache int8   # on the card
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from llm_inference_tpu_torch import cli
from llm_inference_tpu_torch.config import GenerationConfig
from llm_inference_tpu_torch.engine import guided
from llm_inference_tpu_torch.engine.engine import (InferenceEngine,
                                                   format_chat_messages)
from llm_inference_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler, PagedScheduler, Request)
from llm_inference_tpu_torch.engine.speculative import (
    DraftSpeculativeBatchingScheduler, SpeculativeBatchingScheduler)

logger = logging.getLogger("llm_inference_tpu_torch")


class BackendError(Exception):
    """The background step loop died: the request cannot be served."""


def _final_text(req, tok) -> str:
    """A finished request's completion text: trimmed at its stop string,
    or without the stop token's piece (the stream never emitted it)."""
    if req.final_text is not None:
        return req.final_text
    if tok is None:
        return ""
    ids = req.output_ids
    if req.finished and ids:
        ids = ids[:-1]
    return tok.decode(ids)


def _status(e: Exception) -> int:
    """The HTTP status of a failed request: 500 when the step loop died,
    400 for a request the server cannot take, 503 when the queue is full."""
    if isinstance(e, BackendError):
        return 500
    if isinstance(e, (ValueError, NotImplementedError)):
        return 400
    return 503


class ServingBackend:
    """Thread-safe wrapper: a scheduler, its background step loop and
    per-request completion events. Usable without sockets."""

    def __init__(self, engine: InferenceEngine,
                 gen: Optional[GenerationConfig] = None,
                 paged: bool = False, speculative: bool = False,
                 **sched_kw):
        """`speculative`: per-slot n-gram speculation; a `draft_engine`
        keyword: speculation from that draft model. Both are dense-only."""
        draft_engine = sched_kw.pop("draft_engine", None)
        if (speculative or draft_engine is not None) and paged:
            raise ValueError("speculative serving uses the dense "
                             "scheduler (no paged variant yet)")
        self.engine = engine
        if draft_engine is not None:
            self.sched = DraftSpeculativeBatchingScheduler(
                engine, draft_engine, gen, **sched_kw)
        else:
            cls = (SpeculativeBatchingScheduler if speculative
                   else PagedScheduler if paged
                   else ContinuousBatchingScheduler)
            self.sched = cls(engine, gen, **sched_kw)
        self.error: Optional[str] = None
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._done = {}
        self._reqs = {}
        self._done_at = {}                      # completion time, for GC
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- request side -------------------------------------------------------

    def _check_alive(self) -> None:
        if self.error is not None:
            raise BackendError(f"the scheduler loop died: {self.error}")

    def submit(self, prompt, max_new_tokens=None, on_token=None,
               **sampling):
        """Enqueue; returns the Request (pass it to wait()). `sampling`:
        the scheduler's per-request submit keywords."""
        with self._lock:
            self._check_alive()
            req = self.sched.submit(prompt, max_new_tokens,
                                    stream=on_token, **sampling)
            self._done[req.req_id] = threading.Event()
            self._reqs[req.req_id] = req
        self._wake.set()
        return req

    def cancel(self, req_id: int) -> bool:
        """Abort a queued or running request (frees its KV pages)."""
        with self._lock:
            req = self._reqs.get(req_id)
            if req is None or req.done_t > 0:
                return False
            return self.sched.cancel(req)

    def validate(self, prompt, max_new_tokens=None,
                 sampling=None) -> None:
        """Raise what submit would raise, without enqueuing: a streaming
        handler rejects before it commits its 200 status line."""
        with self._lock:
            self._check_alive()
            ids = self.engine._encode_prompts([prompt])[0]
            limit = max_new_tokens or self.sched.gen.max_new_tokens
            if len(ids) + limit > self.sched.S:
                raise ValueError(
                    f"prompt({len(ids)}) + max_new_tokens exceeds "
                    f"max_seq_len {self.sched.S}")
            if sampling:
                self.sched._resolve_sampling(
                    Request(req_id=-1, prompt_ids=[], max_new_tokens=1,
                            **sampling))
            queued = len(self.sched.queue)
            if queued >= self.engine.engine_cfg.max_queued_requests:
                raise RuntimeError("request queue full")

    def wait(self, req, timeout=None) -> bool:
        """Wait for the request's end; raises BackendError if the step
        loop died before it was served."""
        ev = self._done[req.req_id]
        ok = ev.wait(timeout)
        if ok:
            # collected: the entries leave the scan set
            self._done.pop(req.req_id, None)
            self._reqs.pop(req.req_id, None)
            self._done_at.pop(req.req_id, None)
        if self.error is not None and req.done_t == 0:
            self._check_alive()
        return ok

    def score(self, prompts):
        """engine.score, serialised with the step loop."""
        with self._lock:
            self._check_alive()
            return self.engine.score(prompts)

    def embed(self, prompts, pooling="last"):
        """engine.embed, serialised with the step loop."""
        with self._lock:
            self._check_alive()
            return self.engine.embed(prompts, pooling=pooling)

    # -- scheduler side ------------------------------------------------------

    def _loop(self):
        while not self._stop:
            with self._lock:
                try:
                    progressed = self.sched.step()
                except Exception as e:     # the loop's boundary
                    logger.exception("the scheduler loop died")
                    self.error = f"{type(e).__name__}: {e}"
                    for ev in self._done.values():
                        ev.set()           # every waiter answers 500
                    return
                for b_req, ev in list(self._done.items()):
                    if ev.is_set():
                        continue
                    # a request is complete once it left queue and slots
                    if (all(r is None or r.req_id != b_req
                            for r in self.sched.slot_req)
                            and all(q.req_id != b_req
                                    for q in self.sched.queue)):
                        ev.set()
                        self._done_at[b_req] = time.monotonic()
                # a waiter that gave up (timed-out wait, fire-and-forget
                # submit) leaves its entries: drop them a minute after
                # completion
                cutoff = time.monotonic() - 60.0
                for rid, at in list(self._done_at.items()):
                    if at < cutoff:
                        self._done.pop(rid, None)
                        self._reqs.pop(rid, None)
                        self._done_at.pop(rid, None)
            if not progressed:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)

    def stats(self):
        with self._lock:
            return {
                "queued": len(self.sched.queue),
                "active": sum(r is not None for r in self.sched.slot_req),
            }


def make_handler(backend: ServingBackend):
    tok = backend.engine.tokenizer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _openai_error(self, e: Exception):
            code = _status(e)
            kind = {400: "invalid_request_error", 500: "server_error",
                    503: "overloaded_error"}[code]
            self._json(code, {"error": {"message": str(e), "type": kind}})

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("the body must be a JSON object")
            return body

        def do_GET(self):
            if self.path == "/health":
                if backend.error is not None:
                    self._json(500, {"status": "error",
                                     "error": backend.error})
                else:
                    self._json(200, {"status": "ok", **backend.stats()})
            elif self.path.startswith("/metrics"):
                if ("format=prometheus" in self.path
                        or "text/plain" in (self.headers.get("Accept")
                                            or "")):
                    body = backend.engine.metrics.prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(200, backend.engine.metrics.snapshot())
            elif self.path == "/v1/models":
                names = ([backend.engine.cfg.name]
                         + sorted(backend.engine.adapter_slots))
                self._json(200, {"object": "list", "data": [
                    {"id": m, "object": "model",
                     "owned_by": "llm_inference_tpu_torch"} for m in names]})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path in ("/v1/completions", "/v1/chat/completions"):
                self._openai(chat=self.path.endswith("chat/completions"))
                return
            if self.path == "/v1/embeddings":
                self._embeddings()
                return
            if self.path == "/cancel":
                try:
                    rid = int(self._body()["request_id"])
                except (KeyError, ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                self._json(200, {"request_id": rid,
                                 "cancelled": backend.cancel(rid)})
                return
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                body = self._body()
                prompt = body["prompt"]
            except (KeyError, TypeError, ValueError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            max_new = body.get("max_new_tokens")
            samp = {k: body[k] for k in (
                "temperature", "top_k", "top_p", "greedy", "min_p",
                "repetition_penalty", "presence_penalty",
                "frequency_penalty", "seed", "stop_token_ids", "stop",
                "top_logprobs", "adapter", "logit_bias", "guided_choice",
                "guided_regex", "guided_json") if k in body}
            if body.get("stream"):
                self._generate_stream(prompt, max_new, samp)
                return
            try:
                req = backend.submit(prompt, max_new, **samp)
                backend.wait(req)
                resp = {
                    "request_id": req.req_id,
                    "token_ids": req.output_ids,
                    "text": _final_text(req, tok),
                    "finished": req.finished,
                    "ttft_s": req.ttft_s,
                }
                if body.get("logprobs"):
                    resp["token_logprobs"] = req.output_logprobs
                if body.get("prompt_logprobs"):
                    # per-token prompt logprobs; the first has none
                    resp["prompt_logprobs"] = backend.score([prompt])[0]
                if body.get("top_logprobs"):
                    resp["top_logprobs"] = [
                        [{"token_id": i, "logprob": v} for i, v in alts]
                        for alts in req.output_top_logprobs]
            except (ValueError, RuntimeError, BackendError) as e:
                self._json(_status(e), {"error": str(e)})
                return
            self._json(200, resp)

        def _generate_stream(self, prompt, max_new, samp):
            """Newline-delimited JSON, one object a token. Errors before
            the 200 status line are a status; after it, an object."""
            try:
                backend.validate(prompt, max_new, samp)
            except (ValueError, RuntimeError, BackendError) as e:
                self._json(_status(e), {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            hreq = []

            def on_token(rid, t):
                piece = tok.decode_token(t) if tok else ""
                chunk = json.dumps({"token_id": t, "text": piece}) + "\n"
                try:
                    self.wfile.write(chunk.encode())
                    self.wfile.flush()
                except OSError:
                    # the client is gone: cancel (its pages free at the
                    # next harvest). This runs on the scheduler thread,
                    # which must never see the socket's error.
                    if hreq:
                        hreq[0].cancelled = True
            try:
                req = backend.submit(prompt, max_new, on_token, **samp)
                hreq.append(req)
                backend.wait(req)
            except (ValueError, RuntimeError, BackendError) as e:
                self.wfile.write((json.dumps(
                    {"error": str(e), "done": True}) + "\n").encode())
                return
            tail = json.dumps({"done": True, "request_id": req.req_id,
                               "finished": req.finished}) + "\n"
            try:
                self.wfile.write(tail.encode())
            except OSError:
                pass

        def _embeddings(self):
            try:
                body = self._body()
                inp = body["input"]
                if isinstance(inp, str) or (
                        inp and isinstance(inp[0], int)):
                    inp = [inp]          # one string / one id list
                # encoded once: embed takes id lists as they are, and
                # usage counts the same tokens
                token_lists = backend.engine._encode_prompts(inp)
                vecs = backend.embed(token_lists,
                                     pooling=body.get("pooling", "last"))
            except (KeyError, TypeError, ValueError,
                    NotImplementedError) as e:
                self._json(400, {"error": {
                    "message": f"bad request: {e}",
                    "type": "invalid_request_error"}})
                return
            except BackendError as e:
                self._openai_error(e)
                return
            ntok = sum(len(t) for t in token_lists)
            self._json(200, {
                "object": "list",
                "model": backend.engine.cfg.name,
                "data": [{"object": "embedding", "index": i,
                          "embedding": v} for i, v in enumerate(vecs)],
                "usage": {"prompt_tokens": ntok, "total_tokens": ntok}})

        # -- OpenAI-compatible surface (/v1/completions, /v1/chat/...) ----

        def _openai(self, chat: bool):
            """OpenAI-shaped completions; `prompt` is a string (with a
            tokenizer) or a token-id list."""
            try:
                body = self._body()
                if chat:
                    if tok is None:
                        raise ValueError("chat endpoint needs a tokenizer")
                    prompt = format_chat_messages(
                        body["messages"], backend.engine.cfg.name)
                else:
                    prompt = body["prompt"]
            except (KeyError, TypeError, ValueError) as e:
                self._json(400, {"error": {"message": f"bad request: {e}",
                                           "type": "invalid_request_error"}})
                return
            max_new = body.get("max_tokens")
            # the JAX server's fields, and repetition_penalty (a common
            # extension of the OpenAI body)
            samp = {k: body[k] for k in (
                "temperature", "top_p", "presence_penalty",
                "frequency_penalty", "repetition_penalty", "seed", "stop",
                "guided_choice", "guided_regex", "guided_json") if k in body}
            # OpenAI logit_bias arrives with string token-id keys
            if body.get("logit_bias"):
                try:
                    samp["logit_bias"] = {int(k): float(v) for k, v
                                          in body["logit_bias"].items()}
                except (AttributeError, TypeError, ValueError):
                    self._json(400, {"error": {
                        "message": "logit_bias must map token ids to "
                                   "numbers",
                        "type": "invalid_request_error"}})
                    return
            # structured outputs: response_format json_schema → a guided
            # JSON schema; json_object → depth-bounded free-form JSON
            rf = body.get("response_format")
            if isinstance(rf, dict) and rf.get("type") == "json_schema":
                try:
                    samp["guided_json"] = rf["json_schema"]["schema"]
                except (KeyError, TypeError):
                    self._json(400, {"error": {
                        "message": "response_format.json_schema.schema "
                                   "missing",
                        "type": "invalid_request_error"}})
                    return
            elif isinstance(rf, dict) and rf.get("type") == "json_object":
                samp["guided_regex"] = guided.json_value_regex(2)
            # `logprobs: N` → the top-N alternatives of each token (true
            # counts as 1, as in the JAX server)
            lp_n = body.get("logprobs")
            if isinstance(lp_n, int) and lp_n > 0:
                samp["top_logprobs"] = lp_n
            if body.get("model") in backend.engine.adapter_slots:
                samp["adapter"] = body["model"]
            n = int(body.get("n", 1) or 1)
            if not 1 <= n <= 16:
                self._json(400, {"error": {"message": f"n={n} out of "
                                           "range [1, 16]",
                                           "type": "invalid_request_error"}})
                return
            # scoring: echo returns the prompt (with its logprobs when
            # logprobs is set); max_tokens: 0 generates nothing
            echo = bool(body.get("echo")) and not chat
            scoring_only = max_new == 0
            pscore = None
            try:
                if (echo or scoring_only) and body.get("logprobs"):
                    pscore = backend.score([prompt])[0]
                if scoring_only:
                    pids = backend.engine._encode_prompts([prompt])[0]
                    ptxt = (prompt if isinstance(prompt, str)
                            else tok.decode(pids) if tok else "")
                    choice = {"index": 0, "finish_reason": "stop",
                              "text": ptxt if echo else "",
                              "token_ids": []}
                    if pscore is not None:
                        choice["logprobs"] = {
                            "token_logprobs": pscore, "tokens": pids}
                    self._json(200, {
                        "id": "cmpl-score", "object": "text_completion",
                        "model": backend.engine.cfg.name,
                        "choices": [choice],
                        "usage": {"prompt_tokens": len(pids),
                                  "completion_tokens": 0,
                                  "total_tokens": len(pids)}})
                    return
            except (ValueError, NotImplementedError, BackendError) as e:
                self._openai_error(e)
                return
            if body.get("stream"):
                if int(body.get("best_of", n) or n) > n:
                    self._json(400, {"error": {
                        "message": "best_of cannot be used with stream",
                        "type": "invalid_request_error"}})
                    return
                self._openai_stream(prompt, max_new, samp, n, chat)
                return
            # n completions: n requests with seeds seed + i when the body
            # pins one; best_of > n generates more and keeps the n with
            # the highest mean token logprob
            best_of = int(body.get("best_of", n) or n)
            if best_of < n or best_of > 16:
                self._json(400, {"error": {
                    "message": f"best_of={best_of} must be in [n, 16]",
                    "type": "invalid_request_error"}})
                return
            reqs = []
            try:
                for i in range(best_of):
                    samp_i = dict(samp)
                    if "seed" in samp_i and best_of > 1:
                        samp_i["seed"] = int(samp_i["seed"]) + i
                    reqs.append(backend.submit(prompt, max_new, **samp_i))
                for req in reqs:
                    backend.wait(req)
                # usage counts every generated candidate
                generated_toks = sum(len(r.output_ids) for r in reqs)
                if best_of > n:
                    reqs.sort(key=lambda r: -(
                        sum(r.output_logprobs) / max(len(r.output_logprobs),
                                                     1)))
                    reqs = reqs[:n]
            except (ValueError, RuntimeError, BackendError) as e:
                for r in reqs:
                    backend.cancel(r.req_id)
                self._openai_error(e)
                return
            choices = []
            for i, req in enumerate(reqs):
                text = _final_text(req, tok)
                finish = "stop" if req.finished else "length"
                if chat:
                    choice = {"index": i, "finish_reason": finish,
                              "message": {"role": "assistant",
                                          "content": text}}
                else:
                    choice = {"index": i, "finish_reason": finish,
                              "text": text, "token_ids": req.output_ids}
                    if req.output_top_logprobs:
                        toks_txt = ([tok.decode_token(t) for t in
                                     req.output_ids] if tok
                                    else [str(t) for t in req.output_ids])
                        choice["logprobs"] = {
                            "tokens": toks_txt,
                            "token_logprobs": req.output_logprobs,
                            "top_logprobs": [
                                {(tok.decode_token(i2) if tok else str(i2)):
                                 v for i2, v in alts}
                                for alts in req.output_top_logprobs],
                        }
                if body.get("logprobs") and "logprobs" not in choice:
                    # logprobs true/0: the chosen tokens' logprobs only
                    choice["logprobs"] = {
                        "token_logprobs": req.output_logprobs,
                        "tokens": req.output_ids,
                    }
                if echo:
                    ptxt = (prompt if isinstance(prompt, str)
                            else tok.decode(req.prompt_ids) if tok else "")
                    choice["text"] = ptxt + choice.get("text", "")
                    choice["token_ids"] = (list(req.prompt_ids)
                                           + choice.get("token_ids", []))
                    if pscore is not None and "logprobs" in choice:
                        lp = choice["logprobs"]
                        lp["token_logprobs"] = (pscore
                                                + lp["token_logprobs"])
                        lp["tokens"] = (list(req.prompt_ids)
                                        + list(lp["tokens"]))
                choices.append(choice)
            obj = "chat.completion" if chat else "text_completion"
            usage = {"prompt_tokens": len(reqs[0].prompt_ids),
                     "completion_tokens": generated_toks,
                     "total_tokens": len(reqs[0].prompt_ids)
                                     + generated_toks}
            self._json(200, {
                "id": f"cmpl-{reqs[0].req_id}", "object": obj,
                "model": backend.engine.cfg.name,
                "choices": choices, "usage": usage,
            })

        def _openai_stream(self, prompt, max_new, samp, n, chat):
            """SSE: `data: {chunk}` a token, interleaved by choice index
            for n > 1, then one finish chunk a choice and `data: [DONE]`.
            Chat chunks carry delta.content (the role on the first),
            completions chunks text and token_id."""
            try:
                backend.validate(prompt, max_new, samp)
            except (ValueError, RuntimeError, BackendError) as e:
                self._openai_error(e)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            obj = ("chat.completion.chunk" if chat
                   else "text_completion")
            model = backend.engine.cfg.name
            lock = threading.Lock()
            sent_role = [False] * n
            reqs = []

            def write_sse(payload):
                try:
                    self.wfile.write(f"data: {payload}\n\n".encode())
                    self.wfile.flush()
                    return True
                except OSError:
                    for r in reqs:
                        r.cancelled = True    # the client is gone
                    return False

            def on_token_for(idx):
                def on_token(rid, t):
                    piece = tok.decode_token(t) if tok else str(t)
                    if chat:
                        delta = {"content": piece}
                        if not sent_role[idx]:
                            delta = {"role": "assistant", "content": piece}
                            sent_role[idx] = True
                        choice = {"index": idx, "delta": delta,
                                  "finish_reason": None}
                    else:
                        choice = {"index": idx, "text": piece,
                                  "token_id": t, "finish_reason": None}
                    with lock:
                        write_sse(json.dumps({
                            "id": f"cmpl-{rid}", "object": obj,
                            "model": model, "choices": [choice]}))
                return on_token

            try:
                for i in range(n):
                    samp_i = dict(samp)
                    if "seed" in samp_i and n > 1:
                        samp_i["seed"] = int(samp_i["seed"]) + i
                    reqs.append(backend.submit(
                        prompt, max_new, on_token_for(i), **samp_i))
                for req in reqs:
                    backend.wait(req)
            except (ValueError, RuntimeError, BackendError) as e:
                # the status line is sent: report in the stream
                for r in reqs:
                    backend.cancel(r.req_id)
                with lock:
                    write_sse(json.dumps({"error": str(e)}))
                    write_sse("[DONE]")
                return
            with lock:
                for i, req in enumerate(reqs):
                    finish = "stop" if req.finished else "length"
                    choice = ({"index": i, "delta": {},
                               "finish_reason": finish} if chat else
                              {"index": i, "text": "",
                               "finish_reason": finish})
                    write_sse(json.dumps({
                        "id": f"cmpl-{req.req_id}", "object": obj,
                        "model": model, "choices": [choice]}))
                write_sse("[DONE]")

    return Handler


def warmup(backend: ServingBackend) -> None:
    """Serve throwaway requests through every prefill bucket (the largest
    included) and a full decode chunk before real traffic, so that the
    first request does not pay the kernels' build and first launches."""
    ecfg = backend.engine.engine_cfg
    want = ecfg.decode_chunk + 1   # a budget covering a full decode chunk
    buckets = [b for b in ecfg.prefill_buckets if b <= ecfg.max_seq_len]
    for b in buckets:
        # the longest prompt in bucket b that leaves `want` slots
        plen = min(b, ecfg.max_seq_len - want)
        if plen < 1:
            continue
        req = backend.submit([1] * plen, want)
        backend.wait(req)


def serve(engine: InferenceEngine, host: str = "0.0.0.0", port: int = 8000,
          gen: Optional[GenerationConfig] = None, paged: bool = False,
          speculative: bool = False, warm: bool = False,
          **sched_kw) -> ThreadingHTTPServer:
    """Start the backend and bind the HTTP server (returned; call
    .serve_forever(), and .shutdown() then .backend.shutdown() to stop)."""
    backend = ServingBackend(engine, gen, paged=paged,
                             speculative=speculative, **sched_kw)
    if warm:
        warmup(backend)
    httpd = ThreadingHTTPServer((host, port), make_handler(backend))
    httpd.backend = backend
    return httpd


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="LLM HTTP server on the "
                                             "PyTorch port")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share identical prompt-prefix KV pages across "
                         "requests (implies --paged)")
    ap.add_argument("--speculative", action="store_true",
                    help="n-gram speculative decoding per slot "
                         "(greedy-only; dense scheduler)")
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculative window width (proposed tokens)")
    ap.add_argument("--draft-model", default=None,
                    help="preset name of a DRAFT model for two-model "
                         "speculative serving (greedy-only)")
    ap.add_argument("--draft-checkpoint", default=None,
                    help="HF safetensors dir for the draft's weights "
                         "(else weights drawn from a seed)")
    ap.add_argument("--slots", type=int, default=None)
    cli.add_engine_args(ap)         # --tp and --dp above 1 are not ported
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--greedy", action="store_true", default=True,
                    help="accepted for the JAX server's sake: requests "
                         "decode greedily unless they ask otherwise")
    ap.add_argument("--warmup", action="store_true",
                    help="serve a request through every prefill bucket "
                         "before accepting traffic")
    return ap.parse_args(argv)


def make_server(argv=None) -> ThreadingHTTPServer:
    """The server main() starts, bound but not yet serving. Flags whose
    machinery the port lacks raise NotImplementedError before anything
    is built."""
    args = parse_args(argv)
    for flag, on, why in (
            ("--tp > 1", args.tp > 1, "the schedulers over a tensor-"
             "parallel engine are not ported yet"),
            ("--dp > 1", args.dp > 1, "data parallelism is not ported "
             "yet")):
        if on:
            raise NotImplementedError(f"{flag}: {why}")
    engine = cli.build_engine(args)
    gen = GenerationConfig(greedy=True, max_new_tokens=args.max_new_tokens)
    kw = {"prefix_cache": True} if args.prefix_cache else {}
    if args.speculative or args.draft_model:
        kw["gamma"] = args.gamma
    if args.draft_model:
        dargs = copy.copy(args)
        dargs.model = args.draft_model
        dargs.checkpoint = args.draft_checkpoint
        dargs.tp = dargs.dp = 1            # the draft stays on one device
        dargs.lora = None                  # and serves the base model
        kw["draft_engine"] = cli.build_engine(dargs)
    return serve(engine, args.host, args.port, gen,
                 paged=args.paged or args.prefix_cache,
                 speculative=args.speculative, warm=args.warmup,
                 slots=args.slots, **kw)


def main(argv=None):
    httpd = make_server(argv)
    host, port = httpd.server_address[:2]
    print(f"serving on {host}:{port}", file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.backend.shutdown()


if __name__ == "__main__":
    main()
