"""The port's HTTP server (llm_inference_tpu_torch.engine.server) on the
CPU, over real sockets on 127.0.0.1: tests/test_server.py's classes
against the port (batch, streaming, health and metrics, the OpenAI /v1
surface, cancellation, logprobs, sampling knobs, n and best_of, SSE,
guided decoding and logit_bias, scoring and echo, embeddings, Prometheus
metrics, speculative serving), a parity class that sends the same
bodies to a JAX server and a port server on the same weights, the
speculative flags and those that are not ported, a step loop that dies,
and the command-line entry point."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from llm_inference_tpu.config import GenerationConfig as JGenerationConfig
from llm_inference_tpu.engine import server as j_srv

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            tiny_llama)
from llm_inference_tpu_torch.engine import server as srv
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler, PagedScheduler)
from llm_inference_tpu_torch.engine.speculative import (
    DraftSpeculativeBatchingScheduler, SpeculativeBatchingScheduler)
from llm_inference_tpu_torch.models import llama

from torch_bridge import engine_pair

ECFG = dict(max_seq_len=64, decode_chunk=4, max_batch_size=2,
            prefill_buckets=(8, 16))
GEN6 = GenerationConfig(greedy=True, max_new_tokens=6, eos_token_ids=(1,))


def _engine(tokenizer=None, **kw):
    cfg = tiny_llama(num_kv_heads=2)
    return InferenceEngine(
        cfg, llama.init_params(cfg, seed=0, device="cpu"),
        engine_cfg=EngineConfig(**dict(ECFG, **kw)), tokenizer=tokenizer,
        device="cpu")


def _start(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def _stop(httpd):
    httpd.shutdown()
    httpd.backend.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def httpd():
    h = _start(srv.serve(_engine(), host="127.0.0.1", port=0, gen=GEN6))
    yield h
    _stop(h)


def _url(httpd, path):
    return f"http://127.0.0.1:{httpd.server_address[1]}{path}"


def _post(httpd, obj, path="/generate"):
    req = urllib.request.Request(
        _url(httpd, path), data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _status(httpd, obj, path="/generate"):
    """The HTTP error status of a request that must fail, and its body."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(httpd, obj, path)
    return e.value.code, json.loads(e.value.read())


def _generate(eng, prompt):
    return eng.generate([list(prompt)], GEN6)[0].token_ids


class TestServer:
    def test_generate(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "max_new_tokens": 5}) as r:
            out = json.load(r)
        assert len(out["token_ids"]) <= 5 and out["ttft_s"] > 0

    def test_generate_matches_engine(self, httpd):
        want = _generate(httpd.backend.engine, [9, 10, 11])
        with _post(httpd, {"prompt": [9, 10, 11]}) as r:
            assert json.load(r)["token_ids"] == want

    def test_concurrent_requests(self, httpd):
        rng = np.random.default_rng(0)
        prompts = [list(map(int, rng.integers(2, 200, 4))) for _ in range(6)]
        results = {}

        def one(i):
            with _post(httpd, {"prompt": prompts[i]}) as r:
                results[i] = json.load(r)
        ts = [threading.Thread(target=one, args=(i,))
              for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert len(results) == len(prompts)
        eng = httpd.backend.engine
        for i, p in enumerate(prompts):
            assert results[i]["token_ids"] == _generate(eng, p), i

    def test_streaming(self, httpd):
        with _post(httpd, {"prompt": [4, 5], "stream": True}) as r:
            lines = [json.loads(line) for line in r.read().splitlines()]
        assert lines[-1]["done"] is True
        assert all("token_id" in line for line in lines[:-1])

    def test_health_and_metrics(self, httpd):
        with urllib.request.urlopen(_url(httpd, "/health"), timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        with urllib.request.urlopen(_url(httpd, "/metrics"), timeout=30) as r:
            assert any(k.startswith("ttft_s") for k in json.load(r))

    @pytest.mark.parametrize("body", [{"nope": 1}, [5, 6, 7],
                                      {"prompt": list(range(2, 200)),
                                       "max_new_tokens": 5}])
    @pytest.mark.parametrize("path", ["/generate", "/v1/completions",
                                      "/v1/embeddings"])
    def test_bad_and_oversized_requests_are_400(self, httpd, body, path):
        if path == "/v1/completions" and isinstance(body, dict):
            body = dict(body, max_tokens=body.get("max_new_tokens"))
        assert _status(httpd, body, path)[0] == 400


class TestOpenAICompat:
    def test_completions(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "max_tokens": 4},
                   path="/v1/completions") as r:
            out = json.load(r)
        assert out["object"] == "text_completion"
        c = out["choices"][0]
        assert len(c["token_ids"]) == 4
        assert c["finish_reason"] in ("stop", "length")
        assert out["usage"]["total_tokens"] == 7

    def test_completions_matches_generate(self, httpd):
        with _post(httpd, {"prompt": [9, 10, 11], "max_new_tokens": 5}) as r:
            want = json.load(r)["token_ids"]
        with _post(httpd, {"prompt": [9, 10, 11], "max_tokens": 5},
                   path="/v1/completions") as r:
            assert json.load(r)["choices"][0]["token_ids"] == want

    def test_chat_without_tokenizer_is_400(self, httpd):
        code, _ = _status(httpd, {"messages": [{"role": "user",
                                                "content": "x"}]},
                          "/v1/chat/completions")
        assert code == 400

    def test_oversized_is_400_openai_shape(self, httpd):
        code, body = _status(httpd, {"prompt": [5], "max_tokens": 4000},
                             "/v1/completions")
        assert code == 400
        assert body["error"]["type"] == "invalid_request_error"


class TestCancellation:
    def test_cancel_queued_request(self, httpd):
        b = httpd.backend
        reqs = [b.submit([5, 6, 7], 6) for _ in range(3)]
        assert b.cancel(reqs[2].req_id) in (True, False)
        for r in reqs:
            assert b.wait(r, timeout=120)
        assert reqs[2].cancelled or len(reqs[2].output_ids) == 6

    def test_cancel_endpoint(self, httpd):
        req = httpd.backend.submit([9, 10, 11], 6)
        with _post(httpd, {"request_id": req.req_id}, path="/cancel") as r:
            assert json.load(r)["request_id"] == req.req_id
        assert httpd.backend.wait(req, timeout=120)

    def test_cancel_mid_generation_stops_early(self):
        """A running request flagged cancelled retires at the next harvest
        with fewer tokens than its budget, and its pages return."""
        engine = _engine(decode_chunk=2, page_size=8)
        sched = PagedScheduler(engine, GenerationConfig(
            greedy=True, max_new_tokens=30, eos_token_ids=()), slots=1)
        free0 = sched.alloc.free_pages
        req = sched.submit([5, 6, 7, 8])
        steps = 0
        while sched.step():
            steps += 1
            if steps == 3:
                sched.cancel(req)
        assert req.cancelled and len(req.output_ids) < 30
        assert sched.alloc.free_pages == free0


class TestStopTokensAndWarmup:
    def test_stop_token_ends_generation(self, httpd):
        b = httpd.backend
        ref = b.submit([7, 8, 9], 6)
        b.wait(ref, timeout=120)
        assert len(ref.output_ids) >= 3
        stop = ref.output_ids[2]
        req = b.submit([7, 8, 9], 6, stop_token_ids=[stop])
        b.wait(req, timeout=120)
        assert req.finished
        first = ref.output_ids.index(stop)
        assert req.output_ids == ref.output_ids[:first + 1]

    def test_warmup_runs_every_bucket(self, httpd):
        srv.warmup(httpd.backend)
        r = httpd.backend.submit([5, 6], 2)
        assert httpd.backend.wait(r, timeout=120)


class TestLogprobs:
    def test_logprobs_returned_and_consistent(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "max_new_tokens": 5,
                           "logprobs": True}) as r:
            out = json.load(r)
        lps = out["token_logprobs"]
        assert len(lps) == len(out["token_ids"]) == 5
        assert all(lp <= 0.0 for lp in lps)

    @pytest.mark.parametrize("n", [1, 2])
    def test_openai_logprobs_shape(self, httpd, n):
        with _post(httpd, {"prompt": [5, 6, 7], "max_tokens": 4,
                           "logprobs": n}, path="/v1/completions") as r:
            lp = json.load(r)["choices"][0]["logprobs"]
        assert len(lp["tokens"]) == len(lp["token_logprobs"]) == 4
        assert all(len(d) == n for d in lp["top_logprobs"])

    def test_generate_top_logprobs(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "greedy": True,
                           "max_new_tokens": 4, "logprobs": True,
                           "top_logprobs": 3}) as r:
            out = json.load(r)
        assert len(out["top_logprobs"]) == len(out["token_ids"])
        first = out["top_logprobs"][0]
        assert len(first) == 3 and first[0]["token_id"] == out["token_ids"][0]


class TestProductionSamplingHTTP:
    def test_seeded_sampling_reproducible(self, httpd):
        body = {"prompt": [3, 4, 5], "temperature": 2.0, "seed": 123,
                "max_new_tokens": 8}
        with _post(httpd, body) as r:
            a = json.load(r)["token_ids"]
        with _post(httpd, body) as r:
            assert json.load(r)["token_ids"] == a
        with _post(httpd, {**body, "seed": 124}) as r:
            assert json.load(r)["token_ids"] != a

    def test_penalties_and_min_p_accepted(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "max_new_tokens": 8,
                           "greedy": True, "presence_penalty": 1000.0,
                           "repetition_penalty": 2.0,
                           "frequency_penalty": 0.1}) as r:
            out = json.load(r)["token_ids"]
        assert len(set(out)) == len(out)
        with _post(httpd, {"prompt": [5, 6, 7], "min_p": 0.5,
                           "temperature": 1.0, "max_new_tokens": 4}) as r:
            assert len(json.load(r)["token_ids"]) <= 4

    @pytest.mark.parametrize("body", [{"min_p": 1.5},
                                      {"repetition_penalty": -1.0},
                                      {"adapter": "x"}])
    def test_bad_knobs_are_400(self, httpd, body):
        assert _status(httpd, {"prompt": [5, 6], **body})[0] == 400


class TestNCompletions:
    def test_openai_n_choices(self, httpd):
        body = {"prompt": [5, 6, 7], "max_tokens": 4, "n": 3,
                "temperature": 2.0, "seed": 5}
        with _post(httpd, body, path="/v1/completions") as r:
            out = json.load(r)
        ch = out["choices"]
        assert [c["index"] for c in ch] == [0, 1, 2]
        assert out["usage"]["completion_tokens"] == sum(
            len(c["token_ids"]) for c in ch)
        assert len({tuple(c["token_ids"]) for c in ch}) > 1
        with _post(httpd, body, path="/v1/completions") as r:
            again = json.load(r)
        assert ([c["token_ids"] for c in again["choices"]]
                == [c["token_ids"] for c in ch])

    def test_openai_n_out_of_range(self, httpd):
        assert _status(httpd, {"prompt": [5, 6], "n": 99},
                       "/v1/completions")[0] == 400


class TestOpenAIStreaming:
    @staticmethod
    def _sse_events(resp):
        return [line[len("data: "):] for line in
                resp.read().decode().splitlines()
                if line.startswith("data: ")]

    def test_completions_sse(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "max_tokens": 4,
                           "stream": True}, path="/v1/completions") as r:
            assert r.headers["Content-Type"].startswith("text/event-stream")
            events = self._sse_events(r)
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        toks = [c["choices"][0]["token_id"] for c in chunks
                if c["choices"][0]["finish_reason"] is None]
        assert len(toks) == 4
        assert chunks[-1]["choices"][0]["finish_reason"] in ("stop",
                                                            "length")
        with _post(httpd, {"prompt": [5, 6, 7], "max_tokens": 4},
                   path="/v1/completions") as r:
            assert toks == json.load(r)["choices"][0]["token_ids"]

    def test_completions_sse_n2_interleaved(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "max_tokens": 3, "n": 2,
                           "temperature": 2.0, "seed": 4, "stream": True},
                   path="/v1/completions") as r:
            events = self._sse_events(r)
        assert events[-1] == "[DONE]"
        per_idx = {0: [], 1: []}
        finishes = set()
        for e in events[:-1]:
            c = json.loads(e)["choices"][0]
            if c["finish_reason"] is None:
                per_idx[c["index"]].append(c["token_id"])
            else:
                finishes.add(c["index"])
        assert len(per_idx[0]) == 3 and len(per_idx[1]) == 3
        assert finishes == {0, 1}


class TestGuidedAndBiasHTTP:
    def test_guided_choice_generate(self, httpd):
        choices = [[5, 9, 11], [7, 13]]
        with _post(httpd, {"prompt": [1, 2, 3],
                           "guided_choice": choices}) as r:
            ids = json.load(r)["token_ids"]
        if ids and ids[-1] == 1:          # the stop token ends the list
            ids = ids[:-1]
        assert ids in choices

    @pytest.mark.parametrize("path,key", [("/generate", "max_new_tokens"),
                                          ("/v1/completions", "max_tokens")])
    def test_logit_bias_string_keys(self, httpd, path, key):
        with _post(httpd, {"prompt": [5, 6, 7], key: 4,
                           "logit_bias": {"17": 100.0}}, path=path) as r:
            out = json.load(r)
        ids = out["token_ids"] if path == "/generate" else \
            out["choices"][0]["token_ids"]
        assert ids == [17] * 4

    def test_guided_regex_without_tokenizer_is_error(self, httpd):
        code, body = _status(httpd, {"prompt": [1, 2], "guided_regex": "a+"})
        assert code == 400 and "tokenizer" in body["error"]

    @pytest.mark.parametrize("extra", [
        {"logit_bias": {"x": "y"}},
        {"response_format": {"type": "json_schema"}},
        {"response_format": {"type": "json_object"}}])
    def test_openai_bad_guided_or_bias_is_400(self, httpd, extra):
        code, body = _status(httpd, {"prompt": [5, 6], "max_tokens": 2,
                                     **extra}, "/v1/completions")
        assert code == 400
        if extra.get("response_format", {}).get("type") == "json_object":
            assert "tokenizer" in json.dumps(body)


class TestScoringAndEcho:
    def test_max_tokens_zero_scores_prompt(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7, 8], "max_tokens": 0,
                           "logprobs": True}, path="/v1/completions") as r:
            out = json.load(r)
        ch = out["choices"][0]
        assert ch["token_ids"] == [] and out["usage"]["completion_tokens"] == 0
        lps = ch["logprobs"]["token_logprobs"]
        assert lps[0] is None and len(lps) == 4
        assert all(isinstance(v, float) and v <= 0 for v in lps[1:])

    def test_scoring_matches_engine_score(self, httpd):
        prompt = [9, 10, 11, 12]
        want = httpd.backend.engine.score([prompt])[0]
        with _post(httpd, {"prompt": prompt, "max_tokens": 0,
                           "logprobs": True}, path="/v1/completions") as r:
            got = json.load(r)["choices"][0]["logprobs"]["token_logprobs"]
        assert got[0] is None
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5)

    def test_echo_prepends_prompt(self, httpd):
        prompt = [5, 6, 7]
        with _post(httpd, {"prompt": prompt, "max_tokens": 3,
                           "echo": True, "logprobs": True},
                   path="/v1/completions") as r:
            ch = json.load(r)["choices"][0]
        assert ch["token_ids"][:3] == prompt and len(ch["token_ids"]) > 3
        lps = ch["logprobs"]["token_logprobs"]
        assert lps[0] is None and len(lps) == len(ch["token_ids"])

    def test_generate_prompt_logprobs(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "max_new_tokens": 2,
                           "prompt_logprobs": True}) as r:
            out = json.load(r)
        assert out["prompt_logprobs"][0] is None
        assert len(out["prompt_logprobs"]) == 3


class TestModelsAndBestOf:
    def test_v1_models_lists_base(self, httpd):
        with urllib.request.urlopen(_url(httpd, "/v1/models"),
                                    timeout=30) as r:
            ids = [m["id"] for m in json.load(r)["data"]]
        assert ids == [httpd.backend.engine.cfg.name]

    def test_best_of_keeps_top_mean_logprob(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "max_tokens": 3, "n": 2,
                           "best_of": 4, "temperature": 2.0, "seed": 11,
                           "logprobs": True}, path="/v1/completions") as r:
            out = json.load(r)
        assert len(out["choices"]) == 2
        means = [sum(c["logprobs"]["token_logprobs"])
                 / len(c["logprobs"]["token_logprobs"])
                 for c in out["choices"]]
        assert means[0] >= means[1] - 1e-9

    @pytest.mark.parametrize("body", [{"n": 3, "best_of": 2},
                                      {"best_of": 3, "stream": True}])
    def test_best_of_rejected(self, httpd, body):
        assert _status(httpd, {"prompt": [5, 6], "max_tokens": 2, **body},
                       "/v1/completions")[0] == 400


class TestSpeculativeServing:
    """Speculative serving (test_server.py's class on the port), the
    flags that build it, and the flags that are still not ported (LoRA,
    tensor or data parallelism), which raise at start-up."""

    @staticmethod
    def _greedy(backend, prompt):
        r = backend.submit(prompt)
        backend.wait(r, timeout=120)
        backend.shutdown()
        return r

    def test_speculative_backend_matches_plain(self):
        eng = _engine(max_seq_len=128, prefill_buckets=(8, 16, 32))
        gen = GenerationConfig(greedy=True, max_new_tokens=16,
                               eos_token_ids=(1,))
        w = self._greedy(srv.ServingBackend(eng, gen, slots=2),
                         [3, 4, 5, 6] * 4)
        spec = srv.ServingBackend(eng, gen, speculative=True, slots=2,
                                  gamma=4)
        assert isinstance(spec.sched, SpeculativeBatchingScheduler)
        g = self._greedy(spec, [3, 4, 5, 6] * 4)
        assert g.output_ids == w.output_ids
        assert spec.sched.spec_stats["accepted"] > 0

    @pytest.mark.parametrize("draft", [False, True])
    def test_speculative_plus_paged_rejected(self, draft):
        eng = _engine()
        kw = dict(draft_engine=eng) if draft else dict(speculative=True)
        with pytest.raises(ValueError, match="dense"):
            srv.ServingBackend(eng, paged=True, **kw)

    def test_draft_backend_matches_plain(self):
        eng = _engine(max_seq_len=128, prefill_buckets=(8, 16, 32))
        cfg = tiny_llama(num_kv_heads=2)
        draft = InferenceEngine(
            cfg, llama.init_params(cfg, seed=3, device="cpu"),
            engine_cfg=eng.engine_cfg, device="cpu")
        gen = GenerationConfig(greedy=True, max_new_tokens=12,
                               eos_token_ids=(1,))
        w = self._greedy(srv.ServingBackend(eng, gen, slots=2),
                         [3, 4, 5, 6])
        spec = srv.ServingBackend(eng, gen, slots=2, gamma=3,
                                  draft_engine=draft)
        assert isinstance(spec.sched, DraftSpeculativeBatchingScheduler)
        assert self._greedy(spec, [3, 4, 5, 6]).output_ids == w.output_ids

    @pytest.mark.parametrize("flags,cls,gamma", [
        (["--speculative"], SpeculativeBatchingScheduler, 4),
        (["--speculative", "--gamma", "3"], SpeculativeBatchingScheduler, 3),
        (["--draft-model", "tiny"], DraftSpeculativeBatchingScheduler, 4),
        (["--gamma", "3"], ContinuousBatchingScheduler, None)])
    def test_speculative_flags_build_their_scheduler(self, flags, cls,
                                                     gamma):
        """make_server on the CPU: --speculative, --gamma and --draft-model
        build the scheduler they name (--gamma alone changes nothing), and
        it serves a request."""
        h = _start(srv.make_server(
            ["--device", "cpu", "--host", "127.0.0.1", "--port", "0",
             "--max-seq-len", "128", "--max-new-tokens", "4"] + flags))
        try:
            assert type(h.backend.sched) is cls
            assert getattr(h.backend.sched, "gamma", None) == gamma
            with _post(h, {"prompt": [5, 6, 7], "max_tokens": 4},
                       "/v1/completions") as r:
                assert len(json.load(r)["choices"][0]["token_ids"]) == 4
        finally:
            _stop(h)

    def test_speculative_plus_paged_flags_rejected(self):
        with pytest.raises(ValueError, match="dense"):
            srv.make_server(["--device", "cpu", "--port", "0",
                             "--speculative", "--paged"])

    # --lora alone is served (tests/test_torch_lora.py), not over --tp 2
    @pytest.mark.parametrize("flags", [["--lora", "a=/x", "--tp", "2"],
                                       ["--tp", "2"], ["--dp", "2"]])
    def test_unported_flags_raise_at_startup(self, flags):
        with pytest.raises(NotImplementedError):
            srv.make_server(["--device", "cpu", "--port", "0"] + flags)


class TestStopTokenTextTrim:
    def test_text_excludes_stop_token_piece(self):
        class Tok:
            def encode(self, text, add_bos=True):
                return [int(t) for t in text.split()]

            def decode(self, ids):
                return "".join(f"{t} " for t in ids)

            def decode_token(self, tid):
                return f"{tid} "

        b = srv.ServingBackend(_engine(tokenizer=Tok()), GenerationConfig(
            greedy=True, max_new_tokens=10, eos_token_ids=()), slots=2)
        base = b.submit([5, 6, 7])
        b.wait(base, timeout=120)
        stop_tok = base.output_ids[3]
        r = b.submit([5, 6, 7], stop_token_ids=[stop_tok])
        b.wait(r, timeout=120)
        b.shutdown()
        assert r.output_ids[-1] == stop_tok
        text = srv._final_text(r, Tok())
        assert text == "".join(f"{t} " for t in r.output_ids[:-1])


class TestEmbeddingsHTTP:
    @pytest.mark.parametrize("pooling", ["last", "mean"])
    def test_v1_embeddings(self, httpd, pooling):
        with _post(httpd, {"input": [[5, 6, 7], [9, 10]],
                           "pooling": pooling}, path="/v1/embeddings") as r:
            out = json.load(r)
        assert out["object"] == "list" and len(out["data"]) == 2
        assert out["usage"]["prompt_tokens"] == 5
        v = out["data"][0]["embedding"]
        assert abs(sum(x * x for x in v) - 1.0) < 1e-4
        want = httpd.backend.engine.embed([[5, 6, 7]], pooling=pooling)[0]
        np.testing.assert_allclose(v, want, atol=1e-6)

    def test_v1_embeddings_bad_input_is_400(self, httpd):
        assert _status(httpd, {"input": [[]]}, "/v1/embeddings")[0] == 400


class TestPrometheusMetrics:
    def test_prometheus_exposition(self, httpd):
        with _post(httpd, {"prompt": [5, 6, 7], "max_new_tokens": 3}) as r:
            json.load(r)
        with urllib.request.urlopen(_url(
                httpd, "/metrics?format=prometheus"), timeout=30) as r:
            assert "text/plain" in r.headers["Content-Type"]
            text = r.read().decode()
        assert "# TYPE llmi_ttft_s gauge" in text
        assert 'llmi_ttft_s{quantile="0.50"}' in text
        with urllib.request.urlopen(_url(httpd, "/metrics"),
                                    timeout=30) as r:
            assert "ttft_s_p50" in json.load(r)


class TestLoopFailure:
    def test_dead_step_loop_answers_500_and_health_reports_it(self):
        """A step that raises ends the loop: the waiting request and every
        later one answer 500 with the error, /health says so, and nothing
        hangs."""
        h = _start(srv.serve(_engine(), host="127.0.0.1", port=0, gen=GEN6))
        try:
            def boom():
                raise RuntimeError("device lost")
            h.backend.sched.step = boom
            code, body = _status(h, {"prompt": [5, 6, 7]})
            assert code == 500 and "device lost" in body["error"]
            code, body = _status(h, {"prompt": [5, 6], "max_tokens": 2},
                                 "/v1/completions")
            assert code == 500 and body["error"]["type"] == "server_error"
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(_url(h, "/health"), timeout=30)
            assert e.value.code == 500
            assert "device lost" in json.load(e.value)["error"]
            with pytest.raises(srv.BackendError):
                h.backend.submit([5, 6])
        finally:
            _stop(h)


class TestEntryPoint:
    def test_make_server_serves_tiny_int8_on_the_cpu(self):
        """`python -m llm_inference_tpu_torch.engine.server --device cpu
        --model tiny --quant int8` as main() builds it, on port 0."""
        h = _start(srv.make_server(
            ["--device", "cpu", "--model", "tiny", "--quant", "int8",
             "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "128",
             "--max-new-tokens", "4", "--prefix-cache"]))
        try:
            assert isinstance(h.backend.sched, PagedScheduler)
            with _post(h, {"prompt": [5, 6, 7]}) as r:
                assert len(json.load(r)["token_ids"]) == 4
        finally:
            _stop(h)


# --------------------------------------------- the same bodies, JAX vs port

PARITY_BODIES = [
    ("/generate", {"prompt": [5, 6, 7, 8], "max_new_tokens": 6}),
    ("/generate", {"prompt": [9, 10, 11], "max_new_tokens": 5,
                   "logprobs": True, "top_logprobs": 2,
                   "repetition_penalty": 1.3, "presence_penalty": 0.5}),
    ("/generate", {"prompt": [1, 2, 3], "guided_choice": [[5, 9, 11],
                                                          [7, 13]]}),
    ("/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 4,
                         "logprobs": 2, "frequency_penalty": 0.5,
                         "logit_bias": {"40": 3.0}}),
    ("/v1/completions", {"prompt": [12, 13, 14, 15], "max_tokens": 3,
                         "echo": True, "logprobs": True}),
    ("/v1/completions", {"prompt": [5, 6, 7, 8], "max_tokens": 0,
                         "logprobs": True}),
]


def _keys(obj):
    """The JSON structure: nested key sets (list items by the first)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj:
        return [_keys(obj[0])]
    return type(obj).__name__ if obj is not None else "null"


def _ids(path, out):
    if path == "/generate":
        return out["token_ids"]
    return out["choices"][0]["token_ids"]


@pytest.fixture(scope="module")
def servers():
    gen = dict(greedy=True, max_new_tokens=6, eos_token_ids=(2,))
    jeng, teng = engine_pair("int8", **ECFG)
    jh = _start(j_srv.serve(jeng, host="127.0.0.1", port=0,
                            gen=JGenerationConfig(**gen)))
    th = _start(srv.serve(teng, host="127.0.0.1", port=0,
                          gen=GenerationConfig(**gen)))
    yield jh, th
    jh.shutdown()
    jh.backend.shutdown()
    jh.server_close()
    _stop(th)


class TestParityWithJaxServer:
    @pytest.mark.parametrize("i", range(len(PARITY_BODIES)))
    def test_same_tokens_and_keys(self, servers, i):
        """A JAX server and a port server on the same weights answer the
        same body with the same token ids and JSON keys; their logprobs
        agree within 2e-2 (test_torch_score_embed's tolerance)."""
        path, body = PARITY_BODIES[i]
        outs = []
        for h in servers:
            with _post(h, body, path) as r:
                outs.append(json.load(r))
        want, got = outs
        assert _ids(path, got) == _ids(path, want)
        assert _keys(got) == _keys(want)
        if path != "/generate" and "logprobs" in want["choices"][0]:
            lw, lg = (o["choices"][0]["logprobs"]["token_logprobs"]
                      for o in outs)
            assert [x is None for x in lg] == [x is None for x in lw]
            np.testing.assert_allclose([x for x in lg if x is not None],
                                       [x for x in lw if x is not None],
                                       atol=2e-2)
