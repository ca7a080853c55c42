"""The port's speculative decoding (llm_inference_tpu_torch.engine.
speculative) on the CPU: tests/test_speculative.py's classes against the
port (each speculative stream equals the port's own plain greedy stream),
and parity with the JAX package: propose_ngram on seeded histories, and
SpeculativeDecoder and SpeculativeBatchingScheduler on the same weights
(engine_pair's sharpened head: equal tokens and equal stats)."""

import numpy as np
import pytest

from llm_inference_tpu.config import GenerationConfig as JGenerationConfig
from llm_inference_tpu.engine import speculative as j_spec

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            tiny_llama)
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler)
from llm_inference_tpu_torch.engine.speculative import (
    DraftModelSpeculativeDecoder, DraftSpeculativeBatchingScheduler,
    SpeculativeBatchingScheduler, SpeculativeDecoder, propose_ngram)
from llm_inference_tpu_torch.models import llama

from torch_bridge import engine_pair

ECFG = dict(max_seq_len=128, decode_chunk=4, max_batch_size=3,
            prefill_buckets=(8, 16, 32))
# the speculative and the plain scheduler's logprobs of the same tokens:
# the T = 5 window and the T = 1 step differ only in float32 rounding
LOGPROB_TOL = 2e-3
# the port's logits agree with the JAX package's within 1e-2
# (test_torch_model); the sharpened head scales that by 64, and the
# compared logprobs stay within 2e-2 (test_torch_server's parity class)
JAX_LOGPROB_TOL = 2e-2


def _engine(seed=0, **cfg_kw):
    cfg = tiny_llama(**dict(dict(num_kv_heads=2), **cfg_kw))
    return InferenceEngine(cfg, llama.init_params(cfg, seed=seed,
                                                  device="cpu"),
                           engine_cfg=EngineConfig(**ECFG), device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _gen(n, eos=(1,)):
    return GenerationConfig(greedy=True, max_new_tokens=n, eos_token_ids=eos)


def _plain(eng, prompt, gen):
    return eng.generate([list(prompt)], gen)[0].token_ids


def _cut_eos(ids, eos=1):
    """The speculative output keeps its stop token; generate's does not."""
    return ids[:ids.index(eos)] if eos in ids else ids


def _run(sched, prompts):
    reqs = [sched.submit(list(p)) for p in prompts]
    while sched.step():
        pass
    return reqs


# ------------------------------------------------------------ proposer

def test_ngram_lookup():
    #      0  1  2  3  4  5  6  7  8
    ids = [7, 8, 9, 4, 5, 6, 1, 7, 8]
    # the suffix (7, 8) matched at 0: propose what followed it
    assert propose_ngram(ids, gamma=3, ngram=2) == [9, 4, 5]
    assert propose_ngram(ids, gamma=1, ngram=2) == [9]
    assert propose_ngram([1, 2, 3, 4], gamma=3, ngram=2) == []
    # the most RECENT earlier occurrence wins
    assert propose_ngram([5, 1, 5, 2, 5], gamma=1, ngram=1) == [2]


@pytest.mark.parametrize("gamma,ngram,min_ngram", [(4, 3, 1), (1, 2, 1),
                                                   (6, 4, 2), (3, 1, 1)])
def test_propose_ngram_matches_jax(gamma, ngram, min_ngram):
    """The same proposals as JAX's propose_ngram on 200 seeded histories
    over small alphabets (so that suffixes recur)."""
    rng = np.random.default_rng(gamma * 100 + ngram * 10 + min_ngram)
    hits = 0
    for _ in range(200):
        ids = rng.integers(0, int(rng.integers(2, 9)),
                           int(rng.integers(1, 40))).tolist()
        want = j_spec.propose_ngram(ids, gamma, ngram, min_ngram)
        assert propose_ngram(ids, gamma, ngram, min_ngram) == want, ids
        hits += bool(want)
    assert hits > 50


# ------------------------------------------------------ B = 1, n-gram

class TestSpeculativeDecoding:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_plain_greedy(self, engine, seed):
        rng = np.random.default_rng(seed)
        prompt = rng.integers(2, 200, int(rng.integers(4, 16))).tolist()
        gen = _gen(24)
        got, stats = SpeculativeDecoder(engine, gamma=4).generate(prompt,
                                                                  gen)
        assert _cut_eos(got) == _plain(engine, prompt, gen), stats

    def test_repetitive_prompt_accepts(self, engine):
        """A cyclic prompt makes the proposer productive: accepted tokens,
        fewer verify forwards than tokens, and the plain greedy stream."""
        prompt = [3, 4, 5, 6] * 5
        gen = _gen(32)
        want = _plain(engine, prompt, gen)
        got, stats = SpeculativeDecoder(engine, gamma=4).generate(prompt,
                                                                  gen)
        assert _cut_eos(got) == want
        assert stats["steps"] < len(want), stats
        assert stats["accepted"] > 0, stats

    def test_window_past_cache_end_refused(self, engine):
        """prompt + max_new_tokens + γ + 1 > max_seq_len raises (a window
        crossing the end would shift its write over committed KV)."""
        with pytest.raises(ValueError, match="speculative window"):
            SpeculativeDecoder(engine, gamma=4).generate([5] * 100, _gen(24))


class TestDraftModelSpeculative:
    def test_self_draft_accepts_everything(self, engine):
        """The target as its own draft: whole windows are accepted (so the
        backfill runs) and the stream is plain greedy."""
        prompt = [3, 4, 5, 6, 7]
        gen = _gen(24)
        want = _plain(engine, prompt, gen)
        got, stats = DraftModelSpeculativeDecoder(
            engine, engine, gamma=4).generate(prompt, gen)
        assert _cut_eos(got) == want, stats
        assert stats["steps"] <= len(want) // 3 + 2, stats
        assert stats["accepted"] > 0 and stats["backfills"] > 0, stats

    @pytest.mark.parametrize("seed", [0, 3])
    def test_independent_draft_matches_plain_greedy(self, engine, seed):
        """A different, smaller draft model: the target's greedy stream."""
        draft = _engine(seed + 7, num_layers=1, hidden_size=64,
                        intermediate_size=128, num_heads=2, head_dim=32)
        prompt = np.random.default_rng(seed).integers(2, 200, 9).tolist()
        gen = _gen(16)
        got, stats = DraftModelSpeculativeDecoder(
            engine, draft, gamma=3).generate(prompt, gen)
        assert _cut_eos(got) == _plain(engine, prompt, gen), stats


@pytest.mark.parametrize("make", [
    lambda t, d: DraftModelSpeculativeDecoder(t, d),
    lambda t, d: DraftSpeculativeBatchingScheduler(t, d)],
    ids=["decoder", "scheduler"])
def test_vocab_mismatch_rejected(engine, make):
    with pytest.raises(ValueError, match="vocab"):
        make(engine, _engine(1, vocab_size=128))


# -------------------------------------------------- batching scheduler

class TestSpeculativeBatchingScheduler:
    def test_matches_plain_scheduler(self, engine):
        """Two requests in one speculative batch: the plain scheduler's
        greedy streams, with speculation paying off."""
        gen = _gen(20)
        prompts = [[3, 4, 5, 6] * 4, [9, 10, 11] * 3]
        wants = _run(ContinuousBatchingScheduler(engine, gen, slots=3),
                     prompts)
        spec = SpeculativeBatchingScheduler(engine, gen, slots=3, gamma=4)
        for w, g in zip(wants, _run(spec, prompts)):
            assert g.output_ids == w.output_ids, spec.spec_stats
        st = spec.spec_stats
        assert st["accepted"] > 0 and st["produced"] > st["steps"], st

    def test_logprobs_match_plain(self, engine):
        gen = _gen(10)
        prompt = [5, 6, 7, 5, 6, 7, 5, 6]
        w, = _run(ContinuousBatchingScheduler(engine, gen, slots=3),
                  [prompt])
        g, = _run(SpeculativeBatchingScheduler(engine, gen, slots=3),
                  [prompt])
        assert g.output_ids == w.output_ids
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   atol=LOGPROB_TOL)

    @pytest.mark.parametrize("knob", [
        dict(temperature=1.5), dict(repetition_penalty=1.2),
        dict(presence_penalty=0.5), dict(frequency_penalty=0.5),
        dict(logit_bias={5: 1.0}), dict(guided_choice=[[5, 6], [7]]),
        dict(top_logprobs=2), dict(adapter="a")])
    def test_refused_knobs(self, engine, knob):
        spec = SpeculativeBatchingScheduler(engine, _gen(4), slots=3)
        with pytest.raises(ValueError, match="greedy|logit_bias|adapter"):
            spec.submit([3, 4], **knob)
        assert not spec.queue

    def test_budget_cut_mid_window(self, engine):
        """max_new_tokens inside an accepted window truncates there."""
        spec = SpeculativeBatchingScheduler(engine, _gen(3, eos=()),
                                            slots=3, gamma=4)
        r, = _run(spec, [[3, 4, 5, 6] * 4])
        assert len(r.output_ids) == 3

    def test_stop_token_and_cancel_mid_window(self, engine):
        """A stop token inside an accepted window ends the request there;
        a cancelled request retires at its next verify."""
        gen = _gen(20, eos=())
        prompt = [3, 4, 5, 6] * 4
        w, = _run(ContinuousBatchingScheduler(engine, gen, slots=3),
                  [prompt])
        stop = w.output_ids[5]
        spec = SpeculativeBatchingScheduler(engine, gen, slots=3, gamma=4)
        r = spec.submit(list(prompt), stop_token_ids=[stop])
        c = spec.submit(list(prompt))
        spec.step()
        spec.cancel(c)
        while spec.step():
            pass
        cut = w.output_ids.index(stop) + 1
        assert r.finished and r.output_ids == w.output_ids[:cut]
        assert c.cancelled and len(c.output_ids) < 20
        assert all(x is None for x in spec.slot_req)

    def test_fallback_near_cache_end(self):
        """A request whose window would cross max_seq_len = 32 decodes its
        last tokens in plain chunks, with the plain scheduler's stream."""
        eng = InferenceEngine(
            tiny_llama(), llama.init_params(tiny_llama(), seed=0,
                                            device="cpu"),
            engine_cfg=EngineConfig(max_seq_len=32, decode_chunk=4,
                                    max_batch_size=2,
                                    prefill_buckets=(8, 16)), device="cpu")
        gen = _gen(12)
        prompt = [3, 4, 5, 6] * 5                 # 20 + 12 = 32 exactly
        w, = _run(ContinuousBatchingScheduler(eng, gen, slots=2), [prompt])
        spec = SpeculativeBatchingScheduler(eng, gen, slots=2, gamma=4)
        g, = _run(spec, [prompt])
        assert g.output_ids == w.output_ids
        assert spec.spec_stats["fallbacks"] > 0, spec.spec_stats


class TestDraftSpeculativeBatchingScheduler:
    @pytest.mark.parametrize("draft_seed", [7, 0], ids=["other", "self"])
    def test_matches_plain_scheduler_any_draft(self, engine, draft_seed):
        """The plain scheduler's streams whatever the draft's quality; the
        self-draft accepts more than two tokens a verify."""
        gen = _gen(16)
        prompts = [[3, 4, 5, 6, 7], [9, 10, 11, 12]]
        wants = _run(ContinuousBatchingScheduler(engine, gen, slots=2),
                     prompts)
        sched = DraftSpeculativeBatchingScheduler(
            engine, _engine(draft_seed), gen, slots=2, gamma=3)
        for w, g in zip(wants, _run(sched, prompts)):
            assert g.output_ids == w.output_ids, sched.spec_stats
        st = sched.spec_stats
        if draft_seed == 0:
            assert st["produced"] / st["steps"] > 2.0, st

    @pytest.mark.parametrize("draft_seed", [7, 0], ids=["other", "self"])
    def test_staggered_admission_catchup(self, engine, draft_seed):
        """A request admitted mid-flight: both streams are plain greedy;
        with the self-draft, whole windows are accepted and the draft
        cache catches up with the committed history."""
        gen = _gen(14)
        plain = ContinuousBatchingScheduler(engine, gen, slots=2)
        wants = _run(plain, [[3, 4, 5, 6], [9, 10, 11]])
        sched = DraftSpeculativeBatchingScheduler(
            engine, _engine(draft_seed), gen, slots=2, gamma=3)
        g1 = sched.submit([3, 4, 5, 6])
        sched.step()
        g2 = sched.submit([9, 10, 11])            # staggered admission
        while sched.step():
            pass
        assert [g1.output_ids, g2.output_ids] == [w.output_ids
                                                  for w in wants]
        assert sched.catchups > 0 or draft_seed != 0


# ------------------------------------------------------ parity with JAX

@pytest.fixture(scope="module")
def pair():
    return engine_pair("int8", **ECFG)


JAX_STATS = ("steps", "accepted", "produced")


@pytest.mark.parametrize("prompt", [[3, 4, 5, 6] * 5,
                                    [17, 90, 4, 33, 17, 90, 8]])
def test_decoder_matches_jax(pair, prompt):
    """SpeculativeDecoder on the same weights: JAX's tokens and stats."""
    jeng, teng = pair
    want, jst = j_spec.SpeculativeDecoder(jeng, gamma=4).generate(
        list(prompt), JGenerationConfig(greedy=True, max_new_tokens=24,
                                        eos_token_ids=(1,)))
    got, tst = SpeculativeDecoder(teng, gamma=4).generate(list(prompt),
                                                          _gen(24))
    assert got == want
    assert tst == jst


def test_scheduler_matches_jax(pair):
    """SpeculativeBatchingScheduler on the same weights: JAX's tokens,
    spec_stats (steps, accepted, produced) and logprobs."""
    jeng, teng = pair
    prompts = [[3, 4, 5, 6] * 4, [9, 10, 11] * 3, [40, 41, 42, 43, 44]]
    jsched = j_spec.SpeculativeBatchingScheduler(
        jeng, JGenerationConfig(greedy=True, max_new_tokens=20,
                                eos_token_ids=(1,)), slots=3, gamma=4)
    wants = _run(jsched, prompts)
    tsched = SpeculativeBatchingScheduler(teng, _gen(20), slots=3, gamma=4)
    gots = _run(tsched, prompts)
    assert [g.output_ids for g in gots] == [w.output_ids for w in wants]
    assert ({k: tsched.spec_stats[k] for k in JAX_STATS}
            == jsched.spec_stats)
    for g, w in zip(gots, wants):
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   atol=JAX_LOGPROB_TOL)
