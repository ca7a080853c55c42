"""The port's beam search (llm_inference_tpu_torch.engine.beam_search) on
the CPU: tests/test_beam_search.py's cases against the port (width 1 is
greedy, sorted distinct hypotheses, scores equal to teacher-forced
rescoring, at or above greedy's log-prob, EOS freezes a beam, length
normalisation), the cache reorder (codes and scales of every cache kind,
repeated parents), and parity with the JAX package's BeamSearchDecoder on
the same weights over a bf16 and an int8 cache."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.engine.beam_search import _NEG as J_NEG
from llm_inference_tpu.engine.beam_search import (
    BeamSearchDecoder as JBeamSearchDecoder)
from llm_inference_tpu.engine.beam_search import (
    beam_search as j_beam_search)

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            tiny_llama)
from llm_inference_tpu_torch.engine.beam_search import beam_search
from llm_inference_tpu_torch.engine.engine import (InferenceEngine,
                                                   expand_cache,
                                                   reorder_cache)
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache

from torch_bridge import engine_pair

ECFG = dict(max_seq_len=64, decode_chunk=4, max_batch_size=4,
            prefill_buckets=(8, 16))
# a float32 model's beam score against a float32 teacher-forced forward
RESCORE_ATOL = 1e-3
# on engine_pair's int8 weights (float32 activations) the port and JAX
# do the same arithmetic up to the order of sums: a cumulative score over
# n tokens agrees within n times 1e-3. Where JAX's W-th and (W+1)-th
# candidate scores lie closer than that at the current length, the two
# searches may keep different beams: the comparison ends there.
TOKEN_LP_TOL = 1e-3


@pytest.fixture(scope="module")
def engine():
    cfg = tiny_llama(num_kv_heads=2)
    return InferenceEngine(cfg, llama.init_params(cfg, seed=0, device="cpu"),
                           engine_cfg=EngineConfig(**ECFG), device="cpu")


def seq_log_prob(engine, prompt, gen_tokens):
    """Teacher-forced cumulative log-prob of gen_tokens given prompt, from
    one `logits_mode="all"` forward of the port."""
    full = list(prompt) + list(gen_tokens)
    cache = engine.new_cache(1, max_seq=64)
    logits, _ = llama.forward(
        engine.cfg, engine.params, torch.tensor([full]),
        torch.arange(len(full))[None], cache, logits_mode="all")
    logp = torch.log_softmax(logits[0].float(), -1)
    return sum(float(logp[len(prompt) - 1 + i, t])
               for i, t in enumerate(gen_tokens))


class TestBeamSearch:
    def test_width_one_equals_greedy(self, engine):
        prompt = [5, 6, 7, 8]
        gen = GenerationConfig(greedy=True, max_new_tokens=8,
                               eos_token_ids=(1,))
        want = engine.generate([list(prompt)], gen)[0].token_ids
        hyps = beam_search(engine, prompt, beam_width=1, max_new_tokens=8,
                           eos_token_ids=(1,))
        assert hyps[0].token_ids == want

    def test_returns_sorted_distinct_hypotheses(self, engine):
        hyps = beam_search(engine, [5, 6, 7], beam_width=4,
                           max_new_tokens=6, eos_token_ids=(1,))
        assert len(hyps) == 4
        scores = [h.score for h in hyps]
        assert scores == sorted(scores, reverse=True)
        assert len({tuple(h.token_ids) for h in hyps}) == 4

    def test_scores_match_teacher_forced_rescoring(self, engine):
        prompt = [9, 10, 11]
        hyps = beam_search(engine, prompt, beam_width=3, max_new_tokens=5,
                           eos_token_ids=(1,))
        for h in hyps:
            if h.finished:
                continue          # the trimmed EOS is not rescored
            np.testing.assert_allclose(
                h.log_prob, seq_log_prob(engine, prompt, h.token_ids),
                atol=RESCORE_ATOL)

    def test_beats_or_matches_greedy_log_prob(self, engine):
        """Greedy is one beam path: the best beam's log-prob is at least
        greedy's (same length, no EOS)."""
        prompt = [3, 4, 5, 6]
        gen = GenerationConfig(greedy=True, max_new_tokens=6,
                               eos_token_ids=())
        greedy = engine.generate([list(prompt)], gen)[0].token_ids
        hyps = beam_search(engine, prompt, beam_width=4, max_new_tokens=6,
                           eos_token_ids=())
        assert (hyps[0].log_prob
                >= seq_log_prob(engine, prompt, greedy) - RESCORE_ATOL)

    def test_eos_finishes_beam(self, engine):
        """EOS = greedy's first token: a beam finishes at once, empty."""
        prompt = [5, 6, 7, 8]
        gen = GenerationConfig(greedy=True, max_new_tokens=1,
                               eos_token_ids=())
        first = engine.generate([list(prompt)], gen)[0].token_ids[0]
        hyps = beam_search(engine, prompt, beam_width=2, max_new_tokens=5,
                           eos_token_ids=(first,))
        fin = [h for h in hyps if h.finished]
        assert fin and fin[0].token_ids == []

    def test_length_penalty_ranking(self, engine):
        hyps = beam_search(engine, [7, 8, 9], beam_width=3,
                           max_new_tokens=5, eos_token_ids=(1,),
                           length_penalty=1.0)
        scores = [h.score for h in hyps]
        assert scores == sorted(scores, reverse=True)
        for h in hyps:
            denom = ((5.0 + len(h.token_ids) + 1) / 6.0) ** 1.0
            assert h.score == pytest.approx(h.log_prob / denom)


@pytest.mark.parametrize("kind", [torch.bfloat16, "int8", "int4"])
def test_reorder_and_expand_move_every_tensor(kind):
    """expand_cache repeats each row W times and reorder_cache gathers
    rows by parent, repeated parents included, in the codes and in the
    scales."""
    g = torch.Generator().manual_seed(0)
    c = kvcache.init_cache(2, 2, 2, 16, 8, kind, device="cpu")
    for f in ("k", "v", "k_scale", "v_scale"):
        t = getattr(c, f)
        if t is not None:
            t.copy_(torch.randint(-100, 100, t.shape, generator=g))
    e = expand_cache(c, 3)
    assert e.bits == c.bits and e.k.shape[1] == 6
    parents = torch.tensor([5, 0, 5, 2, 1, 1])
    r = reorder_cache(e, parents)
    for f in ("k", "v", "k_scale", "v_scale"):
        src = getattr(c, f)
        if src is None:
            assert getattr(r, f) is None
            continue
        assert torch.equal(getattr(e, f), src.repeat_interleave(3, 1))
        want = torch.stack([src[:, int(p) // 3] for p in parents], 1)
        assert torch.equal(getattr(r, f), want), f


# ------------------------------------------------------ parity with JAX

def _jax_margins(jeng, prompt, W, n, eos):
    """JAX's margins between its W-th and (W+1)-th candidate scores: at
    the seed (the prefill's logprobs) and at each of the n - 1 steps of
    its search (computed beside each `_step_jit` call, on its inputs)."""
    logits, _ = jeng.prefill([list(prompt)])
    top = jax.lax.top_k(jax.nn.log_softmax(
        jnp.asarray(logits[0], jnp.float32)), W + 1)[0]
    margins = [float(top[W - 1] - top[W])]
    dec = JBeamSearchDecoder(jeng, W, 0.0, eos)
    step = dec._step_jit

    @jax.jit
    def margin(params, cache, tokens, pos, scores, finished):
        lg, _ = jeng._fwd(params, tokens[:, None], pos[:, None], cache,
                          jnp.zeros((W,), jnp.int32))
        cand = scores[:, None] + jax.nn.log_softmax(
            lg.astype(jnp.float32), -1)
        cand = jnp.where(finished[:, None], J_NEG, cand)
        cand = cand.at[:, 0].set(jnp.where(finished, scores, cand[:, 0]))
        t = jax.lax.top_k(cand.reshape(-1), W + 1)[0]
        return t[W - 1] - t[W]

    def recorded(params, cache, *a):
        margins.append(float(margin(params, cache, *a)))
        return step(params, cache, *a)
    dec._step_jit = recorded
    dec.search(list(prompt), n)
    return margins


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_beam_search_matches_jax(kv):
    """The same hypotheses (tokens, finished) as JAX's BeamSearchDecoder,
    log_probs within TOKEN_LP_TOL a token, compared over as many tokens
    as JAX's candidates stay apart (at least half of them)."""
    jeng, teng = engine_pair("int8", kv=kv, **ECFG)
    W, N, eos = 4, 10, (1,)
    prompt = [5, 6, 7, 8, 9]
    margins = _jax_margins(jeng, prompt, W, N, eos)
    # margins[j] decides the (j + 1)-th token of every beam
    m = next((j for j, x in enumerate(margins)
              if x < TOKEN_LP_TOL * (j + 1)), N)
    assert 2 * m >= N, margins
    want = j_beam_search(jeng, prompt, W, m, eos)
    got = beam_search(teng, prompt, W, m, eos)
    assert [h.token_ids for h in got] == [h.token_ids for h in want]
    assert [h.finished for h in got] == [h.finished for h in want]
    np.testing.assert_allclose([h.log_prob for h in got],
                               [h.log_prob for h in want],
                               atol=TOKEN_LP_TOL * m)
